"""``tests/unit/test_compiled_predictor.py`` against the port (see
``test_torch_serving_units.py``): the bucketed predictor's shape count stays at
the bucket count, padded results equal unpadded ones, oversized requests chunk
through the largest bucket, warmup covers every bucket, and predictors that do
not take tensors fall back to eager for good."""

import numpy as np
import pytest
import torch

from tests.test_torch_serving_units import port_cases

torch.set_num_threads(2)

port_cases(globals(), "test_compiled_predictor.py")

# its data=4 mesh needs four ranks: tests/test_torch_serving_mesh.py runs it there
del test_mesh_placement_rounds_buckets_to_data_axis  # noqa: F821


def test_mesh_is_refused_naming_the_roadmap():
    """A MeshSpec runs (tests/test_torch_serving_mesh.py), a pipe axis too
    (the rules leave it replicated, as in the JAX package); a mesh that is
    not a MeshSpec is refused."""
    from unionml_tpu_torch.parallel import MeshSpec

    assert ServingConfig(bucket_sizes=[4], mesh=MeshSpec(pipe=2)).mesh.pipe == 2  # noqa: F821
    with pytest.raises(TypeError, match="MeshSpec"):
        ServingConfig(bucket_sizes=[4], mesh="data")  # noqa: F821


def test_bucketed_call_runs_on_the_model_device_under_inference_mode():
    seen = {}

    def predict(params, feats):
        seen.update(device=feats.device, dtype=feats.dtype, inference=torch.is_inference_mode_enabled())
        return feats @ params["w"]

    cp = CompiledPredictor(predict, ServingConfig(bucket_sizes=[4]))  # noqa: F821
    params = {"w": torch.arange(3, dtype=torch.float32)}
    out = cp(params, np.ones((3, 3)))  # float64 rows, as pandas gives them
    assert seen == {"device": torch.device("cpu"), "dtype": torch.float32, "inference": True}
    assert isinstance(out, torch.Tensor) and out.tolist() == [3.0, 3.0, 3.0]
