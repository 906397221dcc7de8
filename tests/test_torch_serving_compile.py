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

# a device mesh is not ported (ROADMAP.md, Queue A: parallelism and the replica layer)
del test_mesh_placement_rounds_buckets_to_data_axis  # noqa: F821


def test_mesh_is_refused_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="parallelism and the replica layer"):
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
