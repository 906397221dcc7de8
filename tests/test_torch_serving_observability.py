"""``tests/unit/test_observability.py`` against the port (see
``test_torch_serving_units.py``): request ids, traces and the flight recorder,
the Prometheus exposition, the app's debug surface, structured logs, and one
request's timeline from the HTTP layer through the continuous engine."""

import asyncio
import json
from pathlib import Path

import pytest
import torch

from tests.test_torch_serving_units import generator, port_cases, tiny_llama, torch_sklearn_model

torch.set_num_threads(2)

port_cases(globals(), "test_observability.py")


@pytest.fixture
def sklearn_model():
    return torch_sklearn_model()


@pytest.fixture(scope="module")
def tiny_gen():
    return tiny_llama(97, seed=0), None


def _engine(tiny_gen, **kwargs):
    from unionml_tpu_torch.models import GenerationConfig
    from unionml_tpu_torch.serving import ContinuousBatcher

    module, params = tiny_gen
    cfg = GenerationConfig(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
    return ContinuousBatcher(generator(module, params, cfg), **kwargs)


def test_profile_endpoint_rejects_overlapping_captures(traced_app, tmp_path):
    """The JAX case patches ``jax.profiler``; here ``torch.profiler`` captures
    for real (the host's activity on the CPU): one capture, one trace file,
    the overlapping request answered 409."""
    traced_app.profile_dir = str(tmp_path)

    async def overlap():
        traced_app.startup()
        body = json.dumps({"duration_ms": 150}).encode()
        return await asyncio.gather(
            traced_app.server.dispatch_with_headers("POST", "/debug/profile", body),
            traced_app.server.dispatch_with_headers("POST", "/debug/profile", body),
        )

    results = asyncio.run(overlap())
    assert sorted(r[0] for r in results) == [200, 409]
    assert len(list(Path(tmp_path).glob("*.trace.json"))) == 1  # exactly one capture
    ok = next(r for r in results if r[0] == 200)
    assert ok[1]["duration_ms"] == 150.0
    for bad in (-5, "soon"):
        status, _, _, _ = _app_dispatch(  # noqa: F821
            traced_app, "POST", "/debug/profile", json.dumps({"duration_ms": bad}).encode()
        )
        assert status == 400
