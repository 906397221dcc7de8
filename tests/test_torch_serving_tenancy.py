"""``tests/unit/test_tenancy.py`` against the port (see
``test_torch_serving_units.py``): tenant specs and identity, token buckets,
the registry's bounds and env fallbacks, the engine's deficit-round-robin
admission and priority preemption, the tenant shed over HTTP and the
OpenAI-compatible routes. The JAX cases build ``Generator(module, params,
config)``; here that call shape builds the port's ``Generator`` over a tiny
f32 Llama on the CPU."""

import pytest
import torch

from tests.test_torch_serving_units import generator, port_cases, tiny_llama
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

port_cases(globals(), "test_tenancy.py")
Generator = generator  # the JAX call shape, the port's Generator


@pytest.fixture(scope="module")
def tiny():
    return tiny_llama(96, seed=1), None
