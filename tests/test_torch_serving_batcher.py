"""``tests/unit/test_serving.py`` against the port (see ``test_torch_serving_units.py``):
the serving app's routes in-process, the micro-batcher's coalescing and its
solo fallbacks, and ``/metrics``."""

import pytest
import torch

from tests.test_torch_serving_units import port_cases, torch_sklearn_model

torch.set_num_threads(2)

port_cases(globals(), "test_serving.py")


@pytest.fixture
def sklearn_model():
    return torch_sklearn_model()
