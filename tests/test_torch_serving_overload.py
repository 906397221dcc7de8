"""``tests/unit/test_overload.py`` against the port (see ``test_torch_serving_units.py``):
the HTTP layer's in-flight cap (429 + ``Retry-After``), deadlines (503), drain,
the micro-batcher's bounded admission and the app under a flood."""

import pytest
import torch

from tests.test_torch_serving_units import port_cases, torch_sklearn_model

torch.set_num_threads(2)

port_cases(globals(), "test_overload.py")


@pytest.fixture
def sklearn_model():
    return torch_sklearn_model()
