"""``tests/unit/test_fleet_health.py`` against the port (see
``test_torch_serving_units.py``): SLO targets and their burn-rate states,
exemplar pinning, engine and fleet health, the replica scheduler's
breach-aware routing, and ``/healthz``, ``/debug/fleet`` and
``/debug/requests`` on the app."""

import pytest
import torch

from tests.test_torch_serving_units import port_cases, torch_sklearn_model

torch.set_num_threads(2)

port_cases(globals(), "test_fleet_health.py")


@pytest.fixture
def sklearn_model():
    return torch_sklearn_model()
