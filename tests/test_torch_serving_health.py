"""``tests/unit/test_fleet_health.py`` against the port (see
``test_torch_serving_units.py``): SLO targets and their burn-rate states,
exemplar pinning, engine and fleet health, and ``/healthz``,
``/debug/fleet`` and ``/debug/requests`` on the app."""

import pytest
import torch

from tests.test_torch_serving_units import port_cases, torch_sklearn_model

torch.set_num_threads(2)

# the replica scheduler is not ported (ROADMAP.md, Queue A: parallelism and the replica layer)
port_cases(globals(), "test_fleet_health.py", drop_lines=("from unionml_tpu.serving.replicas import",))
del test_scheduler_order_deprioritizes_breaching_replicas  # noqa: F821
del test_scheduler_affinity_head_disqualified_by_breach  # noqa: F821
del test_scheduler_cached_routing_respects_breach  # noqa: F821


@pytest.fixture
def sklearn_model():
    return torch_sklearn_model()
