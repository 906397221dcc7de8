"""The port's fleet fault tolerance (``serving/faults.py`` and the host
lifecycle of ``serving/cluster.py``), held against the JAX package on the
CPU.

``tests/unit/test_faults.py`` runs here against the port, every case (see
``test_torch_serving_units.py``): the plan's schema round trip and
validation, the env reader degrading on garbage, seeded windowed
determinism, the default chaos plan, ``live → suspect → dead → probation →
live`` under an injected drop, a zero-token stream retried on a sibling, an
emitted stream interrupted cleanly, checkpoint and lease fencing, lease-expiry
promotion (and deferring to a lower-id live worker), the announce withdrawn
at shutdown, stale-epoch announces ignored, a replacement worker rebound
through probation, and the ``/metrics`` fleet section. The engines serve the
unit file's tiny f32 Llama on weights carried from its JAX init, and every
stream is held against the JAX package's ``Generator`` on those weights.

Then the two packages' armed plans, given the same plan, seed and virtual
clock, decide every call alike: which RPCs drop, which sleep, where streams
are cut, and the injection counters.
"""

import random

import pytest
import torch

from tests.test_torch_cluster import SHAPE, _jax_expected
from tests.test_torch_continuous import _models
from tests.test_torch_serving_units import generator, port_cases

torch.set_num_threads(2)

port_cases(globals(), "test_faults.py")
Generator = generator  # noqa: F811


@pytest.fixture(scope="module")
def pair():
    """The unit file's JAX init (``PRNGKey(1)``) and a port model on its weights."""
    return _models(SHAPE, seed=1)


@pytest.fixture(scope="module")
def tiny(pair):  # noqa: F811
    return pair[2], None


@pytest.fixture(autouse=True)
def _held_to_jax(pair, monkeypatch):
    """The unit cases' oracle, ``_expected``, is JAX's Generator here."""
    monkeypatch.setitem(globals(), "_expected", lambda tiny, cfg, prompts: _jax_expected(pair, cfg, prompts))


def _plan_spec(seed: int) -> dict:
    """A seeded plan mixing every kind, windows overlapping, some per host."""
    rng = random.Random(seed)
    events = []
    for _ in range(12):
        kind = rng.choice(["worker_kill", "rpc_drop", "rpc_delay", "stream_cut"])
        event = {"t": round(rng.uniform(0, 3), 3), "kind": kind, "for_s": round(rng.uniform(0.1, 1.0), 3)}
        if rng.random() < 0.7:
            event["host"] = rng.randrange(3)
        if kind in ("rpc_drop", "stream_cut"):
            event["p"] = rng.choice([1.0, 0.5, 0.25])
        if kind == "rpc_delay":
            event["delay_s"] = 0.0
        if kind == "stream_cut":
            event["after_tokens"] = rng.randrange(3)
        events.append(event)
    return {"version": 1, "seed": seed, "events": events}


def _decisions(package: str, spec: dict) -> tuple:
    """Every decision an armed plan makes over a seeded walk of virtual time:
    per call the host, the time, and what ``check_rpc`` and
    ``stream_cut_after`` did; then the counters."""
    if package == "jax":
        from unionml_tpu.serving.faults import FaultInjected, FaultPlan
    else:
        from unionml_tpu_torch.serving.faults import FaultInjected, FaultPlan

    clock = Clock()
    armed = FaultPlan.parse(spec).arm(clock=clock)
    rng = random.Random(spec["seed"] + 1)
    out = []
    for _ in range(400):
        clock.now += rng.uniform(0, 0.02)
        host = rng.choice([None, 0, 1, 2])
        try:
            armed.check_rpc(host, "/ctrl/probe")
            rpc = "ok"
        except FaultInjected as exc:
            rpc = str(exc)
        out.append((host, round(clock.now, 6), rpc, armed.stream_cut_after(host), armed.worker_down(host)))
    return out, armed.stats(), FaultPlan.parse(spec).dumps()


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_armed_plans_decide_as_the_jax_package(seed):
    """The same plan, seed and virtual clock: the same drops, cuts, down
    windows and counters, call for call, and the same canonical JSON."""
    spec = _plan_spec(seed)
    assert _decisions("port", spec) == _decisions("jax", spec)


def test_default_chaos_plan_equals_the_jax_package():
    from unionml_tpu.serving.faults import default_chaos_plan as jax_plan
    from unionml_tpu_torch.serving.faults import default_chaos_plan

    for kw in ({}, dict(seed=3, host=2, kill_at_s=0.1, down_s=2.5)):
        assert default_chaos_plan(**kw).dumps() == jax_plan(**kw).dumps()
        assert default_chaos_plan(**kw).fault_times() == jax_plan(**kw).fault_times()
