"""The port's continuous engine against the JAX package's on the serving
surface: the ``stats()`` key set (dense and paged, with and without tenancy
and SLO targets), the deficit-round-robin admission order, priority
preemption and its token-identical resume, and the ``UNIONML_TPU_SLO_*``
exports.

Both engines run the same tiny f32 Llama (the JAX weights carried across by
``llama_params_from_jax``) on the CPU, greedy; each submit sequence is the
same on both sides.
"""

import dataclasses
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from unionml_tpu.serving import TenantRegistry as JaxTenantRegistry, TenantSpec as JaxTenantSpec
from unionml_tpu.serving.continuous import _Session as JaxSession
from unionml_tpu_torch.models import GenerationConfig, Generator, Llama, LlamaConfig, llama_params_from_jax
from unionml_tpu_torch.serving import ContinuousBatcher, TenantRegistry, TenantSpec
from unionml_tpu_torch.serving.continuous import _Session
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

SHAPE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
PROMPTS = [[3, 14, 15, 92, 6], [27, 1], [8, 2, 8, 1, 8, 2, 8]]
SLO_ENV = ("UNIONML_TPU_SLO_TTFT_P95_MS", "UNIONML_TPU_SLO_TBT_P99_MS", "UNIONML_TPU_SLO_SHED_RATIO",
           "UNIONML_TPU_SLO_FAST_WINDOW_S", "UNIONML_TPU_SLO_SLOW_WINDOW_S", "UNIONML_TPU_SLO_MIN_SAMPLES")
#: stats() leaves that are timings or time-windowed rates: compared by key only
TIMED = ("ttft_ms", "tbt_ms", "rates", "slo", "tenant_slo")


@dataclasses.dataclass
class Pair:
    """One engine shape built over both packages: ``jax(**kw)``/``torch(**kw)``."""

    jax_module: object
    jax_params: object
    model: object

    def jax(self, cfg=None, **kw):
        return JaxContinuousBatcher(JaxGenerator(self.jax_module, self.jax_params, JaxGenerationConfig(**(cfg or CFG))),
                                    **kw)

    def torch(self, cfg=None, **kw):
        return ContinuousBatcher(Generator(self.model, GenerationConfig(**(cfg or CFG)), device="cpu"), **kw)


CFG = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))


@pytest.fixture(scope="module")
def pair():
    jax_cfg = JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE)
    module = JaxLlama(jax_cfg)
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, attention_impl="flash", **SHAPE)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return Pair(module, params, model)


@pytest.fixture
def no_slo_env(monkeypatch):
    for name in SLO_ENV:
        monkeypatch.delenv(name, raising=False)


def _drain(stream):
    return [int(t) for chunk in stream for t in np.asarray(chunk).ravel()]


def _paths(tree, prefix=()):
    """Every key path of a nested dict; timed sections contribute their keys only."""
    out = set()
    for key, value in tree.items():
        out.add(prefix + (key,))
        if isinstance(value, dict):
            out |= _paths(value, prefix + (key,))
    return out


def _counters(stats):
    """The deterministic part of a stats() snapshot."""
    out = {}
    for key, value in stats.items():
        if key in TIMED:
            continue
        out[key] = {k: v for k, v in value.items() if k != "backlog_tokens"} if isinstance(value, dict) else value
    return out


ENGINES = {
    "dense": dict(slots=2, decode_chunk=4),
    "paged": dict(slots=2, decode_chunk=4, block_size=8),
    "paged-tenancy": dict(slots=2, decode_chunk=4, block_size=8, tenancy="registry"),
    "paged-slo": dict(slots=2, decode_chunk=4, block_size=8, slo="armed"),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_stats_key_set_and_counters_equal_the_jax_engines(pair, no_slo_env, case):
    """Sequential submits (each drained before the next), so dispatches and
    rows are deterministic: every key path equal, every counter equal; the
    latency windows and rates are compared by their keys."""
    kw = dict(ENGINES[case])
    snapshots = {}
    for name, build, registry, slo_config in (
        ("jax", pair.jax, JaxTenantRegistry, "unionml_tpu.observability.slo"),
        ("torch", pair.torch, TenantRegistry, "unionml_tpu_torch.observability.slo"),
    ):
        engine_kw = dict(kw)
        if engine_kw.get("tenancy") == "registry":
            engine_kw["tenancy"] = registry()
        if engine_kw.get("slo") == "armed":
            engine_kw["slo"] = __import__(slo_config, fromlist=["SLOConfig"]).SLOConfig(
                ttft_p95_ms=1e6, min_samples=1
            )
        engine = build(**engine_kw)
        try:
            outputs = [_drain(engine.submit(p, tenant="t1" if "tenancy" in case else None)) for p in PROMPTS]
            snapshots[name] = (outputs, engine.stats())
        finally:
            engine.close()
    (jax_out, jax_stats), (out, stats) = snapshots["jax"], snapshots["torch"]
    assert out == jax_out
    assert _paths(stats) == _paths(jax_stats)
    assert _counters(stats) == _counters(jax_stats)
    assert stats["speculative"] is False and stats["prefill"]["chunks"] == 0
    if "slo" in case:
        assert stats["slo"]["state"] == jax_stats["slo"]["state"] == "ok"


@pytest.mark.parametrize(
    "export, armed",
    [({"UNIONML_TPU_SLO_TTFT_P95_MS": "0.001", "UNIONML_TPU_SLO_MIN_SAMPLES": "1"}, True),
     ({"UNIONML_TPU_SLO_TBT_P99_MS": "0.001", "UNIONML_TPU_SLO_MIN_SAMPLES": "1",
       "UNIONML_TPU_SLO_FAST_WINDOW_S": "30", "UNIONML_TPU_SLO_SLOW_WINDOW_S": "60"}, True),
     ({"UNIONML_TPU_SLO_TTFT_P95_MS": "soon"}, False),
     ({}, False)],
    ids=["ttft", "tbt-windows", "garbage", "unset"],
)
def test_slo_exports_change_stats_as_in_jax(pair, no_slo_env, monkeypatch, export, armed):
    """The serve CLI's ``UNIONML_TPU_SLO_*`` exports, read at construction:
    an armed target puts an ``slo`` verdict in ``stats()`` (here breached:
    every TTFT/TBT is far over a microsecond), a garbage or missing one
    leaves it out — in both packages alike."""
    for name, value in export.items():
        monkeypatch.setenv(name, value)
    verdicts = {}
    for name, build in (("jax", pair.jax), ("torch", pair.torch)):
        engine = build(slots=2, decode_chunk=4, block_size=8)
        try:
            for p in PROMPTS:
                _drain(engine.submit(p))
            stats = engine.stats()
            verdicts[name] = stats.get("slo")
            assert engine.slo.config == type(engine.slo.config)(**dataclasses.asdict(engine.slo.config))
            verdicts[name + "-config"] = dataclasses.asdict(engine.slo.config)
            verdicts[name + "-health"] = engine.health(max_age_s=0)["state"]
        finally:
            engine.close()
    assert verdicts["torch-config"] == verdicts["jax-config"]
    assert (verdicts["torch"] is not None) == (verdicts["jax"] is not None) == armed
    assert verdicts["torch-health"] == verdicts["jax-health"] == ("breach" if armed else "ok")
    if armed:
        assert verdicts["torch"]["state"] == verdicts["jax"]["state"] == "breach"
        assert set(verdicts["torch"]["objectives"]) == set(verdicts["jax"]["objectives"])


# ------------------------------------------------------------------ admission order


QUEUES = {
    # (tenant, priority, prompt length) in submit order; weights of the registry
    "hostile-burst": ([("evil", 1, 8)] * 6 + [("good", 1, 8)] * 2, {"evil": 1, "good": 1}),
    "weights-2-1": ([("heavy", 1, 8), ("light", 1, 8)] * 12, {"heavy": 2, "light": 1}),
    "zero-weight": ([("burst", 1, 4)] * 3 + [("paid", 1, 4)] * 3, {"burst": 0, "paid": 1}),
    "tiers": ([("a", 2, 4), ("b", 1, 4), ("c", 0, 4), (None, 1, 4), ("a", 0, 9)], {}),
    "mixed-lengths": ([("x", 1, 12), ("y", 1, 3), ("x", 1, 2), ("y", 1, 14), (None, 1, 5), ("y", 1, 1)],
                      {"x": 1, "y": 3}),
    "fifo-no-qos": ([(None, 1, 4)] * 4, None),
}


def _queue(engine, session_cls, entries):
    for i, (tenant, priority, length) in enumerate(entries):
        prompt = [1 + i % 90] * length
        session = session_cls(slot=-1, out=queue.Queue(), max_new=4, tenant=tenant, priority=priority,
                              prompt=list(prompt))
        engine._pending.append((prompt, session))


def _selection_order(engine, n):
    order = []
    with engine._lock:
        for _ in range(n):
            engine._select_pending_locked()
            prompt, session = engine._pending.pop(0)
            order.append((session.tenant, session.priority, prompt[0]))
    return order


@pytest.mark.parametrize("case", list(QUEUES))
def test_drr_admission_order_equals_the_jax_engines(pair, no_slo_env, case):
    entries, weights = QUEUES[case]
    orders = {}
    for name, build, registry, spec, session_cls in (
        ("jax", pair.jax, JaxTenantRegistry, JaxTenantSpec, JaxSession),
        ("torch", pair.torch, TenantRegistry, TenantSpec, _Session),
    ):
        tenancy = None if weights is None else registry({t: spec(weight=w) for t, w in weights.items()})
        engine = build(slots=1, tenancy=tenancy)
        try:
            _queue(engine, session_cls, entries)
            orders[name] = _selection_order(engine, len(entries))
            orders[name + "-deficits"] = dict(engine._drr_deficit)
        finally:
            engine.close()
    assert orders["torch"] == orders["jax"]
    assert orders["torch-deficits"] == orders["jax-deficits"]


# ------------------------------------------------------------------ priority preemption


def _slow_decode(engine, dispatch_s=0.02):
    real = engine.gen._decode

    def slow(*args, _real=real, **kwargs):
        time.sleep(dispatch_s)
        return _real(*args, **kwargs)

    engine.gen._decode = slow


def _preemption_run(build, cfg):
    """Two residents (normal, batch) hold both slots; a high-priority arrival
    preempts the batch one, which resumes. Returns the three streams and the
    engine's counters."""
    engine = build(cfg, slots=2, decode_chunk=2, block_size=16, pool_blocks=24)
    try:
        engine.warmup()
        _slow_decode(engine)
        results = {}

        def consume(name, stream):
            results[name] = _drain(stream)

        threads = [threading.Thread(target=consume, args=(name, engine.submit(prompt, priority=prio)))
                   for name, prompt, prio in (("normal", [3, 1, 4, 1, 5], 1), ("batch", [9, 2, 6, 5], 2))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while engine.occupancy()[0] < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        results["high"] = _drain(engine.submit([7, 7, 1], priority=0))
        for t in threads:
            t.join(timeout=60)
        stats = engine.stats()
        return results, (engine.priority_preemptions, engine.preemptions, stats["tenancy"])
    finally:
        engine.close()


def test_priority_preemption_and_resume_equal_the_jax_engines(pair, no_slo_env):
    cfg = dict(CFG, max_new_tokens=32)
    jax_results, jax_counts = _preemption_run(pair.jax, cfg)
    results, counts = _preemption_run(pair.torch, cfg)
    solo = Generator(pair.model, GenerationConfig(**cfg), device="cpu")
    assert counts == jax_counts == (1, 1, {"shed_tenant_limit": 0, "priority_preemptions": 1})
    assert results == jax_results
    # the preempted (batch) stream resumed token-identically to its solo run
    for name, prompt in (("normal", [3, 1, 4, 1, 5]), ("batch", [9, 2, 6, 5]), ("high", [7, 7, 1])):
        assert results[name] == solo([prompt])[0].tolist(), name


def test_tenant_census_and_health_match(pair, no_slo_env):
    views = {}
    for name, build, session_cls in (("jax", pair.jax, JaxSession), ("torch", pair.torch, _Session)):
        engine = build(slots=1)
        try:
            _queue(engine, session_cls, [("a", 1, 4), ("a", 1, 4), ("b", 1, 4), (None, 1, 4)])
            health = engine.health(max_age_s=0)
            views[name] = (engine.tenant_census(), engine.occupancy(), engine.queued_prefill_tokens(),
                           engine.load(), {k: v for k, v in health.items() if k not in ("rates", "slo")})
            with engine._lock:
                engine._pending.clear()
        finally:
            engine.close()
    assert views["torch"] == views["jax"]
