"""The port's ``ContinuousBatcher`` against the JAX package's engine and solo
runs, on a tiny f32 Llama on the CPU.

Oracle: greedy, f32 — each concurrent stream's tokens equal a solo
``Generator`` run and the JAX engine's stream, token for token. The port's
model uses ``attention_impl="flash"``, so every paged decode step goes through
``paged_decode_attention`` (its plain twin on CPU tensors); the JAX side reads
its pool through the gather path (``"auto"``), as its Pallas kernel has no CPU
mode. Mirrors ``tests/unit/test_continuous.py``'s paged-pool cases. Over an
int8 ``Generator`` the plain route matches the JAX engine's int8 streams, and
the kernel route (int8 matmul and paged decode twins) matches a solo run on
the same route.
"""

import dataclasses
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from unionml_tpu_torch.models import GenerationConfig, Generator, Llama, LlamaConfig, llama_params_from_jax
from unionml_tpu_torch.ops import paged_attention as pa
from unionml_tpu_torch.serving import ContinuousBatcher

torch.set_num_threads(2)

SHAPE = dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
#: wide enough that quantize="int8" (min_size 65536) takes q/o, the MLP and the head
INT8_SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512)
PROMPTS = [[3, 14, 15, 92, 6], [27, 1], [8, 2, 8, 1, 8, 2, 8], [44, 9]]


def _models(shape):
    jax_cfg = JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **shape)
    module = JaxLlama(jax_cfg)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, attention_impl="flash", **shape)
    state = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    flash, plain = Llama(cfg, device="cpu"), Llama(dataclasses.replace(cfg, attention_impl="auto"), device="cpu")
    flash.load_state_dict(state)
    plain.load_state_dict(state)
    return module, params, flash, plain


@pytest.fixture(scope="module")
def models():
    return _models(SHAPE)


@pytest.fixture(scope="module")
def int8_models():
    """Float port models that the first ``Generator(quantize="int8")`` over
    each quantizes in place."""
    return _models(INT8_SHAPE)


def _solo(model, cfg, prompts):
    gen = Generator(model, cfg, device="cpu")
    return [gen([p])[0].tolist() for p in prompts]


def _concurrent(batcher, prompts, **submit_kw):
    results = [None] * len(prompts)

    def worker(i):
        results[i] = [int(t) for chunk in batcher.submit(prompts[i], **submit_kw) for t in np.asarray(chunk).ravel()]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    return results


def test_paged_flash_streams_match_jax_engine_and_solo(models):
    module, params, flash, plain = models
    kw = dict(max_new_tokens=12, temperature=0.0, prompt_buckets=(16,))
    jax_engine = JaxContinuousBatcher(
        JaxGenerator(module, params, JaxGenerationConfig(**kw)), slots=4, decode_chunk=4, block_size=8
    )
    try:
        jax_streams = _concurrent(jax_engine, PROMPTS)
    finally:
        jax_engine.close()
    engine = ContinuousBatcher(Generator(flash, GenerationConfig(**kw), device="cpu"), slots=4, decode_chunk=4, block_size=8)
    try:
        streams = _concurrent(engine, PROMPTS)
        stats = engine.stats()
    finally:
        engine.close()
    assert streams == jax_streams
    assert streams == _solo(plain, GenerationConfig(**kw), PROMPTS)
    assert stats["decoded_rows"] > stats["decode_dispatches"]  # dispatches were shared
    assert stats["kv_blocks"]["used"] == 0
    assert pa.paged_decode_attention.launches == 0  # CPU tensors take the twin, never the kernel


def test_dense_slots_under_contention_match_solo(models):
    """More requests than slots on the dense (non-paged) engine: the overflow
    waits for a free slot and still decodes exactly."""
    _, _, flash, plain = models
    cfg = GenerationConfig(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
    engine = ContinuousBatcher(Generator(flash, cfg, device="cpu"), slots=2, decode_chunk=3)
    try:
        assert _concurrent(engine, PROMPTS) == _solo(plain, cfg, PROMPTS)
    finally:
        engine.close()


def test_undersized_pool_with_lazy_growth(models):
    """Requests with small budgets get only the blocks they need, so a pool
    far smaller than slots x worst-case admits a full house at once."""
    _, _, flash, plain = models
    cfg = GenerationConfig(max_new_tokens=12, temperature=0.0, prompt_buckets=(16,))
    expected = _solo(plain, cfg, PROMPTS)
    engine = ContinuousBatcher(
        Generator(flash, cfg, device="cpu"), slots=4, decode_chunk=4, block_size=8, pool_blocks=10
    )
    try:
        assert engine.pool_blocks < engine.slots * engine.max_blocks
        assert 4 * engine._blocks_lifetime(PROMPTS[0], 4) <= engine.pool_blocks
        assert _concurrent(engine, PROMPTS, max_new_tokens=4) == [e[:4] for e in expected]
        stats = engine.stats()
        assert stats["decoded_rows"] > stats["decode_dispatches"]
        assert {k: stats["kv_blocks"][k] for k in ("total", "used", "block_size", "preemptions")} == {
            "total": 10, "used": 0, "block_size": 8, "preemptions": 0,
        }
    finally:
        engine.close()


def test_preemption_resumes_token_exact(models):
    """Pool = one worst-case request: two long-budget residents cannot both
    finish, so the youngest is preempted, requeued as prompt + emitted tokens
    and re-prefilled — and its stream is still exactly its solo run."""
    _, _, flash, plain = models
    cfg = GenerationConfig(max_new_tokens=16, temperature=0.0, prompt_buckets=(16,))
    gen = Generator(flash, cfg, device="cpu")
    min_pool = ContinuousBatcher(gen, slots=3, decode_chunk=2, block_size=8).max_blocks
    engine = ContinuousBatcher(gen, slots=3, decode_chunk=2, block_size=8, pool_blocks=min_pool)
    try:
        assert _concurrent(engine, PROMPTS[:3]) == _solo(plain, cfg, PROMPTS[:3])
        stats = engine.stats()["kv_blocks"]
        assert stats["preemptions"] > 0 and stats["used"] == 0
    finally:
        engine.close()


def test_oversized_prompt_fails_its_stream_only(models):
    _, _, flash, plain = models
    cfg = GenerationConfig(max_new_tokens=6, temperature=0.0, prompt_buckets=(16,))
    engine = ContinuousBatcher(Generator(flash, cfg, device="cpu"), slots=2, decode_chunk=3, block_size=8)
    try:
        doomed = engine.submit(list(range(1, 40)))  # buckets to 64 > cache_len
        ok = engine.submit(PROMPTS[0])
        with pytest.raises(ValueError, match="blocks"):
            list(doomed)
        assert [int(t) for c in ok for t in c] == _solo(plain, cfg, PROMPTS[:1])[0]
    finally:
        engine.close()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16-layout-pages", "int8-pages"])
def test_int8_generator_streams_match_jax_engine_and_solo(int8_models, kv):
    module, params, flash, plain = int8_models
    kw = dict(max_new_tokens=10, temperature=0.0, prompt_buckets=(16,), kv_cache_dtype=kv)
    jax_engine = JaxContinuousBatcher(
        JaxGenerator(module, params, JaxGenerationConfig(**kw), quantize="int8"), slots=4, decode_chunk=4, block_size=8
    )
    try:
        jax_streams = _concurrent(jax_engine, PROMPTS)
    finally:
        jax_engine.close()
    cfg = GenerationConfig(**kw)
    for model in (plain, flash):
        engine = ContinuousBatcher(Generator(model, cfg, device="cpu", quantize="int8"), slots=4, decode_chunk=4,
                                   block_size=8)
        try:
            streams = _concurrent(engine, PROMPTS)
        finally:
            engine.close()
        solo = _solo(model, cfg, PROMPTS)  # the model is int8 now
        assert streams == solo
        if model is plain:  # the JAX package's numerics
            assert streams == jax_streams
    assert pa.paged_decode_attention.launches == 0


def test_chunked_admission_is_not_ported(models):
    _, _, flash, _ = models
    gen = Generator(flash, GenerationConfig(prompt_buckets=(16,), prefill_chunk=8), device="cpu")
    with pytest.raises(NotImplementedError, match="prefill_chunk"):
        ContinuousBatcher(gen)


@pytest.mark.parametrize("option", ["admit_chunk", "prefix_cache", "tenancy"])
def test_unported_engine_options_raise(models, option):
    _, _, flash, _ = models
    gen = Generator(flash, GenerationConfig(prompt_buckets=(16,)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatcher(gen, **{option: 8 if option == "admit_chunk" else True})


ADMISSION_ENV = ("UNIONML_TPU_ADMIT_CHUNK", "UNIONML_TPU_PREFILL_BUDGET", "UNIONML_TPU_MAX_ADMISSIONS",
                 "UNIONML_TPU_PREFIX_CACHE")
#: (env, engine kwargs, None when the port serves it, else what its NotImplementedError names)
ENV_CASES = {
    "zeros": ({"UNIONML_TPU_ADMIT_CHUNK": "0", "UNIONML_TPU_PREFILL_BUDGET": "0", "UNIONML_TPU_MAX_ADMISSIONS": "1",
               "UNIONML_TPU_PREFIX_CACHE": "0"}, {}, None),
    "garbage": ({"UNIONML_TPU_ADMIT_CHUNK": "abc", "UNIONML_TPU_MAX_ADMISSIONS": "-3"}, {}, None),
    "kwarg-wins": ({"UNIONML_TPU_ADMIT_CHUNK": "256", "UNIONML_TPU_MAX_ADMISSIONS": "4"},
                   {"admit_chunk": 0, "max_admissions": 1}, None),
    "prefix-cache-dense": ({"UNIONML_TPU_PREFIX_CACHE": "1"}, {}, None),
    "admit-chunk": ({"UNIONML_TPU_ADMIT_CHUNK": "256"}, {}, "UNIONML_TPU_ADMIT_CHUNK=256"),
    "prefill-budget": ({"UNIONML_TPU_PREFILL_BUDGET": "512"}, {}, "UNIONML_TPU_PREFILL_BUDGET=512"),
    "max-admissions": ({"UNIONML_TPU_MAX_ADMISSIONS": "2"}, {}, "UNIONML_TPU_MAX_ADMISSIONS=2"),
    "prefix-cache-paged": ({"UNIONML_TPU_PREFIX_CACHE": "1"}, {"block_size": 8}, "UNIONML_TPU_PREFIX_CACHE"),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_serve_env_knobs_resolve_as_in_jax(models, monkeypatch, caplog, case):
    """The serve CLI's four admission exports reach an engine built without
    the kwargs, as in the JAX package: where the JAX engine resolves them to
    monolithic admission without a radix cache, the port's resolves the same
    values (and warns where it warns: garbage values, the prefix cache on a
    dense engine); where the JAX engine would chunk its admissions or cache
    prefixes, the port raises NotImplementedError naming the variable rather
    than serving another schedule. Explicit kwargs win over the env."""
    env, kwargs, refused = ENV_CASES[case]
    for name in ADMISSION_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    module, params, flash, _ = models
    kw = dict(max_new_tokens=4, temperature=0.0, prompt_buckets=(16,))
    jax_logger = logging.getLogger("unionml_tpu")  # it does not propagate to the root logger
    monkeypatch.setattr(jax_logger, "handlers", [*jax_logger.handlers, caplog.handler])
    with caplog.at_level("WARNING"):
        jax_engine = JaxContinuousBatcher(
            JaxGenerator(module, params, JaxGenerationConfig(**kw)), slots=2, decode_chunk=4, **kwargs
        )
    try:
        resolved = (jax_engine.admit_chunk, jax_engine.prefill_budget, jax_engine.max_admissions,
                    jax_engine._radix is not None)
    finally:
        jax_engine.close()
    jax_warnings = caplog.text
    caplog.clear()
    gen = Generator(flash, GenerationConfig(**kw), device="cpu")
    if refused:
        assert resolved != (None, None, 1, False)  # the JAX engine takes a path the port does not have
        with pytest.raises(NotImplementedError, match=refused):
            ContinuousBatcher(gen, slots=2, decode_chunk=4, **kwargs)
        return
    with caplog.at_level("WARNING"):
        engine = ContinuousBatcher(gen, slots=2, decode_chunk=4, **kwargs)
    engine.close()
    assert (engine.admit_chunk, engine.prefill_budget, engine.max_admissions, False) == resolved
    assert resolved == (None, None, 1, False)
    for name in env:
        assert (name in caplog.text) == (name in jax_warnings), name


REPLICA_ENV = ("UNIONML_TPU_DP_REPLICAS", "UNIONML_TPU_REPLICA_ROLES")
#: (env, engine kwargs, how many replicas the JAX engine's constructor would
#: build); the port refuses a fleet, and refuses roles= whatever it names
REPLICA_CASES = {
    "dp-2": ({"UNIONML_TPU_DP_REPLICAS": "2"}, {}, 2),
    "dp-garbage": ({"UNIONML_TPU_DP_REPLICAS": "abc"}, {}, 1),
    "dp-1": ({"UNIONML_TPU_DP_REPLICAS": "1"}, {}, 1),
    "roles": ({"UNIONML_TPU_REPLICA_ROLES": "prefill=1,decode=3"}, {}, 4),
    "roles-garbage": ({"UNIONML_TPU_REPLICA_ROLES": "prefill=x"}, {}, 1),
    "roles-one": ({"UNIONML_TPU_REPLICA_ROLES": "mixed=1"}, {}, 1),
    "roles-kwarg": ({}, {"roles": {"prefill": 1, "decode": 1}}, 2),
    "roles-kwarg-one": ({}, {"roles": {"prefill": 1}}, 1),
    "unset": ({}, {}, 1),
}


@pytest.mark.parametrize("case", list(REPLICA_CASES))
def test_replica_exports_resolve_as_in_jax_and_refuse_a_fleet(models, monkeypatch, caplog, case):
    """The serve CLI's ``--dp-replicas`` and ``--replica-roles`` exports read
    as the JAX package reads them (values, and a warning where it warns on
    garbage); where the JAX engine's constructor would build more than one
    replica, the port's raises NotImplementedError rather than build one
    engine."""
    from unionml_tpu import defaults as jax_defaults
    from unionml_tpu_torch import defaults

    env, kwargs, replicas = REPLICA_CASES[case]
    for name in REPLICA_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jax_logger = logging.getLogger("unionml_tpu")  # it does not propagate to the root logger
    monkeypatch.setattr(jax_logger, "handlers", [*jax_logger.handlers, caplog.handler])
    with caplog.at_level("WARNING"):
        jax_read = (jax_defaults.serve_dp_replicas(), jax_defaults.serve_replica_roles())
    jax_warnings = caplog.text
    caplog.clear()
    with caplog.at_level("WARNING"):
        read = (defaults.serve_dp_replicas(), defaults.serve_replica_roles())
    assert read == jax_read
    for name in env:
        assert (name in caplog.text) == (name in jax_warnings), name
    roles = kwargs.get("roles") or read[1]
    assert max(read[0], sum(roles.values()), 1) == replicas
    gen = Generator(models[2], GenerationConfig(max_new_tokens=4, prompt_buckets=(16,)), device="cpu")
    if replicas > 1 or "roles" in kwargs:
        with pytest.raises(NotImplementedError, match="Queue A: parallelism and the replica layer"):
            ContinuousBatcher(gen, slots=2, decode_chunk=4, **kwargs)
        return
    ContinuousBatcher(gen, slots=2, decode_chunk=4, **kwargs).close()
