"""Chunked admission and the static shared prefix of the port's engine,
held against the JAX package on the CPU.

The chunked and prefix cases of ``tests/unit/test_continuous.py`` run here
against the port (see ``test_torch_serving_units.py``), their fixtures port
builds of the same shapes. Then converted weights and the same prompts go
through both engines under every admission option: greedy streams equal,
and ``stats()["prefill"]``, ``["prefix_cache"]`` and ``["kv_blocks"]``
equal, as are ``cache_len``, ``max_blocks`` and ``pool_blocks``. Tiny f32
models; tolerance 0 on tokens and counters.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_continuous import _models
from tests.test_torch_serving_units import generator, port_cases, tiny_llama

torch.set_num_threads(2)

#: the prefix and chunked-admission cases of the unit file (line numbers of
#: their definitions there: 234, 253, 419, 559, 587, 617, 651-880)
CASES = (
    "test_shared_prefix_across_slots",
    "test_prefix_with_oversized_prefill_chunk",
    "test_paged_kv_with_prefix_and_int8",
    "test_paged_shared_prefix_pages",
    "test_paged_speculative_with_prefix_all_compositions",
    "test_speculative_continuous_with_shared_prefix",
    "test_chunked_admission_streams_match_sequential",
    "test_chunked_admission_interleaves_decode_with_prefill",
    "test_prefill_budget_groups_chunks_per_iteration",
    "test_cancel_mid_chunked_prefill_frees_slot",
    "test_deadline_shed_mid_chunked_prefill",
    "test_chunked_admission_with_shared_prefix_and_speculative",
    "test_chunked_admission_paged_preemption_resume",
)

port_cases(globals(), "test_continuous.py")
for _name in [n for n in globals() if n.startswith("test_") and n not in CASES]:
    # the rest of the file runs against the port in test_torch_continuous.py
    del globals()[_name]
Generator = generator  # noqa: F811


@pytest.fixture(scope="module")
def tiny_gen():
    return tiny_llama(97, seed=0), None


def _draft_for(vocab):  # noqa: F811
    from unionml_tpu_torch.models import Llama, LlamaConfig

    config = LlamaConfig.tiny(vocab_size=vocab, dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64,
                              dtype=torch.float32, param_dtype=torch.float32)
    return Llama(config, device="cpu", seed=9), None


# ----------------------------------------------------------------- both packages


@pytest.fixture(scope="module")
def pair():
    return _models(dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128))


@pytest.fixture(scope="module")
def draft_pair():
    return _models(dict(vocab_size=97, dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64), seed=9)


SYSTEM = [11, 12, 13, 4, 5, 6, 7, 8, 9, 10, 21]  # one full block of 8 and a 3-token tail
#: prompts sharing runs (one a repeat, one diverging inside a block) and a short one
PROMPTS_MIX = [list(range(1, 21)) + [70], list(range(1, 21)) + [71, 72], [5, 6, 7],
               list(range(1, 15)) + [90, 91], list(range(1, 21)) + [70]]
#: (engine kwargs, GenerationConfig extras, uses the static prefix, uses the draft)
ENGINE_CASES = {
    "chunked-dense": (dict(admit_chunk=4), {}, False, False),
    "chunked-budget-paged": (dict(admit_chunk=4, prefill_budget=8, max_admissions=2, block_size=8), {}, False, False),
    "chunked-int8-kv-paged": (dict(admit_chunk=8, block_size=8), dict(kv_cache_dtype="int8"), False, False),
    "prefix-dense": ({}, {}, True, False),
    "prefix-chunked-int8-kv-dense": (dict(admit_chunk=4), dict(kv_cache_dtype="int8"), True, False),
    "prefix-chunked-paged": (dict(admit_chunk=4, block_size=8), {}, True, False),
    "prefix-int8-kv-paged": (dict(block_size=8), dict(kv_cache_dtype="int8"), True, False),
    "radix-paged": (dict(block_size=8, prefix_cache=True), {}, False, False),
    "radix-prefix-chunked": (dict(block_size=8, prefix_cache=True, admit_chunk=8, prefill_budget=16), {}, True, False),
    "radix-int8-kv": (dict(block_size=8, prefix_cache=True), dict(kv_cache_dtype="int8"), False, False),
    "draft-chunked-dense": (dict(admit_chunk=4), {}, False, True),
    "draft-prefix-chunked-paged": (dict(admit_chunk=4, block_size=8), {}, True, True),
}


def _engine_run(package, pair, draft_pair, case):
    """One engine of ``package`` ("jax" or "port") over ``PROMPTS_MIX``
    submitted one after another: its streams, its geometry and its stats."""
    from unionml_tpu import models as jax_models
    from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
    from unionml_tpu_torch import models as port
    from unionml_tpu_torch.serving import ContinuousBatcher

    kwargs, extras, with_prefix, with_draft = ENGINE_CASES[case]
    kw = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16, 32), **extras)
    module, params, model, _ = pair
    if package == "jax":
        if with_draft:
            kw["draft"] = jax_models.DraftSpec(module=draft_pair[0], params=draft_pair[1], gamma=3)
        gen = jax_models.Generator(module, params, jax_models.GenerationConfig(**kw))
        build = JaxContinuousBatcher
    else:
        if with_draft:
            kw["draft"] = port.DraftSpec(module=draft_pair[2], gamma=3)
        gen = port.Generator(model, port.GenerationConfig(**kw), device="cpu")
        build = ContinuousBatcher
    prefix = gen.cache_prefix(SYSTEM) if with_prefix else None
    engine = build(gen, slots=2, decode_chunk=3, prefix=prefix, **kwargs)
    try:
        streams = [[int(t) for chunk in engine.submit(p) for t in np.asarray(chunk).ravel()] for p in PROMPTS_MIX]
        stats = engine.stats()
        geometry = (engine.cache_len, getattr(engine, "max_blocks", None), getattr(engine, "pool_blocks", None))
        cached = [engine.cached_prefix_tokens(p) for p in PROMPTS_MIX]
    finally:
        engine.close()
    return streams, geometry, cached, {k: stats.get(k) for k in ("prefill", "prefix_cache", "kv_blocks")}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_and_counters_equal_jax(pair, draft_pair, no_admission_env, case):
    """Converted weights, the same prompts, the same knobs: the port's
    engine streams the JAX engine's greedy tokens, with the same geometry,
    ``cached_prefix_tokens`` and prefill / prefix-cache / pool counters."""
    jax_run = _engine_run("jax", pair, draft_pair, case)
    port_run = _engine_run("port", pair, draft_pair, case)
    assert port_run[0] == jax_run[0]
    assert port_run[1:] == jax_run[1:]
    if "chunked" in case:
        assert port_run[3]["prefill"]["chunks"] > 0
    if "radix" in case:
        assert port_run[3]["prefix_cache"]["hits"] > 0


@pytest.fixture
def no_admission_env(monkeypatch):
    for name in ("UNIONML_TPU_ADMIT_CHUNK", "UNIONML_TPU_PREFILL_BUDGET", "UNIONML_TPU_MAX_ADMISSIONS",
                 "UNIONML_TPU_PREFIX_CACHE"):
        monkeypatch.delenv(name, raising=False)
