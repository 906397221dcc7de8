"""The port's ``ContinuousBatcher`` in speculative mode against the JAX
package's engine and sequential plain runs, on tiny f32 Llamas on the CPU
(weights carried across).

Oracle: greedy, f32 — each stream of an engine over a drafted ``Generator``
equals the sequential plain ``Generator`` run (truncated at its eos) and the
JAX speculative engine's stream, dense and paged, also across a preemption
and under grammars. Both port models use ``attention_impl="flash"``, so the
draft's single-token steps go through ``paged_decode_attention`` (its plain
twin on CPU tensors) and the verify through the gather path. Mirrors
``tests/unit/test_continuous.py``'s speculative cases and the constrained
speculative cases of ``tests/unit/test_structured.py``.
"""

import dataclasses
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import ConstraintSet as JaxConstraintSet
from unionml_tpu.models import DraftSpec as JaxDraftSpec
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models import compile_regex as jax_compile_regex
from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from unionml_tpu_torch.models import (
    ConstraintSet,
    DraftSpec,
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    compile_regex,
    llama_params_from_jax,
)
from unionml_tpu_torch.ops import paged_attention as pa
from unionml_tpu_torch.serving import ContinuousBatcher

torch.set_num_threads(2)

PROMPTS = [[3, 14, 15, 92, 6], [27, 1], [8, 2, 8, 1, 8, 2, 8], [44, 9]]
VOCAB = 97
#: the grammar cases' vocabulary: id 0 is EOS (empty text), the rest cycle through 8 letters
EOS = 0
TEXTS = [""] + ["abcdefgh"[i % 8] for i in range(VOCAB - 1)]
GRAMMARS = [r"[a-c]{3,5}", r"[abc]+d"]


def _pair(seed, n_layers, dim):
    shape = dict(vocab_size=VOCAB, dim=dim, n_layers=n_layers, n_heads=4, n_kv_heads=2, hidden_dim=2 * dim)
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **shape))
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, attention_impl="flash", **shape)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module, params, model


@pytest.fixture(scope="module")
def models():
    """The target (2 layers, dim 64) and the JAX engine tests' draft (1 layer, dim 32, PRNGKey 9)."""
    return _pair(0, 2, 64), _pair(9, 1, 32)


def _configs(models, gamma, **kw):
    """(JAX, port) GenerationConfigs with the draft attached, plus the plain port config."""
    (_, _, _), (d_module, d_params, d_model) = models
    base = dict(temperature=0.0, prompt_buckets=(16,), **kw)
    jax_cfg = JaxGenerationConfig(**base, draft=JaxDraftSpec(module=d_module, params=d_params, gamma=gamma))
    port_plain = GenerationConfig(**base)
    return jax_cfg, dataclasses.replace(port_plain, draft=DraftSpec(module=d_model, gamma=gamma)), port_plain


def _sequential(model, cfg, prompts, **call_kw):
    """Per-prompt plain runs, truncated after the first eos (the stream contract)."""
    gen = Generator(model, cfg, device="cpu")
    out = []
    for i, p in enumerate(prompts):
        row = gen([p], **{k: [v[i]] for k, v in call_kw.items()})[0]
        hits = np.nonzero(row == cfg.eos_id)[0] if cfg.eos_id is not None else np.array([])
        out.append(row[: int(hits[0]) + 1].tolist() if hits.size else row.tolist())
    return out


def _drain(stream):
    return [int(t) for chunk in stream for t in np.asarray(chunk).ravel()]


def _concurrent(batcher, prompts, **submit_kw):
    results = [None] * len(prompts)

    def worker(i):
        results[i] = _drain(batcher.submit(prompts[i], **{k: v[i] for k, v in submit_kw.items()}))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return results


@pytest.mark.parametrize("block_size", [None, 8], ids=["dense", "paged"])
def test_speculative_streams_match_sequential_and_jax(models, block_size):
    """Concurrent speculative streams share draft and verify rounds (per-row
    floors), yet each greedy stream equals its sequential plain run and the
    JAX speculative engine's stream."""
    (module, params, model), _ = models
    jax_cfg, cfg, plain = _configs(models, 3, max_new_tokens=10)
    jax_engine = JaxContinuousBatcher(JaxGenerator(module, params, jax_cfg), slots=3, decode_chunk=4,
                                      block_size=block_size)
    try:
        jax_streams = _concurrent(jax_engine, PROMPTS)
    finally:
        jax_engine.close()
    engine = ContinuousBatcher(Generator(model, cfg, device="cpu"), slots=3, decode_chunk=4, block_size=block_size)
    try:
        streams = _concurrent(engine, PROMPTS)
        stats = engine.stats()
    finally:
        engine.close()
    expected = _sequential(model, plain, PROMPTS)
    assert streams == expected and jax_streams == expected
    assert stats["speculative"] is True and engine.decoded_rows > engine.decode_dispatches  # rounds were shared
    assert pa.paged_decode_attention.launches == 0  # CPU tensors take the twin, never the kernel
    if block_size is not None:
        assert stats["kv_blocks"]["used"] == 0


@pytest.mark.parametrize("block_size", [None, 8], ids=["dense", "paged"])
def test_speculative_eos_and_budget(models, block_size):
    """slots=1 forces strict slot reuse (eos exits must free it); a
    per-request budget caps a stream below its eos."""
    (module, params, model), _ = models
    probe = Generator(model, GenerationConfig(max_new_tokens=12, temperature=0.0, prompt_buckets=(16,)),
                      device="cpu")(PROMPTS[:1])
    jax_cfg, cfg, plain = _configs(models, 4, max_new_tokens=12, eos_id=int(probe[0][4]), pad_id=0)
    expected = _sequential(model, plain, PROMPTS[:3])
    jax_engine = JaxContinuousBatcher(JaxGenerator(module, params, jax_cfg), slots=1, decode_chunk=5,
                                      block_size=block_size)
    engine = ContinuousBatcher(Generator(model, cfg, device="cpu"), slots=1, decode_chunk=5, block_size=block_size)
    try:
        for batcher in (jax_engine, engine):
            assert [_drain(batcher.submit(p)) for p in PROMPTS[:3]] == expected
            assert _drain(batcher.submit(PROMPTS[1], max_new_tokens=2)) == expected[1][:2]
    finally:
        jax_engine.close()
        engine.close()


def test_preempted_speculative_stream_resumes_exactly(models):
    """Pool = one worst-case request: residents cannot all finish, so the
    youngest is preempted, re-prefilled in BOTH models as prompt + emitted
    tokens (its out_buf restarts at the new residency), and every stream is
    still its sequential plain run."""
    (_, _, model), _ = models
    _, cfg, plain = _configs(models, 3, max_new_tokens=16)
    gen = Generator(model, cfg, device="cpu")
    min_pool = ContinuousBatcher(gen, slots=3, decode_chunk=2, block_size=8).max_blocks
    engine = ContinuousBatcher(gen, slots=3, decode_chunk=2, block_size=8, pool_blocks=min_pool)
    try:
        assert engine._overshoot == 4  # gamma + 1 verify writes a round
        assert _concurrent(engine, PROMPTS[:3]) == _sequential(model, plain, PROMPTS[:3])
        stats = engine.stats()["kv_blocks"]
        assert stats["preemptions"] > 0 and stats["used"] == 0
    finally:
        engine.close()


@pytest.mark.parametrize("draft", ["unrelated", "target-itself"])
def test_stats_and_acceptance_match_jax_engine(models, draft):
    """One resident stream at a time, so both engines run the same rounds:
    ``stats()["speculative"]`` and ``acceptance_rate`` equal the JAX
    engine's (an unrelated draft near 0, the target as its own draft near 1,
    both summed over rows as JAX sums them), and a warm-up resets the
    telemetry."""
    (module, params, model), _ = models
    jax_cfg, cfg, _ = _configs(models, 3, max_new_tokens=10)
    if draft == "target-itself":  # the same tensors, no copy
        jax_cfg = dataclasses.replace(jax_cfg, draft=JaxDraftSpec(module=module, params=params, gamma=3))
        cfg = dataclasses.replace(cfg, draft=DraftSpec(module=model, gamma=3))
    jax_engine = JaxContinuousBatcher(JaxGenerator(module, params, jax_cfg), slots=2, decode_chunk=4, block_size=8)
    engine = ContinuousBatcher(Generator(model, cfg, device="cpu"), slots=2, decode_chunk=4, block_size=8)
    try:
        snapshots = []
        for batcher in (jax_engine, engine):
            for p in PROMPTS:
                _drain(batcher.submit(p))
            snapshots.append(batcher.stats())
        ref, got = snapshots
        assert got["speculative"] is ref["speculative"] is True
        assert "acceptance_rate" in ref and got["acceptance_rate"] == ref["acceptance_rate"]
        assert got["decode_dispatches"] == ref["decode_dispatches"]
        engine.warmup()
        assert "acceptance_rate" not in engine.stats()
    finally:
        jax_engine.close()
        engine.close()


def test_speculative_engine_refuses_logprobs(models):
    (_, _, model), _ = models
    _, cfg, _ = _configs(models, 3, max_new_tokens=4)
    engine = ContinuousBatcher(Generator(model, cfg, device="cpu"), slots=1)
    try:
        with pytest.raises(ValueError, match="logprobs"):
            engine.submit(PROMPTS[0], logprobs=True)
    finally:
        engine.close()


@pytest.mark.parametrize("name,value", [("admit_chunk", 4), ("prefix", object()), ("role", "decode")])
def test_unported_compositions_name_their_item(models, name, value):
    """Compositions with a draft: ``role=`` is still refused, naming its
    ROADMAP.md Queue A item. ``admit_chunk`` and ``prefix`` are ported: the
    speculative engine streams the JAX engine's tokens, which are the
    sequential plain runs' (of the full prompts, under a prefix); a prefix
    that is no ``PrefixCache`` raises ``TypeError`` in both packages."""
    (module, params, model), _ = models
    jax_cfg, cfg, plain = _configs(models, 3, max_new_tokens=4)
    gen = Generator(model, cfg, device="cpu")
    if name == "role":
        with pytest.raises(NotImplementedError, match="Queue A: parallelism and the replica layer"):
            ContinuousBatcher(gen, slots=1, **{name: value})
        return
    jax_gen = JaxGenerator(module, params, jax_cfg)
    kw, jax_kw, full = {name: value}, {name: value}, PROMPTS
    if name == "prefix":
        for build, g in ((ContinuousBatcher, gen), (JaxContinuousBatcher, jax_gen)):
            with pytest.raises(TypeError, match="PrefixCache"):
                build(g, slots=1, prefix=value)
        system = [5, 7, 9, 11, 13]
        kw, jax_kw = {"prefix": gen.cache_prefix(system)}, {"prefix": jax_gen.cache_prefix(system)}
        full = [system + p for p in PROMPTS]
    jax_engine = JaxContinuousBatcher(jax_gen, slots=2, decode_chunk=3, block_size=8, **jax_kw)
    try:
        jax_streams = [_drain(jax_engine.submit(p)) for p in PROMPTS]
    finally:
        jax_engine.close()
    engine = ContinuousBatcher(gen, slots=2, decode_chunk=3, block_size=8, **kw)
    try:
        streams = [_drain(engine.submit(p)) for p in PROMPTS]
        assert engine.stats()["prefill"] == jax_engine.stats()["prefill"]
    finally:
        engine.close()
    assert streams == jax_streams == _sequential(model, plain, full)


# ------------------------------------------------------------------ under grammars


@pytest.fixture(scope="module")
def grammars():
    return (ConstraintSet([compile_regex(g, TEXTS, eos_id=EOS) for g in GRAMMARS]),
            JaxConstraintSet([jax_compile_regex(g, TEXTS, eos_id=EOS) for g in GRAMMARS]))


def test_speculative_constrained_greedy_equals_target_only(models, grammars):
    """The composition oracle: greedy speculative decoding under a grammar
    equals the constrained plain Generator (port and JAX), rows on different
    grammars side by side."""
    (module, params, model), (_, _, d_model) = models
    cs, jax_cs = grammars
    kw = dict(max_new_tokens=10, temperature=0.0, eos_id=EOS, prompt_buckets=(8,))
    plain = Generator(model, GenerationConfig(**kw, constraints=cs), device="cpu")
    spec = Generator(model, GenerationConfig(**kw, constraints=cs, draft=DraftSpec(module=d_model, gamma=3)),
                     device="cpu")
    jax_plain = JaxGenerator(module, params, JaxGenerationConfig(**kw, constraints=jax_cs))
    prompts = [[3, 14, 15], [7, 7, 9]]
    for gids in ([1, 2], [2, 1], [0, 1]):
        expected = np.asarray(jax_plain(prompts, constraint=gids))
        np.testing.assert_array_equal(spec(prompts, constraint=gids), expected)
        np.testing.assert_array_equal(plain(prompts, constraint=gids), expected)
    # stream threads constraint= too: ragged chunks concatenate to __call__'s tokens
    ref = spec(prompts, constraint=[1, 2])
    rows = [[] for _ in prompts]
    for chunk in spec.stream(prompts, chunk_size=3, constraint=[1, 2]):
        for i, arr in enumerate(chunk):
            rows[i].extend(int(t) for t in arr)
    for i, got in enumerate(rows):
        assert got == ref[i, : len(got)].tolist() and all(int(t) == 0 for t in ref[i, len(got):])


def test_speculative_constrained_sampled_satisfies_grammar(models, grammars):
    (_, _, model), (_, _, d_model) = models
    cs, _ = grammars
    spec = Generator(model, GenerationConfig(max_new_tokens=12, temperature=1.0, eos_id=EOS, prompt_buckets=(8,),
                                             constraints=cs, draft=DraftSpec(module=d_model, gamma=3)), device="cpu")
    for seed in range(3):
        text = "".join(TEXTS[t] for t in spec([[2, 3]], seed=seed, constraint=1)[0])
        assert re.fullmatch(r"[a-c]{3,5}", text) or (len(text) < 3 and set(text) <= set("abc")), (seed, text)


@pytest.mark.parametrize("block_size", [None, 8], ids=["dense", "paged"])
def test_speculative_constrained_engine_streams(models, grammars, block_size):
    """Grammar-constrained speculative streams through the engine (the DFA
    state rides the speculative carry's tail) equal the constrained plain
    sequential runs."""
    (_, _, model), (_, _, d_model) = models
    cs, _ = grammars
    kw = dict(max_new_tokens=10, temperature=0.0, eos_id=EOS, prompt_buckets=(16,), constraints=cs)
    gids = [1, 2, 0, 2]
    expected = _sequential(model, GenerationConfig(**kw), PROMPTS, constraint=gids)
    engine = ContinuousBatcher(
        Generator(model, GenerationConfig(**kw, draft=DraftSpec(module=d_model, gamma=3)), device="cpu"),
        slots=3, decode_chunk=4, block_size=block_size,
    )
    try:
        assert _concurrent(engine, PROMPTS, constraint=gids) == expected
    finally:
        engine.close()
