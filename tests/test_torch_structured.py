"""Structured (grammar-constrained) decoding and per-token logprobs in the
port, held against the JAX package on tiny f32 models on the CPU.

- Compiler: ``unionml_tpu_torch.models.structured`` is a copy of the JAX
  package's host compiler; its ``trans``/``allowed`` tables equal the
  original's array for array, and malformed or unrealizable grammars raise
  the same ``ValueError``.
- Decoding: greedy f32 tokens under mixed per-row grammars equal the JAX
  ``Generator``'s (plain route, ``prefill_chunk``, ``quantize="int8"``), and
  the FREE grammar equals the unconstrained port. Sampled decoding is held on
  the distribution: the first step's ``policy_probs`` of the constrained
  logits within 1e-5 absolute, and every sampled token allowed. ``_decode``'s
  logprobs within 1e-5 absolute of the JAX ``decode_steps``'.
- Serving: constrained ``ContinuousBatcher`` streams with ``logprobs=True``
  (dense and paged) equal the JAX engine's, token for token with logprobs
  within 1e-5; a preempted constrained stream resumes token-exact;
  ``warmup()`` leaves the counters at 0 and the streams unchanged.

On the card the file runs without JAX installed (``python -m pytest
--noconftest -m cuda tests/test_torch_structured.py``), so it imports JAX only
where a CPU parity test needs it.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from unionml_tpu_torch import models as port
from unionml_tpu_torch.models import (
    ConstraintSet,
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    compile_regex,
    llama_params_from_jax,
    policy_probs,
)
from unionml_tpu_torch.serving import ContinuousBatcher

torch.set_num_threads(2)

SHAPE = dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
#: wide enough that quantize="int8" (min_size 65536) takes q/o, the MLP and the head
INT8_SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512)
PROMPTS = [[3, 14, 15, 92, 6], [27, 1], [8, 2, 8, 1, 8, 2, 8], [44, 9]]
#: per-row grammars: every user grammar and the FREE one in one batch
GIDS = [1, 0, 2, 3]
EOS = 96
#: user grammars 1-3: a short word, a number, and alternating letters and
#: digits that cannot reach EOS within the budgets below (one character a
#: token) and whose allowed set depends on the position: a resume that
#: restarted the DFA would show
GRAMMARS = (r"[a-c]{3,5}", r"-?[0-9]+(\.[0-9]+)?", r"([a-z][0-9]){10,20}")
LP_ATOL = 1e-5


def _texts(size: int):
    """Token id -> text: ids 1-26 a-z, 27-36 digits, three multi-char pieces;
    the rest (pad 0 and EOS 96 among them) decode empty."""
    texts = [""] * size
    for i in range(26):
        texts[1 + i] = chr(ord("a") + i)
    for i in range(10):
        texts[27 + i] = str(i)
    texts[40], texts[41], texts[42] = "ab", "12", "3.5"
    return texts


def _jax():
    import jax
    import jax.numpy as jnp

    from unionml_tpu import models as jax_models
    from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher

    return jax, jnp, jax_models, JaxContinuousBatcher


def _pair(shape):
    jax, jnp, jm, _ = _jax()
    module = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **shape))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, attention_impl="flash", **shape)
    state = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    flash, plain = Llama(cfg, device="cpu"), Llama(dataclasses.replace(cfg, attention_impl="auto"), device="cpu")
    flash.load_state_dict(state)
    plain.load_state_dict(state)
    texts = _texts(shape["vocab_size"])
    cs = ConstraintSet([compile_regex(p, texts, eos_id=EOS) for p in GRAMMARS])
    jax_cs = jm.ConstraintSet([jm.compile_regex(p, texts, eos_id=EOS) for p in GRAMMARS])
    return dict(module=module, params=params, flash=flash, plain=plain, cs=cs, jax_cs=jax_cs)


@pytest.fixture(scope="module")
def tiny():
    return _pair(SHAPE)


@pytest.fixture(scope="module")
def tiny_int8():
    """Float port models that the first ``Generator(quantize="int8")`` over
    each quantizes in place."""
    return _pair(INT8_SHAPE)


def _configs(m, **kw):
    _, _, jm, _ = _jax()
    kw = dict(dict(max_new_tokens=12, temperature=0.0, prompt_buckets=(16,), eos_id=EOS), **kw)
    return GenerationConfig(constraints=m["cs"], **kw), jm.GenerationConfig(constraints=m["jax_cs"], **kw)


def _grammar_ok(cs, gid, row) -> bool:
    """Walk ``row`` through the set's DFA on the host: every token up to the
    first EOS is allowed in its state."""
    state = int(cs.starts[gid])
    for t in row:
        if not cs.allowed[state, t]:
            return False
        if t == EOS:
            return True
        state = int(cs.trans[state, t])
    return True


# ---------------------------------------------------------------------- compiler

#: printable ASCII, single characters, plus multi-character pieces; id 0 (empty) is EOS
COMPILER_VOCAB = [""] + [chr(c) for c in range(32, 127)] + ["\n", "\t", "ab", "12", "yes", "no", " the", '{"', '":']


def _build(mod, kind, arg):
    if kind == "regex":
        return mod.compile_regex(arg, COMPILER_VOCAB, eos_id=0)
    return getattr(mod, kind)(arg, COMPILER_VOCAB, eos_id=0)


COMPILER_CASES = {
    "template-word": ("regex", r"[a-z]+"),
    "template-sentence": ("regex", r"[a-z][a-z ]*[.!]"),
    "bounded-quantifier": ("regex", r"a{2,3}b{,2}c{2}"),
    "classes-escapes": ("regex", r"\w+\s?\d*[^a-z]\.\\"),
    "alternation": ("regex", r"(ab|b)*c{1,2}|yes|no"),
    "anchors": ("regex", r"^[ab]+$"),
    "literal-brace": ("regex", r"a{-2}"),
    "literal_choice": ("literal_choice", ["yes", "no", "maybe"]),
    "json_object": ("json_object", {"name": "string", "age": "integer", "ok": "boolean"}),
    "stop_sequences": ("stop_sequences", ["ab", "\n\n", "12"]),
}


@pytest.mark.parametrize("case", list(COMPILER_CASES))
def test_compiler_tables_equal_jax(case):
    _, _, jm, _ = _jax()
    kind, arg = COMPILER_CASES[case]
    ours, ref = _build(port, kind, arg), _build(jm, kind, arg)
    assert ours.trans.dtype == ref.trans.dtype == np.int32 and ours.allowed.dtype == ref.allowed.dtype == bool
    assert np.array_equal(ours.trans, ref.trans)
    assert np.array_equal(ours.allowed, ref.allowed)
    assert ours.eos_id == ref.eos_id and ours.n_states == ref.n_states


def test_constraint_set_equals_jax_and_memoizes_device_tables():
    _, _, jm, _ = _jax()
    cases = [COMPILER_CASES[c] for c in ("template-word", "template-sentence", "literal_choice", "json_object")]
    cs = ConstraintSet([_build(port, *c) for c in cases])
    ref = jm.ConstraintSet([_build(jm, *c) for c in cases])
    for name in ("trans", "allowed", "starts"):
        assert np.array_equal(getattr(cs, name), getattr(ref, name)), name
    assert (cs.n_grammars, cs.vocab_size, cs.eos_id) == (ref.n_grammars, ref.vocab_size, ref.eos_id)
    assert np.array_equal(cs.start_states([0, 4, 2]), ref.start_states([0, 4, 2]))
    trans, allowed = cs.device_tables("cpu")
    assert cs.device_tables(torch.device("cpu"))[0] is trans  # one copy per set and device
    assert trans.dtype == torch.int32 and allowed.dtype == torch.bool
    assert np.array_equal(trans.numpy(), cs.trans) and np.array_equal(allowed.numpy(), cs.allowed)


ERROR_CASES = {
    "dangling-escape": lambda m: m.compile_regex("[\\", COMPILER_VOCAB, eos_id=0),
    "bad-bounds": lambda m: m.compile_regex("a{3,2}", COMPILER_VOCAB, eos_id=0),
    "mid-anchor": lambda m: m.compile_regex("a^b", COMPILER_VOCAB, eos_id=0),
    "unbalanced": lambda m: m.compile_regex("(ab", COMPILER_VOCAB, eos_id=0),
    "bad-range": lambda m: m.compile_regex("[z-a]", COMPILER_VOCAB, eos_id=0),
    "unrealizable": lambda m: m.compile_regex("[0-9]+", ["", "a", "b"], eos_id=0),
    "eos-outside-vocab": lambda m: m.compile_regex("a", ["", "a"], eos_id=2),
    "empty-choice": lambda m: m.literal_choice([], COMPILER_VOCAB, eos_id=0),
    "json-typo": lambda m: m.json_object({"ok": "bool"}, COMPILER_VOCAB, eos_id=0),
    "empty-stop": lambda m: m.stop_sequences([""], COMPILER_VOCAB, eos_id=0),
    "mixed-vocab-set": lambda m: m.ConstraintSet(
        [m.compile_regex("a", ["", "a"], eos_id=0), m.compile_regex("a", ["", "a", "b"], eos_id=0)]),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_malformed_grammars_raise_as_in_jax(case):
    _, _, jm, _ = _jax()
    with pytest.raises(ValueError) as ref:
        ERROR_CASES[case](jm)
    with pytest.raises(ValueError) as ours:
        ERROR_CASES[case](port)
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------- Generator


@pytest.mark.parametrize("case", ["plain", "prefill-chunk", "int8"])
def test_greedy_constrained_tokens_match_jax(tiny, tiny_int8, case):
    m = tiny_int8 if case == "int8" else tiny
    kw = dict(prefill_chunk=4) if case == "prefill-chunk" else {}
    cfg, jax_cfg = _configs(m, **kw)
    quantize = "int8" if case == "int8" else None
    _, _, jm, _ = _jax()
    ref = np.asarray(jm.Generator(m["module"], m["params"], jax_cfg, quantize=quantize)(PROMPTS, constraint=GIDS))
    gen = Generator(m["plain"], cfg, device="cpu", quantize=quantize)
    out = gen(PROMPTS, constraint=GIDS)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(np.concatenate(list(gen.stream(PROMPTS, chunk_size=5, constraint=GIDS)), axis=1), ref)
    assert all(_grammar_ok(m["cs"], g, row) for g, row in zip(GIDS, out.tolist()))


def test_free_grammar_equals_unconstrained(tiny):
    cfg, _ = _configs(tiny)
    constrained = Generator(tiny["plain"], cfg, device="cpu")
    free = Generator(tiny["plain"], dataclasses.replace(cfg, constraints=None), device="cpu")
    np.testing.assert_array_equal(constrained(PROMPTS, constraint=0), free(PROMPTS))
    np.testing.assert_array_equal(constrained(PROMPTS), free(PROMPTS))


SAMPLED = {"temperature": dict(temperature=1.0), "top_k": dict(temperature=0.8, top_k=30),
           "top_p": dict(temperature=1.2, top_p=0.9)}


@pytest.mark.parametrize("policy", list(SAMPLED))
def test_sampled_first_step_distribution_matches_jax(tiny, policy):
    """The prompt-sampled step's policy over the constrained logits equals
    the JAX package's (``jax.random`` and ``torch.Generator`` draw other
    numbers, so tokens are held on the distribution), and every token the
    port samples is allowed by its row's grammar."""
    _, jnp, jm, _ = _jax()
    cfg, jax_cfg = _configs(tiny, **SAMPLED[policy])
    gen = Generator(tiny["plain"], cfg, device="cpu")
    jax_gen = jm.Generator(tiny["module"], tiny["params"], jax_cfg)
    _, _, last, _ = gen._start(PROMPTS, 0, constraint=GIDS)
    _, _, jax_last, _ = jax_gen._start(PROMPTS, 0, constraint=GIDS)
    starts = tiny["cs"].start_states(gen._grammar_ids(GIDS, len(PROMPTS), last.shape[0]))
    with torch.no_grad():
        logits = gen._constrain(gen._head(last), torch.as_tensor(starts))
    jax_logits = jax_gen._constrain(jax_gen._head_fn(jax_gen.params, jax_last), (jnp.asarray(starts),))
    np.testing.assert_array_equal(np.isneginf(logits.numpy()), np.isneginf(np.asarray(jax_logits)))
    from unionml_tpu.models.generate import policy_probs as jax_policy_probs

    np.testing.assert_allclose(policy_probs(logits, cfg).numpy(), np.asarray(jax_policy_probs(jax_logits, jax_cfg)),
                               atol=1e-5, rtol=0)
    for seed in range(3):
        out = gen(PROMPTS, seed=seed, constraint=GIDS)
        assert all(_grammar_ok(tiny["cs"], g, row) for g, row in zip(GIDS, out.tolist())), (seed, out)


@pytest.mark.parametrize("constrained", [True, False], ids=["constrained", "unconstrained"])
def test_decode_logprobs_match_jax(tiny, constrained):
    """``_decode``'s tokens and log-probabilities (log-softmax of the masked
    logits) against the JAX ``decode_steps``' from the same carry."""
    _, _, jm, _ = _jax()
    cfg, jax_cfg = _configs(tiny)
    if not constrained:
        cfg, jax_cfg = dataclasses.replace(cfg, constraints=None), dataclasses.replace(jax_cfg, constraints=None)
    gids = GIDS if constrained else None
    gen = Generator(tiny["plain"], cfg, device="cpu")
    jax_gen = jm.Generator(tiny["module"], tiny["params"], jax_cfg)
    *_, carry = gen._start(PROMPTS, 0, constraint=gids)
    *_, jax_carry = jax_gen._start(PROMPTS, 0, constraint=gids)
    assert len(carry) == len(jax_carry) == (6 if constrained else 5)
    toks, lps, carry = gen._decode(*carry, steps=8)
    jax_toks, jax_lps, jax_carry = jax_gen._decode(jax_gen.params, *jax_carry, steps=8)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jax_toks))
    np.testing.assert_allclose(lps.numpy(), np.asarray(jax_lps), atol=LP_ATOL, rtol=0)
    assert (lps.numpy() <= 0).all()
    if constrained:
        np.testing.assert_array_equal(carry[-1].numpy(), np.asarray(jax_carry[-1]))  # DFA states


def test_constraint_errors_match_jax(tiny):
    _, _, jm, _ = _jax()
    cfg, jax_cfg = _configs(tiny, max_new_tokens=4)
    gens = (Generator(tiny["plain"], cfg, device="cpu"), jm.Generator(tiny["module"], tiny["params"], jax_cfg))
    bare = (Generator(tiny["plain"], dataclasses.replace(cfg, constraints=None), device="cpu"),
            jm.Generator(tiny["module"], tiny["params"], dataclasses.replace(jax_cfg, constraints=None)))
    cases = [
        (bare, lambda g: g(PROMPTS[:2], constraint=1)),
        (bare, lambda g: list(g.stream(PROMPTS[:2], constraint=[1, 1]))),
        (gens, lambda g: g(PROMPTS[:3], constraint=[1, 2])),  # wrong arity
        (gens, lambda g: g(PROMPTS[:2], constraint=4)),  # ids are 0..3
        (gens, lambda g: list(g.stream(PROMPTS[:2], constraint=[0, -1]))),
    ]
    for pair, call in cases:
        messages = []
        for gen in pair:
            with pytest.raises(ValueError) as exc:
                call(gen)
            messages.append(str(exc.value))
        assert messages[0] == messages[1]


# ---------------------------------------------------------------------- ContinuousBatcher


def _serve(engine, prompts, gids, logprobs=True):
    """Submit every prompt from its own thread; returns ``[(tokens,
    logprobs)]``, checking after each chunk that the stream already holds a
    logprob for every token consumed."""
    results = [None] * len(prompts)
    covered = []

    def worker(i):
        stream = engine.submit(prompts[i], constraint=gids[i], logprobs=logprobs)
        tokens = []
        for chunk in stream:
            tokens.extend(int(t) for t in np.asarray(chunk).ravel())
            covered.append(len(stream.logprobs) >= len(tokens) if logprobs else True)
        results[i] = (tokens, list(stream.logprobs))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    assert covered and all(covered)
    return results


def _assert_streams_match(streams, ref):
    for (tokens, lps), (ref_tokens, ref_lps) in zip(streams, ref):
        assert tokens == ref_tokens
        assert len(lps) == len(tokens)
        np.testing.assert_allclose(lps, ref_lps, atol=LP_ATOL, rtol=0)
        assert all(np.isfinite(lps)) and max(lps) <= 0


@pytest.mark.parametrize("block_size", [None, 8], ids=["dense", "paged"])
def test_engine_constrained_logprob_streams_match_jax(tiny, block_size):
    _, _, jm, JaxContinuousBatcher = _jax()
    cfg, jax_cfg = _configs(tiny)
    jax_engine = JaxContinuousBatcher(jm.Generator(tiny["module"], tiny["params"], jax_cfg), slots=4, decode_chunk=4,
                                      block_size=block_size)
    try:
        ref = _serve(jax_engine, PROMPTS, GIDS)
    finally:
        jax_engine.close()
    engine = ContinuousBatcher(Generator(tiny["flash"], cfg, device="cpu"), slots=4, decode_chunk=4,
                               block_size=block_size)
    try:
        streams = _serve(engine, PROMPTS, GIDS)
    finally:
        engine.close()
    _assert_streams_match(streams, ref)
    solo = Generator(tiny["plain"], cfg, device="cpu")
    for (tokens, _), p, g in zip(streams, PROMPTS, GIDS):
        row = solo([p], constraint=g)[0].tolist()  # pads after EOS, where the stream ends
        assert tokens == row[: len(tokens)] and set(row[len(tokens):]) <= {cfg.pad_id}
        assert _grammar_ok(tiny["cs"], g, tokens)


def test_engine_without_logprobs_keeps_none(tiny):
    cfg, _ = _configs(tiny, max_new_tokens=6)
    engine = ContinuousBatcher(Generator(tiny["flash"], cfg, device="cpu"), slots=2, decode_chunk=3, block_size=8)
    try:
        streams = _serve(engine, PROMPTS[:2], [1, 3], logprobs=False)
    finally:
        engine.close()
    assert [lps for _, lps in streams] == [[], []]


def test_preempted_constrained_stream_resumes_token_exact(tiny):
    """Pool = one worst-case request: the youngest resident is preempted and
    resumed by prefilling prompt + echo from the DFA state the echo walks to —
    its tokens equal a solo constrained run, its logprobs the JAX engine's
    unpreempted ones."""
    _, _, jm, JaxContinuousBatcher = _jax()
    cfg, jax_cfg = _configs(tiny, max_new_tokens=16)
    gids = [3, 3, 3]
    gen = Generator(tiny["flash"], cfg, device="cpu")
    min_pool = ContinuousBatcher(gen, slots=3, decode_chunk=2, block_size=8).max_blocks
    engine = ContinuousBatcher(gen, slots=3, decode_chunk=2, block_size=8, pool_blocks=min_pool)
    try:
        streams = _serve(engine, PROMPTS[:3], gids)
        stats = engine.stats()["kv_blocks"]
    finally:
        engine.close()
    assert stats["preemptions"] > 0 and stats["used"] == 0
    solo = Generator(tiny["plain"], cfg, device="cpu")
    assert [s[0] for s in streams] == [solo([p], constraint=g)[0].tolist() for p, g in zip(PROMPTS[:3], gids)]
    jax_engine = JaxContinuousBatcher(jm.Generator(tiny["module"], tiny["params"], jax_cfg), slots=3, decode_chunk=2)
    try:
        ref = _serve(jax_engine, PROMPTS[:3], gids)
    finally:
        jax_engine.close()
    _assert_streams_match(streams, ref)


def test_warmup_resets_counters_and_keeps_streams(tiny):
    cfg, _ = _configs(tiny, max_new_tokens=8, prompt_buckets=(8, 16))
    gen = Generator(tiny["flash"], cfg, device="cpu")
    cold = ContinuousBatcher(gen, slots=4, decode_chunk=4, block_size=8)
    try:
        expected = _serve(cold, PROMPTS, GIDS)
    finally:
        cold.close()
    engine = ContinuousBatcher(gen, slots=4, decode_chunk=4, block_size=8)
    try:
        engine.warmup()
        stats = engine.stats()
        assert (stats["decode_dispatches"], stats["decoded_rows"]) == (0, 0)
        assert stats["ttft_ms"] == stats["tbt_ms"] == {"window": 0}
        assert stats["kv_blocks"]["used"] == 0
        streams = _serve(engine, PROMPTS, GIDS)
    finally:
        engine.close()
    _assert_streams_match(streams, expected)


def test_engine_constraint_errors_match_jax(tiny):
    _, _, jm, JaxContinuousBatcher = _jax()
    cfg, jax_cfg = _configs(tiny, max_new_tokens=4)
    engines = (ContinuousBatcher(Generator(tiny["flash"], cfg, device="cpu"), slots=2),
               JaxContinuousBatcher(jm.Generator(tiny["module"], tiny["params"], jax_cfg), slots=2))
    bare = (ContinuousBatcher(Generator(tiny["flash"], dataclasses.replace(cfg, constraints=None), device="cpu"),
                              slots=2),
            JaxContinuousBatcher(jm.Generator(tiny["module"], tiny["params"],
                                              dataclasses.replace(jax_cfg, constraints=None)), slots=2))
    try:
        for pair, constraint in ((bare, 1), (engines, 4), (engines, -1)):
            messages = []
            for engine in pair:
                with pytest.raises(ValueError) as exc:
                    engine.submit(PROMPTS[0], constraint=constraint)
                messages.append(str(exc.value))
            assert messages[0] == messages[1]
    finally:
        for engine in (*engines, *bare):
            engine.close()


# ---------------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card with sm_90 (the paged decode kernel has no CPU mode)")


@pytest.mark.cuda
def test_constrained_engine_on_card_matches_cpu():
    """The paged engine on the card (the paged decode kernel under every
    decode step) serves the same constrained streams as on the CPU (the
    kernel's twin): tokens identical, logprobs within 1e-4 (f32, sums in
    another order)."""
    _card()
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, attention_impl="flash", **SHAPE)
    cuda_model = Llama(cfg, seed=0, device="cuda")
    cpu_model = Llama(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in cuda_model.state_dict().items()})
    cs = ConstraintSet([compile_regex(p, _texts(SHAPE["vocab_size"]), eos_id=EOS) for p in GRAMMARS])
    gcfg = GenerationConfig(max_new_tokens=12, temperature=0.0, prompt_buckets=(16,), eos_id=EOS, constraints=cs)
    runs = []
    before = paged_decode_attention.launches
    for model, device in ((cuda_model, "cuda"), (cpu_model, "cpu")):
        engine = ContinuousBatcher(Generator(model, gcfg, device=device), slots=4, decode_chunk=4, block_size=8)
        try:
            runs.append(_serve(engine, PROMPTS, GIDS))
        finally:
            engine.close()
    assert paged_decode_attention.launches > before
    for (tokens, lps), (ref_tokens, ref_lps) in zip(*runs):
        assert tokens == ref_tokens
        np.testing.assert_allclose(lps, ref_lps, atol=1e-4, rtol=0)
    assert all(_grammar_ok(cs, g, tokens) for (tokens, _), g in zip(runs[0], GIDS))
