"""Parity of the port's ``Generator.beam_search`` with the JAX package's, on
the JAX beam tests' vocab-6 micro Llama (f32, CPU, weights carried across).

The cases of ``tests/unit/test_beam.py`` (exhaustive search, width 1 ==
greedy, wider beams score no worse, eos pads), then beams equal to the JAX
search's: every beam's tokens exact and its score within 1e-5, also where two
vocabulary columns tie exactly (``jax.lax.top_k`` prefers the lower index;
the port must too) and inside a grammar. The exhaustive oracle enumerates
all continuations in one batched forward of the port model, so it fits the
tier-1 budget.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import ConstraintSet as JaxConstraintSet
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models import compile_regex as jax_compile_regex
from unionml_tpu_torch.models import (
    ConstraintSet,
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    compile_regex,
    llama_params_from_jax,
)
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

SHAPE = dict(vocab_size=6, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64)
#: token id -> text for the constrained case; id 0 is EOS
TEXTS = ["", "a", "b", "c", " ", "d"]
GRAMMAR = "[a-c]+ d"


def _carry(params):
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **SHAPE)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


@pytest.fixture(scope="module")
def micro():
    """The JAX tests' ``micro_lm`` (PRNGKey 0) and the port model carrying it."""
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    return module, params, _carry(params)


def _gens(module, params, model, **kw):
    """A JAX and a port Generator over the same weights and config."""
    jax_kw = {k: v for k, v in kw.items() if k != "constraints"}
    port_kw = {k: v for k, v in kw.items() if k != "jax_constraints"}
    if "jax_constraints" in kw:
        jax_kw["constraints"] = jax_kw.pop("jax_constraints")
    base = dict(max_new_tokens=4, temperature=0.0, prompt_buckets=(8,))
    return (JaxGenerator(module, params, JaxGenerationConfig(**{**base, **jax_kw})),
            Generator(model, GenerationConfig(**{**base, **port_kw}), device="cpu"))


def _jax_beams(gen, prompts, num_beams, constraint=None):
    """Every beam's tokens and score from the JAX search (what its
    ``beam_search`` reduces to the best row)."""
    n = len(prompts)
    groups = 1 << max(0, (n - 1).bit_length())
    _, _, last, carry = gen._start(prompts, 0, batch_override=groups, constraint=constraint)
    tile = jnp.arange(groups * num_beams) // num_beams
    cache = jax.tree_util.tree_map(lambda c: c[tile], carry[0])
    cstate = ()
    if gen._cs is not None:
        cstate = (jnp.asarray(gen._cs.start_states(gen._grammar_ids(constraint, n, groups)))[tile],)
    out, scores, _ = gen._build_beam_fn(num_beams)(gen.params, cache, last[tile], carry[2][tile], tile >= n, *cstate)
    return np.asarray(out).reshape(groups, num_beams, -1)[:n], np.asarray(scores).reshape(groups, num_beams)[:n]


def _seq_scores(model, prompt, conts):
    """Sum log-prob of each continuation after ``prompt``, in one batched forward."""
    tokens = torch.tensor([list(prompt) + list(c) for c in conts])
    with torch.no_grad():
        lp = torch.log_softmax(model(tokens).float(), dim=-1)
    steps = len(conts[0])
    picked = lp[:, len(prompt) - 1: len(prompt) - 1 + steps].gather(2, tokens[:, len(prompt):, None])[..., 0]
    return picked.sum(dim=1).numpy()


@pytest.mark.parametrize("prompt", [[1, 4, 2], [5, 3]])
def test_full_width_beam_equals_exhaustive_search(micro, prompt):
    """Beam width vocab^(steps - 1) tracks every prefix, so the search is
    exact: it finds the best of all vocab^steps continuations."""
    _, _, model = micro
    steps, vocab = 3, SHAPE["vocab_size"]
    conts = list(itertools.product(range(vocab), repeat=steps))
    best = list(conts[int(np.argmax(_seq_scores(model, prompt, conts)))])
    gen = Generator(model, GenerationConfig(max_new_tokens=steps, temperature=0.0, prompt_buckets=(8,)), device="cpu")
    assert gen.beam_search([prompt], num_beams=vocab ** (steps - 1))[0].tolist() == best


def test_beam_one_equals_greedy(micro):
    _, _, model = micro
    gen = Generator(model, GenerationConfig(max_new_tokens=8, temperature=0.0, prompt_buckets=(8,)), device="cpu")
    prompts = [[1, 2, 3], [4, 5]]
    np.testing.assert_array_equal(gen.beam_search(prompts, num_beams=1), gen(prompts))


def test_beam_width_improves_or_matches_score(micro):
    _, _, model = micro
    steps, prompt = 4, [2, 1]
    gen = Generator(model, GenerationConfig(max_new_tokens=steps, temperature=0.0, prompt_buckets=(8,)), device="cpu")
    found = [gen.beam_search([prompt], num_beams=k)[0].tolist() for k in (1, 2, 4, 8)]
    scores = _seq_scores(model, prompt, found)
    assert all(b >= a - 1e-5 for a, b in zip(scores, scores[1:])), scores


def test_beam_eos_finishes_and_pads(micro):
    """Some eos choice surfaces (tiny vocab: sweep them all), and everything
    after the first eos is pad."""
    _, _, model = micro
    seen_eos = False
    for eos in range(1, SHAPE["vocab_size"]):
        gen = Generator(model, GenerationConfig(max_new_tokens=6, temperature=0.0, prompt_buckets=(8,), eos_id=eos,
                                                pad_id=0), device="cpu")
        out = gen.beam_search([[1, 2]], num_beams=3)[0].tolist()
        if eos in out:
            seen_eos = True
            assert all(t == 0 for t in out[out.index(eos) + 1:]), (eos, out)
    assert seen_eos


PROMPTS = [[1, 4, 2], [5, 3], [2, 2, 2, 1]]


@pytest.mark.parametrize(
    "num_beams,kw",
    [(1, {}), (4, {}), (8, {}), (4, {"eos_id": 3, "pad_id": 0}), (4, {"max_new_tokens": 7})],
    ids=["width-1", "width-4", "width-8-over-vocab", "eos", "longer"],
)
def test_beams_match_jax(micro, num_beams, kw):
    """Every beam, not only the best: tokens exact, scores within 1e-5; the
    best row through ``beam_search`` equal, also with a length penalty."""
    module, params, model = micro
    jax_gen, gen = _gens(module, params, model, **kw)
    ref_out, ref_scores = _jax_beams(jax_gen, PROMPTS, num_beams)
    out, scores = gen._beam(PROMPTS, num_beams)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-5, rtol=0)
    for penalty in (0.0, 1.0):
        np.testing.assert_array_equal(gen.beam_search(PROMPTS, num_beams=num_beams, length_penalty=penalty),
                                      np.asarray(jax_gen.beam_search(PROMPTS, num_beams=num_beams,
                                                                     length_penalty=penalty)))


def test_beam_ties_break_to_the_lower_index_as_jax(micro):
    """A duplicated vocabulary column makes two tokens' logits equal at every
    step: the search must keep the lower id first among equal scores, as
    ``jax.lax.top_k`` does, so every beam stays token-identical to JAX's."""
    module, params, _ = micro
    params = jax.tree_util.tree_map(np.asarray, params)
    kernel = params["lm_head"]["kernel"].copy()
    kernel[:, 4] = kernel[:, 1]  # tokens 1 and 4 tie exactly
    params = {**params, "lm_head": {**params["lm_head"], "kernel": kernel}}
    model = _carry(params)
    with torch.no_grad():
        logits = model(torch.tensor(PROMPTS[:1]))
    assert torch.equal(logits[..., 1], logits[..., 4])
    for steps in (1, 5):  # one step: the seeds alone, the tied pair side by side
        jax_gen, gen = _gens(module, params, model, max_new_tokens=steps)
        ref_out, ref_scores = _jax_beams(jax_gen, PROMPTS, 6)
        out, scores = gen._beam(PROMPTS, 6)
        if steps == 1:  # every token seeds a beam; the tied pair sits side by side, 1 first
            for row, row_scores in zip(out[:, :, 0].tolist(), scores):
                i = row.index(1)
                assert row[i + 1] == 4 and row_scores[i] == row_scores[i + 1], (row, row_scores)
        np.testing.assert_array_equal(out, ref_out)
        np.testing.assert_allclose(scores, ref_scores, atol=1e-5, rtol=0)


def test_constrained_beams_match_jax(micro):
    """Inside a grammar: candidate scores are the masked, renormalized
    policy's log-probs and DFA states follow their parents; every beam equals
    the JAX search's and the best row walks the grammar to EOS."""
    module, params, model = micro
    cs = ConstraintSet([compile_regex(GRAMMAR, TEXTS, eos_id=0)])
    jax_cs = JaxConstraintSet([jax_compile_regex(GRAMMAR, TEXTS, eos_id=0)])
    jax_gen, gen = _gens(module, params, model, max_new_tokens=6, eos_id=0, pad_id=0, constraints=cs,
                         jax_constraints=jax_cs)
    ref_out, ref_scores = _jax_beams(jax_gen, PROMPTS, 4, constraint=1)
    out, scores = gen._beam(PROMPTS, 4, constraint=1)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-5, rtol=0)
    best = gen.beam_search(PROMPTS, num_beams=4, constraint=1)
    np.testing.assert_array_equal(best, np.asarray(jax_gen.beam_search(PROMPTS, num_beams=4, constraint=1)))
    for row in best:
        text = "".join(TEXTS[t] for t in row)
        assert set(text) <= set("abc d"), text
