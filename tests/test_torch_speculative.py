"""Parity of the port's speculative decoding with the JAX package's, on tiny
f32 Llamas on the CPU, weights carried across.

The cases of ``tests/unit/test_speculative.py``: greedy output must equal the
JAX ``SpeculativeGenerator``'s, the JAX plain ``Generator``'s and the port's
plain ``Generator``'s, token for token, for any draft. Sampled decoding is
held on the distribution, since ``jax.random`` and ``torch.Generator`` draw
different numbers: the round's rejection law (accept test, residual) on
fixed distributions within 1e-6 of the JAX expressions, and an empirical
second-token histogram within total variation 0.06 of the exact target law.
The MoE target's case runs in ``test_torch_moe.py``, the ``prefix=`` case in
``test_torch_prefix_cache.py``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models import SpeculativeGenerator as JaxSpeculativeGenerator
from unionml_tpu.models.generate import policy_probs as jax_policy_probs
from unionml_tpu_torch.models import (
    DraftSpec,
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    SpeculativeGenerator,
    llama_params_from_jax,
    policy_probs,
)
from unionml_tpu_torch.models.speculative import rejection_step
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

PROMPTS = [[3, 14, 15, 92, 6], [27, 1], [8, 2, 8, 1, 8, 2, 8], [44, 9]]
VOCAB = 97


def _pair(seed: int, n_layers: int = 2, dim: int = 64):
    """A JAX (module, params) and the port model carrying the same weights."""
    shape = dict(vocab_size=VOCAB, dim=dim, n_layers=n_layers, n_heads=4, n_kv_heads=2, hidden_dim=2 * dim)
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **shape))
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **shape)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module, params, model


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.fixture(scope="module")
def drafts():
    """The JAX test's drafts: an unrelated one (seed 123) and another (seed 7)."""
    return {seed: _pair(seed, n_layers=1, dim=32) for seed in (123, 7)}


def _greedy(**kw):
    base = dict(max_new_tokens=10, temperature=0.0, prompt_buckets=(16,))
    base.update(kw)
    return JaxGenerationConfig(**base), GenerationConfig(**base)


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_disagreeing_draft_matches_jax(target, drafts, gamma):
    """An unrelated draft disagrees almost always, yet the emitted tokens are
    the target's greedy sequence: port == JAX speculative == JAX plain ==
    port plain."""
    module, params, model = target
    d_module, d_params, d_model = drafts[123]
    jcfg, cfg = _greedy()
    expected = np.asarray(JaxGenerator(module, params, jcfg)(PROMPTS))
    jax_spec = np.asarray(JaxSpeculativeGenerator(module, params, d_module, d_params, jcfg, gamma=gamma)(PROMPTS))
    spec = SpeculativeGenerator(model, d_model, cfg, gamma=gamma, device="cpu")
    out = spec(PROMPTS)
    assert out.dtype == np.int32 and out.shape == (len(PROMPTS), 10)
    np.testing.assert_array_equal(jax_spec, expected)
    np.testing.assert_array_equal(out, expected)
    np.testing.assert_array_equal(Generator(model, cfg, device="cpu")(PROMPTS), expected)
    assert spec.rounds >= 1


@pytest.mark.parametrize("horizon,gamma", [(12, 3), (40, 4)], ids=["short", "long-horizon"])
def test_perfect_draft_accepts_everything(target, horizon, gamma):
    """Draft == target (the same module, no copy): exact tokens, and every
    round accepts all its proposals, so the rounds are the all-accept
    minimum, ceil((horizon - 1) / (gamma + 1)), over a long horizon too.
    That needs the draft cache's completeness feed: without it the last
    draft's K/V slot stays unwritten and acceptance decays."""
    module, params, model = target
    jcfg, cfg = _greedy(max_new_tokens=horizon)
    expected = np.asarray(JaxGenerator(module, params, jcfg)(PROMPTS))
    spec = SpeculativeGenerator(model, model, cfg, gamma=gamma, device="cpu")
    np.testing.assert_array_equal(spec(PROMPTS), expected)
    assert spec.rounds == -(-(horizon - 1) // (gamma + 1)), spec.rounds
    # every round accepts gamma proposals per row, but the last one's clipped to the budget
    full_rounds = (horizon - 1) // (gamma + 1)
    tail = (horizon - 1) - full_rounds * (gamma + 1)
    assert spec.accepted_tokens == len(PROMPTS) * (full_rounds * gamma + min(tail, gamma)), spec.accepted_tokens
    assert spec.accepted_tokens == spec.proposed_tokens  # acceptance 1.0


def test_completeness_feed_fills_the_draft_cache(target):
    """After a perfect-draft run every draft-cache slot below a row's length
    holds the K/V the target wrote there (the same weights), the last draft
    of each all-accept round included: the completeness feed writes it. A
    missing feed leaves that slot zero, still visible to later queries."""
    _, _, model = target
    _, cfg = _greedy(max_new_tokens=40)
    draft_model = copy.deepcopy(model)  # the target's weights, its own cache
    spec = SpeculativeGenerator(model, draft_model, cfg, gamma=4, device="cpu")
    n, state = spec._start_state(PROMPTS, 0)
    budget = torch.full_like(state[5], cfg.max_new_tokens)
    state = spec._loop(state, budget, budget)
    t_cache, d_cache, lengths = state[0], state[1], state[3]
    assert state[7] == 8  # all-accept rounds for 39 tokens at gamma 4
    for t_layer, d_layer in zip(t_cache, d_cache):
        for b in range(n):
            rows = d_layer["k"][b, : int(lengths[b])]
            assert (rows.abs().sum(dim=(-1, -2)) > 0).all()
            torch.testing.assert_close(rows, t_layer["k"][b, : int(lengths[b])], atol=1e-4, rtol=1e-4)


def test_eos_truncates_like_plain_decoding(target, drafts):
    module, params, model = target
    d_module, d_params, d_model = drafts[7]
    free = np.asarray(JaxGenerator(module, params, _greedy()[0])(PROMPTS))
    jcfg, cfg = _greedy(eos_id=int(free[0][2]), pad_id=0)  # an eos mid-sequence for row 0
    expected = np.asarray(JaxGenerator(module, params, jcfg)(PROMPTS))
    np.testing.assert_array_equal(
        np.asarray(JaxSpeculativeGenerator(module, params, d_module, d_params, jcfg, gamma=4)(PROMPTS)), expected
    )
    np.testing.assert_array_equal(SpeculativeGenerator(model, d_model, cfg, gamma=4, device="cpu")(PROMPTS), expected)


def test_draft_spec_through_the_generator_facade(target, drafts):
    """``GenerationConfig(draft=DraftSpec(...))`` routes the façade through
    speculative decoding: the same greedy tokens, and ``stream()`` yields the
    ragged per-row chunks whose totals equal ``__call__``'s."""
    module, params, model = target
    _, _, d_model = drafts[7]
    jcfg, base = _greedy()
    expected = np.asarray(JaxGenerator(module, params, jcfg)(PROMPTS))
    gen = Generator(model, dataclasses.replace(base, draft=DraftSpec(module=d_model, gamma=3)), device="cpu")
    np.testing.assert_array_equal(gen(PROMPTS), expected)
    assert gen._speculative() is gen._speculative() and gen._speculative().rounds >= 1
    chunks = list(gen.stream(PROMPTS, chunk_size=4))
    assert all(isinstance(chunk, list) and len(chunk) == len(PROMPTS) for chunk in chunks)
    for i, row in enumerate(expected):
        total = np.concatenate([c[i] for c in chunks])
        assert len(total) == base.max_new_tokens  # no eos configured: the full budget
        np.testing.assert_array_equal(total, row)


def test_draft_spec_refuses_params_and_partition_rules(target):
    _, _, model = target
    with pytest.raises(ValueError, match="params"):
        DraftSpec(module=model, params={"w": 1})
    with pytest.raises(ValueError, match="params"):
        DraftSpec(model, {"w": 1})  # the JAX field order: module, params
    # partition_rules place the draft on the target's mesh (tests/test_torch_generate_tp.py)
    rules = [("x", None)]
    assert DraftSpec(module=model, partition_rules=rules).partition_rules is rules


def test_stream_matches_call_with_eos(target, drafts):
    _, _, model = target
    _, _, d_model = drafts[123]
    free = Generator(model, _greedy(max_new_tokens=12)[1], device="cpu")(PROMPTS)
    eos = int(free[0][2])
    _, cfg = _greedy(max_new_tokens=12, eos_id=eos, pad_id=0)
    spec = SpeculativeGenerator(model, d_model, cfg, gamma=4, device="cpu")
    called = spec(PROMPTS)
    chunks = list(spec.stream(PROMPTS, chunk_size=3))
    for i, row in enumerate(called):
        hits = np.nonzero(row == eos)[0]
        np.testing.assert_array_equal(np.concatenate([c[i] for c in chunks]), row[: int(hits[0]) + 1] if hits.size else row)


SAMPLED = dict(temperature=0.9, top_k=20)


@pytest.mark.parametrize("case", ["mixed", "all-accept", "greedy"])
def test_rejection_law_matches_jax_expressions(case):
    """The round's accept test and residual on fixed distributions, against
    the JAX round's own expressions (``speculative.py:247-269``) on the same
    policies, uniforms and proposals: accepted counts equal, accept
    probabilities ``min(1, p/q)`` and residuals within 1e-6."""
    rng = np.random.RandomState({"mixed": 0, "all-accept": 1, "greedy": 2}[case])
    batch, gamma, vocab = 6, 3, 31
    d_logits = (rng.randn(batch, gamma, vocab) * 2).astype(np.float32)
    t_logits = (rng.randn(batch, gamma + 1, vocab) * 2).astype(np.float32)
    if case == "all-accept":
        t_logits[:, :gamma] = d_logits  # p == q on the proposals: every draft accepts
    greedy = case == "greedy"
    kw = dict(temperature=0.0) if greedy else SAMPLED
    cfg, jcfg = GenerationConfig(**kw), JaxGenerationConfig(**kw)
    q = policy_probs(torch.from_numpy(d_logits), cfg)
    p = policy_probs(torch.from_numpy(t_logits), cfg)
    jq, jp = jax_policy_probs(jnp.asarray(d_logits), jcfg), jax_policy_probs(jnp.asarray(t_logits), jcfg)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    # proposals drawn from q (argmax for greedy), uniforms from numpy: both sides take the same ones
    drafts = np.stack([[rng.choice(vocab, p=q[b, i].double().numpy() / q[b, i].double().sum().item())
                        for i in range(gamma)] for b in range(batch)]).astype(np.int32)
    if greedy:
        drafts = d_logits.argmax(-1).astype(np.int32)
    u = rng.rand(gamma, batch).astype(np.float32)
    accepted, resid = rejection_step(p, q, torch.from_numpy(drafts), None if greedy else torch.from_numpy(u))

    # the JAX round's expressions, verbatim
    x = jnp.asarray(drafts)
    still = jnp.ones((batch,), bool)
    j_accepted = jnp.zeros((batch,), jnp.int32)
    for i in range(gamma):
        px = jnp.take_along_axis(jp[:, i], x[:, i: i + 1], axis=-1)[:, 0]
        qx = jnp.take_along_axis(jq[:, i], x[:, i: i + 1], axis=-1)[:, 0]
        ok = jnp.asarray(u[i]) * qx < px
        j_accepted = j_accepted + (still & ok)
        still = still & ok
        xi = torch.from_numpy(drafts[:, i: i + 1]).long()
        port_prob = (p[:, i].gather(1, xi) / q[:, i].gather(1, xi))[:, 0].clamp(max=1.0)
        np.testing.assert_allclose(port_prob.numpy(), np.minimum(1.0, np.asarray(px / qx)), atol=1e-6, rtol=0)
    p_at = jnp.take_along_axis(jp, j_accepted[:, None, None], axis=1)[:, 0]
    q_ext = jnp.concatenate([jq, jnp.zeros_like(jq[:, :1])], axis=1)
    q_at = jnp.take_along_axis(q_ext, j_accepted[:, None, None], axis=1)[:, 0]
    j_resid = jnp.maximum(p_at - q_at, 0.0)
    j_resid = jnp.where(j_resid.sum(-1, keepdims=True) > 0, j_resid, p_at)
    np.testing.assert_array_equal(accepted.numpy(), np.asarray(j_accepted))
    np.testing.assert_allclose(resid.numpy(), np.asarray(j_resid), atol=1e-6, rtol=0)
    if case == "all-accept":
        assert (accepted.numpy() == gamma).all()


def test_sampled_second_token_follows_the_target_law(target, drafts):
    """Rejection sampling leaves the output law the target's, whatever the
    draft: over 2048 rows of one prompt in one call, the second token (the
    first speculated one) has an empirical histogram within total variation
    0.06 of its exact law under the target, sum over t1 of P(t1) P(t2 | t1)
    (two same-law 2048-draws over top_k=4 per step sit near 0.02)."""
    _, _, model = target
    _, _, d_model = drafts[123]
    cfg = GenerationConfig(max_new_tokens=2, temperature=1.0, top_k=4, prompt_buckets=(8,))
    prompt = [3, 14, 15]
    n = 2048
    spec = SpeculativeGenerator(model, d_model, cfg, gamma=2, device="cpu")
    second = spec([prompt] * n, seed=5)[:, 1]
    with torch.no_grad():
        p1 = policy_probs(model(torch.tensor([prompt]))[0, -1].float(), cfg)
        law = torch.zeros(VOCAB, dtype=torch.float64)
        for t1 in torch.nonzero(p1).flatten().tolist():
            p2 = policy_probs(model(torch.tensor([prompt + [t1]]))[0, -1].float(), cfg)
            law += p1[t1].double() * p2.double()
    empirical = np.bincount(second, minlength=VOCAB) / n
    tv = 0.5 * np.abs(empirical - law.numpy()).sum()
    assert tv < 0.06, tv


def test_sampling_is_seed_deterministic(target, drafts):
    _, _, model = target
    _, _, d_model = drafts[7]
    cfg = GenerationConfig(max_new_tokens=6, temperature=0.9, top_k=30, prompt_buckets=(16,))
    spec = SpeculativeGenerator(model, d_model, cfg, gamma=3, device="cpu")
    a = spec(PROMPTS, seed=11)
    np.testing.assert_array_equal(a, spec(PROMPTS, seed=11))
    assert (spec(PROMPTS, seed=12) != a).any()
    assert ((0 <= a) & (a < VOCAB)).all()
