"""The port's routed-experts decoder (``unionml_tpu_torch/models/moe.py``)
against the JAX package's, on the CPU.

The same seeded numpy inputs and the same weights (carried across by
``moe_from_jax``) go through both packages, f32:

- ``top_k_dispatch`` on router probabilities with forced ties, capacity
  overflow and ``valid`` masks: dispatch and combine equal exactly, the aux
  loss within 1e-6;
- ``MoETransformer`` logits within 1e-5 (rtol and atol), with and without a
  ``token_mask``; ``moe_lm_loss`` within 1e-5; 3 steps of ``fit`` (AdamW):
  losses within 1e-5 relative;
- greedy tokens, equal to JAX's, at the default tight capacity
  (``capacity_factor=1.25``, so tokens are dropped): ``Generator`` under
  bucket and batch padding and with ``prefill_chunk``; ``ContinuousBatcher``
  dense, paged, chunked, with the static prefix and the radix cache; the
  speculative engine over an MoE target; ``quantize="int8"`` (stacked expert
  kernels with ``[E, 1, F]`` scales, the router left in f32).

Then the MoE cases of the JAX unit files run against the port (see
``test_torch_serving_units.py``): ``test_continuous.py:142``,
``test_generate.py:214``, ``test_quant.py:119`` and
``test_speculative.py:131``. Their ``Module(config).init(key, tokens)`` calls
build the port's module loaded with the JAX init's weights, so each port case
runs on the JAX case's weights. ``test_generate.py:193`` stays ``slow``, as
in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from tests.test_torch_serving_units import port_cases
from unionml_tpu import TrainerConfig as JaxTrainerConfig, make_train_step as jax_make_train_step
from unionml_tpu.models import DraftSpec as JaxDraftSpec
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models.moe import MoEConfig as JaxMoEConfig, MoETransformer as JaxMoETransformer
from unionml_tpu.models.moe import moe_lm_loss as jax_moe_lm_loss, top_k_dispatch as jax_top_k_dispatch
from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from unionml_tpu.train import fit as jax_fit
from unionml_tpu_torch import TrainerConfig, TrainState, fit, make_train_step
from unionml_tpu_torch.models import (
    DraftSpec,
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    MoEConfig,
    MoETransformer,
    SpeculativeGenerator,
    llama_from_jax,
    moe_from_jax,
    moe_lm_loss,
    moe_params_to_numpy,
    top_k_dispatch,
)
from unionml_tpu_torch.ops.quant import QuantizedKernel, QuantizedTensor
from unionml_tpu_torch.serving import ContinuousBatcher

torch.set_num_threads(2)

#: the JAX unit files' MoE shape; ``moe_every=2`` interleaves dense blocks (layers 0 and 2) with routed ones
SHAPE = dict(vocab_size=61, dim=64, n_heads=4, n_kv_heads=2, hidden_dim=96, n_experts=4, k=2)
MIXED = dict(SHAPE, n_layers=4, moe_every=2)
#: wide enough that the expert stacks ([4, 128, 128] = 65536) reach quantize_params' min_size
INT8_SHAPE = dict(SHAPE, dim=128, hidden_dim=128, n_layers=2, moe_every=2)
PROMPTS = [[3, 1, 4, 1, 5], [9, 2], [8, 2, 8, 1, 8, 2, 8, 5, 9, 13, 21, 34], [44, 9, 7]]
SYSTEM = [11, 12, 13, 4, 5, 6, 7, 8, 9, 10, 21]  # one block of 8 and a 3-token tail


def _pair(shape, seed=0, **overrides):
    """A JAX (module, params) and the port model carrying its weights."""
    jax_cfg = JaxMoEConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **shape, **overrides)
    module = JaxMoETransformer(jax_cfg)
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = MoEConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **shape, **overrides)
    model = moe_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return module, params, model


@pytest.fixture(scope="module")
def mixed():
    return _pair(MIXED, seed=2)


@pytest.fixture(scope="module")
def draft_pair():
    """A 1-layer Llama draft over the same vocabulary (JAX module, params, port model)."""
    shape = dict(vocab_size=SHAPE["vocab_size"], dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64)
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **shape))
    params = module.init(jax.random.PRNGKey(9), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **shape)
    return module, params, llama_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


# ----------------------------------------------------------------- top_k_dispatch


def _router_probs(case):
    """``[N, E]`` probabilities from numpy seed 0, and the case's capacity and mask."""
    rng = np.random.RandomState(0)
    n, e = 24, 4
    probs = rng.dirichlet(np.ones(e), size=n).astype(np.float32)
    if "ties" in case:
        # exact ties at the top, among the top two, and across all four
        probs[0] = [0.25, 0.25, 0.25, 0.25]
        probs[1] = [0.1, 0.3, 0.3, 0.3]
        probs[2] = [0.4, 0.2, 0.2, 0.2]
        probs[3] = [0.2, 0.4, 0.0, 0.4]
        probs[4:8] = probs[0]
    capacity = 3 if "overflow" in case else 24
    valid = (rng.rand(n) > 0.3) if "valid" in case else None
    return probs, capacity, valid


@pytest.mark.parametrize("case", ["plain", "ties", "overflow", "valid", "ties-overflow-valid"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_dispatch_equals_jax(case, k):
    """Dispatch and combine equal JAX's exactly (ties to the lower index,
    first choices before second ones, masked tokens claiming nothing); the
    aux loss within 1e-6."""
    probs, capacity, valid = _router_probs(case)
    want = jax_top_k_dispatch(jnp.asarray(probs), k, capacity, None if valid is None else jnp.asarray(valid))
    got = top_k_dispatch(torch.from_numpy(probs), k, capacity, None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert float(got[2]) == pytest.approx(float(want[2]), abs=1e-6)
    if "overflow" in case:
        assert got[0].sum() < k * (probs.shape[0] if valid is None else valid.sum())  # some tokens were dropped


# ----------------------------------------------------------------- forward, loss, fit


@pytest.mark.parametrize("shape", ["routed", "mixed"])
def test_logits_equal_jax(shape):
    """``MoETransformer`` logits within 1e-5 (rtol and atol) on converted
    weights, with and without a token mask (masked tokens claim no
    capacity, so the real tokens' logits move with the mask)."""
    module, params, model = _pair(dict(SHAPE, n_layers=2, moe_every=1) if shape == "routed" else MIXED, seed=2)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, SHAPE["vocab_size"], size=(3, 16)).astype(np.int32)
    mask = np.arange(16)[None] < np.array([16, 9, 3])[:, None]
    for token_mask in (None, mask):
        want = module.apply({"params": params}, jnp.asarray(tokens),
                            token_mask=None if token_mask is None else jnp.asarray(token_mask))
        with torch.no_grad():
            got = model(torch.from_numpy(tokens), token_mask=None if token_mask is None else torch.from_numpy(token_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_moe_lm_loss_equals_jax(mixed):
    """The LM loss plus the weighted aux loss within 1e-5, with and without
    a loss mask; the aux loss alone moves it (weight 0 drops it)."""
    module, params, model = mixed
    tokens = np.random.RandomState(2).randint(0, SHAPE["vocab_size"], size=(4, 17)).astype(np.int32)
    mask = (tokens > 20).astype(np.int32)
    for batch in (tokens, (tokens, mask)):
        want = float(jax_moe_lm_loss(module, params, jax.tree_util.tree_map(jnp.asarray, batch)))
        with torch.no_grad():
            got = float(moe_lm_loss(model, jax.tree_util.tree_map(torch.from_numpy, batch)))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    no_aux = dataclasses.replace(model.config, aux_loss_weight=0.0)
    with torch.no_grad():
        model.config, kept = no_aux, model.config
        try:
            assert float(moe_lm_loss(model, torch.from_numpy(tokens))) != pytest.approx(got, rel=1e-6)
        finally:
            model.config = kept


def test_fit_three_steps_equal_jax():
    """3 AdamW steps (optax.adamw's defaults on both sides) of ``fit`` with
    ``moe_lm_loss`` on 24 windows in batches of 8: the loss history within
    1e-5 relative; the trained weights within 1e-6 on the mean, and any one
    within the 3 steps' size (Adam divides each gradient by its own root
    mean square, so a gradient near zero carries the f32 rounding of both
    sides into a whole step)."""
    lr, seq = 1e-3, 17
    module, params, model = _pair(MIXED, seed=4)
    windows = np.random.RandomState(5).randint(0, SHAPE["vocab_size"], size=(24, seq)).astype(np.int32)
    state = train_state.TrainState.create(apply_fn=module.apply, params=params, tx=optax.adamw(lr))
    step = jax_make_train_step(lambda p, b: jax_moe_lm_loss(module, p, b))
    ref = jax_fit(state, step, windows, JaxTrainerConfig(epochs=1, batch_size=8, seed=3, log_every_steps=1))
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    result = fit(TrainState(model, optimizer), make_train_step(moe_lm_loss), windows,
                 TrainerConfig(epochs=1, batch_size=8, seed=3, log_every_steps=1), device="cpu")
    assert result.steps == ref.steps == 3
    np.testing.assert_allclose([h["loss"] for h in result.history], [h["loss"] for h in ref.history], rtol=1e-5)
    trained = jax.tree_util.tree_leaves(moe_params_to_numpy(result.state.model))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ref.state.params))
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(trained, want)])
    assert diffs.mean() <= 1e-6 and diffs.max() <= 3 * lr


# ----------------------------------------------------------------- generation


def _greedy(**kw):
    base = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
    base.update(kw)
    return JaxGenerationConfig(**base), GenerationConfig(**base)


@pytest.mark.parametrize("case", ["bucket 8", "bucket 32", "padded batch", "prefill_chunk 4"])
def test_generator_tokens_equal_jax_at_tight_capacity(mixed, case):
    """Greedy tokens equal JAX's at ``capacity_factor=1.25``, where the
    routed blocks drop tokens: the model is called with JAX's ``B`` and
    ``L`` at every step (bucket padding, the padded batch of 3 -> 4 rows,
    the prefill chunks), and pad tokens claim no capacity."""
    module, params, model = mixed
    kw = {"bucket 8": dict(prompt_buckets=(8,)), "bucket 32": dict(prompt_buckets=(32,)),
          "padded batch": dict(prompt_buckets=(16,)), "prefill_chunk 4": dict(prompt_buckets=(16,), prefill_chunk=4)}
    jax_cfg, cfg = _greedy(**kw[case])
    prompts = PROMPTS[:3] if case == "padded batch" else ([PROMPTS[0]] if case.startswith("bucket") else PROMPTS)
    want = JaxGenerator(module, params, jax_cfg)(prompts)
    got = Generator(model, cfg, device="cpu")(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))


#: (engine kwargs, uses the static prefix, uses the draft)
ENGINE_CASES = {
    "dense": ({}, False, False),
    "paged": (dict(block_size=8), False, False),
    "chunked-dense": (dict(admit_chunk=4), False, False),
    "chunked-budget-paged": (dict(admit_chunk=4, prefill_budget=8, max_admissions=2, block_size=8), False, False),
    "prefix-chunked-paged": (dict(admit_chunk=4, block_size=8), True, False),
    "radix-paged": (dict(block_size=8, prefix_cache=True), False, False),
    "speculative-paged": (dict(block_size=8), False, True),
    "speculative-dense": ({}, False, True),
}
#: prompts submitted one after another (a second wave of the first two re-hits the radix cache), so that which
#: rows share a decode dispatch, and with it the experts' capacity, is the same in both packages
ENGINE_PROMPTS = PROMPTS + [list(range(1, 21)) + [40], PROMPTS[0], list(range(1, 21)) + [40]]


def _engine_streams(package, pair, draft_pair, case, quantize=None):
    kwargs, with_prefix, with_draft = ENGINE_CASES[case]
    module, params, model = pair
    kw = dict(max_new_tokens=6, temperature=0.0, prompt_buckets=(16, 32))
    if package == "jax":
        if with_draft:
            kw["draft"] = JaxDraftSpec(module=draft_pair[0], params=draft_pair[1], gamma=3)
        gen, build = JaxGenerator(module, params, JaxGenerationConfig(**kw), quantize=quantize), JaxContinuousBatcher
    else:
        if with_draft:
            kw["draft"] = DraftSpec(module=draft_pair[2], gamma=3)
        gen, build = Generator(model, GenerationConfig(**kw), device="cpu", quantize=quantize), ContinuousBatcher
    prefix = gen.cache_prefix(SYSTEM) if with_prefix else None
    engine = build(gen, slots=2, decode_chunk=3, prefix=prefix, **kwargs)
    try:
        streams = [[int(t) for chunk in engine.submit(p) for t in np.asarray(chunk).ravel()] for p in ENGINE_PROMPTS]
        stats = engine.stats()
    finally:
        engine.close()
    return streams, stats


@pytest.fixture
def no_engine_env(monkeypatch):
    for name in ("UNIONML_TPU_ADMIT_CHUNK", "UNIONML_TPU_PREFILL_BUDGET", "UNIONML_TPU_MAX_ADMISSIONS",
                 "UNIONML_TPU_PREFIX_CACHE", "UNIONML_TPU_QUANTIZE", "UNIONML_TPU_KV_CACHE_DTYPE"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_equal_jax(mixed, draft_pair, no_engine_env, case):
    """The port's engine streams JAX's greedy tokens over an MoE model at
    tight capacity: free slots are done-masked out of routing, admission
    chunks, radix-hit suffixes and speculative verifies route the same
    ``B x L`` groups as JAX's."""
    jax_streams, jax_stats = _engine_streams("jax", mixed, draft_pair, case)
    streams, stats = _engine_streams("port", mixed, draft_pair, case)
    assert streams == jax_streams
    assert all(len(s) == 6 for s in streams)
    if "chunked" in case:
        assert stats["prefill"]["chunks"] == jax_stats["prefill"]["chunks"] > 0
    if "radix" in case:
        assert stats["prefix_cache"]["hits"] == jax_stats["prefix_cache"]["hits"] > 0


def test_int8_generator_and_engine_equal_jax(draft_pair, no_engine_env):
    """``quantize="int8"``: the expert stacks become int8 slots with
    ``[E, 1, F]`` scales bit-identical to JAX's, the router stays an f32
    parameter, and the plain ``Generator`` and the paged engine give JAX's
    int8 tokens."""
    module, params, _ = pair = _pair(INT8_SHAPE, seed=2)
    jax_cfg, cfg = _greedy()
    want = JaxGenerator(module, params, jax_cfg, quantize="int8")(PROMPTS)
    model = _pair(INT8_SHAPE, seed=2)[2]
    gen = Generator(model, cfg, device="cpu", quantize="int8")
    slot = model.layer_1.moe.experts.wi.kernel
    assert isinstance(slot, QuantizedKernel) and tuple(slot.scale.shape) == (4, 1, 128)
    from unionml_tpu.ops.quant import quantize_array as jax_quantize_array

    ref = jax_quantize_array(params["layer_1"]["moe"]["experts"]["wi"]["kernel"])
    np.testing.assert_array_equal(slot.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(slot.scale.numpy(), np.asarray(ref.scale))
    assert isinstance(model.layer_1.moe.router.kernel, torch.nn.Parameter)
    np.testing.assert_array_equal(gen(PROMPTS), np.asarray(want))
    jax_streams, _ = _engine_streams("jax", pair, draft_pair, "paged", quantize="int8")
    streams, _ = _engine_streams("port", (None, None, _pair(INT8_SHAPE, seed=2)[2]), draft_pair, "paged",
                                 quantize="int8")
    assert streams == jax_streams


@pytest.mark.parametrize("capacity", ["tight", "no drops"])
def test_speculative_generator_over_moe_target_equals_jax(mixed, draft_pair, capacity):
    """``SpeculativeGenerator`` with the MoE target: the ``[B, gamma + 1]``
    verify routes under its broadcast token mask, and greedy output equals
    JAX's speculative run. With ``capacity_factor = n_experts / k`` no token
    is dropped, so routing is per token and the output also equals the
    plain ``Generator``'s (at tight capacity the verify's wider group keeps
    tokens that a one-token step drops, in both packages)."""
    from unionml_tpu.models import SpeculativeGenerator as JaxSpeculativeGenerator

    module, params, model = mixed if capacity == "tight" else _pair(MIXED, seed=2, capacity_factor=2.0)
    jax_cfg, cfg = _greedy(max_new_tokens=10)
    want = JaxSpeculativeGenerator(module, params, draft_pair[0], draft_pair[1], jax_cfg, gamma=3)(PROMPTS)
    got = SpeculativeGenerator(model, draft_pair[2], cfg, gamma=3, device="cpu")(PROMPTS)
    np.testing.assert_array_equal(got, np.asarray(want))
    if capacity == "no drops":
        np.testing.assert_array_equal(got, Generator(model, cfg, device="cpu")(PROMPTS))


# ----------------------------------------------------------------- the JAX unit files' MoE cases


class _ConfigPair:
    """``XConfig`` of a unit case, called with jnp dtypes: the JAX config and
    the port's, as a pair for :class:`_JaxInit`."""

    def __init__(self, jax_cls, port_cls):
        self.jax_cls, self.port_cls = jax_cls, port_cls

    def tiny(self, **kw):
        dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
        return self.jax_cls.tiny(**kw), self.port_cls.tiny(**{k: dtypes.get(v, v) for k, v in kw.items()})


def _jax_built(jax_module_cls, loader):
    """``Module(config)`` of a unit case: ``init(key, tokens)`` runs the JAX
    module's init and loads its weights into the port's module on the CPU
    (``.port``), returning the weights as numpy (``{"params": tree}``);
    ``apply`` runs the port's forward."""

    class Built:
        def __init__(self, configs):
            self.jax_module, self.port_config = jax_module_cls(configs[0]), configs[1]
            self.port = None

        def init(self, key, tokens):
            tree = jax.tree_util.tree_map(np.asarray, self.jax_module.init(key, tokens)["params"])
            self.port = loader(tree, self.port_config, device="cpu")
            return {"params": tree}

        def apply(self, variables, tokens):
            """The uncached forward of the oracle cases: the port's logits."""
            with torch.no_grad():
                return self.port(torch.from_numpy(np.array(tokens))).numpy()

    return Built


class _PortGenerator(Generator):
    """JAX's ``Generator(module, params, config, **kw)`` over the port's; its
    ``params`` are the model's parameters and int8 slots by flax path (the
    slots as ``QuantizedTensor``), the JAX tree's leaves."""

    def __init__(self, module, params, config, **kw):
        super().__init__(module.port, config, device="cpu", **kw)

    @property
    def params(self):
        leaves = {name.replace(".", "/"): p for name, p in self.model.named_parameters()}
        for name, slot in self.model.named_modules():
            if isinstance(slot, QuantizedKernel):
                leaves[name.replace(".", "/")] = QuantizedTensor(slot.q, slot.scale)
        return leaves


def _port_speculative(target, tp, draft, dp, config, gamma=4):
    return SpeculativeGenerator(target.port, draft.port, config, gamma=gamma, device="cpu")


def _moe_unit_case(name: str, case: str) -> None:
    namespace: dict = {}
    port_cases(namespace, name, drop_lines=("from unionml_tpu.models import MoEConfig, MoETransformer",))
    namespace.update(
        MoEConfig=_ConfigPair(JaxMoEConfig, MoEConfig),
        MoETransformer=_jax_built(JaxMoETransformer, moe_from_jax),
        LlamaConfig=_ConfigPair(JaxLlamaConfig, LlamaConfig),
        Llama=_jax_built(JaxLlama, llama_from_jax),
        Generator=_PortGenerator,
        SpeculativeGenerator=_port_speculative,
    )
    globals()[case] = namespace[case]


_moe_unit_case("test_continuous.py", "test_moe_routed_decoder_streams_exactly")
_moe_unit_case("test_generate.py", "test_moe_generation_is_padding_invariant_at_tight_capacity")
_moe_unit_case("test_generate.py", "test_moe_greedy_matches_full_forward_oracle")  # slow there and here
_moe_unit_case("test_quant.py", "test_moe_int8_generation_runs_and_router_stays_fp")
_moe_unit_case("test_speculative.py", "test_moe_target_verifies_with_routed_experts")
