"""Parity of the port's Llama (``unionml_tpu_torch.models.llama``) with the
JAX package's, through the weight bridge, at ``LlamaConfig.tiny`` in f32 on
the CPU. Tolerance: 1e-4 absolute on logits (f32 through two layers and a
vocabulary projection, summed in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models.llama import causal_lm_loss as jax_causal_lm_loss
from unionml_tpu_torch.models import Llama, LlamaConfig, causal_lm_loss, llama_params_from_jax

torch.set_num_threads(2)


def _pair(**overrides):
    jax_cfg = JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **overrides)
    module = JaxLlama(jax_cfg)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **overrides)
    return module, params, tree, cfg


@pytest.fixture(scope="module")
def tiny():
    module, params, tree, cfg = _pair()
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(tree, cfg))
    return module, params, tree, cfg, model


def _tokens(cfg, shape=(2, 9), seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=shape).astype(np.int32)


def test_logits_match_flax(tiny):
    module, params, _, cfg, model = tiny
    tokens = _tokens(cfg)
    ref = module.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    assert logits.shape == (2, 9, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    with torch.no_grad():  # return_hidden skips only the head
        hidden = model(torch.from_numpy(tokens), return_hidden=True)
    ref_hidden = module.apply({"params": params}, jnp.asarray(tokens), return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), atol=1e-4, rtol=0)


def test_lora_adapters_load_and_scale():
    """LoRA leaves bridge too, and ``alpha/rank`` scales them as in flax
    (``lora_b`` is made nonzero so the adapter contributes)."""
    module, params, tree, cfg = _pair(lora_rank=4)
    rng = np.random.RandomState(1)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: rng.randn(*a.shape).astype(np.float32) * 0.05 if "lora_b" in jax.tree_util.keystr(path) else a,
        tree,
    )
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(tree, cfg))
    tokens = _tokens(cfg, seed=2)
    ref = module.apply({"params": jax.tree_util.tree_map(jnp.asarray, tree)}, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fault", ["leftover", "missing"])
def test_bridge_consumes_every_leaf(tiny, fault):
    _, _, tree, cfg, _ = tiny
    tree = {k: dict(v) for k, v in tree.items()}
    if fault == "leftover":
        tree["layer_0"]["stray"] = {"kernel": np.zeros((1,), np.float32)}
    else:
        del tree["final_norm"]
    with pytest.raises(ValueError, match=fault):
        llama_params_from_jax(tree, cfg)


def test_bridge_casts_once_to_the_dtype_asked(tiny):
    _, _, tree, cfg, _ = tiny
    state = llama_params_from_jax(tree, cfg, dtype=torch.bfloat16)
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    assert state["lm_head.kernel"].shape == (cfg.dim, cfg.vocab_size)  # [in, out] kept


def test_causal_lm_loss_matches_flax(tiny):
    module, params, _, cfg, model = tiny
    tokens = _tokens(cfg, seed=3)
    mask = np.random.RandomState(4).rand(*tokens.shape) < 0.7
    apply_fn = lambda p, t: module.apply({"params": p}, t)  # noqa: E731
    for batch_np, batch_t in (
        (jnp.asarray(tokens), torch.from_numpy(tokens)),
        ((jnp.asarray(tokens), jnp.asarray(mask)), (torch.from_numpy(tokens), torch.from_numpy(mask))),
    ):
        ref = jax_causal_lm_loss(apply_fn, params, batch_np)
        with torch.no_grad():
            loss = causal_lm_loss(model, batch_t)
        np.testing.assert_allclose(loss.item(), float(ref), atol=1e-5, rtol=0)
