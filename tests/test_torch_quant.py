"""The port's int8 weight quantization against the JAX package's, on the CPU.

- ``quantize_array``: int8 values and scales bit-identical to JAX's for
  ``[K, F]``, stacked ``[E, K, F]`` and ``channel_axis=0``; ``dequantize``
  equal.
- ``quantize_params`` selects the same leaves as JAX on the same Llama tree,
  for the defaults and custom ``include``/``exclude``/``min_size``, as a tree
  and in place on a module.
- A quantized ``Llama`` on the plain route (``attention_impl="auto"``) gives
  the logits of JAX ``module.apply`` on the dequantized tree within 1e-5; on
  the kernel route (``"flash"``, the kernels' twins) it rounds matmul inputs
  to bf16, so it is held to the plain route within a bf16-level tolerance.
- The weight bridge carries a JAX quantized tree into a quantized ``Llama``
  and back bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.ops import quant as jq
from unionml_tpu_torch.models import Llama, LlamaConfig, llama_from_jax, llama_params_from_jax, llama_params_to_numpy
from unionml_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

# dim 256: q/o (65536) and the MLP kernels reach min_size = 65536, k/v (256 x 128) do not
SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512)
TOKENS = np.array([[3, 14, 15, 92, 6, 53, 58, 97], [27, 1, 8, 2, 8, 1, 8, 2]], np.int32)


@pytest.fixture(scope="module")
def jax_tree():
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return module, params


def _port_model(params, **overrides):
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **SHAPE, **overrides)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


def _quantized_paths(tree, prefix=""):
    """Paths of a port tree's QuantizedTensor leaves."""
    out = set()
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out |= _quantized_paths(leaf, f"{prefix}{key}/")
        elif isinstance(leaf, tq.QuantizedTensor):
            out.add(f"{prefix}{key}")
    return out


def _jax_quantized_paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))[0]
    return {"/".join(str(p.key) for p in path) for path, leaf in leaves if isinstance(leaf, jq.QuantizedTensor)}


@pytest.mark.parametrize(
    "shape,channel_axis",
    [((64, 48), -1), ((3, 64, 48), -1), ((64, 48), 0), ((3, 64, 48), 1)],
    ids=["KF", "EKF", "KF-axis0", "EKF-axis1"],
)
def test_quantize_array_is_bit_identical(shape, channel_axis):
    rng = np.random.RandomState(0)
    w = (rng.randn(*shape) * rng.uniform(0.01, 10, size=shape[-1])).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    w.flat[5] = 2.5 * (np.abs(w).max() / 127.0)  # near a rounding tie
    ref = jq.quantize_array(w, channel_axis=channel_axis)
    qt = tq.quantize_array(torch.from_numpy(w), channel_axis=channel_axis)
    assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32 and qt.shape == shape
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(ref.scale))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            tq.dequantize(qt, tdt).float().numpy(), np.asarray(jq.dequantize(ref, jdt)).astype(np.float32)
        )


@pytest.mark.parametrize(
    "kw",
    [{}, {"min_size": 1}, {"min_size": 40000, "include": r"(attn|lm_head)/.*kernel$"},
     {"exclude": r"(embed|norm|scale|wo|k_proj)", "min_size": 1 << 15}],
    ids=["defaults", "min_size-1", "include-attn-and-head", "exclude-wo-and-k"],
)
def test_quantize_params_selects_the_jax_leaves(jax_tree, kw):
    _, params = jax_tree
    expected = _jax_quantized_paths(jq.quantize_params(params, **kw))
    tree = jax.tree_util.tree_map(np.asarray, params)
    ported = tq.quantize_params(jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree), **kw)
    assert _quantized_paths(ported) == expected
    back = tq.dequantize_tree(ported, torch.float32)
    for path, ref in jax.tree_util.tree_flatten_with_path(jq.dequantize_tree(jq.quantize_params(params, **kw), jnp.float32))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(ref))
    if kw == {}:  # the width chosen so the defaults split the kernels
        assert "layer_0/attn/q_proj/kernel" in expected and "layer_0/attn/k_proj/kernel" not in expected
    # in place on a module: the same leaves become int8 slots
    model = tq.quantize_params(_port_model(params), **kw)
    slots = {name.replace(".", "/") for name, m in model.named_modules() if isinstance(m, tq.QuantizedKernel)}
    assert slots == expected
    assert tq.quantize_params(model, **kw) is model  # idempotent: int8 slots are no parameters
    assert {n for n, m in model.named_modules() if isinstance(m, tq.QuantizedKernel)} == {
        s.replace("/", ".") for s in slots
    }


def test_module_quantization_refuses_a_leaf_no_forward_takes(jax_tree):
    _, params = jax_tree
    with pytest.raises(ValueError, match="does not take an int8"):
        tq.quantize_params(_port_model(params), include=r"embedding$", exclude=r"^$")


def _jax_logits_on_dequantized(module, params):
    deq = jq.dequantize_tree(jq.quantize_params(params), dtype=jnp.float32)
    return np.asarray(module.apply({"params": deq}, jnp.asarray(TOKENS)))


def test_quantized_llama_logits_match_jax(jax_tree):
    module, params = jax_tree
    ref = _jax_logits_on_dequantized(module, params)
    plain_model = tq.quantize_params(_port_model(params))
    flash_model = tq.quantize_params(_port_model(params, attention_impl="flash"))
    # each slot records its model's route, taken once from the kernel switch
    for model, route in ((plain_model, "xla"), (flash_model, "pallas")):
        slots = [m for m in model.modules() if isinstance(m, tq.QuantizedKernel)]
        assert slots and {m.impl for m in slots} == {route}
    with torch.no_grad():
        plain = plain_model(torch.from_numpy(TOKENS)).numpy()
        flash = flash_model(torch.from_numpy(TOKENS)).numpy()
    np.testing.assert_allclose(plain, ref, atol=1e-5, rtol=0)
    # the kernel route rounds each int8 matmul's input to bf16 (8 bits of
    # mantissa): logits within 2e-2 of the plain route's, relative to their scale
    scale = np.abs(plain).max()
    assert np.abs(flash - plain).max() <= 2e-2 * scale
    assert np.abs(flash - plain).max() > 0  # the twins did run


@pytest.mark.parametrize("leaf_form", ["attributes", "dict"])
def test_weight_bridge_round_trips_a_quantized_tree(jax_tree, leaf_form):
    module, params = jax_tree
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_params(params))  # QuantizedTensor leaves of numpy
    if leaf_form == "dict":
        qtree = jax.tree_util.tree_map(
            lambda x: {"q": x.q, "scale": x.scale} if isinstance(x, jq.QuantizedTensor) else x,
            qtree, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor),
        )
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **SHAPE)
    model = llama_from_jax(qtree, cfg, device="cpu")
    back = llama_params_to_numpy(model)
    for path in _jax_quantized_paths(jq.quantize_params(params)):
        node_in, node_out = qtree, back
        for key in path.split("/"):
            node_in, node_out = node_in[key], node_out[key]
        q_in = node_in["q"] if leaf_form == "dict" else node_in.q
        scale_in = node_in["scale"] if leaf_form == "dict" else node_in.scale
        assert node_out["q"].dtype == np.int8 and node_out["scale"].dtype == np.float32
        np.testing.assert_array_equal(node_out["q"], q_in)
        np.testing.assert_array_equal(node_out["scale"], scale_in)
    np.testing.assert_array_equal(back["embed"]["embedding"], qtree["embed"]["embedding"])
    # the loaded model is the in-place quantized one: the same logits
    with torch.no_grad():
        loaded = model(torch.from_numpy(TOKENS))
        quantized = tq.quantize_params(_port_model(params))(torch.from_numpy(TOKENS))
    assert torch.equal(loaded, quantized)
    flash = llama_from_jax(qtree, dataclasses.replace(cfg, attention_impl="flash"), device="cpu")
    assert {m.impl for m in flash.modules() if isinstance(m, tq.QuantizedKernel)} == {"pallas"}
    np.testing.assert_allclose(loaded.numpy(), _jax_logits_on_dequantized(module, params), atol=1e-5, rtol=0)


def test_bridge_state_dict_keeps_int8_types(jax_tree):
    _, params = jax_tree
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_params(params))
    cfg = LlamaConfig.tiny(param_dtype=torch.float32, **SHAPE)
    state = llama_params_from_jax(qtree, cfg, dtype=torch.bfloat16)
    assert state["layer_0.attn.q_proj.kernel.q"].dtype == torch.int8
    assert state["layer_0.attn.q_proj.kernel.scale"].dtype == torch.float32
    assert state["layer_0.attn.k_proj.kernel"].dtype == torch.bfloat16  # below min_size: stays float
    with pytest.raises(ValueError, match="leftover"):
        llama_params_from_jax({**qtree, "extra": np.zeros(3, np.float32)}, cfg)
