"""The port's encoder models (``unionml_tpu_torch/models/{layers,bert,vit,mlp}.py``
and their bridges in ``convert.py``) against the JAX package's, on the CPU.

The same seeded numpy inputs and the same weights (a JAX ``init`` carried
across by ``bert_from_jax``, ``vit_from_jax``, ``mlp_from_jax`` or
``state_dict_from_jax``) go through both packages at the ``tiny()``
configs. Tolerances, where nothing else is said: 1e-5 absolute and relative
on f32 forwards (the two frameworks sum in other orders).

- the encoder layers: flax ``LayerNorm`` (eps 1e-6, the fast variance),
  ``jax.nn.gelu``'s tanh form, ``MLP(gated=False)``, the encoder
  ``TransformerBlock`` with and without a padding mask, and under
  ``attention_impl="flash"`` (the kernels' CPU twins, non-causal) against
  ``"xla"``;
- ``BertEncoder`` with a mask, with token-type ids and with neither, the
  tree without ``type_embed``, ``classification_loss`` on 2- and 3-tuples;
- ``ViT``: the conv layout, the patch order, the refusal of an image size
  the patch does not divide;
- ``MLPClassifier`` on ``[B, 28, 28]``;
- a bf16-compute forward of each model within a stated tolerance;
- each bridge's round trip, leaf for leaf; ``bert_params_from_hf_state_dict``
  against ``load_hf_bert_params`` on an HF-named dict;
- ``init_weights``' laws for the new leaves;
- 3 steps of the port's ``fit`` against JAX's ``fit`` (Adam) for tiny BERT
  and tiny ViT: losses and parameters.
"""

import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax.training import train_state

from unionml_tpu import TrainerConfig as JaxTrainerConfig, make_train_step as jax_make_train_step
from unionml_tpu.models import layers as jl
from unionml_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertEncoder as JaxBertEncoder,
    classification_loss as jax_classification_loss,
    load_hf_bert_params,
)
from unionml_tpu.models.mlp import MLPClassifier as JaxMLPClassifier, MLPConfig as JaxMLPConfig
from unionml_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxViTConfig
from unionml_tpu.train import fit as jax_fit
from unionml_tpu_torch import TrainerConfig, TrainState, fit, make_train_step
from unionml_tpu_torch.models import (
    BertConfig,
    BertEncoder,
    MLPClassifier,
    MLPConfig,
    ViT,
    ViTConfig,
    bert_from_jax,
    bert_params_from_hf_state_dict,
    bert_params_to_numpy,
    classification_loss,
    make_train_state,
    mlp_from_jax,
    mlp_params_to_numpy,
    vit_from_jax,
    vit_params_to_numpy,
)
from unionml_tpu_torch.models import layers as tl
from unionml_tpu_torch.models.convert import state_dict_from_jax

torch.set_num_threads(2)

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
BATCH, SEQ = 4, 16
DIM, HEADS, HIDDEN = 32, 4, 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, tol=TOL):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float32)
    np.testing.assert_allclose(port, np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_leaves(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _tokens(seed=1, batch=BATCH, seq=SEQ, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, size=(batch, seq)).astype(np.int32)


def _padding_mask(batch=BATCH, seq=SEQ, seed=2):
    lengths = np.random.RandomState(seed).randint(1, seq + 1, size=batch)
    lengths[0] = seq
    return (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)


# ---------------------------------------------------------------- layers


def test_layer_norm_matches_flax_within_1e_5():
    """Inputs with a large mean (the fast variance E[x^2] - E[x]^2 is what
    flax computes) and non-trivial scale/bias."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, DIM) * 2 + 4).astype(np.float32)
    params = {"scale": (rng.rand(DIM) + 0.5).astype(np.float32), "bias": rng.randn(DIM).astype(np.float32)}
    ref = fnn.LayerNorm(dtype=jnp.float32).apply({"params": params}, x)
    norm = tl.LayerNorm(DIM, dtype=torch.float32, device="cpu")
    norm.load_state_dict(state_dict_from_jax(params, norm))
    _close(norm(torch.from_numpy(x)), ref)
    assert norm.scale.dtype == norm.bias.dtype == torch.float32


def test_layer_norm_in_bf16_casts_like_flax_within_one_bf16_ulp():
    """bf16 in and out, statistics in f32: the outputs are within one bf16
    ulp (2**-8 relative) of flax's."""
    x = np.random.RandomState(1).randn(4, DIM).astype(np.float32)
    ref = fnn.LayerNorm(dtype=jnp.bfloat16).init_with_output(KEY, jnp.asarray(x, jnp.bfloat16))[0]
    out = tl.LayerNorm(DIM, dtype=torch.bfloat16, device="cpu")(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=2.0 ** -8, atol=2.0 ** -8)


def test_gelu_is_jax_default_tanh_form_within_1e_6():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    port = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(port.numpy(), np.asarray(jax.nn.gelu(x)), atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert np.abs(erf.numpy() - np.asarray(jax.nn.gelu(x))).max() > 1e-4  # the erf form is another function


def test_plain_gelu_mlp_matches_flax():
    x = np.random.RandomState(3).randn(2, 5, DIM).astype(np.float32)
    jax_mlp = jl.MLP(hidden_dim=HIDDEN, gated=False, dtype=jnp.float32)
    params = _np(jax_mlp.init(KEY, x)["params"])
    assert set(params) == {"wi", "wo"} and set(params["wi"]) == {"kernel"}
    mlp = tl.MLP(DIM, HIDDEN, gated=False, dtype=torch.float32, device="cpu")
    mlp.load_state_dict(state_dict_from_jax(params, mlp))
    _close(mlp(torch.from_numpy(x)), jax_mlp.apply({"params": params}, x))


@pytest.fixture(scope="module")
def encoder_block():
    x = np.random.RandomState(4).randn(BATCH, SEQ, DIM).astype(np.float32)
    jax_block = jl.TransformerBlock(n_heads=HEADS, hidden_dim=HIDDEN, decoder=False, dtype=jnp.float32)
    params = _np(jax_block.init(KEY, x)["params"])
    return x, jax_block, params


def _port_block(params, impl="auto"):
    block = tl.TransformerBlock(DIM, HEADS, HIDDEN, decoder=False, attention_impl=impl, dtype=torch.float32,
                                device="cpu")
    block.load_state_dict(state_dict_from_jax(params, block))
    return block


def test_encoder_block_tree_is_flax_names(encoder_block):
    _, _, params = encoder_block
    assert set(params) == {"attn_norm", "attn", "mlp_norm", "mlp"}
    assert set(params["attn_norm"]) == {"scale", "bias"} and set(params["mlp"]) == {"wi", "wo"}
    block = _port_block(params)
    assert isinstance(block.attn_norm, tl.LayerNorm) and not block.attn.causal and not block.attn.rope


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padding-mask"])
def test_encoder_block_matches_flax(encoder_block, masked):
    x, jax_block, params = encoder_block
    mask = _padding_mask()[:, None, None, :].astype(bool) if masked else None
    ref = jax_block.apply({"params": params}, x, mask=None if mask is None else jnp.asarray(mask))
    port = _port_block(params)(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    _close(port, ref)


def test_encoder_block_flash_twins_match_plain_route_non_causal(encoder_block):
    """``attention_impl="flash"`` sends the unmasked encoder call to the
    flash entry non-causal (the kernels' CPU twins here): output and input
    gradient within 1e-5 of the plain route, and of flax's."""
    x, jax_block, params = encoder_block
    outs, grads = [], []
    for impl in ("flash", "xla"):
        inp = torch.from_numpy(x).requires_grad_()
        out = _port_block(params, impl)(inp)
        out.backward(torch.ones_like(out))
        outs.append(out.detach())
        grads.append(inp.grad)
    _close(outs[0], outs[1].numpy())
    _close(grads[0], grads[1].numpy())
    _close(outs[0], jax_block.apply({"params": params}, x))


def test_decoder_block_keeps_its_tree():
    block = tl.TransformerBlock(DIM, HEADS, HIDDEN, 2, rope=True, dtype=torch.float32, device="meta")
    assert isinstance(block.attn_norm, tl.RMSNorm) and block.attn.causal and block.mlp.gated
    assert sorted(n for n, _ in block.named_parameters() if n.startswith("mlp.")) == [
        "mlp.wg.kernel", "mlp.wi.kernel", "mlp.wo.kernel"]


# ---------------------------------------------------------------- BERT


@pytest.fixture(scope="module")
def bert():
    cfg = JaxBertConfig.tiny(dtype=jnp.float32)
    module = JaxBertEncoder(cfg)
    tokens = _tokens()
    types_ = np.random.RandomState(5).randint(0, cfg.type_vocab_size, size=tokens.shape).astype(np.int32)
    plain = _np(module.init(KEY, tokens)["params"])
    typed = _np(module.init(KEY, tokens, None, types_)["params"])
    return module, plain, typed, tokens, types_


def test_bert_tree_has_no_type_embed_unless_init_saw_token_types(bert):
    _, plain, typed, _, _ = bert
    assert sorted(plain) == ["classifier", "embed_norm", "layer_0", "layer_1", "pooler", "pos_embed", "tok_embed"]
    assert sorted(typed) == sorted([*plain, "type_embed"])
    port = bert_from_jax(plain, BertConfig.tiny(dtype=torch.float32), device="cpu")
    assert port.type_embed is None
    assert sorted(bert_params_to_numpy(port)) == sorted(plain)
    assert bert_from_jax(typed, BertConfig.tiny(dtype=torch.float32), device="cpu").type_embed is not None


@pytest.mark.parametrize("case", ["neither", "mask", "token-types", "mask+token-types"])
def test_bert_logits_match_flax(bert, case):
    module, plain, typed, tokens, types_ = bert
    mask = _padding_mask() if "mask" in case else None
    tt = types_ if "token-types" in case else None
    params = typed if tt is not None else plain
    ref = module.apply({"params": params}, tokens, mask, tt)
    port = bert_from_jax(params, BertConfig.tiny(dtype=torch.float32), device="cpu")
    as_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        _close(port(as_t(tokens), as_t(mask), as_t(tt)), ref)


def test_bert_token_types_without_the_table_raise_in_both(bert):
    module, plain, _, tokens, types_ = bert
    with pytest.raises(Exception):
        module.apply({"params": plain}, tokens, None, types_)
    port = bert_from_jax(plain, BertConfig.tiny(dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="token_types"):
        port(torch.from_numpy(tokens), None, torch.from_numpy(types_))


@pytest.mark.parametrize("arity", [2, 3])
def test_classification_loss_matches_jax(bert, arity):
    module, plain, _, tokens, _ = bert
    labels = np.random.RandomState(6).randint(0, 2, size=(BATCH,)).astype(np.int32)
    mask = _padding_mask()
    batch = (tokens, mask, labels) if arity == 3 else (tokens, labels)
    loss, aux = jax_classification_loss(lambda p, *a: module.apply({"params": p}, *a), plain, batch)
    port = bert_from_jax(plain, BertConfig.tiny(dtype=torch.float32), device="cpu")
    port_loss, port_aux = classification_loss(port, tuple(torch.from_numpy(a) for a in batch))
    _close(port_loss, loss)
    assert float(port_aux["accuracy"]) == float(aux["accuracy"])


# ---------------------------------------------------------------- ViT


@pytest.fixture(scope="module")
def vit():
    cfg = JaxViTConfig.tiny(dtype=jnp.float32)
    module = JaxViT(cfg)
    images = np.random.RandomState(7).randn(3, cfg.image_size, cfg.image_size, cfg.channels).astype(np.float32)
    return module, _np(module.init(KEY, images)["params"]), images


def test_vit_logits_match_flax(vit):
    module, params, images = vit
    port = vit_from_jax(params, ViTConfig.tiny(dtype=torch.float32), device="cpu")
    with torch.no_grad():
        _close(port(torch.from_numpy(images)), module.apply({"params": params}, images))


def test_vit_conv_layout_and_patch_order(vit):
    """The patch kernel stays flax's ``[kh, kw, in, out]``, and patch ``p``
    of the sequence is row ``p // (S / P)``, column ``p % (S / P)`` of the
    image: each patch's embedding equals its pixels times the kernel."""
    _, params, images = vit
    cfg = ViTConfig.tiny(dtype=torch.float32)
    port = vit_from_jax(params, cfg, device="cpu")
    kernel = params["embed"]["patch_embed"]["kernel"]
    assert tuple(port.embed.patch_embed.kernel.shape) == kernel.shape == (8, 8, 3, cfg.dim)
    with torch.no_grad():
        emb = port.embed(torch.from_numpy(images)).numpy()
    side, p = cfg.image_size // cfg.patch_size, cfg.patch_size
    pos = params["embed"]["pos_embed"][0]
    for index in (0, 1, side, cfg.n_patches - 1):
        row, col = divmod(index, side)
        pixels = images[:, row * p:(row + 1) * p, col * p:(col + 1) * p, :]
        want = np.einsum("bhwc,hwcd->bd", pixels, kernel) + params["embed"]["patch_embed"]["bias"]
        np.testing.assert_allclose(emb[:, 1 + index] - pos[1 + index], want, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(emb[:, 0], np.broadcast_to(params["embed"]["cls_token"][0, 0] + pos[0], emb[:, 0].shape))


def test_vit_refuses_an_image_size_the_patch_does_not_divide():
    with pytest.raises(ValueError, match="patch_size"):
        ViT(ViTConfig.tiny(image_size=30), device="meta")
    model = ViT(ViTConfig.tiny(dtype=torch.float32), device="cpu", seed=0)
    with pytest.raises(ValueError, match="not"):
        model(torch.zeros(1, 24, 24, 3))


# ---------------------------------------------------------------- MLP


@pytest.fixture(scope="module")
def mlp():
    module = JaxMLPClassifier(JaxMLPConfig(dtype=jnp.float32))
    x = np.random.RandomState(8).rand(5, 28, 28).astype(np.float32)
    return module, _np(module.init(KEY, x)["params"]), x


def test_mlp_classifier_on_mnist_shapes_matches_flax(mlp):
    module, params, x = mlp
    assert sorted(params) == ["dense_0", "dense_1", "head"] and set(params["head"]) == {"kernel", "bias"}
    port = mlp_from_jax(params, MLPConfig(dtype=torch.float32), device="cpu")
    assert port.dense_0.kernel.shape == (784, 512)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), module.apply({"params": params}, x))


def test_make_train_state_is_adam_over_a_seeded_classifier():
    state = make_train_state(MLPConfig(features=(8,), num_classes=3, dtype=torch.float32), 16, 1e-2, seed=0,
                             device="cpu")
    assert isinstance(state.optimizer, torch.optim.Adam) and state.optimizer.defaults["lr"] == 1e-2
    assert state.optimizer.defaults["betas"] == (0.9, 0.999) and state.optimizer.defaults["eps"] == 1e-8
    assert state.model(torch.zeros(2, 4, 4)).shape == (2, 3)


# ---------------------------------------------------------------- bf16 compute


def test_bf16_compute_forwards_within_stated_tolerance(bert, vit, mlp):
    """bf16 compute, f32 parameters, the same weights as JAX's bf16 forward:
    the logits agree within 0.05 absolute + 0.05 relative (each side rounds
    every matmul, norm and activation output to bf16's 8 significant bits,
    in other orders, over 2 blocks)."""
    module, plain, _, tokens, _ = bert
    jb = JaxBertEncoder(JaxBertConfig.tiny())
    mask = _padding_mask()
    pb = bert_from_jax(plain, BertConfig.tiny(), device="cpu")
    out = pb(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    ref = jb.apply({"params": plain}, tokens, mask)
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(ref, np.float32), atol=0.05, rtol=0.05)

    _, vparams, images = vit
    pv = vit_from_jax(vparams, ViTConfig.tiny(), device="cpu")
    ref = JaxViT(JaxViTConfig.tiny()).apply({"params": vparams}, images)
    np.testing.assert_allclose(pv(torch.from_numpy(images)).float().detach().numpy(), np.asarray(ref, np.float32),
                               atol=0.05, rtol=0.05)

    _, mparams, x = mlp
    pm = mlp_from_jax(mparams, MLPConfig(), device="cpu")
    ref = JaxMLPClassifier(JaxMLPConfig()).apply({"params": mparams}, x)
    np.testing.assert_allclose(pm(torch.from_numpy(x)).float().detach().numpy(), np.asarray(ref, np.float32),
                               atol=0.05, rtol=0.05)


# ---------------------------------------------------------------- bridges


@pytest.mark.parametrize("which", ["bert", "bert-typed", "vit", "mlp"])
def test_bridge_round_trip_leaf_for_leaf(bert, vit, mlp, which):
    if which.startswith("bert"):
        tree = bert[2] if which == "bert-typed" else bert[1]
        back = bert_params_to_numpy(bert_from_jax(tree, BertConfig.tiny(), device="cpu"))
    elif which == "vit":
        tree = vit[1]
        back = vit_params_to_numpy(vit_from_jax(tree, ViTConfig.tiny(), device="cpu"))
    else:
        tree = mlp[1]
        back = mlp_params_to_numpy(mlp_from_jax(tree, MLPConfig(), device="cpu"))
    want, got = _leaves(tree), _leaves(back)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32 and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("which", ["leftover", "missing"])
def test_bridges_refuse_leftover_and_missing_leaves(vit, which):
    tree = jax.tree_util.tree_map(lambda a: a, vit[1])
    if which == "leftover":
        tree["head"]["extra"] = np.zeros(3, np.float32)
    else:
        del tree["embed"]["cls_token"]
    with pytest.raises(ValueError, match=which):
        vit_from_jax(tree, ViTConfig.tiny(), device="cpu")


def _hf_state_dict(tree, cfg, positions):
    """An HF-named BERT state dict (as ``BertModel.state_dict()`` names it)
    from a JAX tree with a type table: the reference's mapping run
    backwards, plus HF's projection biases and position ids, which the
    mapping drops, and ``positions`` rows of the position table."""
    rng = np.random.RandomState(9)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    pos = np.concatenate([tree["pos_embed"]["embedding"], rng.randn(positions - cfg.max_seq_len, cfg.dim)]).astype(
        np.float32)
    sd = {
        "embeddings.word_embeddings.weight": t(tree["tok_embed"]["embedding"]),
        "embeddings.position_embeddings.weight": t(pos),
        "embeddings.token_type_embeddings.weight": t(tree["type_embed"]["embedding"]),
        "embeddings.LayerNorm.weight": t(tree["embed_norm"]["scale"]),
        "embeddings.LayerNorm.bias": t(tree["embed_norm"]["bias"]),
        "embeddings.position_ids": torch.arange(positions)[None],
        "pooler.dense.weight": t(tree["pooler"]["kernel"].T),
        "pooler.dense.bias": t(tree["pooler"]["bias"]),
    }
    for i in range(cfg.n_layers):
        layer, hf = tree[f"layer_{i}"], f"encoder.layer.{i}"
        for name, proj in (("attention.self.query", "q_proj"), ("attention.self.key", "k_proj"),
                           ("attention.self.value", "v_proj"), ("attention.output.dense", "o_proj")):
            sd[f"{hf}.{name}.weight"] = t(layer["attn"][proj]["kernel"].T)
            sd[f"{hf}.{name}.bias"] = t(rng.randn(cfg.dim).astype(np.float32))
        sd[f"{hf}.intermediate.dense.weight"] = t(layer["mlp"]["wi"]["kernel"].T)
        sd[f"{hf}.intermediate.dense.bias"] = t(rng.randn(cfg.hidden_dim).astype(np.float32))
        sd[f"{hf}.output.dense.weight"] = t(layer["mlp"]["wo"]["kernel"].T)
        sd[f"{hf}.output.dense.bias"] = t(rng.randn(cfg.dim).astype(np.float32))
        for name, norm in (("attention.output.LayerNorm", "attn_norm"), ("output.LayerNorm", "mlp_norm")):
            sd[f"{hf}.{name}.weight"] = t(layer[norm]["scale"])
            sd[f"{hf}.{name}.bias"] = t(layer[norm]["bias"])
    return sd


@pytest.mark.parametrize("source", ["mapping", "bert-prefixed file"])
def test_hf_state_dict_gives_load_hf_bert_params_tree(bert, monkeypatch, tmp_path, source):
    """The JAX loader reads the same dict through a stand-in ``AutoModel``
    (nothing is downloaded); both trees are equal leaf for leaf, without a
    classifier and with the position table cut to ``max_seq_len``. With a
    classifier merged in, the tree loads into the port and gives JAX's
    logits."""
    module, _, typed, tokens, types_ = bert
    jcfg = JaxBertConfig.tiny(dtype=jnp.float32)
    sd = _hf_state_dict(typed, jcfg, positions=jcfg.max_seq_len + 16)
    fake = types.SimpleNamespace(AutoModel=types.SimpleNamespace(
        from_pretrained=lambda name: types.SimpleNamespace(state_dict=lambda: sd)))
    monkeypatch.setitem(sys.modules, "transformers", fake)
    want = load_hf_bert_params("stand-in", jcfg)
    cfg = BertConfig.tiny(dtype=torch.float32)
    if source == "mapping":
        got = bert_params_from_hf_state_dict(sd, cfg)
    else:
        path = tmp_path / "pytorch_model.bin"
        torch.save({f"bert.{k}": v for k, v in sd.items()}, path)
        got = bert_params_from_hf_state_dict(str(path), cfg)
    assert "classifier" not in got and got["pos_embed"]["embedding"].shape == (jcfg.max_seq_len, jcfg.dim)
    want_leaves, got_leaves = _leaves(_np(want)), _leaves(got)
    assert sorted(got_leaves) == sorted(want_leaves)
    for key, value in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[key], value, err_msg=key)
    merged = {**got, "classifier": typed["classifier"]}
    with torch.no_grad():
        port = bert_from_jax(merged, cfg, device="cpu")(torch.from_numpy(tokens), None, torch.from_numpy(types_))
    _close(port, module.apply({"params": {**_np(want), "classifier": typed["classifier"]}}, tokens, None, types_))


def test_init_weights_laws_for_encoder_leaves():
    """Conv fan-in is kh*kw*in, cls_token zeros, pos_embed normal(0.02),
    Dense and LayerNorm biases zero, LayerNorm scales one."""
    cfg = ViTConfig(image_size=64, patch_size=16, dim=256, n_layers=1, n_heads=4, hidden_dim=64, num_classes=8)
    model = ViT(cfg, device="cpu", seed=0)
    kernel = model.embed.patch_embed.kernel
    assert abs(kernel.std().item() * math.sqrt(16 * 16 * 3) - 1) < 0.05
    assert torch.all(model.embed.cls_token == 0) and torch.all(model.embed.patch_embed.bias == 0)
    assert abs(model.embed.pos_embed.std().item() - 0.02) < 0.002
    assert torch.all(model.head.head.bias == 0) and torch.all(model.layer_0.attn_norm.bias == 0)
    assert torch.all(model.head.final_norm.scale == 1)
    assert abs(model.layer_0.mlp.wi.kernel.std().item() * math.sqrt(cfg.dim) - 1) < 0.05
    bert_model = BertEncoder(BertConfig.tiny(), device="cpu", seed=0, token_types=True)
    assert abs(bert_model.type_embed.embedding.std().item() * math.sqrt(128) - 1) < 0.3
    assert torch.all(bert_model.pooler.bias == 0) and torch.all(bert_model.embed_norm.bias == 0)


@pytest.mark.parametrize("entry", ["BertEncoder", "ViT", "MLPClassifier", "make_train_state", "bert_from_jax"])
def test_encoder_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, bert, entry):
    plain = bert[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "BertEncoder": lambda: BertEncoder(BertConfig.tiny()),
        "ViT": lambda: ViT(ViTConfig.tiny()),
        "MLPClassifier": lambda: MLPClassifier(MLPConfig(), 16),
        "make_train_state": lambda: make_train_state(MLPConfig(), 16),
        "bert_from_jax": lambda: bert_from_jax(plain, BertConfig.tiny()),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()


# ---------------------------------------------------------------- fit


FIT_LR, FIT_BATCH, FIT_ROWS = 1e-3, 8, 24


def _jax_fit(module, params, data, loss_fn):
    state = train_state.TrainState.create(apply_fn=module.apply, params=jax.tree_util.tree_map(jnp.asarray, params),
                                          tx=optax.adam(FIT_LR))
    step = jax_make_train_step(loss_fn, has_aux=True)
    return jax_fit(state, step, data, JaxTrainerConfig(epochs=1, batch_size=FIT_BATCH, seed=3, log_every_steps=1))


def _port_fit(model, data, loss_fn):
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=FIT_LR, betas=(0.9, 0.999), eps=1e-8))
    step = make_train_step(loss_fn, has_aux=True)
    return fit(state, step, data, TrainerConfig(epochs=1, batch_size=FIT_BATCH, seed=3, log_every_steps=1),
               device="cpu")


def _vit_ce(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels.reshape(-1)).mean()


def _compare_fits(ref, result, tree_back):
    """Losses: 1e-5 relative. Parameters after 3 Adam steps at lr 1e-3: 1e-6
    on the mean difference, and at most 1e-4 of all entries beyond 1e-5.
    Adam's step is ``lr * m / (sqrt(v) + 1e-8)``, so for a gradient near
    ``1e-8`` both sides' f32 rounding of it moves a sizable part of a step
    (the ViT's patch kernel: 4 of 291,722 entries beyond 1e-5, the largest
    3.7e-4); no entry may move more than the steps can, 2 * lr * steps."""
    assert result.steps == ref.steps == FIT_ROWS // FIT_BATCH
    np.testing.assert_allclose([h["loss"] for h in result.history], [h["loss"] for h in ref.history], rtol=1e-5)
    want, got = _leaves(_np(ref.state.params)), _leaves(tree_back)
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.mean() <= 1e-6 and (diffs > 1e-5).mean() <= 1e-4, (diffs.mean(), (diffs > 1e-5).sum())
    assert diffs.max() <= 2 * FIT_LR * result.steps, diffs.max()


def test_fit_bert_three_steps_matches_jax_fit(bert):
    module, plain, _, _, _ = bert
    tokens = _tokens(seed=10, batch=FIT_ROWS)
    mask = _padding_mask(batch=FIT_ROWS, seed=11)
    labels = np.random.RandomState(12).randint(0, 2, size=(FIT_ROWS,)).astype(np.int32)
    ref = _jax_fit(module, plain, [tokens, mask, labels],
                   lambda p, b: jax_classification_loss(lambda pp, *a: module.apply({"params": pp}, *a), p, b))
    model = bert_from_jax(plain, BertConfig.tiny(dtype=torch.float32), device="cpu")
    result = _port_fit(model, [tokens, mask, labels], classification_loss)
    _compare_fits(ref, result, bert_params_to_numpy(result.state.model))
    assert "accuracy" in result.history[-1]


def test_fit_vit_three_steps_matches_jax_fit(vit):
    module, params, _ = vit
    cfg = JaxViTConfig.tiny()
    images = np.random.RandomState(13).randn(FIT_ROWS, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    labels = np.random.RandomState(14).randint(0, cfg.num_classes, size=(FIT_ROWS,)).astype(np.int32)

    def jax_loss(p, batch):
        return _vit_ce(module.apply({"params": p}, batch[0]), batch[1]), {}

    def port_loss(model, batch):
        return torch.nn.functional.cross_entropy(model(batch[0]).float(), batch[1].reshape(-1).long()), {}

    ref = _jax_fit(module, params, [images, labels], jax_loss)
    result = _port_fit(vit_from_jax(params, ViTConfig.tiny(dtype=torch.float32), device="cpu"), [images, labels],
                       port_loss)
    _compare_fits(ref, result, vit_params_to_numpy(result.state.model))
