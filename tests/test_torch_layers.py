"""Parity of the port's layers (``unionml_tpu_torch.models.layers`` and
``ops.attention``) with the JAX package's, at tiny f32 sizes on the CPU.

Inputs are made with numpy from a seed and handed to both; flax parameters
reach the port through the weight bridge. Tolerance: 1e-5 absolute (f32, the
two frameworks sum in different orders); int8 KV rows must be bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import layers as jl
from unionml_tpu.ops.attention import dot_product_attention as jax_attention
from unionml_tpu_torch.models import layers as tl
from unionml_tpu_torch.models.convert import state_dict_from_jax
from unionml_tpu_torch.ops.attention import dot_product_attention, multihead_attention

torch.set_num_threads(2)

ATOL = 1e-5
DIM, HEADS, KV_HEADS = 32, 4, 2
HEAD_DIM = DIM // HEADS


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32), atol=atol, rtol=0)


def test_rms_norm_matches_flax():
    x = np.random.RandomState(0).randn(2, 5, DIM).astype(np.float32) * 3
    scale = np.random.RandomState(1).rand(DIM).astype(np.float32) + 0.5
    ref = jl.RMSNorm(dtype=jnp.float32).apply({"params": {"scale": scale}}, x)
    norm = tl.RMSNorm(DIM, dtype=torch.float32, device="cpu")
    norm.load_state_dict(state_dict_from_jax({"scale": scale}, norm))
    _close(norm(torch.from_numpy(x)).detach(), ref)


@pytest.mark.parametrize("per_example", [False, True], ids=["positions[L]", "positions[B,L]"])
def test_rotary_embedding_interleaved_pairs(per_example):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, HEADS, HEAD_DIM).astype(np.float32)
    positions = rng.randint(0, 500, size=(2, 6) if per_example else (6,)).astype(np.int32)
    ref = jl.rotary_embedding(jnp.asarray(x), jnp.asarray(positions), 500000.0)
    port = tl.rotary_embedding(torch.from_numpy(x), torch.from_numpy(positions), 500000.0)
    _close(port, ref)


def test_quantize_kv_rows_bit_equal():
    x = np.random.RandomState(3).randn(3, 7, KV_HEADS, HEAD_DIM).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 scale floor
    ref_rows, ref_scale = jl.quantize_kv_rows(jnp.asarray(x))
    rows, scale = tl.quantize_kv_rows(torch.from_numpy(x))
    assert rows.dtype == torch.int8
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))


def _attention_case(name):
    rng = np.random.RandomState(4)
    q = rng.randn(2, 3, HEADS, HEAD_DIM).astype(np.float32)
    k = rng.randn(2, 7, KV_HEADS, HEAD_DIM).astype(np.float32)
    v = rng.randn(2, 7, KV_HEADS, HEAD_DIM).astype(np.float32)
    if name == "gqa":
        return (q, k, v), {}
    if name == "causal-offset":  # Lq < Lk: the diagonal shifts by k_len - q_len
        return (q, k, v), {"causal": True}
    mask = rng.rand(2, 1, 3, 7) < 0.5
    mask[1, 0, 2] = False  # a query row with no visible key returns 0
    return (q, k, v), {"mask": mask}


@pytest.mark.parametrize("name", ["gqa", "causal-offset", "mask-with-empty-row"])
def test_dot_product_attention_matches_jax(name):
    (q, k, v), kw = _attention_case(name)
    ref = jax_attention(*map(jnp.asarray, (q, k, v)), **{a: jnp.asarray(b) if a == "mask" else b for a, b in kw.items()})
    port = dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), **{a: torch.from_numpy(b) if a == "mask" else b for a, b in kw.items()}
    )
    _close(port, ref)
    if name == "mask-with-empty-row":
        assert torch.count_nonzero(port[1, 2]) == 0


def test_flash_forward_without_mask_raises_not_quietly_plain(monkeypatch):
    """An unmasked ``impl="flash"`` call never quietly takes the plain path:
    it reaches ``flash_attention`` (whose CUDA tensors launch the kernels or
    raise), with grouped-query K/V unexpanded."""
    from unionml_tpu_torch.ops import attention as attention_module

    seen = []

    def spy(q, k, v, *, causal):
        seen.append((tuple(k.shape), causal))
        return torch.zeros_like(q)

    monkeypatch.setattr(attention_module, "flash_attention", spy)
    monkeypatch.setattr(attention_module, "dot_product_attention", lambda *a, **kw: pytest.fail("took the plain path"))
    q, kv = torch.zeros(1, 2, HEADS, HEAD_DIM), torch.zeros(1, 2, KV_HEADS, HEAD_DIM)
    multihead_attention(q, kv, kv, causal=True, impl="flash")
    assert seen == [((1, 2, KV_HEADS, HEAD_DIM), True)]


def test_lora_dense_matches_flax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, DIM).astype(np.float32)
    tree = {
        "kernel": rng.randn(DIM, 16).astype(np.float32),
        "lora_a": rng.randn(DIM, 4).astype(np.float32),
        "lora_b": rng.randn(4, 16).astype(np.float32),  # nonzero, so the alpha/rank scaling shows
    }
    ref = jl.LoRADense(16, rank=4, dtype=jnp.float32).apply({"params": tree}, x)
    dense = tl.LoRADense(DIM, 16, rank=4, dtype=torch.float32, device="cpu")
    dense.load_state_dict(state_dict_from_jax(tree, dense))
    _close(dense(torch.from_numpy(x)).detach(), ref, atol=1e-4)


def test_lora_dense_gradients_match_flax():
    """dW, dA, dB and dx of ``sum(y * w)`` equal flax's (1e-4 absolute: f32
    sums over 32 inputs and 6 rows in different orders)."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, DIM).astype(np.float32)
    w = rng.randn(2, 3, 16).astype(np.float32)
    tree = {"kernel": rng.randn(DIM, 16).astype(np.float32), "lora_a": rng.randn(DIM, 4).astype(np.float32),
            "lora_b": rng.randn(4, 16).astype(np.float32)}
    module = jl.LoRADense(16, rank=4, dtype=jnp.float32)
    ref_params, ref_x = jax.grad(
        lambda p, xx: (module.apply({"params": p}, xx) * w).sum(), argnums=(0, 1)
    )(tree, jnp.asarray(x))
    dense = tl.LoRADense(DIM, 16, rank=4, dtype=torch.float32, device="cpu")
    dense.load_state_dict(state_dict_from_jax(tree, dense))
    tx = torch.from_numpy(x).requires_grad_()
    (dense(tx) * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, ref_x, atol=1e-4)
    for name in tree:
        _close(getattr(dense, name).grad, ref_params[name], atol=1e-4)


def test_iota_embed_gradient_equals_the_one_hot_backward():
    """``F.embedding``'s scatter-add gives the table gradient of the JAX
    module's one-hot-matmul backward, repeated tokens included."""
    tokens = np.array([[1, 3, 3], [0, 7, 1]], np.int32)
    table = np.random.RandomState(8).randn(8, DIM).astype(np.float32)
    g = np.random.RandomState(9).randn(2, 3, DIM).astype(np.float32)
    module = jl.IotaEmbed(8, DIM, dtype=jnp.float32)
    ref = jax.grad(lambda p: (module.apply({"params": p}, jnp.asarray(tokens)) * g).sum())({"embedding": table})
    embed = tl.IotaEmbed(8, DIM, dtype=torch.float32, device="cpu")
    embed.load_state_dict(state_dict_from_jax({"embedding": table}, embed))
    (embed(torch.from_numpy(tokens)) * torch.from_numpy(g)).sum().backward()
    _close(embed.embedding.grad, ref["embedding"])


# ---------------------------------------------------------------- Attention cache branches

BLOCK, N_BLOCKS, MAX_BLOCKS = 4, 9, 4  # block 8 is the scratch block


@pytest.fixture(scope="module")
def attention_params():
    module = jl.Attention(n_heads=HEADS, n_kv_heads=KV_HEADS, causal=True, rope=True,
                          dtype=jnp.float32, param_dtype=jnp.float32)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, DIM)))["params"]
    return _np_tree(params)


def _caches(kind, batch, length=12):
    """Matching numpy caches for both sides: zeros (with int8 pools), plus a
    block table giving each row disjoint blocks (paged)."""
    last = lambda name: 1 if name.endswith("_scale") else HEAD_DIM  # noqa: E731
    names = ("k", "v", "k_scale", "v_scale") if kind.endswith("int8") else ("k", "v")
    dtype = lambda name: np.float32 if name.endswith("_scale") or not kind.endswith("int8") else np.int8  # noqa: E731
    if kind.startswith("paged"):
        cache = {n: np.zeros((KV_HEADS, N_BLOCKS, BLOCK, last(n)), dtype(n)) for n in names}
        cache["table"] = np.array([[0, 3, 5, 8], [1, 2, 4, 6]], np.int32)[:batch]
    else:
        cache = {n: np.zeros((batch, length, KV_HEADS, last(n)), dtype(n)) for n in names}
    return cache


@pytest.mark.parametrize(
    "kind,port_impl",
    [("uncached", "auto"), ("dense", "auto"), ("dense-int8", "auto"), ("paged", "auto"),
     ("paged", "flash"), ("paged-int8", "flash")],
)
def test_attention_branches_match_flax(attention_params, kind, port_impl):
    """Prefill 5 tokens at per-example offsets, then one decode step; outputs
    and every cache buffer match. The JAX side always reads the paged pool
    through its gather path: its Pallas kernel has no CPU mode. The port's
    ``impl="flash"`` decode goes through ``paged_decode_attention``, whose CPU
    tensors take the plain twin."""
    rng = np.random.RandomState(6)
    batch = 2
    jax_mod = jl.Attention(n_heads=HEADS, n_kv_heads=KV_HEADS, causal=True, rope=True,
                           dtype=jnp.float32, param_dtype=jnp.float32)
    port = tl.Attention(DIM, HEADS, KV_HEADS, causal=True, rope=True, impl=port_impl,
                        dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    port.load_state_dict(state_dict_from_jax(attention_params, port))
    variables = {"params": attention_params}
    prefill = rng.randn(batch, 5, DIM).astype(np.float32)
    if kind == "uncached":
        ref = jax_mod.apply(variables, prefill)
        with torch.no_grad():
            _close(port(torch.from_numpy(prefill)), ref)
        return
    starts = np.array([0, 3], np.int32)
    steps = [(prefill, starts[:, None] + np.arange(5)[None]),
             (rng.randn(batch, 1, DIM).astype(np.float32), starts[:, None] + 5)]
    jcache = {n: jnp.asarray(a) for n, a in _caches(kind, batch).items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in _caches(kind, batch).items()}
    for x, positions in steps:
        ref, jcache = jax_mod.apply(variables, x, jnp.asarray(positions), None, jcache)
        with torch.no_grad():
            out, tcache = port(torch.from_numpy(x), torch.from_numpy(positions.astype(np.int32)), None, tcache)
        _close(out, ref)
        for name in jcache:
            if name == "table":
                continue
            if jcache[name].dtype == jnp.int8:
                np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(jcache[name]))
            else:
                _close(tcache[name], jcache[name])
