"""The paged decode attention wrapper and its plain twin.

On the CPU the port's ``paged_decode_attention`` takes its plain twin; it is
held against the JAX package's gather path (``pool[:, table]`` back to the
logical layout under the ``slot < length`` mask, then
``dot_product_attention`` — the oracle the JAX tests use, since its Pallas
kernel has no CPU mode). Tolerance 1e-5 absolute at f32. The hand-written
kernel itself runs only on a CUDA card with sm_90: its test is marked
``cuda`` and skips elsewhere. On the card it runs without JAX installed
(``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``),
so this file imports JAX only where the CPU parity test needs it.
"""

import numpy as np
import pytest
import torch

from unionml_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

HEADS, KV_HEADS, HEAD_DIM = 8, 2, 16  # GQA 4:1
PAGE, PAGES_PER_SEQ = 16, 4


def _inputs(lengths, seed=0):
    rng = np.random.RandomState(seed)
    batch = len(lengths)
    n_pages = batch * PAGES_PER_SEQ + 1  # + a scratch page
    q = rng.randn(batch, HEADS, HEAD_DIM).astype(np.float32)
    k = rng.randn(KV_HEADS, n_pages, PAGE, HEAD_DIM).astype(np.float32)
    v = rng.randn(KV_HEADS, n_pages, PAGE, HEAD_DIM).astype(np.float32)
    table = rng.permutation(n_pages - 1)[: batch * PAGES_PER_SEQ].reshape(batch, PAGES_PER_SEQ).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


def _jax_gather_path(q, k, v, lengths, table):
    import jax.numpy as jnp

    from unionml_tpu.ops.attention import dot_product_attention as jax_attention

    def logical(pool):
        rows = jnp.asarray(pool)[:, table]  # [H_kv, B, MB, bs, D]
        rows = rows.reshape(rows.shape[0], rows.shape[1], -1, rows.shape[-1])
        return jnp.transpose(rows, (1, 2, 0, 3))

    keys, values = logical(k), logical(v)
    visible = (jnp.arange(keys.shape[1])[None, :] < jnp.asarray(lengths)[:, None])[:, None, None, :]
    return np.asarray(jax_attention(jnp.asarray(q)[:, None], keys, values, mask=visible)[:, 0])


@pytest.mark.parametrize(
    "lengths",
    [(1, 16, 32, 21), (64, 7, 48, 1), (0, 33, 17, 64)],
    ids=["one-and-page-boundaries", "table-end-and-ragged", "empty-row"],
)
def test_cpu_wrapper_matches_jax_gather_path(lengths):
    q, k, v, lens, table = _inputs(lengths)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*map(torch.from_numpy, (q, k, v, lens, table)))
    assert pa.paged_decode_attention.launches == before  # CPU tensors never launch the kernel
    assert out.shape == (len(lengths), HEADS, HEAD_DIM) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_gather_path(q, k, v, lens, table), atol=1e-5, rtol=0)
    for row, length in enumerate(lengths):
        if length == 0:
            assert torch.count_nonzero(out[row]) == 0


@pytest.mark.parametrize(
    "bad",
    ["lengths-int64", "pool-mismatch", "q-bf16-pool-f32", "table-noncontiguous"],
)
def test_kernel_inputs_are_checked(bad):
    """What the CUDA launch would refuse is refused in Python, before any
    pointer reaches the kernel (the checks are device-independent)."""
    q, k, v, lens, table = map(torch.from_numpy, _inputs((3, 5)))
    if bad == "lengths-int64":
        lens = lens.long()
    elif bad == "pool-mismatch":
        v = v[:, :, :8]
    elif bad == "q-bf16-pool-f32":
        q = q.bfloat16()
    else:
        table = torch.cat([table, table], dim=1)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        pa._check(q, k, v, lens, table)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_twin_on_card(dtype):
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card with sm_90 (the kernel has no CPU mode)")
    dtype = getattr(torch, dtype)
    q, k, v, lens, table = (torch.from_numpy(a).cuda() for a in _inputs((1, 16, 33, 64)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, k, v, lens, table)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_reference(q, k, v, lens, table)
    # bf16: the kernel pre-scales q and keeps f32 throughout; the twin rounds scores and weights to bf16
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
