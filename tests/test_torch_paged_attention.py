"""The paged decode attention wrapper and its plain twin.

On the CPU the port's ``paged_decode_attention`` takes its plain twin; it is
held against the JAX package's gather path (``pool[:, table]`` back to the
logical layout under the ``slot < length`` mask, then
``dot_product_attention`` — the oracle the JAX tests use, since its Pallas
kernel has no CPU mode). Tolerance 1e-5 absolute at f32. The hand-written
kernel itself runs only on a CUDA card with sm_90: its tests are marked
``cuda`` and skip elsewhere. On the CPU the kernel's split-and-combine
algorithm is checked through its plain spelling,
``paged_decode_attention_split_reference`` (f32, 1e-5 absolute against the
same gather path), with the launch plan and the input checks. The int8-page
mode (``k_scales``/``v_scales``) is held the same way: its twin against the
JAX package's int8 gather path over a pool its ``quantize_kv_rows`` made, the
scale checks in Python, and its own kernel against the twin on the card. On
the card it runs without JAX installed
(``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``),
so this file imports JAX only where the CPU parity tests need it.
"""

import numpy as np
import pytest
import torch

from unionml_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

HEADS, KV_HEADS, HEAD_DIM = 8, 2, 16  # GQA 4:1
PAGE, PAGES_PER_SEQ = 16, 4


#: visible lengths: empty, one, a page edge, ragged, two edges, the full table and past it (clamped)
LENGTH_CASES = (0, 1, 16, 21, 33, 64, 100)


def _inputs(lengths, seed=0, head_dim=HEAD_DIM, heads=HEADS, kv_heads=KV_HEADS, pages_per_seq=PAGES_PER_SEQ,
            page=PAGE):
    rng = np.random.RandomState(seed)
    batch = len(lengths)
    n_pages = batch * pages_per_seq + 1  # + a scratch page
    q = rng.randn(batch, heads, head_dim).astype(np.float32)
    k = rng.randn(kv_heads, n_pages, page, head_dim).astype(np.float32)
    v = rng.randn(kv_heads, n_pages, page, head_dim).astype(np.float32)
    table = rng.permutation(n_pages - 1)[: batch * pages_per_seq].reshape(batch, pages_per_seq).astype(np.int32)
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


@pytest.mark.parametrize("splits", [1, 2, 3, PAGES_PER_SEQ])
@pytest.mark.parametrize(
    "lengths",
    [(0, 1, 16, 21), (33, 64, 100, 48), (64, 0, 5, 32)],
    ids=["empty-one-edge-ragged", "edges-full-past-table", "full-empty-short-edge"],
)
def test_split_reference_matches_jax_gather_path(lengths, splits):
    """The kernel's split-and-combine algorithm, spelled out in torch: per
    split partials combined in split order agree with the gather path at f32
    within 1e-5, for every split count, also where a split sees no key (with
    3 splits of 2 pages the last split is always past the 4-page table)."""
    q, k, v, lens, table = _inputs(lengths, seed=len(lengths) + splits)
    out = pa.paged_decode_attention_split_reference(*map(torch.from_numpy, (q, k, v, lens, table)), splits)
    assert out.shape == (len(lengths), HEADS, HEAD_DIM) and out.dtype == torch.float32
    assert not torch.isnan(out).any()
    np.testing.assert_allclose(out.numpy(), _jax_gather_path(q, k, v, lens, table), atol=1e-5, rtol=0)
    for row, length in enumerate(lengths):
        if length == 0:
            assert torch.count_nonzero(out[row]) == 0


@pytest.mark.parametrize(
    "shape",
    [
        (4, 8, 4, 19, 4096),  # the served shape (Llama-3-8B width, 16-position bf16 pages)
        (8, 8, 4, 128, 4096),  # B=8, ctx=2048
        (1, 8, 4, 512, 4096),  # B=1, ctx=8192
        (64, 8, 4, 19, 4096),  # enough rows to fill the card unsplit
        (2, 2, 12, 7, 2048),  # a group of 12 heads: two head tiles
        (3, 1, 1, 1, 65536),  # one page a row, pages too large for two stages
        (1, 2, 4, 4, 1024),  # the CPU tests' geometry
    ],
)
def test_plan_covers_every_page_once(shape):
    batch, n_kv, group, pages, page_bytes = shape
    plan = pa._plan(batch, n_kv, group, pages, page_bytes, 132)
    runs = [range(s * plan.pages_per_split, min((s + 1) * plan.pages_per_split, pages)) for s in range(plan.splits)]
    assert [p for run in runs for p in run] == list(range(pages))  # every page once, in order
    assert all(len(run) > 0 for run in runs)  # no split is empty at full length
    grid_x = plan.splits  # the splits of one (row, KV head, head tile) are one cluster along x
    assert 1 <= plan.splits <= pa._MAX_CLUSTER and grid_x % plan.splits == 0
    assert 1 <= plan.stages <= min(pa._MAX_STAGES, plan.pages_per_split)
    assert plan.stages == 1 or 2 * page_bytes * plan.stages <= pa._RING_BYTES


@pytest.mark.parametrize("head_dim", [12, 20, 264, 512])
def test_check_refuses_head_sizes_the_kernel_does_not_take(head_dim):
    q, k, v, lens, table = map(torch.from_numpy, _inputs((3, 5), head_dim=head_dim))
    with pytest.raises(ValueError, match="head_dim"):
        pa._check(q, k, v, lens, table)


def _card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card with sm_90 (the kernel has no CPU mode)")


def _on_card(arrays, dtype):
    q, k, v, lens, table = (torch.from_numpy(a).cuda() for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), lens, table


def _assert_matches_twin(q, k, v, lens, table):
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, k, v, lens, table)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_reference(q, k, v, lens, table)
    # bf16: the kernel pre-scales q and keeps f32 throughout; the twin rounds scores and weights to bf16
    atol, rtol = (1e-5, 0.0) if q.dtype == torch.float32 else (2e-2, 2e-2)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    for row, length in enumerate(lens.tolist()):
        if length == 0:
            assert torch.count_nonzero(out[row]) == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4, 8])
@pytest.mark.parametrize("head_dim", [16, 24, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_twin_on_card(dtype, head_dim, batch):
    """Every length case at every head size the package uses (16, 32, 64,
    128) and at the kernel's edges (24: lanes of a key row left idle; 96: the
    tensor-core route's odd tile count; 256: the largest), for B = 1 (each
    case alone), 4 and 8 (the cases side by side, rotated)."""
    _card()
    dtype = getattr(torch, dtype)
    n = len(LENGTH_CASES)
    cases = [(length,) for length in LENGTH_CASES] if batch == 1 else [
        tuple(LENGTH_CASES[(i + shift) % n] for i in range(batch)) for shift in (0, 3)]
    for seed, lengths in enumerate(cases):
        _assert_matches_twin(*_on_card(_inputs(lengths, seed=seed, head_dim=head_dim), dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("heads,kv_heads", [(8, 8), (6, 2), (24, 2)], ids=["mha", "group-3", "group-12"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_head_groups_on_card(dtype, heads, kv_heads):
    """Groups of one head, of a size that is no power of two, and of more
    heads than one block takes (two head tiles)."""
    _card()
    arrays = _inputs((21, 64, 0, 100), seed=3, head_dim=64, heads=heads, kv_heads=kv_heads)
    _assert_matches_twin(*_on_card(arrays, getattr(torch, dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_page_sizes_on_card(dtype, page):
    """Pages of 8 positions (half a tensor-core key group, the rest masked) and of 32 (two groups)."""
    _card()
    lengths = (0, 1, page, page + 3, 4 * page, 100)
    arrays = _inputs(lengths, seed=6, head_dim=128, page=page)
    _assert_matches_twin(*_on_card(arrays, getattr(torch, dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_long_table_on_card(dtype):
    """A 256-page table: each split walks more pages than its ring has
    stages, so stages are refilled."""
    _card()
    arrays = _inputs((4096, 2500, 17, 5000), seed=4, head_dim=128, pages_per_seq=256)
    plan = pa._plan(4, KV_HEADS, HEADS // KV_HEADS, 256, PAGE * 128 * getattr(torch, dtype).itemsize,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.pages_per_split > plan.stages
    _assert_matches_twin(*_on_card(arrays, getattr(torch, dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_is_deterministic_and_one_launch_on_card(dtype):
    """Two calls give the same bits; one call is exactly one device kernel
    (no scale, memset or combine kernel) and never synchronises the host."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    q, k, v, lens, table = _on_card(_inputs((4096, 21, 0, 1000), seed=5, head_dim=128, pages_per_seq=256),
                                    getattr(torch, dtype))
    once = pa.paged_decode_attention(q, k, v, lens, table)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host read of lengths or the table would raise
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = pa.paged_decode_attention(q, k, v, lens, table)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(once, again)
    device_events = [e for e in prof.events() if str(e.device_type).endswith("CUDA") and e.device_time > 0]
    assert len(device_events) == 1, [e.name for e in device_events]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [12, 264])
def test_kernel_raises_rather_than_falls_back_on_card(head_dim):
    _card()
    q, k, v, lens, table = _on_card(_inputs((3, 5), head_dim=head_dim), torch.float32)
    before = pa.paged_decode_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(q, k, v, lens, table)
    assert pa.paged_decode_attention.launches == before


# ------------------------------------------------------------------ the int8-page mode


def _jax_quantize(x):
    import jax.numpy as jnp

    from unionml_tpu.models.layers import quantize_kv_rows as jax_quantize_kv_rows

    return tuple(np.asarray(a) for a in jax_quantize_kv_rows(jnp.asarray(x)))


def _port_quantize(x):
    from unionml_tpu_torch.models.layers import quantize_kv_rows

    return tuple(a.numpy() for a in quantize_kv_rows(torch.from_numpy(x)))


def _int8_inputs(lengths, seed=0, head_dim=HEAD_DIM, quantize=_port_quantize, **kw):
    """The float inputs with K/V quantized per (position, head) (int8 values,
    f32 scales ``[..., 1]``) by ``quantize``: the port's ``quantize_kv_rows``
    (the card tests, which run without JAX) or the JAX package's."""
    q, k, v, lens, table = _inputs(lengths, seed=seed, head_dim=head_dim, **kw)
    (kq, ks), (vq, vs) = quantize(k), quantize(v)
    return q, kq, vq, ks, vs, lens, table


def _jax_int8_gather_path(q, kq, vq, ks, vs, lengths, table):
    """The JAX package's int8 gather path: the int8 pool times its scales in
    f32, rounded to q's dtype, then the float gather path."""
    import jax.numpy as jnp

    k = (jnp.asarray(kq).astype(jnp.float32) * jnp.asarray(ks)).astype(q.dtype)
    v = (jnp.asarray(vq).astype(jnp.float32) * jnp.asarray(vs)).astype(q.dtype)
    return _jax_gather_path(q, np.asarray(k), np.asarray(v), lengths, table)


@pytest.mark.parametrize(
    "lengths",
    [(1, 16, 32, 21), (64, 7, 48, 1), (0, 33, 17, 100)],
    ids=["one-and-page-boundaries", "table-end-and-ragged", "empty-row-and-past-table"],
)
def test_int8_pages_cpu_wrapper_matches_jax_int8_gather_path(lengths):
    """int8 pages with per-(position, head) scales through the wrapper on
    the CPU (its twin) agree with the JAX package's int8 gather path at f32
    within 1e-5, launch nothing, and give exact zeros for an empty row."""
    q, kq, vq, ks, vs, lens, table = _int8_inputs(lengths, seed=9, quantize=_jax_quantize)
    before = (pa.paged_decode_attention.launches, pa.paged_decode_attention.int8_launches)
    t = dict(zip(("q", "k", "v", "ks", "vs", "lens", "table"), map(torch.from_numpy, (q, kq, vq, ks, vs, lens, table))))
    out = pa.paged_decode_attention(t["q"], t["k"], t["v"], t["lens"], t["table"], k_scales=t["ks"], v_scales=t["vs"])
    assert (pa.paged_decode_attention.launches, pa.paged_decode_attention.int8_launches) == before
    assert kq.dtype == np.int8 and ks.shape == kq.shape[:-1] + (1,)
    assert out.shape == (len(lengths), HEADS, HEAD_DIM) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_int8_gather_path(q, kq, vq, ks, vs, lens, table), atol=1e-5, rtol=0)
    for row, length in enumerate(lengths):
        if length == 0:
            assert torch.count_nonzero(out[row]) == 0


def test_int8_pages_twin_matches_the_port_gather_path():
    """The twin computes what the port's int8 gather path computes in the
    model (``Attention._paged_cached_attention`` over an int8 pool): bf16 q
    over a pool quantized by the port's ``quantize_kv_rows``, bitwise."""
    from unionml_tpu_torch.models.layers import quantize_kv_rows

    q, k, v, lens, table = map(torch.from_numpy, _inputs((5, 64, 0, 30), seed=2))
    (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    qb = q.bfloat16()
    out = pa.paged_decode_attention_reference(qb, kq, vq, lens, table, k_scales=ks, v_scales=vs)
    same = pa.paged_decode_attention_reference(qb, (kq.float() * ks).bfloat16(), (vq.float() * vs).bfloat16(), lens,
                                               table)
    assert out.dtype == torch.bfloat16 and torch.equal(out, same)


@pytest.mark.parametrize("only", ["k_scales", "v_scales"])
def test_int8_pages_need_both_scales(only):
    q, kq, vq, ks, vs, lens, table = map(torch.from_numpy, _int8_inputs((3, 5)))
    kw = {only: ks if only == "k_scales" else vs}
    with pytest.raises(ValueError, match="together"):
        pa.paged_decode_attention(q, kq, vq, lens, table, **kw)
    with pytest.raises(ValueError, match="together"):
        pa.paged_decode_attention_reference(q, kq, vq, lens, table, **kw)


@pytest.mark.parametrize("bad", ["float-pages", "f16-scales", "scale-shape", "lengths-int64", "head-dim"])
def test_int8_kernel_inputs_are_checked(bad):
    """What the int8-page launch would refuse is refused in Python first."""
    q, kq, vq, ks, vs, lens, table = map(torch.from_numpy, _int8_inputs((3, 5), head_dim=12 if bad == "head-dim" else
                                                                         HEAD_DIM))
    if bad == "float-pages":
        kq, vq = kq.float(), vq.float()
    elif bad == "f16-scales":
        ks, vs = ks.half(), vs.half()
    elif bad == "scale-shape":
        ks = ks[..., 0]
    elif bad == "lengths-int64":
        lens = lens.long()
    with pytest.raises((TypeError, ValueError)):
        pa._check_int8(q, kq, vq, ks, vs, lens, table)


def _int8_on_card(arrays, dtype):
    q, kq, vq, ks, vs, lens, table = (torch.from_numpy(a).cuda() for a in arrays)
    return q.to(dtype), kq, vq, ks, vs, lens, table


def _assert_int8_matches_twin(q, kq, vq, ks, vs, lens, table):
    before = (pa.paged_decode_attention.launches, pa.paged_decode_attention.int8_launches)
    out = pa.paged_decode_attention(q, kq, vq, lens, table, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert (pa.paged_decode_attention.launches, pa.paged_decode_attention.int8_launches) == (before[0], before[1] + 1)
    ref = pa.paged_decode_attention_reference(q, kq, vq, lens, table, k_scales=ks, v_scales=vs)
    # the bf16 mode's tolerances: both round the dequantized K/V to q's dtype alike; the kernel keeps the scores in f32
    atol, rtol = (1e-5, 0.0) if q.dtype == torch.float32 else (2e-2, 2e-2)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    for row, length in enumerate(lens.tolist()):
        if length == 0:
            assert torch.count_nonzero(out[row]) == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_matches_twin_on_card(dtype, head_dim):
    """Every length case side by side, at the draft's (64) and the target's
    (128) head size and at the kernel's edges."""
    _card()
    n = len(LENGTH_CASES)
    for shift in (0, 3):
        lengths = tuple(LENGTH_CASES[(i + shift) % n] for i in range(n))
        _assert_int8_matches_twin(*_int8_on_card(_int8_inputs(lengths, seed=shift, head_dim=head_dim),
                                                 getattr(torch, dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_long_table_is_deterministic_on_card(dtype):
    """A 256-page table split over a cluster, twice: the same bits."""
    _card()
    arrays = _int8_on_card(_int8_inputs((4096, 2500, 17, 0), seed=4, head_dim=128, pages_per_seq=256),
                           getattr(torch, dtype))
    once = _assert_int8_matches_twin(*arrays)
    q, kq, vq, ks, vs, lens, table = arrays
    assert torch.equal(once, pa.paged_decode_attention(q, kq, vq, lens, table, k_scales=ks, v_scales=vs))
