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


@pytest.mark.parametrize("page_bytes", [1024, 2080, 4096, 4224, 6144, 8192, 8320, 10240, 16384, 33280, 65536])
@pytest.mark.parametrize("pages", [1, 3, 7, 16, 43, 256, 1000])
@pytest.mark.parametrize("ring", [(pa._MAX_STAGES, pa._RING_BYTES), (pa._MAX_INT8_STAGES, pa._INT8_RING_BYTES)],
                         ids=["float-ring", "int8-ring"])
def test_plan_gives_each_refilled_stage_one_reader(ring, pages, page_bytes):
    """A reader waits for its page by the parity of the stage's fill: the
    kernels read page i with reader i % min(8, stages), so wherever a stage
    is refilled the same reader must read all its fills (then the previous
    fill was its own and cannot be taken for the next); the same holds for
    the lanes that issue the copies and wait for the stage's release."""
    max_stages, ring_bytes = ring
    plan = pa._plan(1, 1, 1, pages, page_bytes, 132, max_stages, ring_bytes)
    assert 1 <= plan.stages <= max_stages and plan.stages <= plan.pages_per_split
    assert plan.stages == 1 or 2 * page_bytes * plan.stages <= ring_bytes
    for wpp in (1, 2, 4, 8):  # warps that share a page in the float kernel's CUDA-core loop: min(8 / wpp, stages)
        readers = min(pa._READERS // wpp, plan.stages)
        by_stage = {}
        for i in range(plan.pages_per_split):
            by_stage.setdefault(i % plan.stages, set()).add(i % readers)
        assert all(len(r) == 1 for r in by_stage.values()), (plan, wpp)
    # the int8 kernel's tensor-core route issues from two producer lanes (alternate pages) where each stage then has
    # one issuing lane: an even number of stages, or none refilled
    issuers = 2 if plan.stages % 2 == 0 or plan.stages >= plan.pages_per_split else 1
    by_stage = {}
    for i in range(plan.pages_per_split):
        by_stage.setdefault(i % plan.stages, set()).add(i % issuers)
    assert plan.stages >= plan.pages_per_split or all(len(r) == 1 for r in by_stage.values()), plan


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


def _shared_prefix_inputs(seed=8, head_dim=128, pages_per_seq=8):
    """Tables whose rows share their first pages, as the engine's static
    prefix and radix-cached runs make them: every row starts on the same two
    pages, rows 1 and 2 share a third, row 3 repeats row 0's table and q
    (so its output must be row 0's, bit for bit); the rest of each row is
    private."""
    q, k, v, _, table = _inputs((0,) * 4, seed=seed, head_dim=head_dim, pages_per_seq=pages_per_seq)
    table[:, :2] = table[0, :2]
    table[2, 2] = table[1, 2]
    table[3] = table[0]
    q[3] = q[0]
    lengths = np.asarray((37, 2 * PAGE + 9, 3 * PAGE, 37), np.int32)
    return q, k, v, lengths, table


def test_cpu_wrapper_over_shared_pages_matches_jax_gather_path():
    q, k, v, lens, table = _shared_prefix_inputs()
    ref = _jax_gather_path(q, k, v, lens, table)
    out = pa.paged_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens, table)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out[3].numpy(), out[0].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_over_shared_pages_on_card(dtype):
    """Rows whose tables share their first pages (several table entries
    point at one block): the kernel matches its twin, leaves the pool
    untouched (it only reads), and two rows with one table, q and length
    give the same bits."""
    _card()
    q, k, v, lens, table = _on_card(_shared_prefix_inputs(), getattr(torch, dtype))
    k0, v0 = k.clone(), v.clone()
    out = _assert_matches_twin(q, k, v, lens, table)
    assert torch.equal(k, k0) and torch.equal(v, v0)
    assert torch.equal(out[3], out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_small_ring_refills_on_card(dtype):
    """Pages of 32 positions at D=128 (8 KB in bf16, 16 KB in f32): a ring
    of 4 or 2 stages, fewer than the 8 reading warps, refilled many times in
    each split (each stage then has one reader)."""
    _card()
    arrays = _inputs((8192, 8000, 33, 0), seed=12, head_dim=128, pages_per_seq=256, page=32)
    plan = pa._plan(4, KV_HEADS, HEADS // KV_HEADS, 256, 32 * 128 * getattr(torch, dtype).itemsize,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.stages < 8 and plan.pages_per_split > 2 * plan.stages
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
@pytest.mark.parametrize("head_dim", [16, 64, 128, 256, 24, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_matches_twin_on_card(dtype, head_dim):
    """Every length case side by side, at the draft's (64) and the target's
    (128) head size, at the kernel's edges, and at head sizes the bulk
    copies cannot take (24, 40: the direct route in both dtypes)."""
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


# ------------------------------------------------------------------ the int8-page kernel's routes and plan


@pytest.mark.parametrize(
    "dtype,head_dim,page,aligned,route",
    [
        ("bfloat16", 128, 16, True, "mma"),  # the served shape: the target's head, 16-position pages
        ("bfloat16", 64, 16, True, "mma"),  # the speculative draft's head
        ("bfloat16", 16, 16, True, "mma"),  # one k-step a row (4-byte K loads)
        ("bfloat16", 256, 16, True, "mma"),
        ("bfloat16", 128, 8, True, "mma"),  # half a 16-key group, the rest masked
        ("bfloat16", 128, 32, True, "mma"),  # two groups a page
        ("bfloat16", 128, 276, True, "mma"),  # the largest pages whose stage fits the ring at D=128 and 256
        ("bfloat16", 256, 140, True, "mma"),
        ("float32", 128, 16, True, "direct"),  # f32 q: CUDA cores, rows loaded directly
        ("float32", 64, 8, True, "direct"),
        ("float32", 128, 32, True, "direct"),
        ("bfloat16", 128, 6, True, "direct"),  # scales of 24 bytes: no 16-byte bulk copy
        ("float32", 128, 6, True, "direct"),
        ("bfloat16", 24, 16, True, "direct"),  # a K row of 24 bytes
        ("float32", 40, 16, True, "direct"),
        ("bfloat16", 128, 16, False, "direct"),  # a pool off a 16-byte boundary
        ("float32", 128, 16, False, "direct"),
        ("bfloat16", 256, 144, True, "direct"),  # a stage of 74,880 bytes: over the ring
    ],
)
def test_int8_route_is_chosen_from_shapes(dtype, head_dim, page, aligned, route):
    """The route the int8-page kernel takes, a pure function of q's dtype,
    the head size, the page size and the pools' alignment; the card tests
    below run each of these shapes and check the route that launched."""
    assert pa._int8_route(getattr(torch, dtype), head_dim, page, aligned) == route


@pytest.mark.parametrize(
    "shape",
    [
        (4, 8, 4, 19, 16, 128),  # the served shape (Llama-3-8B width, 16-position int8 pages)
        (8, 8, 4, 128, 16, 128),  # B=8, ctx=2048
        (1, 8, 4, 512, 16, 128),  # B=1, ctx=8192
        (4, 8, 4, 19, 16, 64),  # the draft's head
        (4, 2, 4, 256, 16, 128),  # the card tests' 256-page table
        (7, 2, 4, 4, 8, 128),  # the card tests' page sizes
        (7, 2, 4, 4, 32, 128),
        (7, 2, 4, 4, 6, 128),
        (2, 1, 8, 16, 140, 256),  # a stage of 72,800 bytes: one stage
        (3, 1, 1, 1, 256, 256),  # a direct-route page larger than the ring
    ],
)
def test_int8_plan_fits_the_ring_and_covers_every_page_once(shape):
    """The int8 plan: every page once, in order, no empty split, and a ring
    of at most 16 stages within the ring's bytes (K and V pages with their
    scales), except the one stage a page too large for the ring keeps (its
    shape goes the direct route, which has no ring)."""
    batch, n_kv, group, pages, page, head_dim = shape
    page_bytes = pa._int8_page_bytes(page, head_dim)
    plan = pa._plan(batch, n_kv, group, pages, page_bytes, 132, pa._MAX_INT8_STAGES, pa._INT8_RING_BYTES)
    runs = [range(s * plan.pages_per_split, min((s + 1) * plan.pages_per_split, pages)) for s in range(plan.splits)]
    assert [p for run in runs for p in run] == list(range(pages))
    assert all(len(run) > 0 for run in runs)
    assert 1 <= plan.splits <= pa._MAX_CLUSTER
    assert 1 <= plan.stages <= min(pa._MAX_INT8_STAGES, plan.pages_per_split)
    if pa._int8_route(torch.bfloat16, head_dim, page, True) == "direct":
        assert 2 * page_bytes > pa._INT8_RING_BYTES or page % 4
    else:
        assert 2 * page_bytes * plan.stages <= pa._INT8_RING_BYTES


def test_int8_ring_holds_twice_the_float_ring_at_the_served_shape():
    """An int8 page (with its scales) is about half a bf16 page, so the
    int8 plan keeps about twice the pages in flight for the same bytes."""
    bf16 = pa._plan(8, 8, 4, 128, 16 * 128 * 2, 132)
    int8 = pa._plan(8, 8, 4, 128, pa._int8_page_bytes(16, 128), 132, pa._MAX_INT8_STAGES, pa._INT8_RING_BYTES)
    assert (bf16.splits, bf16.pages_per_split) == (int8.splits, int8.pages_per_split)
    assert (bf16.stages, int8.stages) == (8, 16)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 8 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() * t.element_size() + 24, dtype=torch.uint8, device=t.device)
    start = (8 - flat.data_ptr() % 16) % 16
    view = flat[start: start + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    return view


def _assert_int8_route(route, q, kq, vq, ks, vs, lens, table):
    """The kernel against its twin, launched once by ``route``."""
    before = dict(pa.paged_decode_attention.int8_route_launches)
    aligned = all(t.data_ptr() % 16 == 0 for t in (kq, vq, ks, vs))
    assert pa._int8_route(q.dtype, q.shape[2], kq.shape[2], aligned) == route
    out = _assert_int8_matches_twin(q, kq, vq, ks, vs, lens, table)
    after = pa.paged_decode_attention.int8_route_launches
    assert {r: after[r] - before[r] for r in after} == {r: int(r == route) for r in after}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 16, 32, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_page_sizes_on_card(dtype, page):
    """Pages of 8 positions (half a tensor-core key group), 16 (the served
    size), 32 (two groups) and 6 (scales of 24 bytes: the direct route), at
    the length limits, by the route each takes."""
    _card()
    lengths = (0, 1, page, page + 3, 4 * page, 100, 2 * page - 1)
    arrays = _int8_on_card(_int8_inputs(lengths, seed=6, head_dim=128, page=page), getattr(torch, dtype))
    _assert_int8_route("mma" if dtype == "bfloat16" and page % 4 == 0 else "direct", *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,kv_heads", [(8, 8), (8, 2), (16, 2)], ids=["group-1", "group-4", "group-8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_head_groups_on_card(dtype, heads, kv_heads):
    """Groups of one head (7 of the tensor-core tile's 8 heads idle), of
    four (the served model's) and of eight (a full tile)."""
    _card()
    arrays = _int8_on_card(_int8_inputs((21, 64, 0, 100), seed=3, head_dim=64, heads=heads, kv_heads=kv_heads),
                           getattr(torch, dtype))
    _assert_int8_route("mma" if dtype == "bfloat16" else "direct", *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_long_table_refills_the_ring_on_card(dtype):
    """A 256-page table over 8 rows whose splits each walk more pages than
    the ring has stages, so every split refills stages, at full length in
    three rows."""
    _card()
    lengths = (4096, 4096, 2500, 17, 0, 4096, 1000, 4095)
    arrays = _int8_on_card(_int8_inputs(lengths, seed=8, head_dim=128, pages_per_seq=256), getattr(torch, dtype))
    _, plan = pa._int8_launch(*arrays[:5], arrays[6], torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.pages_per_split > plan.stages
    _assert_int8_route("mma" if dtype == "bfloat16" else "direct", *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_small_ring_refills_on_card(dtype):
    """D=256 with 32-position pages: a stage of 16,640 bytes, a ring of 4
    stages (fewer than the 8 reading warps) refilled many times a split."""
    _card()
    lengths = (8192, 8000, 33, 0, 8192, 100, 4000, 7000)
    arrays = _int8_on_card(_int8_inputs(lengths, seed=12, head_dim=256, pages_per_seq=256, page=32),
                           getattr(torch, dtype))
    _, plan = pa._int8_launch(*arrays[:5], arrays[6], torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.stages == 4 and plan.pages_per_split > 2 * plan.stages
    _assert_int8_route("mma" if dtype == "bfloat16" else "direct", *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_one_row_long_table_on_card(dtype):
    """One row of 32 heads over 8 KV heads and a 1024-page table: 16
    splits (clusters of the largest size) of 64 pages, each refilling its
    16 stages three times."""
    _card()
    arrays = _int8_on_card(_int8_inputs((16000,), seed=13, head_dim=128, heads=32, kv_heads=8, pages_per_seq=1024),
                           getattr(torch, dtype))
    _, plan = pa._int8_launch(*arrays[:5], arrays[6], torch.cuda.get_device_properties(0).multi_processor_count)
    assert (plan.splits, plan.pages_per_split, plan.stages) == (16, 64, 16)
    _assert_int8_route("mma" if dtype == "bfloat16" else "direct", *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_misaligned_pools_take_the_direct_route_on_card(dtype):
    """Pools and scales 8 bytes past a 16-byte boundary (the kernel's limit
    is 8): no bulk copy, the direct route."""
    _card()
    q, kq, vq, ks, vs, lens, table = _int8_on_card(_int8_inputs((21, 64, 0, 100), seed=10, head_dim=128),
                                                   getattr(torch, dtype))
    _assert_int8_route("direct", q, *map(_misaligned, (kq, vq, ks, vs)), lens, table)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["build", "launch"])
def test_int8_kernel_raises_rather_than_falls_back_on_card(monkeypatch, fault):
    """A tensor-core-route shape whose kernel fails to build or to launch
    raises; it never returns the twin's or another route's output."""
    _card()
    arrays = _int8_on_card(_int8_inputs((21, 64, 0, 100), seed=11, head_dim=128), torch.bfloat16)
    q, kq, vq, ks, vs, lens, table = arrays
    assert pa._int8_route(q.dtype, 128, PAGE, True) == "mma"

    def broken():
        if fault == "build":
            raise RuntimeError("nvcc failed for csrc/paged_decode_attention_int8.cu")
        return lambda *args: 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(pa, "_int8_kernel", broken)
    before = (pa.paged_decode_attention.int8_launches, dict(pa.paged_decode_attention.int8_route_launches))
    with pytest.raises(RuntimeError, match="nvcc failed" if fault == "build" else "mma route"):
        pa.paged_decode_attention(q, kq, vq, lens, table, k_scales=ks, v_scales=vs)
    assert (pa.paged_decode_attention.int8_launches, pa.paged_decode_attention.int8_route_launches) == before
