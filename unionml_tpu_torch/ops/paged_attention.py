"""Paged-attention decode over heads-major block pools.

Counterpart of ``unionml_tpu/ops/paged_attention.py``. There the decode read
goes through the Pallas kernel that ships with JAX; here it goes through the
hand-written Hopper kernel ``csrc/paged_decode_attention.cu``, which splits
each row's pages across the blocks of a thread-block cluster, keeps an online
softmax per split, combines the splits inside the same launch and never
materializes ``pool[table]``.

:func:`paged_decode_attention` launches that kernel for CUDA tensors (or
raises) and takes the plain twin, :func:`paged_decode_attention_reference`,
only for tensors on the CPU. The twin is the gather path of
:meth:`unionml_tpu_torch.models.layers.Attention._paged_cached_attention`.
:func:`paged_decode_attention_split_reference` spells out the kernel's
split-and-combine algorithm in plain torch, for the tests.

The int8-page mode (``k_scales``/``v_scales``) goes through its own kernel,
``csrc/paged_decode_attention_int8.cu``, which reads the int8 rows and one
f32 scale per position and head (the JAX library kernel broadcasts its scales
to the full head width) by one of two routes, :func:`_int8_route`'s choice
from the shapes: ``"mma"`` (bf16 q: staged pages, dequantized to bf16, tensor
cores) and ``"direct"`` (f32 q, and any other shape the kernel takes: rows
loaded straight from device memory, CUDA cores). As in
the JAX package, the engine serves int8 pages through the gather path; the
mode is held and timed against it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from unionml_tpu_torch.ops.attention import dot_product_attention

__all__ = ["paged_decode_attention", "paged_decode_attention_reference", "paged_decode_attention_split_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256  # a key row is split over at most 32 lanes of 8 values
_MAX_HEAD_TILE = 8  # heads of a GQA group one block takes (a larger group takes several tiles)
_MAX_CLUSTER = 16  # the H100's non-portable thread-block cluster size
_MAX_STAGES = 8
#: the warps of a block that read pages (both kernels; one more warp copies them)
_READERS = 8
#: the int8-page kernel's ring: an int8 page with its scales is about half a bf16 page, so twice the stages fit
#: in about the same bytes (16 stages of 16-position pages at D = 128; two blocks an SM still fit)
_MAX_INT8_STAGES = 16
_INT8_RING_BYTES = 72 << 10
#: blocks an SM holds at once (8 reading warps and one copying warp each); a cluster's blocks share one
#: GPC, so a grid of clusters reaches fewer SMs than the card has (124 of 132 on an H100): plan for 15/16
_BLOCKS_PER_SM = 2
_RING_BYTES = 64 << 10  # a block's ring of K and V pages in flight, in shared memory
_MAX_PAGE_BYTES = 64 << 10  # one page of one KV head: a stage (K and V) must fit shared memory
#: the int8-page kernel's routes and their codes in csrc/paged_decode_attention_int8.cu
_INT8_ROUTES = {"direct": 0, "mma": 1}


class _Plan(NamedTuple):
    """One launch: ``splits`` blocks of a cluster per (row, KV head, head
    tile), ``pages_per_split`` table entries each, ``stages`` pages of K and
    V in flight a block."""

    splits: int
    pages_per_split: int
    stages: int


def paged_decode_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain twin: gather ``pool[:, table]`` back to the logical
    ``[B, pages_per_seq * page_size, H_kv, D]`` layout and attend under the
    ``slot < length`` mask through :func:`dot_product_attention`. int8 pages
    are dequantized in f32 (``int8 * scale``) and rounded to q's dtype first,
    as the JAX package's int8 gather path does."""
    _check_scales(k_scales, v_scales)
    n_pages = k_pages.shape[1]
    table = page_indices.long().clamp(0, n_pages - 1)  # JAX's gather clamps; be explicit

    def logical(pool: torch.Tensor) -> torch.Tensor:
        rows = pool[:, table]  # [H_kv, B, MB, bs, last]
        rows = rows.reshape(rows.shape[0], rows.shape[1], -1, rows.shape[-1])
        return rows.permute(1, 2, 0, 3)  # [B, MB * bs, H_kv, last]

    if k_scales is not None:
        keys = (logical(k_pages).float() * logical(k_scales)).to(q.dtype)
        values = (logical(v_pages).float() * logical(v_scales)).to(q.dtype)
    else:
        keys, values = logical(k_pages).to(q.dtype), logical(v_pages).to(q.dtype)
    slot = torch.arange(keys.shape[1], device=q.device)
    visible = (slot[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]  # [B, 1, 1, S]
    return dot_product_attention(q[:, None], keys, values, mask=visible)[:, 0]


def paged_decode_attention_split_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    splits: int,
) -> torch.Tensor:
    """The kernel's algorithm in plain torch, in f32: the table cut into
    ``splits`` runs of ``ceil(pages / splits)`` entries, a partial
    ``(acc, m, l)`` per run over the positions it sees, and the partials
    combined in split order. A run that sees no key (past the row's length,
    or past the table) keeps ``m = -inf``, ``l = 0`` and adds nothing; a row
    of length 0 gives zeros. q is pre-scaled in its own dtype, as the kernel
    does. Lengths and table entries are clamped as the kernel clamps them."""
    batch, n_heads, head_dim = q.shape
    n_kv, n_pages, page_size, _ = k_pages.shape
    group = n_heads // n_kv
    pages = page_indices.shape[1]
    per = max(1, -(-pages // splits))
    table = page_indices.long().clamp(0, n_pages - 1)
    lens = lengths.long().clamp(0, pages * page_size)
    qs = (q * head_dim ** -0.5).to(q.dtype).float().reshape(batch, n_kv, group, head_dim)

    def logical(pool: torch.Tensor) -> torch.Tensor:  # [B, H_kv, pages * page_size, D] in f32
        return pool[:, table].reshape(n_kv, batch, pages * page_size, head_dim).permute(1, 0, 2, 3).float()

    keys, values = logical(k_pages), logical(v_pages)
    scores = torch.einsum("bkgd,bksd->bkgs", qs, keys)
    slot = torch.arange(pages * page_size, device=q.device)
    mx = torch.full((batch, n_kv, group), -torch.inf, device=q.device)
    partials = []
    for s in range(splits):
        seen = (slot >= s * per * page_size) & (slot < (s + 1) * per * page_size) & (slot < lens[:, None])
        masked = scores.masked_fill(~seen[:, None, None, :], -torch.inf)
        m = masked.amax(-1)  # -inf where the split sees no key
        p = torch.exp(masked - torch.where(torch.isfinite(m), m, torch.zeros_like(m))[..., None])
        partials.append((torch.einsum("bkgs,bksd->bkgd", p, values), m, p.sum(-1)))
        mx = torch.maximum(mx, m)
    acc = torch.zeros_like(qs)
    total = torch.zeros_like(mx)
    for part_acc, m, l in partials:  # in split order
        c = torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - mx))
        acc = acc + part_acc * c[..., None]
        total = total + l * c
    out = torch.where(total[..., None] > 0, acc / torch.where(total > 0, total, 1.0)[..., None], 0.0)
    return out.reshape(batch, n_heads, head_dim).to(q.dtype)


@functools.lru_cache(maxsize=4096)
def _plan(batch: int, n_kv_heads: int, group: int, pages_per_seq: int, page_bytes: int, n_sms: int,
          max_stages: int = _MAX_STAGES, ring_bytes: int = _RING_BYTES) -> _Plan:
    """The split of one launch, from shapes alone (never from ``lengths``).

    Each (row, KV head, tile of up to 8 heads of the group) gets ``splits``
    blocks of one thread-block cluster (at most 16), aiming at
    :data:`_BLOCKS_PER_SM` blocks an SM; the table is cut into runs of
    ``pages_per_split`` entries, and ``splits`` is trimmed so that no split
    is empty at full length. ``stages`` pages of K and V (``page_bytes``
    each, with their scales in the int8 mode) are in flight a block, at most
    ``max_stages`` and ``ring_bytes`` in all.

    A reader (a warp, or the warps that share a page) waits for its page by
    the parity of the stage's fill, so it must never find the stage two
    fills behind: the stages are all the split's pages (no refill), or a
    multiple of the kernels' 8 reading warps, or a power of two under 8 (the
    kernels then read with as many readers as stages). Each stage then has
    one reader, which has read the stage's previous fill itself."""
    tiles = -(-group // _MAX_HEAD_TILE)
    want = _BLOCKS_PER_SM * n_sms * 15 // 16 // (batch * n_kv_heads * tiles)  # one wave at most
    splits = max(1, min(_MAX_CLUSTER, pages_per_seq, want))
    per = max(1, -(-pages_per_seq // splits))
    splits = max(1, -(-pages_per_seq // per))
    cap = max(1, min(max_stages, ring_bytes // (2 * page_bytes)))
    if per <= cap:
        stages = per
    elif cap >= _READERS:
        stages = cap - cap % _READERS
    else:
        stages = 1 << (cap.bit_length() - 1)
    return _Plan(splits, per, stages)


def _int8_page_bytes(page_size: int, head_dim: int) -> int:
    """Bytes of one int8 page of one KV head with its f32 scales: half a
    stage of the int8-page kernel's ring."""
    return page_size * (head_dim + 4)


def _int8_route(dtype: torch.dtype, head_dim: int, page_size: int, aligned16: bool) -> str:
    """The int8-page kernel's route for a shape, from shapes alone.

    ``"mma"`` (bf16 q) copies whole pages and their scales into a ring in
    shared memory with 1D bulk copies, which move 16-byte units between
    16-byte boundaries: it needs ``head_dim % 16 == 0``, ``page_size % 4 ==
    0``, all four pools on a 16-byte boundary (``aligned16``) and a stage (K
    and V pages and scales) of at most :data:`_INT8_RING_BYTES`. f32 q and
    every other shape the kernel takes go ``"direct"``."""
    mma = (dtype == torch.bfloat16 and aligned16 and head_dim % 16 == 0 and page_size % 4 == 0
           and 2 * _int8_page_bytes(page_size, head_dim) <= _INT8_RING_BYTES)
    return "mma" if mma else "direct"


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    from unionml_tpu_torch._build import load_library

    fn = load_library("paged_decode_attention").paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _int8_kernel():
    from unionml_tpu_torch._build import load_library

    fn = load_library("paged_decode_attention_int8").paged_decode_attention_int8
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_scales(k_scales: Optional[torch.Tensor], v_scales: Optional[torch.Tensor]) -> None:
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")


def _check_int8(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices) -> None:
    """What the int8-page kernel takes; anything else raises before a launch."""
    _check_layout(q, k_pages, v_pages, lengths, page_indices,
                  dict(k_pages=k_pages, v_pages=v_pages, k_scales=k_scales, v_scales=v_scales, lengths=lengths,
                       page_indices=page_indices))
    scale_shape = k_pages.shape[:-1] + (1,)
    if k_scales.shape != scale_shape or v_scales.shape != scale_shape:
        raise ValueError(f"expected scales {tuple(scale_shape)}, got {tuple(k_scales.shape)}/{tuple(v_scales.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"the int8-page kernel takes float32 or bfloat16 q and int8 pools, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise TypeError(f"the scales must be float32, got {k_scales.dtype}/{v_scales.dtype}")
    if k_pages.data_ptr() % 8 or v_pages.data_ptr() % 8:
        raise ValueError("the int8 pools must start on an 8-byte boundary (a lane reads 8 values at once)")


def _check_layout(q, k_pages, v_pages, lengths, page_indices, tensors) -> None:
    """The shapes, index types, devices and contiguity both kernels take."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"expected q [B, H, D] and pools [H_kv, P, page, D], got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    batch, n_heads, head_dim = q.shape
    n_kv = k_pages.shape[0]
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != head_dim or n_heads % n_kv:
        raise ValueError(
            f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}"
        )
    if head_dim % 8 or not 0 < head_dim <= _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim % 8 == 0 and head_dim <= {_MAX_HEAD_DIM}, got {head_dim}")
    if lengths.shape != (batch,) or page_indices.dim() != 2 or page_indices.shape[0] != batch:
        raise ValueError(f"expected lengths [B] and page_indices [B, pages], got {tuple(lengths.shape)}, {tuple(page_indices.shape)}")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise TypeError("lengths and page_indices must be int32")
    if k_pages.shape[1] == 0:
        raise ValueError("the kernel takes a non-empty pool")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(q, k_pages, v_pages, lengths, page_indices) -> None:
    """What the kernel takes; anything else raises before a launch."""
    _check_layout(q, k_pages, v_pages, lengths, page_indices,
                  dict(k_pages=k_pages, v_pages=v_pages, lengths=lengths, page_indices=page_indices))
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q and pools of q's dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    page_bytes = k_pages.shape[2] * q.shape[2] * k_pages.element_size()
    if page_bytes > _MAX_PAGE_BYTES:
        raise ValueError(f"the kernel takes pages of at most {_MAX_PAGE_BYTES} bytes, got {tuple(k_pages.shape)} in {k_pages.dtype}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must start on a 16-byte boundary (the kernel bulk-copies whole pages)")


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step of attention over paged K/V.

    ``q: [B, H, D]``, ``k_pages/v_pages: [H_kv, n_pages, page_size, D]``,
    ``lengths: [B] int32`` (visible positions per row, INCLUDING the token
    just written), ``page_indices: [B, pages_per_sequence] int32``. Returns
    ``[B, H, D]`` in q's dtype. Grouped-query attention is native.

    CUDA tensors launch the Hopper kernel (float32 or bfloat16, ``D % 8 ==
    0``, ``D <= 256``; one launch a call, which neither reads ``lengths`` or
    ``page_indices`` on the host nor synchronises) or raise; CPU tensors take
    :func:`paged_decode_attention_reference`. As in the JAX wrapper, ``q`` is
    pre-scaled by ``head_dim ** -0.5`` in its own dtype (the kernel does it
    as it loads q) and the kernel computes raw ``q . k``; in bfloat16 that
    rounds differently from the reference, which scales the scores.

    ``k_scales``/``v_scales`` (both or neither; f32 ``[H_kv, n_pages,
    page_size, 1]``, the port's ``quantize_kv_rows`` convention ``dequant =
    int8 * scale``) select the int8-page mode over int8 pools: its own
    kernel, which dequantizes each value in f32 and rounds it to q's dtype
    as the twin does, counted in ``paged_decode_attention.int8_launches``
    (and by route in ``paged_decode_attention.int8_route_launches``).
    """
    _check_scales(k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, lengths, page_indices,
                                                k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on CUDA or CPU tensors, got {q.device}")
    q = q.contiguous()
    if k_scales is not None:
        return _paged_int8(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices)
    _check(q, k_pages, v_pages, lengths, page_indices)
    batch, n_heads, head_dim = q.shape
    n_kv, n_pages, page_size, _ = k_pages.shape
    pages_per_seq = page_indices.shape[1]
    out = torch.empty_like(q)
    index = q.device.index
    plan = _plan(batch, n_kv, n_heads // n_kv, pages_per_seq, page_size * head_dim * q.element_size(),
                 _sm_count(index))
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(), page_indices.data_ptr(),
            out.data_ptr(), batch, n_heads, n_kv, head_dim, n_pages, page_size, pages_per_seq, plan.splits,
            plan.pages_per_split, plan.stages, _DTYPE_CODES[q.dtype], head_dim ** -0.5)
    if index == torch.cuda.current_device():
        err = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


def _int8_launch(q, k_pages, v_pages, k_scales, v_scales, page_indices, n_sms: int) -> tuple:
    """``(route, plan)`` of the int8-page kernel for these tensors: the
    route from their shapes and alignment, the split with the ring sized
    for int8 pages and their scales."""
    batch, n_heads, head_dim = q.shape
    n_kv, _, page_size, _ = k_pages.shape
    aligned16 = all(t.data_ptr() % 16 == 0 for t in (k_pages, v_pages, k_scales, v_scales))
    plan = _plan(batch, n_kv, n_heads // n_kv, page_indices.shape[1], _int8_page_bytes(page_size, head_dim), n_sms,
                 _MAX_INT8_STAGES, _INT8_RING_BYTES)
    return _int8_route(q.dtype, head_dim, page_size, aligned16), plan


def _paged_int8(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices) -> torch.Tensor:
    """Launch the int8-page kernel by :func:`_int8_route`'s route (one
    launch a call, split as the float kernel is planned, the ring sized for
    int8 pages)."""
    _check_int8(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices)
    batch, n_heads, head_dim = q.shape
    n_kv, n_pages, page_size, _ = k_pages.shape
    pages_per_seq = page_indices.shape[1]
    out = torch.empty_like(q)
    index = q.device.index
    route, plan = _int8_launch(q, k_pages, v_pages, k_scales, v_scales, page_indices, _sm_count(index))
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
            lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(), batch, n_heads, n_kv, head_dim, n_pages,
            page_size, pages_per_seq, plan.splits, plan.pages_per_split, plan.stages, _INT8_ROUTES[route],
            _DTYPE_CODES[q.dtype], head_dim ** -0.5)
    with torch.cuda.device(index):
        err = _int8_kernel()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention int8-page kernel ({route} route) launch failed: cudaError {err}")
    paged_decode_attention.int8_launches += 1
    paged_decode_attention.int8_route_launches[route] += 1
    return out


#: kernel launches since the count was last reset (CPU calls never count):
#: float pages, then int8 pages, then the int8 pages' launches by route
paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
paged_decode_attention.int8_route_launches = dict.fromkeys(_INT8_ROUTES, 0)
