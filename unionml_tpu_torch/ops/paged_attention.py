"""Paged-attention decode over heads-major block pools.

Counterpart of ``unionml_tpu/ops/paged_attention.py``. There the decode read
goes through the Pallas kernel that ships with JAX; here it goes through the
hand-written Hopper kernel ``csrc/paged_decode_attention.cu``, which walks
each row's pages with an online softmax and never materializes ``pool[table]``.

:func:`paged_decode_attention` launches that kernel for CUDA tensors (or
raises) and takes the plain twin, :func:`paged_decode_attention_reference`,
only for tensors on the CPU. The twin is the gather path of
:meth:`unionml_tpu_torch.models.layers.Attention._paged_cached_attention`.
"""

from __future__ import annotations

import ctypes

import torch

from unionml_tpu_torch.ops.attention import dot_product_attention

__all__ = ["paged_decode_attention", "paged_decode_attention_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
) -> torch.Tensor:
    """The plain twin: gather ``pool[:, table]`` back to the logical
    ``[B, pages_per_seq * page_size, H_kv, D]`` layout and attend under the
    ``slot < length`` mask through :func:`dot_product_attention`."""
    n_pages = k_pages.shape[1]
    table = page_indices.long().clamp(0, n_pages - 1)  # JAX's gather clamps; be explicit

    def logical(pool: torch.Tensor) -> torch.Tensor:
        rows = pool[:, table]  # [H_kv, B, MB, bs, D]
        rows = rows.reshape(rows.shape[0], rows.shape[1], -1, rows.shape[-1])
        return rows.permute(1, 2, 0, 3)  # [B, MB * bs, H_kv, D]

    keys, values = logical(k_pages).to(q.dtype), logical(v_pages).to(q.dtype)
    slot = torch.arange(keys.shape[1], device=q.device)
    visible = (slot[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]  # [B, 1, 1, S]
    return dot_product_attention(q[:, None], keys, values, mask=visible)[:, 0]


def _kernel():
    from unionml_tpu_torch._build import load_library

    fn = load_library("paged_decode_attention").paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, lengths, page_indices) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"expected q [B, H, D] and pools [H_kv, P, page, D], got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    batch, n_heads, head_dim = q.shape
    n_kv = k_pages.shape[0]
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != head_dim or n_heads % n_kv:
        raise ValueError(
            f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}"
        )
    if lengths.shape != (batch,) or page_indices.dim() != 2 or page_indices.shape[0] != batch:
        raise ValueError(f"expected lengths [B] and page_indices [B, pages], got {tuple(lengths.shape)}, {tuple(page_indices.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q and pools of q's dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise TypeError("lengths and page_indices must be int32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("lengths", lengths), ("page_indices", page_indices)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
) -> torch.Tensor:
    """One decode step of attention over paged K/V.

    ``q: [B, H, D]``, ``k_pages/v_pages: [H_kv, n_pages, page_size, D]``,
    ``lengths: [B] int32`` (visible positions per row, INCLUDING the token
    just written), ``page_indices: [B, pages_per_sequence] int32``. Returns
    ``[B, H, D]`` in q's dtype. Grouped-query attention is native.

    CUDA tensors launch the Hopper kernel (float32 or bfloat16) or raise; CPU
    tensors take :func:`paged_decode_attention_reference`. As in the JAX
    wrapper, ``q`` is pre-scaled by ``head_dim ** -0.5`` in its own dtype and
    the kernel computes raw ``q . k``; in bfloat16 that rounds differently from
    the reference, which scales the scores.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, lengths, page_indices)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k_pages, v_pages, lengths, page_indices)
    batch, n_heads, head_dim = q.shape
    n_kv, n_pages, page_size, _ = k_pages.shape
    q_scaled = (q * head_dim ** -0.5).to(q.dtype).contiguous()
    out = torch.empty_like(q_scaled)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q_scaled.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
            page_indices.data_ptr(), out.data_ptr(), batch, n_heads, n_kv, head_dim, n_pages,
            page_size, page_indices.shape[1], _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


#: kernel launches since the count was last reset (CPU calls never count)
paged_decode_attention.launches = 0
