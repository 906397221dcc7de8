"""Attention ops: the plain PyTorch reference and the ``impl`` dispatch.

Counterpart of ``unionml_tpu/ops/attention.py``. Layout convention throughout:
``[batch, length, heads, head_dim]`` (BLHD), as in the JAX package, so the
tests compare like with like.
"""

from __future__ import annotations

from typing import Optional

import torch

from unionml_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention in plain tensor ops (always correct, any device).

    ``q``: ``[B, Lq, H, D]``; ``k``/``v``: ``[B, Lk, H, D]`` or ``[B, Lk, Hkv, D]``
    with ``H % Hkv == 0`` (grouped-query: KV heads are repeated). Scores stay in
    the input dtype, masked entries take ``finfo(dtype).min``, the softmax runs
    in f32 and its weights are cast back to the input dtype. ``mask`` is
    boolean, broadcastable to ``[B, H, Lq, Lk]``, True = attend. A query row
    with no visible key returns 0.
    """
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    n_heads, n_kv = q.shape[2], k.shape[2]
    if n_kv != n_heads:  # grouped-query: repeat KV heads
        k = k.repeat_interleave(n_heads // n_kv, dim=2)
        v = v.repeat_interleave(n_heads // n_kv, dim=2)

    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lowest = torch.finfo(scores.dtype).min
    visible = None
    if causal:
        q_idx = torch.arange(q.shape[1], device=q.device)[:, None]
        k_idx = torch.arange(k.shape[1], device=q.device)[None, :]
        # the diagonal shifts by k_len - q_len: the last query sees every key
        causal_mask = (q_idx >= (k_idx - (k.shape[1] - q.shape[1])))[None, None]
        scores = scores.masked_fill(~causal_mask, lowest)
        visible = causal_mask
    if mask is not None:
        scores = scores.masked_fill(~mask, lowest)
        visible = mask if visible is None else visible & mask

    weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if visible is not None:
        # a row with NO visible key is zero, not the uniform mean of V that a
        # softmax over an all-masked row would give
        weights = weights.masked_fill(~visible.any(dim=-1, keepdim=True), 0)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention entry point used by the model library.

    ``impl``: ``"auto"``/``"xla"`` (the plain reference) or ``"flash"``, which
    sends an unmasked call to :func:`flash_attention` (the Hopper kernels on
    CUDA tensors, their twins on the CPU). A masked call always takes the
    reference, as in the JAX package: the kernels take no arbitrary mask.
    """
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "flash" and mask is None:
        # grouped-query KV passes through unexpanded: the kernels map query
        # head h to KV head h * n_kv // n_heads
        return flash_attention(q, k, v, causal=causal)
    return dot_product_attention(q, k, v, causal=causal, mask=mask)
