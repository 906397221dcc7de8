"""Ring and Ulysses attention over a sequence-sharded context, counterpart
of ``unionml_tpu/ops/ring_attention.py``.

The sequence dim is sharded over the mesh's ``sequence`` axis: each rank
holds one block ``[B, L/s, H, D]`` of q, k and v. :func:`ring_attention`
rotates the K/V blocks around the axis's ring (``batch_isend_irecv``
pairs) while each rank folds them into its queries' running softmax
statistics, so memory stays O(L/s); :func:`ulysses_attention` reshards
sequence<->heads with two all-to-alls and runs dense attention over the
full sequence for a subset of heads. Both are the JAX package's XLA code,
not a Pallas kernel, and port as torch ops over collectives: no kernel of
this repository runs here. The arithmetic is the JAX package's, the
``finfo.min`` initial max and masked scores included, so f32 results agree
within rounding.

:func:`ring_attention`/:func:`ulysses_attention` take each rank's local
blocks (the layers call them inside a sequence-parallel forward);
:func:`sequence_sharded_attention` takes the full arrays on every rank,
cuts each rank's blocks, and gathers the result back. Gradients flow
through both: the K/V rotation's backward rotates the cotangents back,
the all-to-all's is the inverse all-to-all, and the cut and the gather of
:func:`sequence_sharded_attention` are each other's transposes, so every
rank ends with the whole gradient of its whole inputs.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from unionml_tpu_torch.parallel.collectives import all_to_all, gather_from, ring_permute, split_to

__all__ = ["ring_attention", "sequence_sharded_attention", "ulysses_attention"]


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    n_heads, n_kv = q.shape[2], k.shape[2]
    if n_kv != n_heads:  # GQA: expand KV to the query heads
        k = k.repeat_interleave(n_heads // n_kv, dim=2)
        v = v.repeat_interleave(n_heads // n_kv, dim=2)
    return k, v


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, *, axis: str = "sequence",
                   causal: bool = False, softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention for sequence-sharded ``[B, L_local, H, D]`` blocks
    (grouped-query K/V with ``H_kv`` dividing ``H``); every rank of the axis
    calls it. The causal mask compares global positions: this rank's
    queries start at ``index * L_local``, the block it holds after ``step``
    rotations came from index ``index - step``."""
    ring_size, my_index = mesh.size(axis), mesh.index(axis)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    k, v = _repeat_kv(q, k, v)
    batch, q_len, n_heads, head_dim = q.shape
    k_len = k.shape[1]
    dev = q.device
    q_pos = my_index * q_len + torch.arange(q_len, device=dev)
    neg = torch.finfo(torch.float32).min
    qf = q.float() * scale

    m = torch.full((batch, n_heads, q_len, 1), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((batch, n_heads, q_len, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((batch, n_heads, q_len, head_dim), dtype=torch.float32, device=dev)

    def attend(step, m, l, acc, k_blk, v_blk):
        src = (my_index - step) % ring_size
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        if causal:
            k_pos = src * k_len + torch.arange(k_len, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = scores.masked_fill(~mask[None, None], neg)
        m_next = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(scores - m_next)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        return m_next, l, acc

    # rotate first, then accumulate: ring_size - 1 transfers, none discarded
    m, l, acc = attend(0, m, l, acc, k, v)
    k_blk, v_blk = k, v
    for step in range(1, ring_size):
        k_blk, v_blk = ring_permute((k_blk, v_blk), mesh, axis)
        m, l, acc = attend(step, m, l, acc, k_blk, v_blk)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / denom).to(q.dtype).transpose(1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, *, axis: str = "sequence",
                      causal: bool = False, softmax_scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: ``[B, L/s, H, D] -> [B, L,
    H/s, D]`` by all-to-all, dense attention over the full sequence, and
    back. Needs the (query) heads to divide by the axis size."""
    size = mesh.size(axis)
    k, v = _repeat_kv(q, k, v)
    n_heads = q.shape[2]
    if n_heads % size:
        raise ValueError(f"ulysses needs heads ({n_heads}) divisible by axis size ({size})")
    q_full, k_full, v_full = (all_to_all(t, mesh, axis, split_axis=2, concat_axis=1) for t in (q, k, v))
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q_full.float() * scale, k_full.float())
    if causal:
        n = q_full.shape[1]
        pos = torch.arange(n, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores = scores.masked_fill(~mask[None, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_full.float()).to(q.dtype)
    return all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, *,
                               causal: bool = False, batch_axes: Sequence[str] = ("data", "fsdp"),
                               sequence_axis: str = "sequence", impl: str = "ring") -> torch.Tensor:
    """Sequence-parallel attention over full ``[B, L, H, D]`` arrays that
    every rank holds: each rank takes its batch rows (over ``batch_axes``)
    and sequence block, runs :func:`ring_attention` (``impl="ring"``) or
    :func:`ulysses_attention` (``impl="ulysses"``), and the full output is
    gathered back on every rank (differentiable: each rank's gradients of
    ``q``, ``k`` and ``v`` are the whole arrays')."""
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[impl]
    present = tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1)

    def local(t: torch.Tensor) -> torch.Tensor:
        return split_to(split_to(t, mesh, present, dim=0), mesh, sequence_axis, dim=1)

    out = fn(local(q), local(k), local(v), mesh, axis=sequence_axis, causal=causal)
    out = gather_from(out, mesh, sequence_axis, gather_axis=1)
    for a in reversed(present):  # rows are row-major over the batch axes: the innermost gathers first
        out = gather_from(out, mesh, a, gather_axis=0)
    return out
