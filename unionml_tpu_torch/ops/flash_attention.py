"""Flash attention: blocked online-softmax forward and recompute backward.

Counterpart of ``unionml_tpu/ops/flash_attention.py``. There the forward and
the two backward kernels are Pallas TPU kernels; here they are hand-written
Hopper kernels, routed by dtype. bf16 runs on the tensor cores:
``csrc/flash_forward.cu`` (the forward) and ``csrc/flash_backward.cu`` (the
fused backward: dq, dk and dv in one launch). float32 runs the f32 forward
of ``csrc/flash_forward_f32.cu`` and the fused f32 backward of
``csrc/flash_backward_f32.cu``, both on the tensor cores with each product in
three TF32 passes to near-f32 accuracy. The ``[L, L]`` score matrix never reaches
device memory in either direction: the forward saves the per-row logsumexp
and the backward recomputes ``P = exp(S - lse)`` tile by tile.

:func:`flash_attention` is a :class:`torch.autograd.Function` whose forward
and backward make the same two calls on every device: :func:`flash_forward`
and :func:`flash_backward`. Each launches a kernel for CUDA tensors (or
raises) and takes its plain twin (``*_reference``, dense tensors, f32) only
for tensors on the CPU. :func:`flash_forward` routes float32 to
:func:`flash_forward_f32`; :func:`flash_backward` routes float32 to
:func:`flash_backward_f32`. ``delta = rowsum(dO * O)`` is one plain f32
reduction outside the kernels, as in the JAX code. The twins round to the
operands' dtype where the JAX kernels do (a no-op in f32): the forward's
unnormalised ``P`` before ``P.V`` (``l`` sums the f32 ``P``, and the product
is divided by ``l`` at the end), the backward's ``P`` and ``dS`` before their
second products. ``flash_backward_dq_reference`` and
``flash_backward_dkv_reference`` are the twins of the JAX package's two
backward kernels, which the fused kernels replace.

Shapes: ``q: [B, Lq, H, D]``, ``k/v: [B, Lk, Hkv, D]`` with ``H % Hkv == 0``.
The API's ``blocks`` only decide which lengths are legal, as in the JAX
package (``min(block, L)`` must tile ``L``); the kernels keep their own tiles
and mask ragged ones. The bf16 kernels take ``D % 16 == 0`` and ``D <= 128``
and 16-byte aligned tensors, and raise on anything else; the f32 kernels take
any ``D <= 128``. A query row that sees no key (causal with ``Lq > Lk``)
gives 0 and lse ``1e30`` — the contract
of :func:`~unionml_tpu_torch.ops.attention.dot_product_attention`. The Pallas
forward breaks it when ``Lk - Lq`` is not a multiple of ``block_q``: its
masked scores are ``finfo.min``, not ``-inf``, so such a row that shares a
computed tile with rows that do see keys gets the mean of V.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

__all__ = [
    "flash_attention",
    "flash_backward",
    "flash_backward_dkv_reference",
    "flash_backward_dq_reference",
    "flash_backward_f32",
    "flash_backward_reference",
    "flash_forward",
    "flash_forward_f32",
    "flash_forward_reference",
]

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
MAX_HEAD_DIM = 128  # the kernels' register tiles hold up to 128 head-dim columns
_BF16_ALIGN = 16  # bytes: the bf16 kernels' TMA copies need aligned tensors
_FUSED_QUERY_TILE = 64  # query rows of a tile of the fused backwards (their dq counters are per tile)
_BIG = 1e30  # lse of a row that sees no key: exp(S - BIG) == 0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Blocks = Optional[Tuple[int, int]]


def _check_shapes(q: torch.Tensor, k: torch.Tensor, blocks: Blocks) -> None:
    """The JAX entry's checks, with its messages: KV heads divide the query
    heads, and ``min(block, L)`` tiles each length."""
    q_len, n_heads = q.shape[1], q.shape[2]
    k_len, n_kv = k.shape[1], k.shape[2]
    if n_heads % n_kv:
        raise ValueError(f"query heads ({n_heads}) must be a multiple of KV heads ({n_kv})")
    block_q = min((blocks or (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K))[0], q_len)
    block_k = min((blocks or (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K))[1], k_len)
    if q_len % block_q or k_len % block_k:
        raise ValueError(f"blocks ({block_q}, {block_k}) do not tile lengths ({q_len}, {k_len})")


# ---------------------------------------------------------------- plain twins


def _visible(q_len: int, k_len: int, device: torch.device) -> torch.Tensor:
    """``[Lq, Lk]``: query row i sees key j when ``i + (Lk - Lq) >= j``."""
    q_idx = torch.arange(q_len, device=device)[:, None]
    k_idx = torch.arange(k_len, device=device)[None, :]
    return q_idx + (k_len - q_len) >= k_idx


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """``scale * q.k`` in f32 as ``[B, H, Lq, Lk]``, masked entries ``-inf``."""
    group = q.shape[2] // k.shape[2]
    keys = k.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys) * q.shape[-1] ** -0.5
    if causal:
        scores = scores.masked_fill(~_visible(q.shape[1], k.shape[1], q.device), float("-inf"))
    return scores


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' plain twin: ``(out in q's dtype, lse [B, H, Lq]
    f32)``. As the JAX kernel does, ``l`` sums the f32 ``P``, the product
    takes ``P`` rounded to v's dtype, and the output is divided by ``l`` after
    the product."""
    scores = _scores(q, k, causal)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # a row that sees no key
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    values = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), values)
    out = pv / torch.where(l == 0, torch.ones_like(l), l).permute(0, 2, 1, 3)
    lse = torch.where(l == 0, torch.full_like(l, _BIG), m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _recompute(q, k, v, dout, lse, delta, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """``P = exp(S - lse)`` and ``dS = P * (dO.V^T - delta)``, ``[B, H, Lq, Lk]``
    f32, each rounded to the operands' dtype (q's) as the JAX kernels round
    them before their second products, then widened back to f32."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    values = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), values)
    ds = p * (dp - delta[..., None])
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def _dq_from(ds, q, k) -> torch.Tensor:
    keys = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, keys) * q.shape[-1] ** -0.5).to(q.dtype)


def _dkv_from(p, ds, q, k, v, dout) -> Tuple[torch.Tensor, torch.Tensor]:
    batch, k_len, n_kv, head_dim = k.shape
    group = q.shape[2] // n_kv
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * head_dim**-0.5
    dk = dk.reshape(batch, k_len, n_kv, group, head_dim).sum(dim=3)
    dv = dv.reshape(batch, k_len, n_kv, group, head_dim).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_reference(q, k, v, dout, lse, delta, causal: bool) -> torch.Tensor:
    """The dq kernel's plain twin: ``scale * dS.K``, in q's dtype."""
    _, ds = _recompute(q, k, v, dout, lse, delta, causal)
    return _dq_from(ds, q, k)


def flash_backward_dkv_reference(q, k, v, dout, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's plain twin: ``dv = P^T.dO`` and ``dk = scale *
    dS^T.Q`` per query head, summed over each KV group in f32, then cast to
    k's and v's dtype."""
    p, ds = _recompute(q, k, v, dout, lse, delta, causal)
    return _dkv_from(p, ds, q, k, v, dout)


def flash_backward_reference(
    q, k, v, dout, lse, delta, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward's plain twin: ``(dq, dk, dv)``, the dq and dk/dv
    twins together (``P`` and ``dS`` recomputed once)."""
    p, ds = _recompute(q, k, v, dout, lse, delta, causal)
    return (_dq_from(ds, q, k), *_dkv_from(p, ds, q, k, v, dout))


# ---------------------------------------------------------------- kernels

#: (library, pointer arguments, trailing dtype code) of each C entry
_ENTRIES = {
    "flash_attention_forward": ("flash_forward_f32", 5, True),
    "flash_attention_forward_bf16": ("flash_forward", 5, False),
    "flash_attention_backward_fused": ("flash_backward", 11, False),
    "flash_attention_backward_f32": ("flash_backward_f32", 10, False),
}


def _kernel(name: str):
    from unionml_tpu_torch._build import load_library

    library, pointers, dtype_code = _ENTRIES[name]
    fn = getattr(load_library(library), name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_int] * dtype_code + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    if q.dim() != 4 or any(t.dim() != 4 for t in tensors[:3]):
        raise ValueError("expected q [B, Lq, H, D] and k/v/dO [B, L, heads, D]")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors[:3]):
        raise TypeError(f"the kernels take float32 or bfloat16 q/k/v/dO of one dtype, got {q.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} exceeds the kernels' {MAX_HEAD_DIM}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")


def _launch(name: str, counter, q, k, *pointers_and_tensors, causal: bool) -> None:
    """Launch ``name`` on q's current stream; raise on a refused launch."""
    batch, q_len, n_heads, head_dim = q.shape
    k_len, n_kv = k.shape[1], k.shape[2]
    fn = _kernel(name)
    dtype_code = (_DTYPE_CODES[q.dtype],) if _ENTRIES[name][2] else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in pointers_and_tensors), batch, n_heads, n_kv, q_len, k_len, head_dim,
            int(causal), head_dim**-0.5, *dtype_code, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    counter.launches += 1


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got {q.device}")
    return q.device.type


def _check_f32(q: torch.Tensor, name: str) -> None:
    if q.dtype != torch.float32:
        raise TypeError(f"the {name} kernel takes float32 (bfloat16 has its own kernels), got {q.dtype}")


def _check_bf16(name: str, q: torch.Tensor, *tensors: torch.Tensor) -> None:
    """The bf16 tensor-core kernels' limits: bfloat16, ``D % 16 == 0`` (and
    ``D <= 128``, checked with the shapes) and 16-byte aligned tensors."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the {name} kernel takes bfloat16 (float32 has its own kernels), got {q.dtype}")
    if q.shape[-1] % 16:
        raise ValueError(f"the {name} kernel takes head_dim % 16 == 0, got {q.shape[-1]}")
    if any(t.data_ptr() % _BF16_ALIGN for t in (q, *tensors)):
        raise ValueError(f"the {name} kernel takes {_BF16_ALIGN}-byte aligned tensors")


def _forward_bf16(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 tensor-core forward on CUDA tensors, counted on :func:`flash_forward`."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_kernel_inputs(q, k, v, k)
    _check_bf16("forward", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32, device=q.device)
    _launch("flash_attention_forward_bf16", flash_forward, q, k, q, k, v, out, lse, causal=causal)
    return out, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: on CUDA tensors the bf16 tensor-core kernel (float32
    goes to :func:`flash_forward_f32`), on the CPU the twin."""
    if _device_of(q) == "cpu":
        return flash_forward_reference(q, k, v, causal)
    if q.dtype == torch.float32:
        return flash_forward_f32(q, k, v, causal)
    return _forward_bf16(q, k, v, causal)


def flash_forward_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the f32 forward kernel (3xTF32 tensor-core products, one
    launch) for CUDA tensors, its twin on the CPU."""
    if _device_of(q) == "cpu":
        return flash_forward_reference(q, k, v, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_kernel_inputs(q, k, v, k)
    _check_f32(q, "f32 forward")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32, device=q.device)
    _launch("flash_attention_forward", flash_forward_f32, q, k, q, k, v, out, lse, causal=causal)
    return out, lse


def _group_sum(heads: torch.Tensor, n_kv: int, dtype: torch.dtype) -> torch.Tensor:
    """``[B, L, H, D]`` f32 at query-head resolution summed over each KV group
    (one plain f32 reduction), then cast to ``dtype``."""
    batch, length, n_heads, head_dim = heads.shape
    return heads.view(batch, length, n_kv, n_heads // n_kv, head_dim).sum(dim=3).to(dtype)


def _fused_outputs(q: torch.Tensor, k: torch.Tensor, causal: bool, counters_per_tile: int):
    """The fused kernels' outputs and scratch: the dq counters (zeroed,
    ``counters_per_tile`` a query tile of a head), dq (zeroed where query
    tiles that see no key are never written) and dk, dv at query-head
    resolution in f32."""
    batch, q_len, n_heads, head_dim = q.shape
    k_len = k.shape[1]
    n_q = -(-q_len // _FUSED_QUERY_TILE)
    dq_count = torch.zeros(batch * n_heads * n_q * counters_per_tile, dtype=torch.int32, device=q.device)
    dq = torch.zeros_like(q) if causal and q_len > k_len else torch.empty_like(q)
    dk_heads = torch.empty(batch, k_len, n_heads, head_dim, dtype=torch.float32, device=q.device)
    return dq_count, dq, dk_heads, torch.empty_like(dk_heads)


def flash_backward_f32(q, k, v, dout, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``, dk and dv at KV-head resolution: the fused f32
    kernel (3xTF32 tensor-core products, one launch) for CUDA tensors, which
    writes dk and dv per query head for one plain f32 group sum here; the
    twin on the CPU."""
    if _device_of(q) == "cpu":
        return flash_backward_reference(q, k, v, dout, lse, delta, causal)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _check_kernel_inputs(q, k, v, dout, lse, delta)
    _check_f32(q, "f32 backward")
    dq_count, dq, dk_heads, dv_heads = _fused_outputs(q, k, causal, counters_per_tile=1)
    _launch(
        "flash_attention_backward_f32", flash_backward_f32, q, k, q, k, v, dout, lse, delta, dq_count, dq,
        dk_heads, dv_heads, causal=causal,
    )
    return dq, _group_sum(dk_heads, k.shape[2], k.dtype), _group_sum(dv_heads, k.shape[2], v.dtype)


def flash_backward(q, k, v, dout, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``, dk and dv at KV-head resolution. CPU tensors take the
    twin; CUDA float32 :func:`flash_backward_f32`; CUDA bfloat16 the fused
    bf16 kernel (``D % 16 == 0``, ``D <= 128``), which writes dk and dv per
    query head in f32 for one plain f32 group sum here, then the cast."""
    if _device_of(q) == "cpu":
        return flash_backward_reference(q, k, v, dout, lse, delta, causal)
    if q.dtype == torch.float32:
        return flash_backward_f32(q, k, v, dout, lse, delta, causal)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _check_kernel_inputs(q, k, v, dout, lse, delta)
    _check_bf16("fused backward", q, k, v, dout)
    dq_count, dq, dk_heads, dv_heads = _fused_outputs(q, k, causal, counters_per_tile=2)  # one a warpgroup
    dq_sum = torch.empty(q.shape[0], q.shape[2], q.shape[1], q.shape[3], dtype=torch.float32, device=q.device)
    _launch(
        "flash_attention_backward_fused", flash_backward, q, k, q, k, v, dout, lse, delta, dq_sum, dq_count, dq,
        dk_heads, dv_heads, causal=causal,
    )
    return dq, _group_sum(dk_heads, k.shape[2], k.dtype), _group_sum(dv_heads, k.shape[2], v.dtype)


#: kernel launches since the count was last reset (CPU calls never count)
flash_forward.launches = 0
flash_forward_f32.launches = 0
flash_backward.launches = 0
flash_backward_f32.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, blocks: Blocks):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.blocks = causal, blocks
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        _check_shapes(q, k, ctx.blocks)  # the backward follows the forward's blocks, as in JAX
        # delta_i = rowsum(dO_i * O_i), the dS correction term; [B, H, Lq] like lse
        delta = torch.einsum("blhd,blhd->bhl", dout.float(), out.float())
        dq, dk, dv = flash_backward(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False, blocks: Blocks = None
) -> torch.Tensor:
    """Flash attention entry point: ``out [B, Lq, H, D]`` in q's dtype, and a
    backward through :func:`flash_backward`. ``k/v`` may carry fewer (KV)
    heads than q. ``blocks=(block_q, block_k)`` overrides the tiles that
    decide which lengths are legal (default 128 x 128)."""
    _check_shapes(q, k, blocks)
    return _FlashAttention.apply(q, k, v, causal, blocks)
