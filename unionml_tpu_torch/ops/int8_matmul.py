"""Int8 weight-only matmul: ``y = x @ (q * scale)`` with on-chip dequant.

Counterpart of ``unionml_tpu/ops/int8_matmul.py``. There the Pallas kernel
streams int8 tiles into VMEM, converts them to bf16 for the MXU, accumulates
in f32 and applies the per-channel scale once at the end. Here the same
function is the hand-written Hopper kernel ``csrc/int8_matmul.cu``: int8 is
the only weight traffic, which eager PyTorch cannot give otherwise (a
dequantize before the matmul writes and reads the weight again in bf16).

:func:`int8_matmul` launches that kernel for CUDA tensors (or raises) and
takes its plain twin, :func:`int8_matmul_reference`, only for tensors on the
CPU. Both compute ``bf16(x) @ q`` in f32 and scale once, so they agree up to
summation order. :func:`quantized_matmul` is the entry point the models call,
with the JAX signature.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Optional, Tuple

import torch

__all__ = ["int8_matmul", "int8_matmul_reference", "quantized_matmul"]

_F_CANDIDATES = (512, 256, 128)
_K_CANDIDATES = (512, 256, 128, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: (rows of x per block, weight columns per thread): 64 f32 accumulators a
#: thread, and 16-, 8- or 4-byte weight loads; the kernel's templates match
_TILES = ((4, 16), (8, 8), (16, 4))
_SPLIT_ROWS = 64  # a split-K share is a whole number of these K rows
#: the kernel's own limits: whole 64-row K steps, and F in whole 16-byte
#: weight loads (so a lane's columns are all in or all out)
_KERNEL_K, _KERNEL_F = 64, 16


def _pick_block(dim: int, candidates) -> Optional[int]:
    for c in candidates:
        if dim % c == 0:
            return c
    return None


def int8_matmul_reference(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The kernel's function in plain torch: x rounded to bf16 (an f32 x
    too, as on the TPU), int8 converted exactly, f32 accumulation, the scale
    applied once to the sum."""
    out_dtype = out_dtype or x.dtype
    acc = x.to(torch.bfloat16).float() @ q.float()
    return (acc * scale.float()).to(out_dtype)


def _plan(m: int, k_dim: int, f_dim: int, n_sms: int) -> Tuple[int, int, int, int]:
    """``(tile_m, cols_per_thread, splits, k_per_split)`` for one launch.

    K is split across blocks until the grid holds two blocks per SM (decode
    has M <= 4, so the column blocks alone leave most SMs idle), but never so
    far that the f32 partial sums (``splits * M * F`` written and read again)
    exceed an eighth of the weight's bytes."""
    tile_m, vec = next(((t, v) for t, v in _TILES if m <= t), _TILES[-1])
    blocks = -(-f_dim // (32 * vec)) * -(-m // tile_m)
    units = k_dim // _SPLIT_ROWS
    want = -(-2 * n_sms // blocks)
    cap = max(1, k_dim // (64 * m))
    splits = max(1, min(want, cap, units))
    per = -(-units // splits)
    return tile_m, vec, -(-units // per), per * _SPLIT_ROWS


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _kernel():
    from unionml_tpu_torch._build import load_library

    fn = load_library("int8_matmul").int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> None:
    """What the kernel takes; anything else raises before a launch."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"expected x [M, K] and q [K, F], got {tuple(x.shape)} and {tuple(q.shape)}")
    if not _kernel_takes(q, scale):
        raise ValueError(f"the int8 kernel takes a [K, F] weight with K % {_KERNEL_K} == 0 and F % {_KERNEL_F} == 0 "
                         f"and a [1, F] scale, got {tuple(q.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16 x and out_dtype, got {x.dtype} and {out_dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected int8 q and float32 scale, got {q.dtype} and {scale.dtype}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("q and scale must start on a 16-byte boundary (the kernel loads 16 bytes at a time)")


def _kernel_takes(q: torch.Tensor, scale: torch.Tensor) -> bool:
    k_dim, f_dim = q.shape[-2], q.shape[-1]
    return q.dim() == 2 and k_dim % _KERNEL_K == 0 and f_dim % _KERNEL_F == 0 and tuple(scale.shape) == (1, f_dim)


def _launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``csrc/int8_matmul.cu`` (or a raise), counted."""
    _check(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, got {x.device}")
    m, k_dim = x.shape
    f_dim = q.shape[1]
    out = torch.empty((m, f_dim), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    tile_m, _, splits, k_per_split = _plan(m, k_dim, f_dim, _sm_count(x.device.index))
    partial = torch.empty((splits, m, f_dim), dtype=torch.float32, device=x.device) if splits > 1 else None
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            m, k_dim, f_dim, tile_m, splits, k_per_split, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return out


def _forward(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale, out_dtype=out_dtype)
    return _launch(x.contiguous(), q, scale, out_dtype)


def _apply(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`_forward`, through :class:`_Int8Matmul` only when ``x`` needs a
    gradient (the autograd function costs host time on every decode call)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Matmul.apply(x, q, scale, out_dtype)
    return _forward(x, q, scale, out_dtype)


class _Int8Matmul(torch.autograd.Function):
    """The kernel (CUDA tensors) or its twin (CPU tensors) with a gradient
    for ``x``, so LoRA adapters under a frozen int8 base train alike on both:
    ``dx = bf16((dy * scale) @ q^T)`` in ``x``'s dtype, the twin's own
    autograd result. The JAX kernel has no gradient; this backward is a
    plain matmul against the int8 values converted to f32. ``q`` and
    ``scale`` take none."""

    @staticmethod
    def forward(ctx, x, q, scale, out_dtype):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return _forward(x, q, scale, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        dx = ((dy.float() * scale) @ q.float().t()).to(torch.bfloat16).to(ctx.x_dtype)
        return dx, None, None, None


def int8_matmul(
    x: torch.Tensor,
    q: torch.Tensor,
    scale: torch.Tensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    block_m: Optional[int] = None,
    block_k: Optional[int] = None,
    block_f: Optional[int] = None,
) -> torch.Tensor:
    """``[M, K] @ int8 [K, F] * f32 [1, F] -> [M, F]`` in ``out_dtype``
    (default x's), differentiable in ``x``.

    K and F must admit the JAX package's block tiling (K by 512/256/128/64,
    F by 512/256/128), and explicit ``block_k``/``block_f`` must divide them;
    otherwise ``ValueError``, as there. The blocks only validate: the kernel
    keeps its own tiles and masks the ragged edge of M and F. CUDA tensors
    launch the Hopper kernel (x and ``out_dtype`` float32 or bfloat16) or
    raise; CPU tensors take :func:`int8_matmul_reference`.
    """
    del block_m  # JAX pads M to its block; the kernel masks ragged rows
    k_dim, f_dim = q.shape
    block_k = block_k or _pick_block(k_dim, _K_CANDIDATES)
    block_f = block_f or _pick_block(f_dim, _F_CANDIDATES)
    if block_k is None or block_f is None:
        raise ValueError(f"no block tiling for weight shape {(k_dim, f_dim)}")
    if k_dim % block_k or f_dim % block_f:
        raise ValueError(f"blocks ({block_k}, {block_f}) do not tile weight {(k_dim, f_dim)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, got {x.device}")
    return _apply(x, q, scale, out_dtype or x.dtype)


#: kernel launches since the count was last reset (CPU calls never count)
int8_matmul.launches = 0


def quantized_matmul(x: torch.Tensor, qt: Any, *, out_dtype: Optional[torch.dtype] = None,
                     impl: str = "xla") -> torch.Tensor:
    """Matmul against a :class:`~unionml_tpu_torch.ops.quant.QuantizedTensor`.

    ``impl="xla"`` dequantizes to ``out_dtype`` and multiplies: the JAX
    package's numerics. ``impl="pallas"`` on CUDA tensors launches the int8
    kernel for any 2D weight with a per-output-channel scale, K a multiple
    of 64 and F of 16 (the kernel's own limits, wider than the JAX tiling),
    and raises ``ValueError`` on any other weight: it never runs the
    dequantize path on the card. ``x`` may carry leading dims.

    Where the CPU differs from JAX: JAX's ``"pallas"`` off a TPU always
    takes the dequantize path. The port's, on CPU tensors, runs the kernel's
    plain twin for every weight the kernel takes (it rounds ``x`` to bf16 as
    the kernel does), and dequantizes only for the others, as JAX does.
    """
    out_dtype = out_dtype or x.dtype
    k_dim, f_dim = qt.q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_dim)
    if impl == "pallas" and (x.device.type != "cpu" or _kernel_takes(qt.q, qt.scale)):
        out = _apply(x2, qt.q, qt.scale, out_dtype)
    else:
        w = (qt.q.float() * qt.scale).to(out_dtype)
        out = x2.to(out_dtype) @ w
    return out.reshape(*lead, f_dim)
