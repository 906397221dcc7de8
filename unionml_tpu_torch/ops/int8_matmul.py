"""Int8 weight-only matmul: ``y = x @ (q * scale)`` with on-chip dequant.

Counterpart of ``unionml_tpu/ops/int8_matmul.py``. There the Pallas kernel
streams int8 tiles into VMEM, converts them to bf16 for the MXU, accumulates
in f32 and applies the per-channel scale once at the end. Here the same
function is the hand-written Hopper kernel ``csrc/int8_matmul.cu``: int8
tiles converted to bf16 in shared memory for the tensor cores (wgmma), so
int8 is the only weight traffic, which eager PyTorch cannot give otherwise
(a dequantize before the matmul writes and reads the weight again in bf16).

:func:`int8_matmul` launches that kernel for CUDA tensors (or raises) and
takes its plain twin, :func:`int8_matmul_reference`, only for tensors on the
CPU. Both compute ``bf16(x) @ q`` in f32 and scale once, so they agree up to
summation order. :func:`quantized_matmul` is the entry point the models call,
with the JAX signature.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, NamedTuple, Optional

import torch

__all__ = ["int8_matmul", "int8_matmul_reference", "quantized_matmul"]

_F_CANDIDATES = (512, 256, 128)
_K_CANDIDATES = (512, 256, 128, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: N tile (tokens a tile, the wgmma's N; the smallest that holds M, larger M
#: takes several tiles) -> (output channels a block, 64-row K tiles a
#: pipeline stage); the kernel's templates match
_TILES = {8: (64, 2), 16: (64, 2), 32: (64, 1), 64: (64, 1), 128: (128, 1), 256: (128, 1)}
_STEP_K = 64  # K rows of a K tile; a cluster rank's share is a whole number of stages
_MAX_CLUSTER = 16  # the H100's non-portable thread-block cluster size
#: the kernel's own limits: whole 64-row K tiles, and weight rows of whole
#: 16-byte units (the TMA unit's row stride)
_KERNEL_K, _KERNEL_F = 64, 16


class _Plan(NamedTuple):
    """One launch: ``n_tile`` tokens by ``f_tile`` output channels a block,
    and ``splits`` blocks of a thread-block cluster sharing each tile's K,
    ``k_per_split`` rows each. The splits meet in distributed shared memory:
    no plan needs a scratch buffer or a second kernel."""

    n_tile: int
    f_tile: int
    splits: int
    k_per_split: int


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


@functools.lru_cache(maxsize=4096)
def _plan(m: int, k_dim: int, f_dim: int, n_sms: int) -> _Plan:
    """The tiles and the cluster split of K for one launch.

    N is the smallest tile of :data:`_TILES` that holds M; at N >= 128 a
    block takes 128 output channels with two warpgroups (one block fills an
    SM's shared memory), below it 64 with one (an SM holds several). K is
    split over up to 16 blocks of a cluster while the grid still fits the
    blocks the SMs hold at once (decode has M <= 8, so the F tiles alone
    leave most SMs idle)."""
    n_tile = next((n for n in _TILES if m <= n), max(_TILES))
    f_tile, k_tiles = _TILES[n_tile]
    per_sm = 1 if n_tile >= 128 else 2
    tiles = -(-f_dim // f_tile) * -(-m // n_tile)
    units = -(-k_dim // (k_tiles * _STEP_K))  # pipeline stages over K
    want = max(1, per_sm * n_sms // tiles)
    per = max(-(-units // want), -(-units // _MAX_CLUSTER), 1)
    return _Plan(n_tile, f_tile, -(-units // per), per * k_tiles * _STEP_K)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    from unionml_tpu_torch._build import load_library

    fn = load_library("int8_matmul").int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_weight(q: torch.Tensor, scale: torch.Tensor) -> None:
    """The weight the kernel takes; anything else raises before a launch."""
    if not _kernel_takes(q, scale):
        raise ValueError(f"the int8 kernel takes a [K, F] weight with K % {_KERNEL_K} == 0 and F % {_KERNEL_F} == 0 "
                         f"and a [1, F] scale, got {tuple(q.shape)} and {tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected int8 q and float32 scale, got {q.dtype} and {scale.dtype}")
    if scale.device != q.device:
        raise ValueError(f"scale is on {scale.device}, q on {q.device}")
    if not q.is_contiguous() or not scale.is_contiguous():
        raise ValueError("q and scale must be contiguous")
    if q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("q and scale must start on a 16-byte boundary (the kernel copies 16 bytes at a time)")


def _check_x(x: torch.Tensor, k_dim: int, device: torch.device, out_dtype: torch.dtype) -> None:
    """The input and output the kernel takes against a checked [K, F] weight on ``device``."""
    if x.dim() != 2 or x.shape[1] != k_dim:
        raise ValueError(f"expected x [M, {k_dim}], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16 x and out_dtype, got {x.dtype} and {out_dtype}")
    if x.device != device:
        raise ValueError(f"x is on {x.device}, the weight on {device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel copies 16 bytes at a time)")


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> None:
    """What the kernel takes; anything else raises before a launch."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"expected x [M, K] and q [K, F], got {tuple(x.shape)} and {tuple(q.shape)}")
    _check_weight(q, scale)
    _check_x(x, q.shape[0], q.device, out_dtype)


def _kernel_takes(q: torch.Tensor, scale: torch.Tensor) -> bool:
    k_dim, f_dim = q.shape[-2], q.shape[-1]
    return q.dim() == 2 and k_dim % _KERNEL_K == 0 and f_dim % _KERNEL_F == 0 and tuple(scale.shape) == (1, f_dim)


def _launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype,
            weight_checked: bool = False) -> torch.Tensor:
    """One launch of ``csrc/int8_matmul.cu`` (or a raise), counted. With
    ``weight_checked`` only ``x`` and ``out_dtype`` are checked: the caller
    validated ``q`` and ``scale`` once (:func:`quantized_matmul` on a
    :class:`~unionml_tpu_torch.ops.quant.QuantizedKernel`)."""
    if weight_checked:
        _check_x(x, q.shape[0], q.device, out_dtype)
    else:
        _check(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, got {x.device}")
    m, k_dim = x.shape
    f_dim = q.shape[1]
    out = torch.empty((m, f_dim), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)  # round to nearest even, as the twin rounds
    index = x.device.index
    plan = _plan(m, k_dim, f_dim, _sm_count(index))
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k_dim, f_dim,
            plan.n_tile, plan.splits, plan.k_per_split, _DTYPE_CODES[out_dtype])
    if index == torch.cuda.current_device():
        err = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return out


def _forward(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype,
             weight_checked: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale, out_dtype=out_dtype)
    return _launch(x.contiguous(), q, scale, out_dtype, weight_checked)


def _apply(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype,
           weight_checked: bool = False) -> torch.Tensor:
    """:func:`_forward`, through :class:`_Int8Matmul` only when ``x`` needs a
    gradient (the autograd function costs host time on every decode call)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Matmul.apply(x, q, scale, out_dtype, weight_checked)
    return _forward(x, q, scale, out_dtype, weight_checked)


class _Int8Matmul(torch.autograd.Function):
    """The kernel (CUDA tensors) or its twin (CPU tensors) with a gradient
    for ``x``, so LoRA adapters under a frozen int8 base train alike on both:
    ``dx = bf16((dy * scale) @ q^T)`` in ``x``'s dtype, the twin's own
    autograd result. The JAX kernel has no gradient; this backward is a
    plain matmul against the int8 values converted to f32. ``q`` and
    ``scale`` take none."""

    @staticmethod
    def forward(ctx, x, q, scale, out_dtype, weight_checked):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return _forward(x, q, scale, out_dtype, weight_checked)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        dx = ((dy.float() * scale) @ q.float().t()).to(torch.bfloat16).to(ctx.x_dtype)
        return dx, None, None, None, None


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
    """Matmul against a :class:`~unionml_tpu_torch.ops.quant.QuantizedTensor`
    or a model's :class:`~unionml_tpu_torch.ops.quant.QuantizedKernel` slot.

    ``impl="xla"`` dequantizes to ``out_dtype`` and multiplies: the JAX
    package's numerics. ``impl="pallas"`` on CUDA tensors launches the int8
    kernel for any 2D weight with a per-output-channel scale, K a multiple
    of 64 and F of 16 (the kernel's own limits, wider than the JAX tiling),
    and raises ``ValueError`` on any other weight: it never runs the
    dequantize path on the card. A ``QuantizedKernel``'s weight is checked
    the first time it reaches the kernel and again only after its buffers
    change (``kernel_checked``); other weights are checked on every call.
    ``x`` may carry leading dims.

    Where the CPU differs from JAX: JAX's ``"pallas"`` off a TPU always
    takes the dequantize path. The port's, on CPU tensors, runs the kernel's
    plain twin for every weight the kernel takes (it rounds ``x`` to bf16 as
    the kernel does), and dequantizes only for the others, as JAX does.
    """
    out_dtype = out_dtype or x.dtype
    q, scale = qt.q, qt.scale
    k_dim, f_dim = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_dim)
    if impl == "pallas" and (x.device.type != "cpu" or _kernel_takes(q, scale)):
        checked = getattr(qt, "kernel_checked", None)
        if checked is False and x.device.type == "cuda":  # a QuantizedKernel's first launch since it changed
            _check_weight(q, scale)
            qt.kernel_checked = checked = True
        out = _apply(x2, q, scale, out_dtype, bool(checked))
    else:
        w = (q.float() * scale).to(out_dtype)
        out = x2.to(out_dtype) @ w
    return out.reshape(*lead, f_dim)
