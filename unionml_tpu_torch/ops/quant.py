"""Weight-only int8 quantization for inference.

Counterpart of ``unionml_tpu/ops/quant.py``. Small-batch decode streams every
weight byte once a step, so int8 weights with per-output-channel f32 scales
halve the bytes a step reads. :func:`quantize_array` is the JAX formula
(``max(absmax, 1e-8) / 127``, then ``clip(round(w / scale), -127, 127)``;
``torch.round`` rounds half to even, as ``jnp.round``), so the int8 values
and scales are bit-identical to the JAX package's.

:func:`quantize_params` takes a nested mapping of weights, as the JAX
function takes a pytree, and returns a new tree with :class:`QuantizedTensor`
leaves. Given a module it quantizes IN PLACE instead: each selected float
kernel is replaced by a :class:`QuantizedKernel` holding the int8 values and
scales, so one copy of the weights lives in device memory; the slot records
the model's int8 route (:func:`int8_route`). Either way a leaf
is selected by its flax path (``layer_0/attn/q_proj/kernel``, the port's
dotted parameter name with ``/``), so one regex selects the same leaves in
both packages.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Tuple

import torch
from torch import nn

__all__ = [
    "QuantizedKernel",
    "QuantizedTensor",
    "dequantize",
    "dequantize_tree",
    "quantize_array",
    "quantize_params",
]


@dataclasses.dataclass
class QuantizedTensor:
    """Symmetric per-channel int8 weight: ``w ≈ q * scale`` with ``q`` int8
    and ``scale`` f32 broadcast over the reduced axis (default: per output
    channel, ``[1, F]`` for a ``[K, F]`` kernel)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    def to(self, device: Any) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device))


def quantize_array(w: Any, *, channel_axis: int = -1) -> QuantizedTensor:
    """Quantize one weight to int8 with symmetric per-channel scales.

    With the default trailing ``channel_axis`` only the contraction axis (the
    one just before the channels) is reduced: a ``[K, F]`` kernel gets
    ``[1, F]`` scales and stacked expert kernels ``[E, K, F]`` get
    ``[E, 1, F]``. Any other ``channel_axis`` keeps that axis and reduces all
    the others."""
    w32 = torch.as_tensor(w).float()
    channel = channel_axis % w32.dim()
    if channel == w32.dim() - 1 and w32.dim() >= 2:
        axes: Tuple[int, ...] = (w32.dim() - 2,)
    else:
        axes = tuple(i for i in range(w32.dim()) if i != channel)
    abs_max = w32.abs().amax(dim=axes, keepdim=True) if axes else w32.abs()
    scale = abs_max.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def dequantize(leaf: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Inverse of :func:`quantize_array`; passes other leaves through."""
    if isinstance(leaf, QuantizedTensor):
        return (leaf.q.float() * leaf.scale).to(dtype)
    return leaf


def dequantize_tree(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Map :func:`dequantize` over a nested mapping."""
    if isinstance(params, Mapping):
        return {key: dequantize_tree(value, dtype) for key, value in params.items()}
    return dequantize(params, dtype)


class QuantizedKernel(nn.Module):
    """The slot of a dense kernel after in-place quantization: buffers ``q``
    (int8, the kernel's shape) and ``scale`` (f32), and ``impl``, the
    :func:`~unionml_tpu_torch.ops.int8_matmul.quantized_matmul` route its
    owner multiplies by, passing the slot itself as the weight. Its
    state-dict names are the kernel's plus ``.q``/``.scale``, the fields of
    the flax tree's quantized leaf."""

    def __init__(self, qt: QuantizedTensor, impl: str = "xla"):
        super().__init__()
        self.impl = impl
        self.register_buffer("q", qt.q)
        self.register_buffer("scale", qt.scale)
        #: whether the int8 kernel's wrapper has validated ``q`` and ``scale``;
        #: set at their first launch, cleared whenever the buffers change
        self.kernel_checked = False

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("q", "scale"):
            self.__dict__["kernel_checked"] = False
        super().__setattr__(name, value)

    def _apply(self, fn, *args, **kwargs):  # .to(), .cuda(), .half(): new buffers
        self.kernel_checked = False
        return super()._apply(fn, *args, **kwargs)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape


def int8_route(module: nn.Module) -> str:
    """The int8 route of a model's kernel switch: the Hopper kernel
    (``"pallas"``) when its ``config.attention_impl`` is ``"flash"``, the
    JAX package's dequantize-then-matmul (``"xla"``) otherwise."""
    return "pallas" if getattr(getattr(module, "config", None), "attention_impl", None) == "flash" else "xla"


def set_quantized(module: nn.Module, name: str, qt: QuantizedTensor) -> None:
    """Replace the parameter ``name`` (dotted, relative to ``module``) by a
    :class:`QuantizedKernel` on ``module``'s :func:`int8_route`. Its owner
    must list the leaf in its ``quantizable`` attribute: only modules whose
    forward takes an int8 kernel (the dense layers and the LM head) accept
    one."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    if leaf not in getattr(owner, "quantizable", ()):
        raise ValueError(f"{name}: {type(owner).__name__} does not take an int8 {leaf!r} in the port")
    delattr(owner, leaf)
    setattr(owner, leaf, QuantizedKernel(qt, int8_route(module)))


#: default targets: large matmul kernels; embeddings stay unquantized (a
#: gather reads one row per token), norms/biases/adapters are too small to
#: matter, and MoE routers are precision-sensitive
_DEFAULT_INCLUDE = r"(kernel)$"
_DEFAULT_EXCLUDE = r"(embed|embedding|norm|scale|bias|lora_a|lora_b|router)"


def quantize_params(
    params: Any,
    *,
    include: str = _DEFAULT_INCLUDE,
    exclude: str = _DEFAULT_EXCLUDE,
    min_size: int = 1 << 16,
    channel_axis: int = -1,
) -> Any:
    """Quantize matching weight leaves to int8.

    A leaf is quantized when its flax path matches ``include``, does not
    match ``exclude``, has rank >= 2 and at least ``min_size`` elements.
    ``params`` is a nested mapping (a new tree is returned, as in the JAX
    package) or an ``nn.Module``, quantized in place and returned: each
    selected parameter becomes a :class:`QuantizedKernel`, and a kernel that
    is already int8 is no parameter any more, so a second call changes
    nothing."""
    inc, exc = re.compile(include), re.compile(exclude)

    def selected(path: str, shape: Tuple[int, ...]) -> bool:
        numel = 1
        for d in shape:
            numel *= int(d)
        return bool(inc.search(path)) and not exc.search(path) and len(shape) >= 2 and numel >= min_size

    if isinstance(params, nn.Module):
        names = [name for name, p in params.named_parameters() if selected(name.replace(".", "/"), tuple(p.shape))]
        for name in names:  # names only: each float kernel is freed as soon as its slot is swapped
            with torch.no_grad():
                qt = quantize_array(params.get_parameter(name), channel_axis=channel_axis)
            set_quantized(params, name, qt)
        return params

    def walk(tree: Mapping[str, Any], prefix: str) -> dict:
        out = {}
        for key, leaf in tree.items():
            path = f"{prefix}{key}"
            if isinstance(leaf, Mapping):
                out[key] = walk(leaf, path + "/")
            elif selected(path, tuple(getattr(leaf, "shape", ()))):
                out[key] = quantize_array(leaf, channel_axis=channel_axis)
            else:
                out[key] = leaf
        return out

    return walk(params, "")
