"""Weight bridge: flax parameter trees <-> the port's modules.

The port's parameter names are the flax paths with ``/`` written as ``.``
(``layer_0/attn/q_proj/kernel`` -> ``layer_0.attn.q_proj.kernel``) and its
kernels stay ``[in, out]``, so a leaf loads as it is. The bridge takes the tree
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), so this package never imports JAX. It raises on any leaf left
over and on any parameter left missing, and casts once to the dtype asked for.
The way back, :func:`llama_params_to_numpy`, gives a module's parameters as
the same nested dicts, so trained weights compare leaf for leaf.

Quantized leaves cross too. In the tree they are objects with ``.q``/``.scale``
fields (what ``tree_map(np.asarray, quantize_params(params))`` gives) or
``{"q", "scale"}`` dicts, recognized by those fields alone; in the port they
are :class:`~unionml_tpu_torch.ops.quant.QuantizedKernel` slots whose
buffers ``kernel.q``/``kernel.scale`` load bit for bit, and the way back
gives them as ``{"q", "scale"}`` dicts.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.llama import Llama, LlamaConfig
from unionml_tpu_torch.ops.quant import QuantizedTensor, set_quantized


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "."))
        elif hasattr(value, "q") and hasattr(value, "scale"):  # a quantized leaf
            flat[f"{name}.q"], flat[f"{name}.scale"] = value.q, value.scale
        else:
            flat[name] = value
    return flat


def _meta_llama(tree: Mapping[str, Any], config: LlamaConfig) -> Llama:
    """A :class:`Llama` on the meta device with an (empty) int8 slot for
    every kernel that ``tree`` holds quantized."""
    module = Llama(config, device="meta")
    flat = _flatten(tree)
    for name in [n for n, _ in module.named_parameters()]:
        if f"{name}.q" in flat and f"{name}.scale" in flat:
            set_quantized(module, name, QuantizedTensor(
                torch.empty(np.shape(flat[f"{name}.q"]), dtype=torch.int8, device="meta"),
                torch.empty(np.shape(flat[f"{name}.scale"]), dtype=torch.float32, device="meta"),
            ))
    return module


def state_dict_from_jax(
    tree: Mapping[str, Any], module: nn.Module, dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``module`` from a flax tree of numpy arrays. Every
    leaf must name one of the module's parameters or buffers with the same
    shape, and every one of them must be named. ``dtype`` (default: each
    parameter's own) is applied once, here, to parameters only (int8 values
    and their scales keep their types); ``module.load_state_dict`` then
    copies to its device."""
    flat = _flatten(tree)
    expected = module.state_dict()
    params = {name for name, _ in module.named_parameters()}
    leftover = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if leftover or missing:
        raise ValueError(f"flax tree does not match the module: leftover {leftover}, missing {missing}")
    out = {}
    for name, ref in expected.items():
        value = np.asarray(flat[name])
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: flax shape {value.shape} != port shape {tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(value, order="C")).to((dtype if name in params else None) or ref.dtype)
    return out


def llama_params_from_jax(
    tree: Mapping[str, Any], config: LlamaConfig, dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.Tensor]:
    """The :class:`Llama` state dict for ``config`` from a flax Llama param
    tree (``embed/embedding``, ``layer_{i}/attn/{q,k,v,o}_proj/kernel``,
    ``layer_{i}/mlp/{wg,wi,wo}/kernel``, ``layer_{i}/{attn,mlp}_norm/scale``,
    ``final_norm/scale``, ``lm_head/kernel`` and the ``lora_a``/``lora_b``
    adapters where ``lora_rank > 0``). Load it with
    ``Llama(config, device=...).load_state_dict(...)``, or, for a tree with
    quantized leaves, build the model with :func:`llama_from_jax`."""
    return state_dict_from_jax(tree, _meta_llama(tree, config), dtype)


def llama_from_jax(tree: Mapping[str, Any], config: LlamaConfig, *, device: DeviceLike = None) -> Llama:
    """A :class:`Llama` on ``device`` (``None`` = CUDA) loaded from a flax
    tree: each quantized leaf becomes an int8 slot holding its values and
    scales bit for bit, every other leaf a parameter in ``config.param_dtype``.
    Nothing is allocated in float for the quantized kernels."""
    module = _meta_llama(tree, config)
    state = state_dict_from_jax(tree, module)
    module = module.to_empty(device=resolve_device(device))
    module.load_state_dict(state)
    return module


def llama_params_to_numpy(model: Llama) -> Dict[str, Any]:
    """The way back of :func:`llama_params_from_jax`: a :class:`Llama`'s
    parameters as nested dicts of f32 numpy arrays shaped like the flax tree
    (``layer_0.attn.q_proj.kernel`` -> ``tree["layer_0"]["attn"]["q_proj"]["kernel"]``),
    and each int8 slot as ``{"q": int8, "scale": f32}`` under its kernel's
    path."""
    tree: Dict[str, Any] = {}
    for name, tensor in [*model.named_parameters(), *model.named_buffers()]:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        value = tensor.detach().cpu()
        node[leaf] = (value.float() if isinstance(tensor, nn.Parameter) else value).numpy()
    return tree
