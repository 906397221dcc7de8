"""Weight bridge: flax parameter trees <-> the port's modules.

The port's parameter names are the flax paths with ``/`` written as ``.``
(``layer_0/attn/q_proj/kernel`` -> ``layer_0.attn.q_proj.kernel``) and its
kernels stay ``[in, out]``, so a leaf loads as it is. The bridge takes the tree
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), so this package never imports JAX. It raises on any leaf left
over and on any parameter left missing, and casts once to the dtype asked for.
The way back, :func:`llama_params_to_numpy`, gives a module's parameters as
the same nested dicts, so trained weights compare leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from unionml_tpu_torch.models.llama import Llama, LlamaConfig


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = value
    return flat


def state_dict_from_jax(
    tree: Mapping[str, Any], module: nn.Module, dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``module`` from a flax tree of numpy arrays. Every
    leaf must name one of the module's parameters with the same shape, and
    every parameter must be named. ``dtype`` (default: each parameter's own)
    is applied once, here; ``module.load_state_dict`` then copies to its
    device."""
    flat = _flatten(tree)
    expected = module.state_dict()
    leftover = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if leftover or missing:
        raise ValueError(f"flax tree does not match the module: leftover {leftover}, missing {missing}")
    out = {}
    for name, ref in expected.items():
        value = np.asarray(flat[name])
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: flax shape {value.shape} != port shape {tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(value, order="C")).to(dtype or ref.dtype)
    return out


def llama_params_from_jax(
    tree: Mapping[str, Any], config: LlamaConfig, dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.Tensor]:
    """The :class:`Llama` state dict for ``config`` from a flax Llama param
    tree (``embed/embedding``, ``layer_{i}/attn/{q,k,v,o}_proj/kernel``,
    ``layer_{i}/mlp/{wg,wi,wo}/kernel``, ``layer_{i}/{attn,mlp}_norm/scale``,
    ``final_norm/scale``, ``lm_head/kernel`` and the ``lora_a``/``lora_b``
    adapters where ``lora_rank > 0``). Load it with
    ``Llama(config, device=...).load_state_dict(...)``."""
    return state_dict_from_jax(tree, Llama(config, device="meta"), dtype)


def llama_params_to_numpy(model: Llama) -> Dict[str, Any]:
    """The way back of :func:`llama_params_from_jax`: a :class:`Llama`'s
    parameters as nested dicts of f32 numpy arrays shaped like the flax tree
    (``layer_0.attn.q_proj.kernel`` -> ``tree["layer_0"]["attn"]["q_proj"]["kernel"]``)."""
    tree: Dict[str, Any] = {}
    for name, param in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = param.detach().float().cpu().numpy()
    return tree
