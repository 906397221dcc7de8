"""Weight bridge: flax parameter trees <-> the port's modules.

The port's parameter names are the flax paths with ``/`` written as ``.``
(``layer_0/attn/q_proj/kernel`` -> ``layer_0.attn.q_proj.kernel``) and its
kernels stay ``[in, out]``, so a leaf loads as it is. The bridge takes the tree
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), so this package never imports JAX. It raises on any leaf left
over and on any parameter left missing, and casts once to the dtype asked for.
The way back, :func:`llama_params_to_numpy`, gives a module's parameters as
the same nested dicts, so trained weights compare leaf for leaf. The encoder
models (BERT, ViT, the MLP classifier) cross the same way
(:func:`bert_from_jax`, :func:`vit_from_jax`, :func:`mlp_from_jax`; the
pipelined ViT's stacked tree through :func:`pipelined_vit_from_jax`), and a
HuggingFace BERT state dict becomes the JAX package's tree through
:func:`bert_params_from_hf_state_dict`.

Quantized leaves cross too. In the tree they are objects with ``.q``/``.scale``
fields (what ``tree_map(np.asarray, quantize_params(params))`` gives) or
``{"q", "scale"}`` dicts, recognized by those fields alone; in the port they
are :class:`~unionml_tpu_torch.ops.quant.QuantizedKernel` slots whose
buffers ``kernel.q``/``kernel.scale`` load bit for bit, and the way back
gives them as ``{"q", "scale"}`` dicts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.bert import BertConfig, BertEncoder
from unionml_tpu_torch.models.llama import Llama, LlamaConfig
from unionml_tpu_torch.models.mlp import MLPClassifier, MLPConfig
from unionml_tpu_torch.models.moe import MoEConfig, MoETransformer
from unionml_tpu_torch.models.vit import PipelinedViT, ViT, ViTConfig
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
    return _with_int8_slots(Llama(config, device="meta"), tree)


def _with_int8_slots(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """``module`` (on the meta device) with an (empty) int8 slot for every
    kernel that ``tree`` holds quantized."""
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
    return _load(_meta_llama(tree, config), tree, device)


def moe_from_jax(tree: Mapping[str, Any], config: MoEConfig, *, device: DeviceLike = None) -> MoETransformer:
    """A :class:`~unionml_tpu_torch.models.moe.MoETransformer` on ``device``
    (``None`` = CUDA) loaded from a flax MoE tree, as :func:`llama_from_jax`
    loads a Llama: the routed blocks' ``layer_{i}/moe/router/kernel`` and
    ``layer_{i}/moe/experts/{wg,wi,wo}/kernel`` (``[n_experts, in, out]``,
    quantized with ``[n_experts, 1, out]`` scales or not), the dense blocks'
    ``layer_{i}/mlp/...``, and the shared leaves of a Llama tree."""
    return _load(_with_int8_slots(MoETransformer(config, device="meta"), tree), tree, device)


def _load(module: nn.Module, tree: Mapping[str, Any], device: DeviceLike) -> nn.Module:
    state = state_dict_from_jax(tree, module)
    module = module.to_empty(device=resolve_device(device))
    module.load_state_dict(state)
    return module


def llama_params_to_numpy(model: nn.Module) -> Dict[str, Any]:
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


#: the way back of :func:`moe_from_jax`: the same walk over a
#: ``MoETransformer``'s parameters and int8 buffers
moe_params_to_numpy = llama_params_to_numpy


def bert_from_jax(tree: Mapping[str, Any], config: BertConfig, *, device: DeviceLike = None) -> BertEncoder:
    """A :class:`~unionml_tpu_torch.models.bert.BertEncoder` on ``device``
    (``None`` = CUDA) loaded from a flax BERT tree (``tok_embed``,
    ``pos_embed``, ``embed_norm``, ``layer_{i}``, ``pooler``, ``classifier``
    and, when the tree has it, ``type_embed``: the module gets the table
    exactly when the tree holds one)."""
    return _load(BertEncoder(config, device="meta", token_types="type_embed" in tree), tree, device)


def vit_from_jax(tree: Mapping[str, Any], config: ViTConfig, *, device: DeviceLike = None) -> ViT:
    """A :class:`~unionml_tpu_torch.models.vit.ViT` on ``device`` (``None`` =
    CUDA) loaded from a flax ViT tree (``embed/{patch_embed,cls_token,
    pos_embed}``, ``layer_{i}``, ``head/{final_norm,head}``); the patch
    kernel loads in flax's ``[kh, kw, in, out]`` as it is."""
    return _load(ViT(config, device="meta"), tree, device)


def mlp_from_jax(tree: Mapping[str, Any], config: MLPConfig, *, device: DeviceLike = None) -> MLPClassifier:
    """A :class:`~unionml_tpu_torch.models.mlp.MLPClassifier` on ``device``
    (``None`` = CUDA) loaded from a flax tree (``dense_{i}``, ``head``); the
    input width is read from the first kernel."""
    first = tree["dense_0"] if config.features else tree["head"]
    return _load(MLPClassifier(config, int(np.shape(first["kernel"])[0]), device="meta"), tree, device)


def pipelined_vit_from_jax(tree: Mapping[str, Any], config: ViTConfig, n_stages: int, *,
                           device: DeviceLike = None, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A :class:`~unionml_tpu_torch.models.vit.PipelinedViT` params tree on
    ``device`` (``None`` = CUDA) from the JAX ``PipelinedViT`` tree:
    ``embed`` and ``head`` leaf for leaf, and the ``stages`` subtree's
    stacked ``[n_stages, ...]`` leaves as they are (the same nesting: a
    stage's parameter paths under ``stages/``). Every leaf must match the
    model's names and shapes; each becomes a tensor in ``dtype`` (default
    ``config.param_dtype``)."""
    model = PipelinedViT(config, n_stages)
    dtype = dtype or config.param_dtype
    device = resolve_device(device)
    expected = {f"embed.{n}": tuple(p.shape) for n, p in model.embed.named_parameters()}
    expected.update({f"stages.{n}": (n_stages, *p.shape) for n, p in model.stage.named_parameters()})
    expected.update({f"head.{n}": tuple(p.shape) for n, p in model.head.named_parameters()})
    from unionml_tpu_torch.parallel.pipeline import _nest

    flat = _flatten(tree)
    if set(flat) != set(expected):
        raise ValueError(f"tree leaves {sorted(set(flat) ^ set(expected))} do not match PipelinedViT's parameters")
    for name, value in flat.items():
        if tuple(np.shape(value)) != expected[name]:
            raise ValueError(f"{name}: shape {np.shape(value)} is not {expected[name]}")
    # a copy: the tree's arrays may be read-only, and the params are trained in place
    return _nest({name: torch.tensor(np.asarray(value), dtype=dtype, device=device) for name, value in flat.items()})


def pipelined_vit_params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The way back of :func:`pipelined_vit_from_jax`: the params tree as
    nested dicts of f32 numpy arrays, stacked stage leaves included."""
    return {k: pipelined_vit_params_to_numpy(v) if isinstance(v, Mapping) else
            v.detach().float().cpu().numpy() for k, v in params.items()}


#: the ways back of :func:`bert_from_jax`, :func:`vit_from_jax` and
#: :func:`mlp_from_jax`: the same walk over the module's parameters
bert_params_to_numpy = vit_params_to_numpy = mlp_params_to_numpy = llama_params_to_numpy


def bert_params_from_hf_state_dict(
    state_dict: Union[Mapping[str, Any], str, "os.PathLike[str]"], config: BertConfig
) -> Dict[str, Any]:
    """The JAX package's BERT tree (``load_hf_bert_params``'s mapping) from a
    HuggingFace BERT state dict: a ``{name: tensor or array}`` mapping in
    memory, or the path of one saved with ``torch.save`` (e.g. a local
    ``pytorch_model.bin``). Names may carry the ``bert.`` prefix of the
    task models. Nothing is downloaded and ``transformers`` is not needed.

    The tree is the reference's exactly: nested dicts of f32 numpy arrays
    with ``tok_embed``, ``pos_embed`` (cut to ``config.max_seq_len`` rows),
    ``type_embed``, ``embed_norm``, ``pooler`` and ``layer_{i}`` for
    ``config.n_layers`` layers, and no ``classifier`` (a fine-tune adds its
    own). Load it with :func:`bert_from_jax` once a classifier is merged in.

    It reproduces the reference's mapping, not HF BERT's function: HF BERT
    is post-norm, and the mapping puts each layer's post-attention norm
    (``attention.output.LayerNorm``) in the pre-norm ``attn_norm`` slot and
    its post-FFN norm (``output.LayerNorm``) in ``mlp_norm``; the blocks
    have no projection biases, so HF's query/key/value/output and FFN biases
    are dropped."""
    if isinstance(state_dict, (str, os.PathLike)):
        state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
    sd = {}
    for name, value in state_dict.items():
        value = value.detach().cpu().float().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        sd[name[len("bert."):] if name.startswith("bert.") else name] = value

    def dense(prefix: str) -> Dict[str, np.ndarray]:
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def norm(prefix: str) -> Dict[str, np.ndarray]:
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    params: Dict[str, Any] = {
        "tok_embed": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "pos_embed": {"embedding": sd["embeddings.position_embeddings.weight"][: config.max_seq_len]},
        "type_embed": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
        "embed_norm": norm("embeddings.LayerNorm"),
        "pooler": dense("pooler.dense"),
    }
    for i in range(config.n_layers):
        hf = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attn_norm": norm(f"{hf}.attention.output.LayerNorm"),
            "attn": {
                "q_proj": {"kernel": sd[f"{hf}.attention.self.query.weight"].T},
                "k_proj": {"kernel": sd[f"{hf}.attention.self.key.weight"].T},
                "v_proj": {"kernel": sd[f"{hf}.attention.self.value.weight"].T},
                "o_proj": {"kernel": sd[f"{hf}.attention.output.dense.weight"].T},
            },
            "mlp_norm": norm(f"{hf}.output.LayerNorm"),
            "mlp": {
                "wi": {"kernel": sd[f"{hf}.intermediate.dense.weight"].T},
                "wo": {"kernel": sd[f"{hf}.output.dense.weight"].T},
            },
        }
    return params
