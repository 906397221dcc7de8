"""Vision Transformer image classifier, counterpart of
``unionml_tpu/models/vit.py`` (``BASELINE.json`` config 5).

Images ``[B, H, W, C]`` (flax's layout) are cut into patches by one strided
convolution whose kernel stays in flax's ``[kh, kw, in, out]``; the patches
run row-major over (h, w) behind a ``cls_token``, a learned position table
is added, the shared encoder blocks run, and a LayerNorm and a dense head
classify the ``cls`` position. Parameter names follow the flax tree
(``embed.patch_embed.kernel``, ``embed.cls_token``, ``embed.pos_embed``,
``layer_{i}...``, ``head.final_norm.scale``, ``head.head.kernel``).

:class:`PipelinedViT` runs the blocks as stacked stages over a mesh's
``pipe`` axis (:func:`~unionml_tpu_torch.parallel.pipeline.pipeline_apply`),
with :class:`ViTStage` as its stage; :func:`vit_partition_rules` and
:func:`pipelined_vit_partition_rules` are the JAX package's tables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.layers import Conv, LayerNorm, LoRADense, TransformerBlock, init_weights
from unionml_tpu_torch.parallel.sharding import P, PartitionRules, gathered


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    hidden_dim: int = 4096
    num_classes: int = 1000
    channels: int = 3
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def large(cls, **overrides: Any) -> "ViTConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides: Any) -> "ViTConfig":
        defaults = dict(image_size=32, patch_size=8, dim=128, n_layers=2, n_heads=4, hidden_dim=256, num_classes=10)
        defaults.update(overrides)
        return cls(**defaults)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class ViTEmbed(nn.Module):
    """Patchify + ``cls_token`` + position table: images -> ``[B, 1 +
    n_patches, dim]``. An ``image_size`` that ``patch_size`` does not divide
    is refused (the JAX module would pad it under ``SAME``)."""

    def __init__(self, config: ViTConfig, device: Any = None):
        super().__init__()
        cfg = self.config = config
        if cfg.image_size % cfg.patch_size:
            raise ValueError(f"image_size {cfg.image_size} is not a multiple of patch_size {cfg.patch_size}")
        self.patch_embed = Conv(cfg.channels, cfg.dim, (cfg.patch_size, cfg.patch_size),
                                strides=(cfg.patch_size, cfg.patch_size), dtype=cfg.dtype,
                                param_dtype=cfg.param_dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim, dtype=cfg.param_dtype, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.n_patches, cfg.dim, dtype=cfg.param_dtype,
                                                  device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if tuple(images.shape[1:3]) != (cfg.image_size, cfg.image_size):
            raise ValueError(f"images {tuple(images.shape)} are not [B, {cfg.image_size}, {cfg.image_size}, C]")
        x = self.patch_embed(images)  # [B, h, w, dim]
        batch = x.shape[0]
        x = x.reshape(batch, -1, cfg.dim)  # row-major over (h, w), as the flax reshape
        cls = self.cls_token.to(cfg.dtype).expand(batch, 1, cfg.dim)
        return torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)


class ViTHead(nn.Module):
    """Final LayerNorm + the dense head on the ``cls`` position."""

    def __init__(self, config: ViTConfig, device: Any = None):
        super().__init__()
        self.final_norm = LayerNorm(config.dim, dtype=config.dtype, device=device)
        self.head = LoRADense(config.dim, config.num_classes, use_bias=True, dtype=config.dtype,
                              param_dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.final_norm(x)[:, 0])


class ViT(nn.Module):
    """Images ``[B, H, W, C]`` -> class logits ``[B, num_classes]``.

    ``device=None`` builds on CUDA (and raises without a CUDA device);
    ``device="cpu"`` or ``"meta"`` must be asked for. ``seed`` fills the
    weights from a seeded ``torch.Generator`` on that device. The blocks take
    the plain attention route, as the JAX module's do (197 positions at
    224/16 are not tiled by the flash blocks in either package).
    """

    def __init__(self, config: ViTConfig, *, device: DeviceLike = None, seed: Optional[int] = None):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        self.embed = ViTEmbed(cfg, device=device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", TransformerBlock(
                cfg.dim, cfg.n_heads, cfg.hidden_dim, decoder=False, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype, device=device,
            ))
        self.head = ViTHead(cfg, device=device)
        if seed is not None:
            init_weights(self, torch.Generator(device=device).manual_seed(seed))

    @property
    def layers(self) -> Sequence[TransformerBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.embed(images)
        for layer in self.layers:
            x = layer(x)
        return self.head(x)


class ViTStage(nn.Module):
    """One pipeline stage: ``layers_per_stage`` encoder blocks
    (``layer_{i}``), shape and dtype preserving (what
    :func:`~unionml_tpu_torch.parallel.pipeline.pipeline_apply` needs)."""

    def __init__(self, config: ViTConfig, layers_per_stage: int, device: Any = None):
        super().__init__()
        self.layers_per_stage = layers_per_stage
        for i in range(layers_per_stage):
            self.add_module(f"layer_{i}", TransformerBlock(
                config.dim, config.n_heads, config.hidden_dim, decoder=False, dtype=config.dtype,
                param_dtype=config.param_dtype, device=device,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers_per_stage):
            x = getattr(self, f"layer_{i}")(x)
        return x


def _module_tree(module: nn.Module) -> Dict[str, Any]:
    from unionml_tpu_torch.parallel.pipeline import _nest

    return _nest({name: p.detach() for name, p in module.named_parameters()})


class PipelinedViT:
    """ViT split into stages for pipeline parallelism over the ``pipe`` axis.

    Not an ``nn.Module``, as in the JAX package: the stage stack is a
    stacked parameter tree driven by
    :func:`~unionml_tpu_torch.parallel.pipeline.pipeline_apply`. Its params
    are a nested mapping ``{"embed": ..., "stages": {... [S, ...]},
    "head": ...}`` of tensors whose paths are the JAX tree's; the embed and
    head run on every rank outside the pipeline. The modules held here are
    templates on the meta device that ``torch.func.functional_call`` fills
    from the params at each call."""

    def __init__(self, config: ViTConfig, n_stages: int, n_microbatches: int = 4):
        if config.n_layers % n_stages:
            raise ValueError(f"n_layers={config.n_layers} not divisible by n_stages={n_stages}")
        self.config = config
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.layers_per_stage = config.n_layers // n_stages
        self.embed = ViTEmbed(config, device="meta")
        self.stage = ViTStage(config, self.layers_per_stage, device="meta")
        self.head = ViTHead(config, device="meta")

    def init(self, generator: Optional[torch.Generator] = None, *, device: DeviceLike = None) -> Dict[str, Any]:
        """Random params on ``device`` (``None`` = CUDA) from ``generator``
        (on that device): the embed, each stage in turn, the head, with
        :func:`~unionml_tpu_torch.models.layers.init_weights`'s laws."""
        from unionml_tpu_torch.parallel.pipeline import init_stage_params

        cfg, device = self.config, resolve_device(device)
        embed = ViTEmbed(cfg, device=device)
        init_weights(embed, generator)
        stages = init_stage_params(lambda: ViTStage(cfg, self.layers_per_stage, device=device), self.n_stages,
                                   generator)
        head = ViTHead(cfg, device=device)
        init_weights(head, generator)
        return {"embed": _module_tree(embed), "stages": stages, "head": _module_tree(head)}

    def apply(self, params: Mapping[str, Any], images: torch.Tensor, mesh: Any = None,
              rules: Optional[PartitionRules] = None) -> torch.Tensor:
        """Forward pass of this rank's images. Pass the ``rules`` the params
        were placed with, so the stage stack stays sharded at rest over
        fsdp/model inside the pipeline (each rank gathers its own stage) and
        the embed and head leaves are gathered at use; without rules every
        leaf must be whole but for the stage dim. Without a mesh (or with
        ``pipe`` of 1) the stages run one after another."""
        from unionml_tpu_torch.parallel.pipeline import _flat, pipeline_apply, sequential_stage_apply, stage_call

        def whole(prefix: str, tree: Mapping[str, Any]) -> Dict[str, Any]:
            flat = _flat(tree, sep="/")
            if mesh is not None and rules is not None:
                flat = {k: gathered(v, rules.spec_for(f"{prefix}/{k}") or P(), mesh, keep=()) for k, v in flat.items()}
            return {k.replace("/", "."): v for k, v in flat.items()}

        from torch.func import functional_call

        x = functional_call(self.embed, whole("embed", params["embed"]), (images,))
        stage_fn = stage_call(self.stage)
        if mesh is None:
            x = sequential_stage_apply(stage_fn, params["stages"], x)
        else:
            specs = stage_param_specs(params["stages"], rules) if rules is not None else None
            x = pipeline_apply(stage_fn, params["stages"], x, mesh, n_microbatches=self.n_microbatches,
                               param_specs=specs)
        return functional_call(self.head, whole("head", params["head"]), (x,))


def stage_param_specs(stage_params: Mapping[str, Any], rules: PartitionRules, prefix: str = "stages/"
                      ) -> Dict[str, Any]:
    """The specs of a stacked-stage subtree (a nested mapping like it) from
    a rule table written against whole-tree paths (``stages/...``)."""
    def walk(tree: Mapping[str, Any], path: str) -> Dict[str, Any]:
        return {k: walk(v, f"{path}{k}/") if isinstance(v, Mapping) else (rules.spec_for(f"{path}{k}") or P("pipe"))
                for k, v in tree.items()}

    return walk(stage_params, prefix)


def pipelined_vit_partition_rules() -> PartitionRules:
    """Rules for the :class:`PipelinedViT` params tree: stacked stages gain a
    leading ``pipe`` entry; the embed and head replicate but for the patch
    kernel's and head kernel's ``fsdp`` dims (the JAX package's table)."""
    from unionml_tpu_torch.parallel.pipeline import pipeline_rule_table

    stage_rules = [
        (r"attn/(q_proj|k_proj|v_proj)/kernel", P("fsdp", "model")),
        (r"attn/o_proj/kernel", P("model", "fsdp")),
        (r"mlp/wi/kernel", P("fsdp", "model")),
        (r"mlp/wo/kernel", P("model", "fsdp")),
    ]
    return PartitionRules(
        pipeline_rule_table(stage_rules)
        + [
            (r"embed/patch_embed/kernel", P(None, None, None, "fsdp")),
            (r"head/head/kernel", P("fsdp", None)),
            (r".*", P()),
        ]
    )


def vit_partition_rules() -> PartitionRules:
    """Megatron-style TP and FSDP for :class:`ViT` (the JAX package's table)."""
    return PartitionRules(
        [
            (r"attn/(q_proj|k_proj|v_proj)/kernel", P("fsdp", "model")),
            (r"attn/o_proj/kernel", P("model", "fsdp")),
            (r"mlp/wi/kernel", P("fsdp", "model")),
            (r"mlp/wo/kernel", P("model", "fsdp")),
            (r"patch_embed/kernel", P(None, None, None, "fsdp")),
            (r"head/kernel", P("fsdp", None)),
            (r".*(norm|scale|bias|cls_token|pos_embed)", P()),
        ]
    )
