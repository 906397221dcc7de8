"""Vision Transformer image classifier, counterpart of
``unionml_tpu/models/vit.py`` (``BASELINE.json`` config 5).

Images ``[B, H, W, C]`` (flax's layout) are cut into patches by one strided
convolution whose kernel stays in flax's ``[kh, kw, in, out]``; the patches
run row-major over (h, w) behind a ``cls_token``, a learned position table
is added, the shared encoder blocks run, and a LayerNorm and a dense head
classify the ``cls`` position. Parameter names follow the flax tree
(``embed.patch_embed.kernel``, ``embed.cls_token``, ``embed.pos_embed``,
``layer_{i}...``, ``head.final_norm.scale``, ``head.head.kernel``).

The pipeline-parallel ``ViTStage``/``PipelinedViT`` and the partition rules
wait for the port's parallelism (``ROADMAP.md``, Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.layers import Conv, LayerNorm, LoRADense, TransformerBlock, init_weights


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
