"""MLP classifier, the minimal step-mode model (``BASELINE.json`` config 2),
counterpart of ``unionml_tpu/models/mlp.py``.

Flax infers the input width at ``init``; a torch module is built with it
(``input_dim``). Layer names follow the flax tree (``dense_{i}``, ``head``,
each with ``kernel [in, out]`` and ``bias``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.layers import LoRADense, init_weights
from unionml_tpu_torch.train.driver import TrainState


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    features: Sequence[int] = (512, 256)
    num_classes: int = 10
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


class MLPClassifier(nn.Module):
    """``[B, ...]`` -> flattened to ``[B, input_dim]`` and cast to ``dtype``
    -> ``dense_{i}`` + ReLU for each width of ``config.features`` ->
    ``head`` logits ``[B, num_classes]``. ``device=None`` builds on CUDA;
    ``seed`` fills the weights from a seeded ``torch.Generator``."""

    def __init__(self, config: MLPConfig, input_dim: int, *, device: DeviceLike = None,
                 seed: Optional[int] = None):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        common = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        widths = [input_dim, *cfg.features]
        for i, (fan_in, width) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"dense_{i}", LoRADense(fan_in, width, use_bias=True, **common))
        self.head = LoRADense(widths[-1], cfg.num_classes, use_bias=True, **common)
        if seed is not None:
            init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.config.dtype)
        for i in range(len(self.config.features)):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)


def make_train_state(config: MLPConfig, input_dim: int, learning_rate: float = 1e-3, seed: int = 0, *,
                     device: DeviceLike = None) -> TrainState:
    """Convenience ``init`` for ``Model(init=...)`` apps: a seeded
    :class:`MLPClassifier` on ``device`` (``None`` = CUDA) under Adam with
    optax.adam's defaults (betas 0.9/0.999, eps 1e-8)."""
    module = MLPClassifier(config, input_dim, device=device, seed=seed)
    return TrainState(module, torch.optim.Adam(module.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8))
