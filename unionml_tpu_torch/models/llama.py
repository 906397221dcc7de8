"""Llama-family causal decoder, counterpart of ``unionml_tpu/models/llama.py``.

A pre-norm RoPE/SwiGLU/GQA decoder whose parameter names follow the flax
tree (``embed.embedding``, ``layer_{i}.attn.q_proj.kernel``, ...,
``lm_head.kernel``), so :mod:`unionml_tpu_torch.models.convert` loads a JAX
checkpoint leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.layers import IotaEmbed, RMSNorm, TransformerBlock, init_weights


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    lora_rank: int = 0
    attention_impl: str = "auto"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def llama3_8b(cls, **overrides: Any) -> "LlamaConfig":
        defaults = dict(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            hidden_dim=14336, rope_theta=500000.0,
        )
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **overrides: Any) -> "LlamaConfig":
        """Test/dry-run scale."""
        defaults = dict(
            vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=256, max_seq_len=256,
        )
        defaults.update(overrides)
        return cls(**defaults)


class _LMHead(nn.Module):
    """Untied LM head: a bias-free dense ``[dim, vocab]`` kernel."""

    def __init__(self, dim: int, vocab_size: int, dtype: torch.dtype, param_dtype: torch.dtype, device: Any):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(dim, vocab_size, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class Llama(nn.Module):
    """Causal LM: tokens ``[B, L]`` -> logits ``[B, L, vocab]``.

    ``device=None`` builds on CUDA (and raises without a CUDA device);
    ``device="cpu"`` or ``"meta"`` must be asked for. ``seed`` fills the
    weights from a seeded ``torch.Generator`` on that device; without it they
    are left uninitialized for a checkpoint to fill.
    """

    def __init__(self, config: LlamaConfig, *, device: DeviceLike = None, seed: Optional[int] = None):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        common = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.embed = IotaEmbed(cfg.vocab_size, cfg.dim, **common)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", TransformerBlock(
                cfg.dim, cfg.n_heads, cfg.hidden_dim, cfg.n_kv_heads, rope=True,
                rope_theta=cfg.rope_theta, attention_impl=cfg.attention_impl,
                lora_rank=cfg.lora_rank, **common,
            ))
        self.final_norm = RMSNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.lm_head = _LMHead(cfg.dim, cfg.vocab_size, **common)
        if seed is not None:
            generator = torch.Generator(device=device).manual_seed(seed)
            init_weights(self, generator)

    @property
    def layers(self) -> Sequence[TransformerBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
        cache: Optional[Sequence[Any]] = None,
        token_mask: Optional[torch.Tensor] = None,
    ) -> Any:
        """``cache`` (one layer cache per layer, see
        :func:`unionml_tpu_torch.models.generate.init_cache`) switches the
        stack into incremental decoding: the return value becomes ``(out,
        cache)`` and ``positions`` must be per-example ``[B, L]``. The cache
        tensors are updated in place. ``token_mask`` is part of the shared
        cache contract; a dense decoder ignores it."""
        del token_mask
        x = self.embed(tokens)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        new_cache = []
        for i, block in enumerate(self.layers):
            if cache is not None:
                x, layer_cache = block(x, positions, None, cache[i])
                new_cache.append(layer_cache)
            else:
                x = block(x, positions)
        x = self.final_norm(x)
        if not return_hidden:
            x = self.lm_head(x)
        return (x, tuple(new_cache)) if cache is not None else x


def causal_lm_loss(model: nn.Module, batch: Any) -> torch.Tensor:
    """Next-token cross-entropy (forward only). ``batch``: ``(tokens,
    loss_mask)`` or a tokens tensor."""
    tokens, mask = batch if isinstance(batch, (tuple, list)) and len(batch) == 2 else (batch, None)
    if isinstance(tokens, (tuple, list)):
        tokens = tokens[0]
    logits = model(tokens)[:, :-1].float()
    targets = tokens[:, 1:].long()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none")
    losses = losses.reshape(targets.shape)
    if mask is not None:
        m = mask[:, 1:].float()
        return (losses * m).sum() / m.sum().clamp_min(1.0)
    return losses.mean()
