"""Llama-family causal decoder, counterpart of ``unionml_tpu/models/llama.py``.

A pre-norm RoPE/SwiGLU/GQA decoder whose parameter names follow the flax
tree (``embed.embedding``, ``layer_{i}.attn.q_proj.kernel``, ...,
``lm_head.kernel``), so :mod:`unionml_tpu_torch.models.convert` loads a JAX
checkpoint leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.layers import IotaEmbed, RMSNorm, TransformerBlock, init_weights
from unionml_tpu_torch.ops.int8_matmul import quantized_matmul
from unionml_tpu_torch.ops.quant import QuantizedKernel


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
    #: the kernel switch: ``"flash"`` routes the uncached forward through the
    #: flash kernels, paged single-token decode through the paged decode
    #: kernel and int8 kernels (``Generator(quantize="int8")``) through the
    #: int8 matmul kernel; ``"auto"``/``"xla"`` take the plain paths, the
    #: JAX package's numerics
    attention_impl: str = "auto"
    #: recompute each block's activations in the backward instead of keeping
    #: them (``nn.remat`` in the JAX package; ``torch.utils.checkpoint`` here)
    remat: bool = False
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
    """Untied LM head: a bias-free dense ``[dim, vocab]`` kernel, float or
    int8 (then through ``quantized_matmul`` on the route its slot records)."""

    quantizable = ("kernel",)

    def __init__(self, dim: int, vocab_size: int, dtype: torch.dtype, param_dtype: torch.dtype, device: Any):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(dim, vocab_size, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.kernel, QuantizedKernel):
            return quantized_matmul(x.to(self.dtype), self.kernel, out_dtype=self.dtype, impl=self.kernel.impl)
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
            elif self.config.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = self.final_norm(x)
        if not return_hidden:
            x = self.lm_head(x)
        return (x, tuple(new_cache)) if cache is not None else x


def lora_param_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> ``"lora"`` for adapter parameters (a name containing
    ``lora``), ``"frozen"`` for the base weights."""
    return {name: "lora" if "lora" in name else "frozen" for name, _ in model.named_parameters()}


def lora_optimizer(model: nn.Module, learning_rate: float = 1e-4, **adam_kwargs: Any) -> torch.optim.AdamW:
    """AdamW on the LoRA adapters only; the base weights are frozen
    (``requires_grad_(False)``: no gradient is computed for them, where the
    JAX package computes and zeroes it with ``optax.set_to_zero``).

    Defaults are optax.adamw's, written out: ``b1=0.9``, ``b2=0.999``,
    ``eps=1e-8``, ``weight_decay=1e-4`` (torch's own decay default is 1e-2).
    optax's names ``b1``/``b2`` are taken; other keywords go to
    :class:`torch.optim.AdamW`. The update is optax's: decoupled decay on the
    old parameter plus the bias-corrected Adam step, both times the rate."""
    labels = lora_param_labels(model)
    adapters = []
    for name, param in model.named_parameters():
        if labels[name] == "lora":
            adapters.append(param)
        else:
            param.requires_grad_(False)
    if not adapters:
        raise ValueError("the model has no LoRA parameters; build it with lora_rank > 0")
    betas = (adam_kwargs.pop("b1", 0.9), adam_kwargs.pop("b2", 0.999))
    return torch.optim.AdamW(
        adapters, lr=learning_rate, betas=betas, eps=adam_kwargs.pop("eps", 1e-8),
        weight_decay=adam_kwargs.pop("weight_decay", 1e-4), **adam_kwargs,
    )


def _split_batch(batch: Any):
    tokens, mask = batch if isinstance(batch, (tuple, list)) and len(batch) == 2 else (batch, None)
    if isinstance(tokens, (tuple, list)):
        tokens = tokens[0]
    return tokens, mask


def chunked_causal_lm_loss(model: "Llama", batch: Any, *, chunk_size: int = 256) -> torch.Tensor:
    """Next-token cross-entropy without the full ``[B, S, vocab]`` f32 logits.

    The LM head and the softmax run over ``chunk_size``-token slices, each
    under ``torch.utils.checkpoint`` (``jax.checkpoint`` in the JAX package),
    so at most one chunk's logits exist at a time and the backward recomputes
    them. The sequence is padded to a whole number of chunks (padding has
    weight 0) and the sum is divided by the mask's sum. Equal to
    :func:`causal_lm_loss` up to summation order. The head is cast to the
    hidden states' dtype once, outside the chunks."""
    tokens, mask = _split_batch(batch)
    hidden = model(tokens, return_hidden=True)[:, :-1]  # [B, S, D]
    targets = tokens[:, 1:].long()
    valid = torch.ones(targets.shape, dtype=torch.float32, device=targets.device) if mask is None \
        else mask[:, 1:].float()
    head = model.lm_head.kernel.to(hidden.dtype)
    pad = (-targets.shape[1]) % chunk_size
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        valid = F.pad(valid, (0, pad))

    def chunk_loss(h: torch.Tensor, t: torch.Tensor, m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        logits = (h @ w).float()
        losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), t.reshape(-1), reduction="none")
        return (losses * m.reshape(-1)).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, targets.shape[1], chunk_size):
        hi = lo + chunk_size
        total = total + checkpoint(chunk_loss, hidden[:, lo:hi], targets[:, lo:hi], valid[:, lo:hi], head,
                                   use_reentrant=False)
    return total / valid.sum().clamp_min(1.0)


def causal_lm_loss(model: nn.Module, batch: Any) -> torch.Tensor:
    """Next-token cross-entropy. ``batch``: ``(tokens,
    loss_mask)`` or a tokens tensor."""
    tokens, mask = _split_batch(batch)
    logits = model(tokens)[:, :-1].float()
    targets = tokens[:, 1:].long()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none")
    losses = losses.reshape(targets.shape)
    if mask is not None:
        m = mask[:, 1:].float()
        return (losses * m).sum() / m.sum().clamp_min(1.0)
    return losses.mean()
