"""BERT-family bidirectional encoder with a classification head, counterpart
of ``unionml_tpu/models/bert.py`` (``BASELINE.json`` config 3).

Learned token, position and (optional) token-type embeddings, a LayerNorm,
pre-norm encoder blocks, then a ``tanh`` pooler on the first token and the
classifier. Parameter names follow the flax tree (``tok_embed.embedding``,
``layer_{i}.attn.q_proj.kernel``, ``pooler.kernel``, ...), so
:func:`~unionml_tpu_torch.models.convert.bert_from_jax` loads a JAX tree leaf
for leaf; a HuggingFace checkpoint goes through
:func:`~unionml_tpu_torch.models.convert.bert_params_from_hf_state_dict`.

The JAX module creates ``type_embed`` only when ``init`` is given
``token_type_ids``. Here the table exists when ``token_types=True`` is
asked for, and, as in JAX, a forward with ``token_type_ids`` on a module
without it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.layers import IotaEmbed, LayerNorm, LoRADense, TransformerBlock, init_weights
from unionml_tpu_torch.parallel.sharding import P, PartitionRules


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_classes: int = 2
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def base(cls, **overrides: Any) -> "BertConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides: Any) -> "BertConfig":
        defaults = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4, hidden_dim=256, max_seq_len=128)
        defaults.update(overrides)
        return cls(**defaults)


class BertEncoder(nn.Module):
    """Tokens ``[B, L]`` (with an optional ``[B, L]`` attention mask, 1 = a
    real token, and token-type ids) -> class logits ``[B, num_classes]``.

    ``device=None`` builds on CUDA (and raises without a CUDA device);
    ``device="cpu"`` or ``"meta"`` must be asked for. ``seed`` fills the
    weights from a seeded ``torch.Generator`` on that device; without it they
    are left for a checkpoint to fill. The blocks take the plain attention
    route, as the JAX module's do.
    """

    def __init__(self, config: BertConfig, *, device: DeviceLike = None, seed: Optional[int] = None,
                 token_types: bool = False):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        common = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.tok_embed = IotaEmbed(cfg.vocab_size, cfg.dim, **common)
        self.pos_embed = IotaEmbed(cfg.max_seq_len, cfg.dim, **common)
        self.type_embed = IotaEmbed(cfg.type_vocab_size, cfg.dim, **common) if token_types else None
        self.embed_norm = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", TransformerBlock(
                cfg.dim, cfg.n_heads, cfg.hidden_dim, decoder=False, **common,
            ))
        self.pooler = LoRADense(cfg.dim, cfg.dim, use_bias=True, **common)
        self.classifier = LoRADense(cfg.dim, cfg.num_classes, use_bias=True, **common)
        if seed is not None:
            init_weights(self, torch.Generator(device=device).manual_seed(seed))

    @property
    def layers(self) -> Sequence[TransformerBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(
        self,
        tokens: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        length = tokens.shape[1]
        x = self.tok_embed(tokens) + self.pos_embed(torch.arange(length, device=tokens.device))[None]
        if token_type_ids is not None:
            if self.type_embed is None:
                raise ValueError("token_type_ids given to a BertEncoder built without token_types=True "
                                 "(it has no type_embed table, as a JAX tree initialized without them)")
            x = x + self.type_embed(token_type_ids)
        x = self.embed_norm(x)
        # [B, L] padding mask (1 = real token) -> [B, 1, 1, L]: pad tokens are never attended to
        mask = attention_mask[:, None, None, :].bool() if attention_mask is not None else None
        for layer in self.layers:
            x = layer(x, mask=mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)


def bert_partition_rules() -> PartitionRules:
    """Megatron-style TP and FSDP for :class:`BertEncoder` (the JAX
    package's table: the port's paths are the flax paths)."""
    return PartitionRules(
        [
            (r"attn/(q_proj|k_proj|v_proj)/kernel", P("fsdp", "model")),
            (r"attn/o_proj/kernel", P("model", "fsdp")),
            (r"mlp/wi/kernel", P("fsdp", "model")),
            (r"mlp/wo/kernel", P("model", "fsdp")),
            (r"(tok|pos|type)_embed/embedding", P(None, "fsdp")),
            (r"(pooler|classifier)/kernel", P("fsdp", None)),
            (r".*(norm|scale|bias)", P()),
        ]
    )


def classification_loss(model: nn.Module, batch: Any) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(tokens, labels)`` or ``(tokens, attention_mask, labels)`` ->
    ``(mean cross-entropy, {"accuracy": ...})``, the logits in f32; use with
    ``make_train_step(..., has_aux=True)``."""
    if len(batch) == 3:
        tokens, attention_mask, labels = batch
        logits = model(tokens, attention_mask)
    else:
        tokens, labels = batch
        logits = model(tokens)
    labels = labels.reshape(-1).long()
    loss = F.cross_entropy(logits.float(), labels)
    accuracy = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}
