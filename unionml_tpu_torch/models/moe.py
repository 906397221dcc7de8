"""Mixture-of-Experts decoder, counterpart of ``unionml_tpu/models/moe.py``.

The Switch/Mixtral dense-dispatch formulation of the JAX package, on one
card: the router's top-k choice becomes one-hot dispatch and combine tensors
``[n_tokens, n_experts, capacity]``, and tokens move to and from the experts
through two einsums. Each expert takes a fixed ``capacity`` of tokens;
overflow tokens are dropped by the dispatch mask and pass through the
residual. Parameter names follow the flax tree
(``layer_{i}/moe/router/kernel``, ``layer_{i}/moe/experts/{wg,wi,wo}/kernel``
with a leading ``[n_experts]`` dim), so
:func:`~unionml_tpu_torch.models.convert.moe_from_jax` loads a JAX checkpoint
leaf for leaf.

What the port keeps bit for bit, since each one changes tokens:

- the top-k order on ties: the lower expert index first, as
  ``jax.lax.top_k`` (a stable descending sort; ``torch.topk`` promises no
  order);
- the capacity, ``max(1, int(capacity_factor * k * n_tokens / n_experts))``
  over the whole call's ``B x L``, so a caller must route the same ``B`` and
  ``L`` as the JAX package at every step; over a mesh whose ranks hold
  different rows of the batch (``data``, ``fsdp``, ``dcn_data``), the
  global batch's capacity, slots and aux loss, as JAX's jit computes them;
- slot priority: every token's first choice claims capacity before any
  token's second, and only ``token_mask`` tokens claim it;
- the router in f32 (quantization leaves it alone), the casts of tokens and
  gates to the compute dtype before the two einsums, and the dequantize-then-
  multiply of int8 experts.

JAX's ``sow`` of the Switch load-balance loss becomes an attribute: each
:class:`MoELayer` keeps the aux loss of its last forward in ``aux_loss``, and
:func:`moe_lm_loss` sums them. The sharding constraints of the JAX layer
(``_constrain``) are left out: a placed layer computes on its rank's
experts and sums over the ``expert`` axis itself (:meth:`MoELayer.forward`,
Megatron's f and g around the experts' share), under
:func:`moe_partition_rules`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.layers import (
    Attention,
    IotaEmbed,
    LoRADense,
    RMSNorm,
    TransformerBlock,
    init_weights,
    sharded_weight,
)
from unionml_tpu_torch.models.llama import _LMHead, _split_batch
from unionml_tpu_torch.ops.quant import QuantizedKernel, QuantizedTensor
from unionml_tpu_torch.parallel.collectives import all_gather, allreduce_sum, sum_gradients
from unionml_tpu_torch.parallel.sharding import P, PartitionRules, batch_mean, row_axes, scope_mesh, splits


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(index, n)`` (int64) without its range check, which on
    CPU tensors reads the indices on the host: a program the AOT store
    captures (a tape of ops on the CPU) must read nothing there."""
    return (index[..., None] == torch.arange(n, device=index.device)).long()


def top_k_dispatch(
    router_probs: torch.Tensor, k: int, capacity: int, valid: Optional[torch.Tensor] = None, *,
    mesh: Any = None, row_axes: Tuple[str, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build dispatch/combine tensors from router probabilities.

    :param router_probs: ``[n_tokens, n_experts]`` softmax outputs.
    :param valid: optional ``[n_tokens]`` bool; False tokens (padding) claim
        no expert capacity, get zero dispatch/combine rows, and are left out
        of the aux loss.
    :param row_axes: the ``mesh`` axes over which the ranks hold different
        rows (:func:`~unionml_tpu_torch.parallel.sharding.row_axes`): the
        tokens are then this rank's block of the global token array, in the
        axes' row-major order, and ``capacity`` is the global one. Each
        token takes the slot it takes in the global array (its rank's
        cumsum, plus the earlier ranks' claims of that expert in this
        choice, plus every rank's claims in the earlier choices), and the
        aux loss is the global one, every rank holding its value.
    :returns: ``(dispatch [N, E, C] of 0/1, combine [N, E, C], aux_loss
        scalar)``, in ``router_probs``' dtype.
    """
    n_tokens, n_experts = router_probs.shape
    dtype, device = router_probs.dtype, router_probs.device
    ranked = torch.sort(router_probs, dim=-1, descending=True, stable=True)  # ties: lower index first
    gate_vals, gate_idx = ranked.values[:, :k], ranked.indices[:, :k]
    # Mixtral-style renormalization: the k selected gates sum to 1 per token
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    onehots = []
    for slot in range(k):
        onehot = _one_hot(gate_idx[:, slot], n_experts)  # [N, E]
        if valid is not None:
            onehot = onehot * valid.long()[:, None]
        onehots.append(onehot)
    earlier = totals = None
    if row_axes:
        # every rank's claims per choice and expert, in the global rows' order
        every = torch.stack([o.sum(dim=0) for o in onehots])[None]  # [1, k, E]
        for axis in reversed(row_axes):
            every = all_gather(every, mesh, axis)
        earlier, totals = every[: mesh.index(row_axes)].sum(dim=0), every.sum(dim=0)

    dispatch = torch.zeros((n_tokens, n_experts, capacity), dtype=dtype, device=device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((n_experts,), dtype=torch.int64, device=device)
    slots = torch.arange(capacity, device=device)
    for slot, onehot in enumerate(onehots):
        # position of each token within its chosen expert's capacity buffer
        pos = torch.cumsum(onehot, dim=0) - 1 + counts[None, :]
        if earlier is None:
            counts = counts + onehot.sum(dim=0)
        else:
            pos = pos + earlier[slot][None, :]
            counts = counts + totals[slot]
        within = (pos < capacity) & (onehot > 0)
        # jax.nn.one_hot of an index outside [0, capacity) is a zero row
        slot_dispatch = ((pos[..., None] == slots) & within[..., None]).to(dtype)  # [N, E, C]
        dispatch = dispatch + slot_dispatch
        combine = combine + gate_vals[:, slot, None, None] * slot_dispatch

    # Switch load-balance loss: n_experts * sum_e f_e * p_e, minimized at uniform
    top1 = _one_hot(gate_idx[:, 0], n_experts).to(dtype)
    if row_axes:
        w = valid.to(dtype)[:, None] if valid is not None else torch.ones((n_tokens, 1), dtype=dtype, device=device)
        with torch.no_grad():
            token_sum, denom = (top1 * w).sum(dim=0), w.sum()
            for axis in row_axes:
                token_sum, denom = allreduce_sum((token_sum, denom), mesh, axis)
        # every rank holds the global mean, and the driver averages the
        # ranks' gradients: f before g sums the ranks' cotangents, so each
        # rank's probabilities take the whole of theirs
        prob_sum = (router_probs * w).sum(dim=0)
        for axis in row_axes:
            prob_sum = allreduce_sum(sum_gradients(prob_sum, mesh, axis), mesh, axis)
        denom = denom.clamp_min(1.0)
        token_frac, prob_frac = token_sum / denom, prob_sum / denom
    elif valid is None:
        token_frac = top1.mean(dim=0)
        prob_frac = router_probs.mean(dim=0)
    else:
        w = valid.to(dtype)[:, None]
        denom = w.sum().clamp_min(1.0)
        token_frac = (top1 * w).sum(dim=0) / denom
        prob_frac = (router_probs * w).sum(dim=0) / denom
    aux_loss = n_experts * torch.sum(token_frac * prob_frac)
    return dispatch, combine, aux_loss


class _StackedDense(nn.Module):
    """One dense kernel a expert, stacked ``[n_experts, in, out]`` (flax's
    ``nn.vmap`` of a bias-free ``LoRADense``): ``[E, C, in] -> [E, C, out]``.
    An int8 slot (``[E, 1, out]`` scales) dequantizes to the compute dtype
    and then multiplies, as the JAX package's ``dequantize_tree`` does."""

    quantizable = ("kernel",)
    #: set by ``place_module`` over a mesh: the stack is then this rank's
    #: experts (split over ``expert``), each tensor-parallel over ``model``
    _mesh = None
    _specs = None

    def __init__(self, n_experts: int, in_features: int, features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: Any):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(n_experts, in_features, features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel
        if self._mesh is not None:
            kernel = sharded_weight(kernel, self._specs["kernel"], self._mesh)
        if isinstance(kernel, (QuantizedKernel, QuantizedTensor)):
            weight = (kernel.q.float() * kernel.scale).to(self.dtype)
        else:
            weight = kernel.to(self.dtype)
        y = torch.bmm(x.to(self.dtype), weight)
        if self._mesh is not None and splits(self._specs["kernel"], 1, "model", self._mesh):
            y = allreduce_sum(y, self._mesh, "model")  # row-parallel inside each expert
        return y


class _Experts(nn.Module):
    """The experts' gated SwiGLU blocks (``wg``, ``wi``, ``wo``), one weight
    stack each."""

    def __init__(self, n_experts: int, features: int, hidden_dim: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: Any):
        super().__init__()
        dense = lambda i, o: _StackedDense(n_experts, i, o, dtype, param_dtype, device)  # noqa: E731
        self.wg = dense(features, hidden_dim)
        self.wi = dense(features, hidden_dim)
        self.wo = dense(hidden_dim, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.silu(self.wg(x)) * self.wi(x))


class MoELayer(nn.Module):
    """Top-k routed expert FFNs replacing a dense MLP. ``aux_loss`` holds
    the Switch load-balance loss of the last forward (``None`` before one)."""

    def __init__(self, features: int, n_experts: int, hidden_dim: int, k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16, param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        self.n_experts, self.k, self.capacity_factor, self.dtype = n_experts, k, capacity_factor, dtype
        # the router runs in f32: routing decisions are precision-sensitive (and
        # quantize_params' default exclude leaves it alone)
        self.router = LoRADense(features, n_experts, dtype=torch.float32, param_dtype=param_dtype, device=device)
        self.experts = _Experts(n_experts, features, hidden_dim, dtype, param_dtype, device)
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch, length, dim = x.shape
        n_tokens = batch * length
        tokens = x.reshape(n_tokens, dim)
        mesh = self.experts.wi._mesh
        # over a mesh whose ranks hold different rows, the layer computes
        # over the global token array (JAX's jit sees the global batch)
        rows = row_axes(mesh) if mesh is not None else ()
        n_global = n_tokens * (mesh.size(rows) if rows else 1)
        capacity = max(1, int(self.capacity_factor * self.k * n_global / self.n_experts))
        router_logits = self.router(tokens.float())
        valid = token_mask.reshape(n_tokens) if token_mask is not None else None
        dispatch, combine, self.aux_loss = top_k_dispatch(torch.softmax(router_logits, dim=-1), self.k, capacity,
                                                          valid, mesh=mesh, row_axes=rows)
        held = self.experts.wi.kernel.shape[0]
        expert_tokens = tokens
        if held != self.n_experts:
            # expert-parallel: this rank holds experts [e0, e0 + held); the
            # tokens are the same on every rank of the expert axis, so each
            # runs its experts' share and the shares sum over the axis. The
            # replicated tokens and gates enter that share through f, so
            # their cotangents sum the shares' (the router, which runs
            # replicated, takes its whole gradient through the gates)
            e0 = mesh.index("expert") * held
            combine = sum_gradients(combine, mesh, "expert")
            dispatch, combine = dispatch[:, e0:e0 + held], combine[:, e0:e0 + held]
            expert_tokens = sum_gradients(tokens, mesh, "expert")
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(self.dtype), expert_tokens.to(self.dtype))
        expert_out = self.experts(expert_in)  # [E, C, D]
        out = torch.einsum("nec,ecd->nd", combine.to(self.dtype), expert_out)
        if held != self.n_experts:
            out = allreduce_sum(out, mesh, "expert")
        return out.reshape(batch, length, dim)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 8
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    n_experts: int = 8
    k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2  # every Nth block uses MoE FFN (1 = all blocks, Mixtral-style)
    max_seq_len: int = 4096
    rope_theta: float = 500000.0
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **overrides: Any) -> "MoEConfig":
        defaults = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
            n_experts=4, k=2, moe_every=1, max_seq_len=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


class MoEBlock(nn.Module):
    """Pre-norm decoder block with a routed-experts FFN."""

    def __init__(self, config: MoEConfig, device: Any = None):
        super().__init__()
        cfg = config
        common = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.attn_norm = RMSNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.attn = Attention(cfg.dim, cfg.n_heads, cfg.n_kv_heads, causal=True, rope=True,
                              rope_theta=cfg.rope_theta, **common)
        self.moe_norm = RMSNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.moe = MoELayer(cfg.dim, cfg.n_experts, cfg.hidden_dim, k=cfg.k, capacity_factor=cfg.capacity_factor,
                            **common)

    def forward(
        self,
        x: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[Any] = None,
        token_mask: Optional[torch.Tensor] = None,
    ) -> Any:
        attn_out = self.attn(self.attn_norm(x), positions, mask, cache)
        if cache is not None:
            attn_out, cache = attn_out
        x = x + attn_out
        x = x + self.moe(self.moe_norm(x), token_mask)
        return (x, cache) if cache is not None else x


class MoETransformer(nn.Module):
    """Causal LM with routed-expert FFNs (Mixtral-family shape): tokens ``[B,
    L]`` -> logits ``[B, L, vocab]``.

    Follows :class:`~unionml_tpu_torch.models.llama.Llama`'s cache contract,
    so ``Generator``, ``ContinuousBatcher`` and ``SpeculativeGenerator`` take
    it as they take a Llama. ``token_mask`` (``[B, L]`` bool, False =
    padding) keeps pad tokens from claiming expert capacity. Capacity under
    incremental decoding is per routed group (one decode step); size
    ``capacity_factor`` for the serving batch. Every ``moe_every``-th block
    is routed, the others are dense decoder blocks. ``device`` and ``seed``
    as for ``Llama``.
    """

    def __init__(self, config: MoEConfig, *, device: DeviceLike = None, seed: Optional[int] = None):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        common = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.embed = IotaEmbed(cfg.vocab_size, cfg.dim, **common)
        for i in range(cfg.n_layers):
            if self.routed(i):
                block: nn.Module = MoEBlock(cfg, device=device)
            else:
                block = TransformerBlock(cfg.dim, cfg.n_heads, cfg.hidden_dim, cfg.n_kv_heads, rope=True,
                                         rope_theta=cfg.rope_theta, **common)
            self.add_module(f"layer_{i}", block)
        self.final_norm = RMSNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.lm_head = _LMHead(cfg.dim, cfg.vocab_size, **common)
        if seed is not None:
            init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def routed(self, i: int) -> bool:
        """Whether block ``i`` is a :class:`MoEBlock`."""
        return i % self.config.moe_every == self.config.moe_every - 1

    @property
    def layers(self) -> Sequence[nn.Module]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
        cache: Optional[Sequence[Any]] = None,
        token_mask: Optional[torch.Tensor] = None,
    ) -> Any:
        x = self.embed(tokens)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        new_cache = []
        for i, block in enumerate(self.layers):
            extra = (token_mask,) if self.routed(i) else ()  # only routed blocks consume it
            if cache is not None:
                x, layer_cache = block(x, positions, None, cache[i], *extra)
                new_cache.append(layer_cache)
            else:
                x = block(x, positions, None, None, *extra)
        x = self.final_norm(x)
        if not return_hidden:
            x = self.lm_head(x)
        return (x, tuple(new_cache)) if cache is not None else x


def moe_partition_rules() -> PartitionRules:
    """Expert-parallel layout (the JAX package's table): stacked expert
    weights shard their leading dim over ``expert``, with the megatron TP
    pattern inside each expert; everything else follows the llama rules."""
    return PartitionRules(
        [
            (r"experts/(wi|wg)/kernel", P("expert", "fsdp", "model")),
            (r"experts/wo/kernel", P("expert", "model", "fsdp")),
            (r"experts/.*(bias|scale)", P("expert")),
            (r"router/kernel", P()),
            (r"attn/(q_proj|k_proj|v_proj)/kernel", P("fsdp", "model")),
            (r"attn/o_proj/kernel", P("model", "fsdp")),
            # dense interleaved blocks (moe_every > 1) follow the llama MLP layout
            (r"mlp/(wi|wg)/kernel", P("fsdp", "model")),
            (r"mlp/wo/kernel", P("model", "fsdp")),
            (r"embed/embedding", P("model", "fsdp")),
            (r"lm_head/kernel", P("fsdp", "model")),
            (r".*(norm|scale|bias)", P()),
        ]
    )


def moe_lm_loss(model: MoETransformer, batch: Any) -> torch.Tensor:
    """Next-token cross-entropy + weighted router load-balance aux loss.

    ``batch``: tokens tensor or ``(tokens, loss_mask)``, the contract of
    :func:`~unionml_tpu_torch.models.llama.causal_lm_loss`."""
    tokens, mask = _split_batch(batch)
    logits = model(tokens)[:, :-1].float()
    targets = tokens[:, 1:].long()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none")
    losses = losses.reshape(targets.shape)
    # every routed layer's aux loss of this forward (the JAX package's "losses" collection)
    aux = sum(m.aux_loss for m in model.modules() if isinstance(m, MoELayer))
    if scope_mesh() is not None:  # under the driver over a mesh: this rank's share of the global mean
        m = mask[:, 1:].float() if mask is not None else torch.ones_like(losses)
        ce = batch_mean((losses * m).sum(), m.sum())
    elif mask is not None:
        m = mask[:, 1:].float()
        ce = (losses * m).sum() / m.sum().clamp_min(1.0)
    else:
        ce = losses.mean()
    return ce + model.config.aux_loss_weight * aux
