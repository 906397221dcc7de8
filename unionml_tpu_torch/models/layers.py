"""Shared transformer building blocks (PyTorch), counterparts of
``unionml_tpu/models/layers.py``.

Conventions kept from the JAX package so the two compare like with like:

- activations ``[batch, length, heads, head_dim]``;
- ``dtype`` (compute) is separate from ``param_dtype`` (storage);
- dense kernels are stored ``[in, out]`` and applied as ``x @ W``; parameter
  names follow the flax tree (``q_proj.kernel``, ``attn_norm.scale``), so the
  weight bridge (:mod:`unionml_tpu_torch.models.convert`) maps paths 1:1;
- RoPE rotates interleaved pairs ``x[..., 0::2]``/``x[..., 1::2]``.

Where JAX returns a new cache (and donates the old buffers), the port writes
the cache tensors IN PLACE and returns the same dict: one cache lives in
device memory, as there.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch.ops.attention import multihead_attention
from unionml_tpu_torch.ops.int8_matmul import quantized_matmul
from unionml_tpu_torch.ops.quant import QuantizedKernel

#: One layer's KV cache: dense ``{"k": [B, S_max, H_kv, D], "v": ...}`` (plus
#: ``k_scale``/``v_scale`` for int8), or paged heads-major pools plus ``table``.
LayerCache = Dict[str, torch.Tensor]


def _write_cache(buffer: torch.Tensor, new: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Write ``new: [B, L, H, D]`` into ``buffer: [B, S_max, H, D]`` at per-example
    row offsets ``starts: [B]``, in place. JAX's ``dynamic_update_slice`` clamps
    each start to ``[0, S_max - L]``; the port clamps explicitly."""
    batch, length = new.shape[0], new.shape[1]
    starts = starts.long().clamp(0, buffer.shape[1] - length)
    rows = starts[:, None] + torch.arange(length, device=buffer.device)[None, :]
    buffer[torch.arange(batch, device=buffer.device)[:, None], rows] = new.to(buffer.dtype)
    return buffer


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(position, head) int8 for K/V rows: ``(int8 values, f32
    scales [..., 1])``. ``torch.round`` rounds half to even, as ``jnp.round``."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True)
    scale = scale.clamp_min(1e-8) / 127.0
    rows = torch.clamp(torch.round(x32 / scale), -127, 127)
    return rows.to(torch.int8), scale


class RMSNorm(nn.Module):
    """Root-mean-square layer norm: f32 math, f32 ``scale``, cast to ``dtype``."""

    def __init__(self, features: int, epsilon: float = 1e-6, dtype: torch.dtype = torch.bfloat16, device: Any = None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.epsilon)
        return (norm * self.scale).to(self.dtype)


class IotaEmbed(nn.Module):
    """Token embedding: a gather forward, and ``F.embedding``'s scatter-add
    backward. The JAX module's one-hot-matmul backward exists so the SPMD
    partitioner can shard the table's gradient; on one card the scatter-add
    gives the same ``dW`` (the summed rows of the output gradient per
    token), and a frozen table (LoRA) computes none."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features, dtype=param_dtype, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.embedding).to(self.dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE to ``x: [B, L, H, D]`` at integer ``positions: [L]`` (or
    ``[B, L]``), rotating interleaved pairs; angles in f32."""
    head_dim = x.shape[-1]
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    angles = positions.to(x.device).float()[..., None] * freqs  # [..., L, D/2]
    angles = angles[None, :, None] if angles.dim() == 2 else angles[:, :, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


class LoRADense(nn.Module):
    """Dense layer with an optional low-rank adapter: ``y = xW + (xA)B * (alpha/r)``.

    ``kernel`` is a float parameter, or a
    :class:`~unionml_tpu_torch.ops.quant.QuantizedKernel` after in-place
    int8 quantization; then ``xW`` is ``quantized_matmul`` in ``dtype`` on
    the route the slot records, and the adapters and the bias stay as they
    are."""

    #: parameters whose slot may hold an int8 kernel (ops/quant.set_quantized)
    quantizable = ("kernel",)

    def __init__(self, in_features: int, features: int, rank: int = 0, alpha: float = 16.0,
                 use_bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        empty = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=param_dtype, device=device))  # noqa: E731
        self.kernel = empty(in_features, features)
        if rank > 0:
            self.lora_a = empty(in_features, rank)
            self.lora_b = empty(rank, features)
        self.bias = empty(features) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.kernel, QuantizedKernel):
            y = quantized_matmul(x, self.kernel, out_dtype=self.dtype, impl=self.kernel.impl)
        else:
            y = x @ self.kernel.to(self.dtype)
        if self.rank > 0:
            y = y + ((x @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype)) * (self.alpha / self.rank)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Attention(nn.Module):
    """Multi-head (optionally grouped-query) attention with RoPE and impl dispatch.

    ``impl``: ``"auto"``/``"xla"`` (plain attention) or ``"flash"``. Under
    ``"flash"`` the uncached forward (training) goes through
    :func:`~unionml_tpu_torch.ops.flash_attention.flash_attention` and a
    paged cache's single-token decode reads the pool through
    :func:`~unionml_tpu_torch.ops.paged_attention.paged_decode_attention`;
    every other case takes the plain path, exactly as in the JAX package.
    The same switch routes the model's int8 projections
    (:func:`~unionml_tpu_torch.ops.quant.int8_route`): under ``"flash"``
    they go through the int8 matmul kernel.
    """

    def __init__(self, features: int, n_heads: int, n_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None, causal: bool = False, rope: bool = False,
                 rope_theta: float = 10000.0, impl: str = "auto", lora_rank: int = 0,
                 dtype: torch.dtype = torch.bfloat16, param_dtype: torch.dtype = torch.float32,
                 device: Any = None):
        super().__init__()
        if impl in ("ring", "ulysses"):
            raise NotImplementedError(f"attention impl {impl!r} is not ported yet (ROADMAP.md, Queue A)")
        self.n_heads = n_heads
        self.n_kv = n_kv_heads or n_heads
        self.head_dim = head_dim or features // n_heads
        self.causal, self.rope, self.rope_theta, self.impl = causal, rope, rope_theta, impl
        dense = lambda i, o: LoRADense(i, o, rank=lora_rank, dtype=dtype, param_dtype=param_dtype, device=device)  # noqa: E731
        self.q_proj = dense(features, n_heads * self.head_dim)
        self.k_proj = dense(features, self.n_kv * self.head_dim)
        self.v_proj = dense(features, self.n_kv * self.head_dim)
        self.o_proj = dense(n_heads * self.head_dim, features)

    def forward(
        self,
        x: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[LayerCache] = None,
    ) -> Any:
        batch, length = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(batch, length, self.n_heads, self.head_dim)
        k = self.k_proj(x).reshape(batch, length, self.n_kv, self.head_dim)
        v = self.v_proj(x).reshape(batch, length, self.n_kv, self.head_dim)

        if self.rope:
            if positions is None:
                positions = torch.arange(length, device=x.device)
            q = rotary_embedding(q, positions, self.rope_theta)
            k = rotary_embedding(k, positions, self.rope_theta)

        if cache is not None:
            # incremental decoding: the new rows land at each example's next
            # free slots (= absolute positions) and attention runs over the
            # whole buffer under a slot <= position visibility mask
            if positions is None or positions.dim() != 2:
                raise ValueError("cached attention requires per-example positions [B, L]")
            if mask is not None:
                raise NotImplementedError("cached attention builds its own mask")
            if "table" in cache:
                out, cache = self._paged_cached_attention(q, k, v, positions, cache)
                return self.o_proj(out.reshape(batch, length, -1)), cache
            starts = positions[:, 0]
            if "k_scale" in cache:
                kq, k_scale = quantize_kv_rows(k)
                vq, v_scale = quantize_kv_rows(v)
                for name, rows in (("k", kq), ("v", vq), ("k_scale", k_scale), ("v_scale", v_scale)):
                    _write_cache(cache[name], rows, starts)
                keys = (cache["k"].float() * cache["k_scale"]).to(q.dtype)
                values = (cache["v"].float() * cache["v_scale"]).to(q.dtype)
            else:
                _write_cache(cache["k"], k, starts)
                _write_cache(cache["v"], v, starts)
                keys, values = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
            slot = torch.arange(cache["k"].shape[1], device=x.device)
            visible = slot[None, None, None, :] <= positions[:, None, :, None]  # [B, 1, L, S_max]
            out = multihead_attention(q, keys, values, causal=False, mask=visible, impl="xla")
            return self.o_proj(out.reshape(batch, length, -1)), cache

        out = multihead_attention(q, k, v, causal=self.causal, mask=mask, impl=self.impl)
        return self.o_proj(out.reshape(batch, length, -1))

    def _paged_cached_attention(self, q, k, v, positions, cache):
        """The paged write + read. New rows scatter through the block table
        (position p -> block ``table[b, p // bs]``, offset ``p % bs``); the
        read goes through the Hopper kernel (``impl="flash"``, single-token
        decode, non-int8 pages) or the gather path (``pool[:, table]`` back to
        the logical layout under the same ``slot <= position`` mask as the
        dense branch). Pools are heads-major ``[H_kv, n_pages, page_size,
        last]``. Scatter indices collide only on the scratch block (finished
        rows), whose content is never read as live data."""
        table = cache["table"]  # [B, max_blocks] int32
        n_pages, block_size = cache["k"].shape[1], cache["k"].shape[2]
        # JAX's gathers clamp out-of-range indices; the port clamps explicitly
        entry = (positions // block_size).long().clamp(0, table.shape[1] - 1)
        blk = torch.gather(table, 1, entry.to(table.device)).long()  # [B, L]
        off = (positions % block_size).long()

        def scatter(pool: torch.Tensor, rows: torch.Tensor) -> None:
            # rows [B, L, H_kv, last] -> pool[:, blk, off] is [H_kv, B, L, last]
            pool[:, blk, off] = rows.movedim(2, 0).to(pool.dtype)

        def logical(pool: torch.Tensor) -> torch.Tensor:
            rows = pool[:, table.long().clamp(0, n_pages - 1)]  # [H_kv, B, MB, bs, last]
            rows = rows.reshape(rows.shape[0], rows.shape[1], -1, rows.shape[-1])
            return rows.permute(1, 2, 0, 3)  # [B, MB * bs, H_kv, last]

        use_kernel = self.impl == "flash" and q.shape[1] == 1
        if "k_scale" in cache:
            kq, k_scale = quantize_kv_rows(k)
            vq, v_scale = quantize_kv_rows(v)
            for name, rows in (("k", kq), ("v", vq), ("k_scale", k_scale), ("v_scale", v_scale)):
                scatter(cache[name], rows)
            # int8 pages stay on the gather path even under impl="flash", as in
            # the JAX package; the kernel takes float32/bfloat16 pages only
            keys = (logical(cache["k"]).float() * logical(cache["k_scale"])).to(q.dtype)
            values = (logical(cache["v"]).float() * logical(cache["v_scale"])).to(q.dtype)
        else:
            scatter(cache["k"], k)
            scatter(cache["v"], v)
            if use_kernel:
                from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

                # the row's visible length includes the token just scattered
                lengths = (positions[:, 0] + 1).to(torch.int32)
                out = paged_decode_attention(q[:, 0], cache["k"], cache["v"], lengths, table)
                return out[:, None], cache
            keys, values = logical(cache["k"]).to(q.dtype), logical(cache["v"]).to(q.dtype)
        slot = torch.arange(keys.shape[1], device=q.device)
        visible = slot[None, None, None, :] <= positions[:, None, :, None]  # [B, 1, L, MB * bs]
        return multihead_attention(q, keys, values, causal=False, mask=visible, impl="xla"), cache


class MLP(nn.Module):
    """Gated SwiGLU feed-forward block (the decoder's)."""

    def __init__(self, features: int, hidden_dim: int, lora_rank: int = 0, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        dense = lambda i, o: LoRADense(i, o, rank=lora_rank, dtype=dtype, param_dtype=param_dtype, device=device)  # noqa: E731
        self.wg = dense(features, hidden_dim)
        self.wi = dense(features, hidden_dim)
        self.wo = dense(hidden_dim, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.silu(self.wg(x)) * self.wi(x))


class TransformerBlock(nn.Module):
    """Pre-norm decoder block: RMSNorm, causal attention, RMSNorm, SwiGLU."""

    def __init__(self, features: int, n_heads: int, hidden_dim: int, n_kv_heads: Optional[int] = None,
                 rope: bool = False, rope_theta: float = 10000.0, attention_impl: str = "auto",
                 lora_rank: int = 0, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        self.attn_norm = RMSNorm(features, dtype=dtype, device=device)
        self.attn = Attention(
            features, n_heads, n_kv_heads, causal=True, rope=rope, rope_theta=rope_theta,
            impl=attention_impl, lora_rank=lora_rank, dtype=dtype, param_dtype=param_dtype, device=device,
        )
        self.mlp_norm = RMSNorm(features, dtype=dtype, device=device)
        self.mlp = MLP(features, hidden_dim, lora_rank=lora_rank, dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(
        self,
        x: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[LayerCache] = None,
    ) -> Any:
        attn_out = self.attn(self.attn_norm(x), positions, mask, cache)
        if cache is not None:
            attn_out, cache = attn_out
        x = x + attn_out
        x = x + self.mlp(self.mlp_norm(x))
        return (x, cache) if cache is not None else x


@torch.no_grad()
def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Random weights from a seeded ``torch.Generator`` (on the module's
    device): lecun-normal dense kernels, ``1/sqrt(dim)`` embeddings, unit norm
    scales, zero LoRA ``B`` — the flax initializers' laws, not their bits."""
    for name, param in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            param.fill_(1.0)
        elif leaf in ("lora_b", "bias"):
            param.zero_()
        elif leaf == "lora_a":
            param.normal_(0.0, 0.02, generator=generator)
        else:  # kernel [in, out] (fan_in = in) or embedding [vocab, dim] (fan_in = dim)
            fan_in = param.shape[1] if leaf == "embedding" else param.shape[0]
            param.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
