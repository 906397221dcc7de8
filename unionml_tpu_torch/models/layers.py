"""Shared transformer building blocks (PyTorch), counterparts of
``unionml_tpu/models/layers.py``.

Conventions kept from the JAX package so the two compare like with like:

- activations ``[batch, length, heads, head_dim]``;
- ``dtype`` (compute) is separate from ``param_dtype`` (storage);
- dense kernels are stored ``[in, out]`` and applied as ``x @ W``; parameter
  names follow the flax tree (``q_proj.kernel``, ``attn_norm.scale``), so the
  weight bridge (:mod:`unionml_tpu_torch.models.convert`) maps paths 1:1;
- RoPE rotates interleaved pairs ``x[..., 0::2]``/``x[..., 1::2]``;
- convolution kernels keep flax's ``[kh, kw, in, out]`` and images flax's
  ``[B, H, W, C]``; :class:`Conv` permutes both at the call.

Where JAX returns a new cache (and donates the old buffers), the port writes
the cache tensors IN PLACE and returns the same dict: one cache lives in
device memory, as there.

Over a mesh (:func:`unionml_tpu_torch.parallel.sharding.place_module`) each
layer holds only its rank's shards and runs the collectives its sharding
implies, where GSPMD inserts them in the JAX package: axes other than
``model`` and ``expert`` (``fsdp``) are all-gathered before use; a kernel
split over ``model`` on its output dim is column-parallel (this rank's
output columns: its heads, its MLP hidden units), one split on its input
dim row-parallel (a sum over ``model`` follows); the embedding table and
the LM head are vocab-parallel (a masked lookup and a sum; the head's
logits gathered). Attention infers its local head counts from its
projections' widths, so the paged decode kernel reads only this rank's
``H_kv / model`` heads.

Training runs the same layers backward. The collectives carry gradients
(``parallel/collectives.py``): a column-parallel layer's input passes
Megatron's *f* (``sum_gradients``: each rank's input gradient is a part of
the whole), a row-parallel layer's output sum is *g* (``allreduce_sum``);
a LoRA adapter and a bias follow their layer's split (see
:class:`LoRADense`), and an FSDP gather at use keeps only the shard for
the backward, gathering again there (:func:`gathered_matmul`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch.ops.attention import multihead_attention
from unionml_tpu_torch.ops.int8_matmul import quantized_matmul
from unionml_tpu_torch.ops.quant import QuantizedKernel, QuantizedTensor
from unionml_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention
from unionml_tpu_torch.parallel.collectives import all_gather, allreduce_sum, gather_from, split_to, sum_gradients
from unionml_tpu_torch.parallel.sharding import (
    _gather_axes,
    gather_raw,
    gather_transpose,
    gathered,
    record_spec,
    scale_spec,
    splits,
)

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


class _GatheredMatmul(torch.autograd.Function):
    """``x @ gathered(w).to(dtype)`` that saves the shard, not the gathered
    weight: the backward gathers it again (as torch's FSDP does), so a rank
    never holds more than one layer's gathered weight. The weight's own
    gradient (skipped for a frozen weight) goes back through the gather's
    transpose."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, w: torch.Tensor, steps: list, mesh: Any, dtype: torch.dtype) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.args = (steps, mesh, dtype)
        return x @ gather_raw(w.to(dtype), steps, mesh)

    @staticmethod
    def backward(ctx: Any, dy: torch.Tensor) -> Any:
        x, w = ctx.saved_tensors
        steps, mesh, dtype = ctx.args
        full = gather_raw(w.to(dtype), steps, mesh)
        dx = dy @ full.t() if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ dy.reshape(-1, dy.shape[-1])
            dw = gather_transpose(dw.to(w.dtype), steps, mesh)
        return dx, dw, None, None, None


def gathered_matmul(x: torch.Tensor, w: torch.Tensor, spec: Any, mesh: Any, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in ``dtype`` for a placed float kernel ``w``: every axis of
    ``spec`` but ``model`` and ``expert`` gathered at use (the compute
    copy, cast first, is what crosses), and kept for the backward only as
    the shard. With nothing to gather it is the plain product."""
    steps = [] if mesh is None else _gather_axes(spec, mesh, ("model", "expert"))
    if not steps:
        return x @ w.to(dtype)
    return _GatheredMatmul.apply(x, w, steps, mesh, dtype)


def model_input(x: torch.Tensor, dense: "LoRADense") -> Optional[torch.Tensor]:
    """``x`` through *f* (:func:`sum_gradients` over ``model``) when
    ``dense`` is column-parallel, else None: what an attention or MLP block
    passes as ``entered`` to its column-parallel projections, so their
    input gradients are summed once."""
    mesh = dense._mesh
    if mesh is None or not splits(dense._specs["kernel"], 1, "model", mesh):
        return None
    return sum_gradients(x, mesh, "model")


def sharded_weight(kernel: Any, spec: Any, mesh: Any) -> Any:
    """A placed kernel (float, or an int8 slot) with every axis but
    ``model`` and ``expert`` all-gathered: the weight this rank multiplies
    by. An int8 slot that needs no gather is returned as it is (its
    ``kernel_checked`` flag then keeps holding)."""
    if isinstance(kernel, QuantizedKernel):
        q = gathered(kernel.q, spec, mesh)
        scale = gathered(kernel.scale, scale_spec(kernel.scale.shape, spec), mesh)
        return kernel if q is kernel.q and scale is kernel.scale else QuantizedTensor(q, scale)
    return gathered(kernel, spec, mesh)


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


#: flax ``nn.LayerNorm``'s default epsilon, which every encoder uses (torch's is 1e-5)
_FLAX_LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (the encoder's norm): statistics in f32 with
    ``epsilon=1e-6`` and the fast variance ``E[x^2] - E[x]^2`` clipped at 0,
    f32 ``scale``/``bias``, the result cast to ``dtype``. (torch's
    ``LayerNorm`` uses 1e-5 and the two-pass variance.)"""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16, device: Any = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + _FLAX_LN_EPS) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` (with its bias) over ``[B, H, W, C]`` images with ``SAME`` padding:
    the kernel is kept ``[kh, kw, in, out]`` (so a flax tree loads as it
    is) and permuted to torch's ``[out, in, kh, kw]`` at the call, the
    images to ``[B, C, H, W]`` and the result back to ``[B, H', W', out]``.
    The input, kernel and bias are cast to ``dtype``. ``SAME`` pads each
    spatial side as XLA does: ``max((ceil(n / s) - 1) * s + k - n, 0)`` in
    all, the odd one at the end."""

    #: set by ``place_module`` over a mesh (the leaves are then this rank's shards, gathered at use)
    _mesh = None
    _specs = None

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        self.kernel_size, self.strides, self.dtype = tuple(kernel_size), tuple(strides), dtype
        self.kernel = nn.Parameter(torch.empty(*kernel_size, in_features, features, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        pads = []
        for size, k, s in reversed(list(zip(x.shape[2:], self.kernel_size, self.strides))):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        kernel, bias = self.kernel, self.bias
        if self._mesh is not None:
            kernel = gathered(kernel, self._specs["kernel"], self._mesh)
            bias = gathered(bias, self._specs["bias"], self._mesh)
        y = F.conv2d(x, kernel.to(self.dtype).permute(3, 2, 0, 1), bias.to(self.dtype), stride=self.strides)
        return y.permute(0, 2, 3, 1)


class IotaEmbed(nn.Module):
    """Token embedding: a gather forward, and ``F.embedding``'s scatter-add
    backward. The JAX module's one-hot-matmul backward exists so the SPMD
    partitioner can shard the table's gradient; on one card the scatter-add
    gives the same ``dW`` (the summed rows of the output gradient per
    token), and a frozen table (LoRA) computes none."""

    #: set by ``place_module`` over a mesh (the table is then this rank's shard)
    _mesh = None
    _specs = None

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features, dtype=param_dtype, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Over a mesh the lookup is vocab-parallel: this rank's rows answer
        the tokens in its range, the others read 0, and the sum over
        ``model`` is exact (one nonzero term a token). A table split on its
        feature dim gathers the features instead."""
        mesh, tokens = self._mesh, tokens.long()
        spec = None if mesh is None else self._specs["embedding"]
        table = self.embedding
        if mesh is not None:
            if _gather_axes(spec, mesh, ("model", "expert")):
                table = table.to(self.dtype)  # the compute copy crosses (a lookup commutes with the cast)
            table = gathered(table, spec, mesh)
        if mesh is not None and splits(spec, 0, "model", mesh):
            rows = table.shape[0]
            local = tokens - mesh.index("model") * rows
            inside = (local >= 0) & (local < rows)
            out = F.embedding(local.clamp(0, rows - 1), table) * inside[..., None].to(table.dtype)
            return allreduce_sum(out, mesh, "model").to(self.dtype)
        out = F.embedding(tokens, table)
        if mesh is not None and splits(spec, 1, "model", mesh):
            out = gather_from(out, mesh, "model", gather_axis=-1)
        return out.to(self.dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE to ``x: [B, L, H, D]`` at integer ``positions: [L]`` (or
    ``[B, L]``), rotating interleaved pairs; angles in f32."""
    head_dim = x.shape[-1]
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim
    # a fill, not a host copy: the forward runs inside captured CUDA graphs
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exponent)
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
    #: set by ``place_module`` over a mesh (the kernel is then this rank's shard)
    _mesh = None
    _specs = None

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

    def forward(self, x: torch.Tensor, entered: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Over a mesh, column-parallel (kernel split over ``model`` on its
        output dim) gives this rank's output columns from ``x`` passed
        through *f* (or from ``entered``, the caller's ``model_input(x)``);
        row-parallel (split on its input dim) takes this rank's input
        columns in ``x`` and sums the products over ``model``.

        The adapter: column-parallel, ``x @ A`` passes *f* before this
        rank's columns of ``B``; row-parallel, this rank's rows of ``A``
        (gathered back in the backward) and the whole ``B`` (its backward
        a reduce-scatter) give a partial product that joins the base
        product's sum. The bias: column-parallel, this rank's columns of it;
        row-parallel, added once after the sum."""
        mesh, specs = self._mesh, self._specs

        def placed(name: str) -> torch.Tensor:
            leaf = getattr(self, name)
            return leaf if mesh is None else gathered(leaf, specs[name], mesh)

        spec = None if mesh is None else specs["kernel"]
        column = mesh is not None and splits(spec, 1, "model", mesh)
        row = mesh is not None and splits(spec, 0, "model", mesh)
        base_in = x
        if column:
            base_in = entered if entered is not None else sum_gradients(x, mesh, "model")
        if isinstance(self.kernel, QuantizedKernel):
            kernel = self.kernel if mesh is None else sharded_weight(self.kernel, spec, mesh)
            y = quantized_matmul(base_in, kernel, out_dtype=self.dtype, impl=self.kernel.impl)
        else:
            y = gathered_matmul(base_in, self.kernel, spec, mesh, self.dtype)
        if self.rank > 0:
            a, b = placed("lora_a").to(self.dtype), placed("lora_b").to(self.dtype)
            b_split = mesh is not None and splits(specs["lora_b"], 1, "model", mesh)
            if row:
                if not splits(specs["lora_a"], 0, "model", mesh):
                    a = split_to(a, mesh, "model", dim=0)
                if b_split:
                    b = all_gather(b, mesh, "model", gather_axis=1)
                h = x @ a
            else:
                h = x @ a
                if column:
                    h = sum_gradients(h, mesh, "model")
                    if not b_split:
                        b = split_to(b, mesh, "model", dim=1)
                elif b_split:
                    b = gather_from(b, mesh, "model", gather_axis=1)
            y = y + (h @ b) * (self.alpha / self.rank)
        if row:
            y = allreduce_sum(y, mesh, "model")
        if self.bias is not None:
            bias = placed("bias")
            if column and not splits(specs["bias"], 0, "model", mesh):
                bias = split_to(bias, mesh, "model", dim=0)
            y = y + bias.to(self.dtype)
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
    they go through the int8 matmul kernel. ``"ring"``/``"ulysses"`` run
    the uncached forward sequence-parallel over the placed mesh's
    ``sequence`` axis (:mod:`unionml_tpu_torch.ops.ring_attention`); the
    model must be placed on a mesh (``Generator(mesh=...)`` does it).

    Head counts come from the projections' widths at the call: on a mesh
    they are this rank's heads. ``kv_sink``, when a list, receives each
    uncached forward's post-RoPE ``(k, v)`` (the JAX module's ``sow``; the
    sequence-parallel prefill assembles the cache from them).
    """

    kv_sink: Optional[list] = None

    def __init__(self, features: int, n_heads: int, n_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None, causal: bool = False, rope: bool = False,
                 rope_theta: float = 10000.0, impl: str = "auto", lora_rank: int = 0,
                 dtype: torch.dtype = torch.bfloat16, param_dtype: torch.dtype = torch.float32,
                 device: Any = None):
        super().__init__()
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
        entered = model_input(x, self.q_proj)
        q = self.q_proj(x, entered).reshape(batch, length, -1, self.head_dim)
        k = self.k_proj(x, entered).reshape(batch, length, -1, self.head_dim)
        v = self.v_proj(x, entered).reshape(batch, length, -1, self.head_dim)

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

        if self.kv_sink is not None:
            self.kv_sink.append((k, v))
        if self.impl in ("ring", "ulysses"):
            out = self._sequence_parallel(q, k, v, mask)
        else:
            out = multihead_attention(q, k, v, causal=self.causal, mask=mask, impl=self.impl)
        return self.o_proj(out.reshape(batch, length, -1))

    def _sequence_parallel(self, q, k, v, mask):
        mesh = self.q_proj._mesh
        if mesh is None:
            raise ValueError(f"attention impl {self.impl!r} runs over a mesh's sequence axis; place the model "
                             "on a mesh first (Generator(mesh=...))")
        if mask is not None:
            raise NotImplementedError("sequence-parallel attention does not support arbitrary masks")
        fn = ring_attention if self.impl == "ring" else ulysses_attention
        return fn(q, k, v, mesh, causal=self.causal)

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
    """Feed-forward block: gated SwiGLU (``wg``, ``wi``, ``wo``; the
    decoder's) or, with ``gated=False``, plain ``wi`` -> GELU -> ``wo`` (the
    encoder's). The GELU is ``jax.nn.gelu``'s default, the tanh
    approximation."""

    def __init__(self, features: int, hidden_dim: int, gated: bool = True, lora_rank: int = 0,
                 dtype: torch.dtype = torch.bfloat16, param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        self.gated = gated
        dense = lambda i, o: LoRADense(i, o, rank=lora_rank, dtype=dtype, param_dtype=param_dtype, device=device)  # noqa: E731
        if gated:
            self.wg = dense(features, hidden_dim)
        self.wi = dense(features, hidden_dim)
        self.wo = dense(hidden_dim, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        entered = model_input(x, self.wi)
        if self.gated:
            return self.wo(F.silu(self.wg(x, entered)) * self.wi(x, entered))
        return self.wo(F.gelu(self.wi(x, entered), approximate="tanh"))


class TransformerBlock(nn.Module):
    """Pre-norm transformer block: decoder (RMSNorm, causal attention,
    SwiGLU) or, with ``decoder=False``, encoder (LayerNorm, bidirectional
    attention under the caller's ``mask``, GELU MLP)."""

    def __init__(self, features: int, n_heads: int, hidden_dim: int, n_kv_heads: Optional[int] = None,
                 decoder: bool = True, rope: bool = False, rope_theta: float = 10000.0,
                 attention_impl: str = "auto", lora_rank: int = 0, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        norm = RMSNorm if decoder else LayerNorm
        self.attn_norm = norm(features, dtype=dtype, device=device)
        self.attn = Attention(
            features, n_heads, n_kv_heads, causal=decoder, rope=rope, rope_theta=rope_theta,
            impl=attention_impl, lora_rank=lora_rank, dtype=dtype, param_dtype=param_dtype, device=device,
        )
        self.mlp_norm = norm(features, dtype=dtype, device=device)
        self.mlp = MLP(features, hidden_dim, gated=decoder, lora_rank=lora_rank, dtype=dtype,
                       param_dtype=param_dtype, device=device)

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


def _init_leaf(param: torch.Tensor, leaf: str, owner: nn.Module, generator: Optional[torch.Generator]) -> None:
    if leaf == "scale":
        param.fill_(1.0)
    elif leaf in ("lora_b", "bias", "cls_token"):
        param.zero_()
    elif leaf in ("lora_a", "pos_embed"):
        param.normal_(0.0, 0.02, generator=generator)
    else:  # kernel [..., in, out] (fan_in = in; stacked experts lead with E), conv kernel [kh, kw, in, out]
        # (fan_in = kh * kw * in) or embedding [vocab, dim]
        if leaf == "embedding":
            fan_in = param.shape[1]
        elif isinstance(owner, Conv):
            fan_in = math.prod(param.shape[:-1])
        else:
            fan_in = param.shape[-2]
        param.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


@torch.no_grad()
def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None, *,
                 shardings: Optional[Dict[str, Any]] = None, device: Any = None) -> None:
    """Random weights from a seeded ``torch.Generator`` (on the module's
    device): lecun-normal dense and convolution kernels, ``1/sqrt(dim)``
    embeddings, unit norm scales, zero biases, LoRA ``B`` and ``cls_token``,
    normal(0.02) LoRA ``A`` and learned ``pos_embed`` tables — the flax
    initializers' laws, not their bits.

    With ``shardings`` (``{path: NamedSharding}``, as
    :func:`~unionml_tpu_torch.parallel.combine_fsdp_tp` gives them) the
    module may be built on ``"meta"``: each leaf in turn is drawn whole on
    ``device`` (the generator's), cut to this rank's shard, and the whole
    freed, so a rank never holds more than one whole leaf beside its shards.
    The draws are the unsharded model's, leaf for leaf."""
    owners = dict(module.named_modules())
    for name, param in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = owners[owner_name]
        if shardings is None:
            _init_leaf(param, leaf, owner, generator)
            continue
        whole = torch.empty(param.shape, dtype=param.dtype, device=device)
        _init_leaf(whole, leaf, owner, generator)
        sharding = shardings[name.replace(".", "/")]
        setattr(owner, leaf, nn.Parameter(sharding.local(whole), requires_grad=param.requires_grad))
        record_spec(owner, leaf, sharding)
        del whole
