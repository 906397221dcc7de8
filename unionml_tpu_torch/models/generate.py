"""Autoregressive generation: bucketed prefill + a decode loop over a KV cache.

Counterpart of ``unionml_tpu/models/generate.py``. The JAX engine jits one
prefill per prompt bucket and one ``lax.scan`` decode; PyTorch runs eagerly,
so prefill is one forward and decode a Python loop over ``steps``. The cache
contract is the same: per-example contiguous rows (``init_cache``) or a paged
heads-major pool (``init_paged_cache``), written in place where JAX donates.
Randomness comes from explicit ``torch.Generator`` objects where JAX threads
``jax.random`` keys; the two give different numbers from the same seed, so
sampled decoding matches the JAX package in distribution
(:func:`filtered_logits`/:func:`policy_probs`), greedy decoding token for token.

**Over a mesh** (``mesh=MeshSpec(...).build()``, ``partition_rules=``) the
JAX engine's single controller becomes one process per rank, every rank
making the same calls (they are deterministic given their arguments). The
model is cut to this rank's shards (:mod:`unionml_tpu_torch.parallel.sharding`)
and its layers run the collectives. The rows of a batch split over the
``data`` axis (the cache is ``P(data, None, model, None)``: ``data``
rows, ``model`` KV heads), padded to a multiple of it; every other axis
holds the same rows. Results are gathered over ``data``, so every rank
returns the whole batch. A sampled token is drawn only by the rank at index
0 of the axes beside ``data`` and broadcast to them: ranks never draw from
their own generators. Greedy ids are the argmax of logits every rank holds
bit for bit (the head's vocab shards are gathered), so they need no
broadcast. ``config.sp_prefill`` ("ring"/"ulysses") runs the prefill
sequence-parallel over the ``sequence`` axis and assembles the cache from
each layer's gathered K/V; decode then runs on every rank of that axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import weakref
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, module_device, resolve_device
from unionml_tpu_torch.defaults import serve_kv_cache_dtype, serve_quantize
from unionml_tpu_torch.models.layers import quantize_kv_rows
from unionml_tpu_torch.ops.quant import quantize_params
from unionml_tpu_torch.parallel.collectives import all_gather, allreduce_sum, broadcast
from unionml_tpu_torch.parallel.mesh import AXIS_ORDER, ROW_AXES, Mesh
from unionml_tpu_torch.parallel.sharding import combine_fsdp_tp, place_module, row_scope, splits

__all__ = [
    "DraftSpec",
    "GenerationConfig",
    "Generator",
    "PrefixCache",
    "chunk_aligned",
    "gather_paged_rows",
    "filtered_logits",
    "init_cache",
    "init_paged_cache",
    "policy_probs",
    "sample_tokens",
]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """A draft model for speculative decoding, attachable to
    :attr:`GenerationConfig.draft`: the :class:`Generator` façade then routes
    ``__call__``/``stream`` through a
    :class:`~unionml_tpu_torch.models.speculative.SpeculativeGenerator` (same
    output law: greedy token-exact, sampled distribution-exact).

    ``module`` is the draft model itself (an ``nn.Module`` carrying its
    weights, on the target's device). ``params`` keeps the JAX package's
    field order and must stay ``None``: a port model carries its own
    weights. ``quantize`` ("int8") stores the draft quantized IN PLACE; None
    follows ``UNIONML_TPU_QUANTIZE`` as the target's own kwarg does.
    ``partition_rules`` places the draft on the target's mesh (None: the
    inferred FSDP layout)."""

    module: Any
    params: Any = None
    gamma: int = 4
    partition_rules: Optional[Any] = None
    quantize: Optional[str] = None

    def __post_init__(self):
        if self.params is not None:
            raise ValueError("DraftSpec.params must be None in the port: the draft module carries its own weights")


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decoding knobs. ``temperature == 0`` means greedy (argmax) decoding;
    ``top_k``/``top_p``/``min_p`` filter the distribution before sampling.
    ``prefill_chunk`` prefills long prompts through the cache in chunks of
    that many columns. ``constraints`` (a
    :class:`~unionml_tpu_torch.models.structured.ConstraintSet`) lets each
    call pick a grammar per row (``constraint=``). ``draft`` (a
    :class:`DraftSpec`) decodes speculatively. ``sp_prefill`` ("ring" or
    "ulysses") prefills sequence-parallel over a mesh's ``sequence`` axis
    (ignored without one, as in the JAX package)."""

    max_new_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    pad_id: int = 0
    prompt_buckets: Tuple[int, ...] = (64, 256, 1024)
    prefill_chunk: Optional[int] = None
    #: "int8" stores K/V rows symmetric-quantized per (position, head) with
    #: f32 scales; None = the compute dtype
    kv_cache_dtype: Optional[str] = None
    sp_prefill: Optional[str] = None
    draft: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)
    constraints: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)
    min_p: float = 0.0


def chunk_aligned(length: int, chunk: int) -> int:
    """Round ``length`` up to a multiple of ``chunk``."""
    return -(-length // chunk) * chunk


def _kv_dtype_check(kv_dtype: Optional[str]) -> None:
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_cache_dtype {kv_dtype!r}; expected None or 'int8'")


def init_cache(
    config: Any, batch: int, cache_len: int, kv_dtype: Optional[str] = None, *, device: DeviceLike = None
) -> Tuple[dict, ...]:
    """Zeroed per-layer KV buffers ``[batch, cache_len, n_kv_heads, head_dim]``
    in the compute dtype, or int8 values plus f32 ``[..., 1]`` scale planes."""
    _kv_dtype_check(kv_dtype)
    device = resolve_device(device)
    head_dim = config.dim // config.n_heads
    shape = (batch, cache_len, config.n_kv_heads, head_dim)
    if kv_dtype == "int8":
        scale_shape = shape[:-1] + (1,)
        return tuple(
            {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
            }
            for _ in range(config.n_layers)
        )
    return tuple(
        {
            "k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device),
        }
        for _ in range(config.n_layers)
    )


def init_paged_cache(
    config: Any,
    slots: int,
    n_blocks: int,
    block_size: int,
    max_blocks: int,
    kv_dtype: Optional[str] = None,
    *,
    fill_block: int,
    device: DeviceLike = None,
) -> Tuple[dict, ...]:
    """Per-layer PAGED KV pools, heads-major ``[H_kv, n_blocks, block_size,
    D]``, plus a ``[slots, max_blocks]`` int32 block table initialized to
    ``fill_block``. ``fill_block`` is required and must be a reserved scratch
    block (``n_blocks = real + 1``, ``fill_block = real``): free and finished
    slots keep writing one ride-along row per step through their table row.
    Every layer holds the SAME table tensor — JAX keeps one copy per layer
    only because donating an aliased buffer twice is an error there; here one
    in-place table update serves all layers."""
    _kv_dtype_check(kv_dtype)
    device = resolve_device(device)
    head_dim = config.dim // config.n_heads
    shape = (config.n_kv_heads, n_blocks, block_size, head_dim)
    table = torch.full((slots, max_blocks), fill_block, dtype=torch.int32, device=device)
    if kv_dtype == "int8":
        scale_shape = shape[:-1] + (1,)
        return tuple(
            {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
                "table": table,
            }
            for _ in range(config.n_layers)
        )
    return tuple(
        {
            "k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device),
            "table": table,
        }
        for _ in range(config.n_layers)
    )


def _paste_prefix_rows(cache: Tuple[dict, ...], prefix_layers: Tuple[dict, ...]) -> Tuple[dict, ...]:
    """Broadcast a :class:`PrefixCache`'s ``[1, p0, ...]`` K/V rows into
    slots ``[0, p0)`` of every row of a dense cache, in place."""
    with torch.no_grad():
        for layer, pre in zip(cache, prefix_layers):
            for name, rows in pre.items():
                layer[name][:, : rows.shape[1]] = rows.to(layer[name].dtype)
    return cache


def gather_paged_rows(pool_cache: Tuple[dict, ...], blocks_row: Any, width: int) -> Tuple[dict, ...]:
    """Materialize a dense ``[1, width, H_kv, last]`` cache row from a PAGED
    pool (:func:`init_paged_cache`): position ``pos`` reads block
    ``blocks_row[pos // block_size]`` at offset ``pos % block_size``, the
    exact inverse of the engine's admission scatter, so a row gathered from
    cached blocks is bit-identical to the row that was scattered in. Every
    leaf but ``table`` is gathered (the int8 pools' scale planes too); the
    result is a fresh copy. Positions past the cached run read whatever
    their blocks (scratch) hold: the suffix prefill overwrites them before
    anything attends to them."""
    k = pool_cache[0]["k"]
    block_size = k.shape[2]  # pools are heads-major [H, NB, bs, last]
    pos = torch.arange(width, device=k.device)
    blocks = torch.as_tensor(np.asarray(blocks_row), dtype=torch.long, device=k.device)
    blk, off = blocks[pos // block_size], pos % block_size
    return tuple(
        {name: buf[:, blk, off].transpose(0, 1)[None].contiguous() for name, buf in layer.items() if name != "table"}
        for layer in pool_cache
    )


@dataclasses.dataclass(frozen=True)
class PrefixCache:
    """Precomputed K/V rows for a shared prompt prefix (a system prompt),
    built once by :meth:`Generator.cache_prefix` and reused by every request
    that passes it: the prefix's prefill is paid once, not per call."""

    layers: Tuple[Any, ...]  # per-layer cache leaves trimmed to [1, length, ...]
    length: int
    #: the prefix's token ids, kept so an engine with a second model (the
    #: speculative draft) can prefill the same prefix through it; None for
    #: hand-built caches, which then cannot compose with a draft
    tokens: Optional[Tuple[int, ...]] = None


def filtered_logits(logits: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """Apply temperature, ``min_p``, ``top_k`` and ``top_p`` to ``[..., V]``
    logits (masked entries become -inf); softmax of the result is the policy's
    sampling distribution."""
    # no host-to-device copy in here: decode runs inside captured CUDA graphs
    logits = logits / config.temperature
    if config.min_p > 0.0:
        # prob(x) >= min_p * prob(argmax)  <=>  logit(x) >= max_logit + log(min_p)
        log_min_p = float(torch.log(torch.tensor(config.min_p, dtype=logits.dtype)))  # in the logits' dtype
        cutoff = logits.amax(dim=-1, keepdim=True) + log_min_p
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    if config.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -config.top_k][..., None]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if config.top_p < 1.0:
        sorted_desc = torch.flip(torch.sort(logits, dim=-1).values, dims=[-1])
        probs = torch.softmax(sorted_desc, dim=-1)
        exclusive_cum = torch.cumsum(probs, dim=-1) - probs
        # keep the smallest prefix whose mass reaches top_p; its lowest logit
        # becomes the cutoff on the unsorted axis
        dropped = exclusive_cum >= config.top_p
        min_kept = sorted_desc.masked_fill(dropped, math.inf).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < min_kept, -math.inf)
    return logits


def policy_probs(logits: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """The decoding policy as a distribution over ``[..., V]``: a one-hot
    argmax for greedy, else softmax of :func:`filtered_logits`."""
    if config.temperature == 0.0:
        return torch.nn.functional.one_hot(logits.argmax(dim=-1), logits.shape[-1]).float()
    return torch.softmax(filtered_logits(logits.float(), config), dim=-1)


def sample_tokens(
    logits: torch.Tensor, generator: Optional[torch.Generator], config: GenerationConfig
) -> torch.Tensor:
    """Next tokens ``[B]`` int32 from ``logits [B, V]`` under the policy."""
    if config.temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(filtered_logits(logits.float(), config), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their indices, ties to the
    lower index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order among equal values): a stable descending sort."""
    ordered, index = torch.sort(values, dim=-1, descending=True, stable=True)
    return ordered[..., :k], index[..., :k]


def _reorder(cache: Tuple[dict, ...], rows: torch.Tensor) -> Tuple[dict, ...]:
    """Per-layer cache rows gathered to ``rows`` into fresh tensors (the
    model writes its cache in place, so a view would alias a parent's row)."""
    return tuple({name: t.index_select(0, rows) for name, t in layer.items()} for layer in cache)


#: the axes beside ``data``: their ranks hold the same rows, and the one at
#: index 0 draws a sampled token for them
_REPLICA_AXES = tuple(a for a in AXIS_ORDER if a not in ROW_AXES)


def _place(model: Any, mesh: Mesh, partition_rules: Any) -> Any:
    """Cut ``model`` to this rank's shards under ``partition_rules`` (else
    the inferred FSDP layout) and return the config its caches are
    allocated from: this rank's query and KV heads. The layers compute on
    whole heads, so a projection split over ``model`` must split its heads
    evenly, and the row-parallel output projection must take the query
    projection's split."""
    from unionml_tpu_torch.models.layers import Attention

    shardings = combine_fsdp_tp(model, mesh, partition_rules)
    cfg = model.config
    m = mesh.shape["model"]
    head_dim = cfg.dim // cfg.n_heads
    local = None
    for name, mod in model.named_modules():
        if not isinstance(mod, Attention):
            continue
        split = {p: splits(shardings[f"{name}/{p}/kernel".replace(".", "/")].spec, 1, "model", mesh)
                 for p in ("q_proj", "k_proj", "v_proj")}
        row = splits(shardings[f"{name}/o_proj/kernel".replace(".", "/")].spec, 0, "model", mesh)
        heads = (mod.n_heads // (m if split["q_proj"] else 1), mod.n_kv // (m if split["k_proj"] else 1))
        if (split["q_proj"] and mod.n_heads % m) or (split["k_proj"] and mod.n_kv % m) \
                or split["k_proj"] != split["v_proj"] or split["q_proj"] != row or heads[0] % heads[1]:
            raise NotImplementedError(
                f"{name}: {mod.n_heads} query and {mod.n_kv} KV heads under this layout over model={m}; the "
                "port's tensor parallelism splits q/k/v by whole heads (column-parallel) and o_proj by the "
                "same heads (row-parallel)"
            )
        if local is not None and heads != local:
            raise NotImplementedError("every attention layer must split its heads alike")
        local = heads
    place_module(model, shardings)
    if local is None:
        return cfg
    return dataclasses.replace(cfg, n_heads=local[0], n_kv_heads=local[1], dim=local[0] * head_dim)


@contextlib.contextmanager
def _sequence_parallel(model: Any, impl: str):
    """Run ``model``'s attention layers with ``impl`` (ring/ulysses) and
    collect each layer's post-RoPE ``(k, v)``, in layer order, into the
    list this yields."""
    from unionml_tpu_torch.models.layers import Attention

    layers = [m for m in model.modules() if isinstance(m, Attention)]
    kvs: list = []
    saved = [m.impl for m in layers]
    for m in layers:
        m.impl, m.kv_sink = impl, kvs
    try:
        yield kvs
    finally:
        for m, impl_was in zip(layers, saved):
            m.impl = impl_was
            del m.kv_sink


class Generator:
    """Batch text generation over a cached decoder.

    >>> gen = Generator(model, GenerationConfig(max_new_tokens=64))
    >>> tokens = gen([[1, 5, 9], [3, 3]], seed=0)   # [2, 64] int32

    ``model`` follows :class:`~unionml_tpu_torch.models.llama.Llama`'s cache
    contract and must already live on ``device`` (``None`` = CUDA, which
    raises on a machine without one). ``prefill_traces``/``decode_traces``
    mirror the JAX engine's compile counters: they count the programs this
    generator resolved with no entry in its AOT store (:meth:`enable_aot`),
    each run eagerly, captured as a CUDA graph on the card and written to
    the store, so a generator whose store held every program reads ``(0,
    0)``, as in JAX. Without a store nothing is compiled and both stay 0.

    ``quantize="int8"`` quantizes the model's matmul kernels
    (:func:`~unionml_tpu_torch.ops.quant.quantize_params`'s defaults) IN
    PLACE: each float kernel is replaced by its int8 values and scales, so
    one copy of the weights lives in device memory, and the model stays
    quantized for every later user of it. The JAX package builds a new tree
    instead. Under ``attention_impl="flash"`` the int8 matmuls run the int8
    kernel; otherwise they dequantize and multiply, the JAX package's
    numerics. As there, an unset ``quantize`` and ``config.kv_cache_dtype``
    follow the serve CLI's ``UNIONML_TPU_QUANTIZE`` and
    ``UNIONML_TPU_KV_CACHE_DTYPE``; explicit values win.

    ``mesh`` (a :class:`~unionml_tpu_torch.parallel.mesh.Mesh`) and
    ``partition_rules`` cut the model IN PLACE to this rank's shards
    (quantized first, so int8 scales are the whole kernel's); see the module
    docstring for how the ranks run. The model must be on the mesh's device
    and every rank builds the Generator at the same point.
    """

    def __init__(
        self,
        model: Any,
        config: GenerationConfig = GenerationConfig(),
        *,
        device: DeviceLike = None,
        mesh: Optional[Any] = None,
        partition_rules: Optional[Any] = None,
        quantize: Optional[str] = None,
    ):
        if config.sp_prefill not in (None, "ring", "ulysses"):
            raise ValueError(f"unsupported sp_prefill {config.sp_prefill!r}; expected None, 'ring' or 'ulysses'")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a Mesh from MeshSpec(...).build(), got {type(mesh).__name__}")
            if device is None:
                device = mesh.device
        if quantize is None:
            quantize = serve_quantize()
        if config.kv_cache_dtype is None:
            env_kv = serve_kv_cache_dtype()
            if env_kv is not None:
                config = dataclasses.replace(config, kv_cache_dtype=env_kv)
        _kv_dtype_check(config.kv_cache_dtype)
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode {quantize!r}; expected None or 'int8'")
        self.device = resolve_device(device)
        placed = module_device(model)
        if placed is not None and placed != self.device:
            raise ValueError(f"the model lives on {placed}, not {self.device}; build it with device={str(self.device)!r}")
        if quantize == "int8":
            quantize_params(model)
        self.model = model
        self.config = config
        self.quantize = quantize
        self.mesh = mesh
        #: kept so engines re-hosting these weights can rebuild alike
        self.partition_rules = partition_rules
        #: the config caches are allocated from: this rank's heads on a mesh
        self.cache_config = model.config
        if mesh is not None:
            self.cache_config = _place(model, mesh, partition_rules)
        self.prefill_traces = 0
        self.decode_traces = 0
        #: the AOT program store (serving/aot.py), set by :meth:`enable_aot`
        self._aot_store = None
        self._spec_engine = None
        self._cs = config.constraints
        if self._cs is not None:
            # one device copy of the tables per set and device, shared by
            # every engine built over it
            self._cs_trans, self._cs_allowed = self._cs.device_tables(self.device)

    # ------------------------------------------------------------------ steps

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits of compute-dtype hidden rows (an int8 head takes the
        model's int8 route)."""
        return self.model.lm_head(hidden).float()

    def _constrain(self, logits: torch.Tensor, state: Optional[torch.Tensor]) -> torch.Tensor:
        """Mask f32 ``[B, V]`` logits by each row's DFA state ``[B]`` (None =
        unconstrained): tokens the grammar disallows there become -inf."""
        if state is None:
            return logits
        return logits.masked_fill(~self._cs_allowed[state.long()], -math.inf)

    # ------------------------------------------------------------------ mesh

    def _row_slice(self, batch: int, split: bool = True) -> slice:
        """This rank's rows of a ``batch`` padded to the ``data`` axis."""
        if self.mesh is None or not split:
            return slice(0, batch)
        per = batch // self.mesh.size(ROW_AXES)
        lo = self.mesh.index(ROW_AXES) * per
        return slice(lo, lo + per)

    def _row_batch(self, batch: int) -> int:
        """``batch`` rounded up to a multiple of the ``data`` axis."""
        rows = self.mesh.size(ROW_AXES) if self.mesh is not None else 1
        return -(-batch // rows) * rows

    def _gather_rows(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's rows of a host array, in batch order."""
        if self.mesh is None or self.mesh.size(ROW_AXES) == 1:
            return arr
        t = torch.as_tensor(np.ascontiguousarray(arr), device=self.device)
        return all_gather(t, self.mesh, ROW_AXES[0]).cpu().numpy()

    def _all_done(self, done: torch.Tensor) -> bool:
        """Whether every row of the whole batch is done (an agreement over
        ``data``: ranks that gather per chunk must stop together)."""
        live = (~done).any().to(torch.int32)[None]
        if self.mesh is not None:
            live = allreduce_sum(live, self.mesh, ROW_AXES[0])
        return not bool(live.item())

    def _draw(self, fn, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """A random draw: ``fn()`` here, or on a mesh only on the rank at
        index 0 of the axes beside ``data``, broadcast to the others."""
        if self.mesh is None:
            return fn()
        axes = _REPLICA_AXES
        if self.mesh.size(axes) == 1:
            return fn()
        out = fn() if self.mesh.index(axes) == 0 else torch.empty(shape, dtype=dtype, device=self.device)
        return broadcast(out, self.mesh, axes)

    def _sample(self, logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """:func:`sample_tokens` under the mesh's draw rule."""
        if self.config.temperature == 0.0:
            return sample_tokens(logits, generator, self.config)
        return self._draw(lambda: sample_tokens(logits, generator, self.config), (logits.shape[0],), torch.int32)

    @torch.no_grad()
    def _prefill(self, tokens, lengths, cache, generator, row_valid, state=None):
        """Prefill ``tokens [B, P]`` into ``cache`` (in place) and sample each
        row's first token from its last real position, masked by its DFA
        ``state`` when given. Returns ``(tok0 [B] int32, cache, last-token
        hidden [B, dim] f32)``."""
        batch, prompt_len = tokens.shape
        positions = torch.arange(prompt_len, device=self.device)[None].expand(batch, prompt_len)
        token_mask = (positions < lengths[:, None]) & row_valid[:, None]
        hidden, cache = self.model(
            tokens, positions=positions, return_hidden=True, cache=cache, token_mask=token_mask
        )
        last = hidden[torch.arange(batch, device=self.device), (lengths - 1).long()]
        tok0 = self._sample(self._constrain(self._head(last), state), generator)
        return tok0, cache, last.float()

    @torch.no_grad()
    def _sp_prefill(self, tokens, lengths, cache, generator, row_valid, state=None):
        """Sequence-parallel prefill: this rank runs the decoder over its
        block of columns with the ``sequence`` axis's ring or ulysses
        attention at global positions, each layer's post-RoPE K/V is
        gathered over the axis and written into ``cache[:, :width]``, and
        the first token is sampled from the gathered last-token hiddens.
        ``tokens`` is already padded to a multiple of the axis. A model whose
        config takes no ``attention_impl`` (MoE's) is refused with a
        ``TypeError`` here, at the first call, as the JAX package refuses it."""
        if "attention_impl" not in {f.name for f in dataclasses.fields(self.model.config)}:
            raise TypeError(f"sequence-parallel prefill ({self.config.sp_prefill!r}) runs the decoder with "
                            f"attention_impl={self.config.sp_prefill!r}, which {type(self.model.config).__name__} "
                            "does not take")
        mesh = self.mesh
        batch, width = tokens.shape
        block = width // mesh.size("sequence")
        lo = mesh.index("sequence") * block
        positions = (lo + torch.arange(block, device=self.device))[None].expand(batch, block)
        token_mask = (positions < lengths[:, None]) & row_valid[:, None]
        with _sequence_parallel(self.model, self.config.sp_prefill) as kvs:
            hidden = self.model(tokens[:, lo:lo + block], positions=positions, return_hidden=True,
                                token_mask=token_mask)
        hidden = all_gather(hidden, mesh, "sequence", gather_axis=1)
        for layer, (k, v) in zip(cache, kvs):
            rows = {"k": all_gather(k, mesh, "sequence", gather_axis=1),
                    "v": all_gather(v, mesh, "sequence", gather_axis=1)}
            if "k_scale" in layer:
                rows["k"], rows["k_scale"] = quantize_kv_rows(rows["k"])
                rows["v"], rows["v_scale"] = quantize_kv_rows(rows["v"])
            for name, t in rows.items():
                layer[name][:, :width] = t.to(layer[name].dtype)
        last = hidden[torch.arange(batch, device=self.device), (lengths - 1).long()]
        tok0 = self._sample(self._constrain(self._head(last), state), generator)
        return tok0, cache, last.float()

    @torch.no_grad()
    def _prefill_chunk(self, tokens, start: int, lengths, cache, row_valid):
        """One chunk of a long-context prefill: columns ``[start, start + C)``
        of the padded prompt flow through ``cache`` (in place; attention sees
        every slot written before). Returns each row's last-real-token hidden
        ``[B, dim]`` f32 where it falls in this chunk, a ``[B]`` flag saying
        which rows it did, and the cache."""
        batch, chunk = tokens.shape
        positions = start + torch.arange(chunk, device=self.device)[None].expand(batch, chunk)
        token_mask = (positions < lengths[:, None]) & row_valid[:, None]
        hidden, cache = self.model(
            tokens, positions=positions, return_hidden=True, cache=cache, token_mask=token_mask
        )
        sel = positions == (lengths - 1)[:, None]  # at most one true column per row
        chunk_last = torch.einsum("blc,bl->bc", hidden.float(), sel.float())
        return chunk_last, sel.any(dim=1), cache

    @torch.no_grad()
    def _first_token(self, last: torch.Tensor, generator, state=None) -> torch.Tensor:
        """Sample the first generated token from the accumulated last-row
        hiddens (the chunked prefill's epilogue), masked by ``state``."""
        logits = self._head(last.to(self.model.config.dtype))
        return self._sample(self._constrain(logits, state), generator)

    @torch.no_grad()
    def _decode(self, cache, tok, lengths, done, generator, *cstate, steps: int):
        """Roll ``steps`` decode steps from the carry. Returns the new tokens
        ``[B, steps]``, each sampled token's log-probability ``[B, steps]`` f32
        (under the constrained distribution, before the sampling filters;
        done rows report 0.0) and the advanced carry. Done rows emit
        ``pad_id`` and never advance their length. With constraints the carry
        ends in each row's DFA state ``[B]`` int32 (``cstate``), which a done
        row holds."""
        cfg = self.config
        eos = cfg.eos_id
        state = cstate[0] if cstate else None
        toks, lps = [], []
        for _ in range(steps):
            positions = lengths[:, None]  # each example's next free cache slot
            hidden, cache = self.model(
                tok[:, None], positions=positions, return_hidden=True, cache=cache,
                token_mask=(~done)[:, None],
            )
            logits = self._constrain(self._head(hidden[:, 0]), state)
            nxt = self._sample(logits, generator)
            lp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None].long())[:, 0]
            lps.append(lp.masked_fill(done, 0.0))
            if state is not None:
                state = torch.where(done, state, self._cs_trans[state.long(), nxt.long()])
            nxt = nxt.masked_fill(done, cfg.pad_id)
            lengths = lengths + (~done).to(lengths.dtype)
            if eos is not None:
                done = done | (nxt == eos)
            toks.append(nxt)
            tok = nxt
        carry = (cache, tok, lengths, done, generator) + (() if state is None else (state,))
        return torch.stack(toks, dim=1), torch.stack(lps, dim=1), carry

    # ------------------------------------------------------------------ helpers

    def _bucket(self, max_prompt: int) -> int:
        for b in sorted(self.config.prompt_buckets):
            if b >= max_prompt:
                return b
        bucket = int(math.ceil(max_prompt / 64) * 64)
        logger.info(f"prompt length {max_prompt} exceeds configured buckets; padding to {bucket}")
        return bucket

    def _start(self, prompts: Sequence[Sequence[int]], seed: int, extra_cache: int = 0, constraint: Any = None,
               prefix: Optional[PrefixCache] = None, split: bool = True):
        """Pad/bucket the prompts, allocate the cache, prefill (in
        ``prefill_chunk`` slices when set and the bucket is wider), and return
        ``(n, tok0, last, carry)``; the batch is padded to a power of two and
        the padding rows start done. ``constraint`` (an int, or one int per
        prompt) selects each row's grammar from ``config.constraints``; rows
        start at its DFA start state, and the carry gains the per-row state,
        advanced past the first token, as its tail. With ``prefix`` the
        prompts are suffixes: :meth:`_start_with_prefix` prefills only them."""
        cfg = self.config
        if constraint is not None and self._cs is None:
            raise ValueError("constraint= requires GenerationConfig.constraints to be set")
        n = len(prompts)
        if prefix is not None and any(len(p) == 0 for p in prompts):
            # an empty suffix would condition on prefix + [pad_id] (lengths are
            # clamped to >= 1); the prefix's last hidden row is not kept
            raise ValueError("prompts must be non-empty when prefix= is given")
        lengths = np.array([max(len(p), 1) for p in prompts], np.int32)
        bucket = self._bucket(int(lengths.max()))
        batch = 1 << max(0, (n - 1).bit_length())
        if split:
            batch = self._row_batch(batch)
        rows = self._row_slice(batch, split)
        tokens = np.full((batch, bucket), cfg.pad_id, np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = np.asarray(p, np.int32)
        tokens = tokens[rows]
        state = None
        if self._cs is not None:
            starts = self._cs.start_states(self._grammar_ids(constraint, n, batch))
            state = torch.as_tensor(starts[rows], device=self.device)
        row_valid = (torch.arange(batch, device=self.device) < n)[rows]
        if prefix is not None:
            return self._start_with_prefix(prefix, tokens, lengths, batch, rows, n, bucket, extra_cache, seed,
                                           state, row_valid)
        all_lengths = np.ones((batch,), np.int32)
        all_lengths[:n] = lengths
        sp = self.config.sp_prefill and self.mesh is not None and self.mesh.shape["sequence"] > 1
        chunk = cfg.prefill_chunk
        if sp:
            # each sequence rank gets an equal block of columns
            bucket = chunk_aligned(bucket, self.mesh.shape["sequence"])
            tokens = np.pad(tokens, ((0, 0), (0, bucket - tokens.shape[1])), constant_values=cfg.pad_id)
        elif chunk:
            bucket = chunk_aligned(bucket, chunk)  # bucket shape is moot once chunked
            tokens = np.pad(tokens, ((0, 0), (0, bucket - tokens.shape[1])), constant_values=cfg.pad_id)
        cache_len = max(bucket, max(cfg.prompt_buckets, default=0)) + cfg.max_new_tokens + extra_cache
        cache = init_cache(self.cache_config, tokens.shape[0], cache_len, kv_dtype=cfg.kv_cache_dtype,
                           device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        lengths_t = torch.as_tensor(all_lengths[rows], device=self.device)
        if sp:
            tok0, cache, last = self._sp_prefill(
                torch.as_tensor(tokens, device=self.device), lengths_t, cache, generator, row_valid, state
            )
        elif chunk and bucket > chunk:
            last, cache = self._chunked_prefill_loop(tokens, lengths_t, cache, row_valid, chunk)
            tok0 = self._first_token(last, generator, state)
        else:
            tok0, cache, last = self._prefill(
                torch.as_tensor(tokens, device=self.device), lengths_t, cache, generator, row_valid, state
            )
        return self._finish_prefill(n, tok0, last, cache, lengths_t, row_valid, generator, state)

    def _finish_prefill(self, n, tok0, last, cache, lengths_t, row_valid, generator, state):
        eos = self.config.eos_id
        done = (tok0 == eos) if eos is not None else torch.zeros_like(row_valid)
        done = done | ~row_valid  # synthetic batch-padding rows emit pads, never advance
        carry = (cache, tok0, lengths_t, done, generator)
        if state is not None:
            carry += (self._cs_trans[state.long(), tok0.long()],)
        return n, tok0, last, carry

    def _start_with_prefix(self, prefix: PrefixCache, tokens: np.ndarray, lengths: np.ndarray, batch: int,
                           rows: slice, n: int, bucket: int, extra_cache: int, seed: int, state, row_valid):
        """Prefill only the per-request suffix: the prefix's K/V rows are
        pasted into slots ``[0, p0)`` of every cache row and the suffix flows
        through the chunked prefill with positions starting at ``p0`` (RoPE
        phases and visibility continue where the prefix left off)."""
        cfg = self.config
        p0 = prefix.length
        chunk = cfg.prefill_chunk or bucket
        aligned = chunk_aligned(bucket, chunk)
        if aligned > tokens.shape[1]:
            tokens = np.pad(tokens, ((0, 0), (0, aligned - tokens.shape[1])), constant_values=cfg.pad_id)
        cache_len = p0 + max(aligned, max(cfg.prompt_buckets, default=0)) + cfg.max_new_tokens + extra_cache
        cache = init_cache(self.cache_config, tokens.shape[0], cache_len, kv_dtype=cfg.kv_cache_dtype,
                           device=self.device)
        cache = _paste_prefix_rows(cache, prefix.layers)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        # total length = prefix + suffix; padding rows pretend one suffix token
        all_lengths = np.full((batch,), p0 + 1, np.int32)
        all_lengths[:n] = p0 + lengths
        lengths_t = torch.as_tensor(all_lengths[rows], device=self.device)
        last, cache = self._chunked_prefill_loop(tokens, lengths_t, cache, row_valid, chunk, start=p0)
        tok0 = self._first_token(last, generator, state)
        return self._finish_prefill(n, tok0, last, cache, lengths_t, row_valid, generator, state)

    @staticmethod
    def _grammar_ids(constraint: Any, n: int, batch: int) -> np.ndarray:
        """Normalize a ``constraint=`` argument (an int, or one int per
        prompt) to per-row grammar ids; synthetic padding rows ride FREE (id 0)."""
        gids = np.zeros((batch,), np.int64)
        if constraint is not None:
            con = np.asarray(constraint)
            if con.ndim == 0:
                gids[:n] = int(con)
            elif con.shape[0] == n:
                gids[:n] = con
            else:
                raise ValueError(f"constraint has {con.shape[0]} entries for {n} prompts")
        return gids

    def _chunked_prefill_loop(self, tokens: np.ndarray, lengths, cache, row_valid, chunk: int, start: int = 0):
        """Run right-padded ``tokens`` through :meth:`_prefill_chunk` in
        ``chunk``-column slices whose absolute positions begin at ``start``,
        keeping each row's last-real-token hidden state."""
        last = torch.zeros((tokens.shape[0], self.model.config.dim), dtype=torch.float32, device=self.device)
        for c in range(0, tokens.shape[1], chunk):
            chunk_last, has, cache = self._prefill_chunk(
                torch.as_tensor(tokens[:, c : c + chunk], device=self.device), start + c, lengths, cache, row_valid
            )
            last = torch.where(has[:, None], chunk_last, last)
        return last, cache

    def _aot_context(self) -> dict:
        """The key parts that pin a stored program to THIS generator's
        programs: the module's architecture and config, the generation
        config (the KV dtype, buckets and sampling law: all baked into a
        graph), the quantization mode, the device, the mesh, and a digest of
        the grammar tables."""
        import hashlib

        from unionml_tpu_torch.serving.aot import device_context, mesh_context

        ctx = {
            "module": type(self.model).__name__,
            "module_config": repr(getattr(self.model, "config", None)),
            "generation_config": repr(self.config),
            "quantize": self.quantize,
            **device_context(self.device),
            **mesh_context(self.mesh),
        }
        if self._cs is not None:
            digest = hashlib.sha256()
            digest.update(np.asarray(self._cs.trans).tobytes())
            digest.update(np.asarray(self._cs.allowed).tobytes())
            ctx["constraints"] = digest.hexdigest()
        return ctx

    def enable_aot(self, store: Any) -> "Generator":
        """Route this generator's programs (``_prefill`` per bucket,
        ``_prefill_chunk``, ``_first_token`` and ``_decode``, whose ``steps``
        is static) through an AOT
        :class:`~unionml_tpu_torch.serving.aot.ProgramStore`: on the card each
        distinct call signature is captured once as a CUDA graph, its kernel
        libraries coming from the store where it holds them (no ``nvcc``), and
        every program the store did not hold is written back for the next
        cold process. Tokens are those of the eager programs. The graphs of
        this generator share one memory pool. Idempotent; ``None`` is a
        no-op. Over a mesh it raises ``NotImplementedError``: the
        collectives go through gloo's host route, which a graph cannot
        capture."""
        if store is None or self._aot_store is not None:
            return self
        if self.mesh is not None:
            raise NotImplementedError(
                "the AOT store over a mesh is not ported yet: its collectives cannot be captured "
                "(ROADMAP.md, Queue A: the AOT store over a mesh)"
            )
        from unionml_tpu_torch.serving.aot import AOTFunction, GraphPool

        owner = weakref.ref(self)  # the wrappers live in this generator's attributes: no cycle back to it

        def traced(attr: str):
            def bump() -> None:
                gen = owner()
                if gen is not None:
                    setattr(gen, attr, getattr(gen, attr) + 1)
            return bump

        ctx = self._aot_context()
        pool = GraphPool()
        self._aot_store = store
        prefill = dict(pool=pool, on_compile=traced("prefill_traces"))
        self._prefill = AOTFunction(self._prefill, "prefill", store, ctx, **prefill)
        self._prefill_chunk = AOTFunction(self._prefill_chunk, "prefill_chunk", store, ctx, **prefill)
        self._first_token = AOTFunction(self._first_token, "first_token", store, ctx, **prefill)
        self._decode = AOTFunction(self._decode, "decode", store, ctx, static_argnames=("steps",), pool=pool,
                                   on_compile=traced("decode_traces"))
        return self

    def warmup(self) -> "Generator":
        """Resolve the batch-1 prefill program of every configured prompt
        bucket and one decode of ``max_new_tokens - 1`` steps: through the
        AOT store when :meth:`enable_aot` armed one (a populated store makes
        this load-bound: libraries installed, graphs captured, no ``nvcc``),
        else as plain eager runs that build the kernels. The serving engines
        have their own warmup; this is the standalone ``Generator``'s, which
        the serverless batch path and notebooks use."""
        cfg = self.config
        vocab = int(getattr(self.model.config, "vocab_size", 2))
        tok = 1 % max(vocab, 1)
        decoded = False
        for bucket in sorted(set(cfg.prompt_buckets)):
            _, _, _, carry = self._start([[tok] * bucket], 0)
            if not decoded and cfg.max_new_tokens >= 2:
                # one decode covers every bucket: the cache width is the
                # widest bucket's, whichever bucket prefilled the carry
                self._decode(*carry, steps=cfg.max_new_tokens - 1)
                decoded = True
        return self

    def _speculative(self):
        """The speculative engine behind ``config.draft``, built on first use:
        THIS generator (its model already quantized and placed) is the verify
        target."""
        if self._spec_engine is None:
            from unionml_tpu_torch.models.speculative import SpeculativeGenerator

            self._spec_engine = SpeculativeGenerator.from_target(self, self.config.draft)
        return self._spec_engine

    # ------------------------------------------------------------------ generate

    def cache_prefix(self, prefix_tokens: Sequence[int]) -> PrefixCache:
        """Prefill a shared prompt prefix once and return its K/V rows for
        reuse: pass the result as ``prefix=`` to :meth:`__call__`,
        :meth:`stream` or ``ContinuousBatcher`` and only the per-request
        suffix is prefilled."""
        p0 = len(prefix_tokens)
        if p0 == 0:
            raise ValueError("prefix_tokens must be non-empty")
        # every rank prefills the one row itself: a prefix is not split over data
        with row_scope(()):
            _, _, _, carry = self._start([list(prefix_tokens)], 0, split=False)
        layers = tuple({name: t[:1, :p0].clone() for name, t in layer.items()} for layer in carry[0])
        return PrefixCache(layers=layers, length=p0, tokens=tuple(int(t) for t in prefix_tokens))

    def __call__(
        self, prompts: Sequence[Sequence[int]], *, seed: int = 0, prefix: Optional[PrefixCache] = None,
        constraint: Any = None,
    ) -> np.ndarray:
        """Generate ``max_new_tokens`` per prompt; returns ``[len(prompts),
        max_new]`` int32 (``pad_id`` after each example's ``eos_id``). With
        ``prefix`` (from :meth:`cache_prefix`) the prompts are suffixes after
        the shared prefix and only they are prefilled. ``constraint`` (an
        int, or one int per prompt, indexing ``config.constraints``; 0 = the
        FREE grammar) masks each row's decoding by its grammar's token DFA."""
        if self.config.draft is not None:
            return self._speculative()(prompts, seed=seed, prefix=prefix, constraint=constraint)
        n, tok0, _, carry = self._start(prompts, seed, prefix=prefix, constraint=constraint)
        steps = self.config.max_new_tokens - 1
        out = tok0.cpu().numpy()[:, None]
        if steps > 0:
            rest, _, _ = self._decode(*carry, steps=steps)
            out = np.concatenate([out, rest.cpu().numpy()], axis=1)
        return self._gather_rows(out)[:n]

    def beam_search(
        self, prompts: Sequence[Sequence[int]], *, num_beams: int = 4, length_penalty: float = 0.0,
        constraint: Any = None,
    ) -> np.ndarray:
        """Deterministic beam search: the highest-sum-log-prob continuation of
        ``max_new_tokens`` per prompt (``[n_prompts, max_new]`` int32).

        Beams are batch rows: each unique prompt is prefilled once, its cache
        rows tiled to ``num_beams``; each step scores every beam, keeps the
        top ``num_beams`` of the ``num_beams * vocab`` candidates per prompt
        and gathers the cache rows to the surviving parents. A beam that
        emits ``eos_id`` is finished: it competes with its score frozen,
        padding from there on. ``length_penalty`` > 0 divides final scores by
        ``((5 + len) / 6) ** length_penalty`` (GNMT). ``constraint`` runs the
        search inside the grammar: candidate scores are the log-probs of the
        masked, renormalized policy, and DFA states follow their parents."""
        if num_beams < 1:
            raise ValueError("num_beams must be >= 1")
        cfg = self.config
        n = len(prompts)
        out, scores = self._beam(prompts, num_beams, constraint)
        if cfg.eos_id is not None and length_penalty > 0.0:
            is_eos = out == cfg.eos_id
            lens = np.where(is_eos.any(axis=2), is_eos.argmax(axis=2) + 1, out.shape[2])
            scores = scores / (((5.0 + lens) / 6.0) ** length_penalty)
        best = scores.argmax(axis=1)
        return out[np.arange(n), best]

    @torch.no_grad()
    def _beam(self, prompts: Sequence[Sequence[int]], num_beams: int, constraint: Any = None):
        """The search itself: every beam's tokens ``[n, num_beams, max_new]``
        and its sum of log-probs ``[n, num_beams]``."""
        cfg = self.config
        eos, pad = cfg.eos_id, cfg.pad_id
        # prefill each unique prompt once (the batch padded to a power of two
        # of groups, and to the data axis; padding groups start done), then
        # tile every cache row to its beams as fresh tensors
        n, _, last, carry = self._start(prompts, 0, constraint=constraint)
        groups = last.shape[0]  # this rank's groups
        rows = self._row_slice(self._row_batch(1 << max(0, (n - 1).bit_length())))
        batch = groups * num_beams
        tile = torch.arange(batch, device=self.device) // num_beams
        cache = _reorder(carry[0], tile)
        last, lengths = last[tile], carry[2][tile]
        done = (torch.arange(rows.stop, device=self.device)[rows] >= n)[tile]
        st = None
        if self._cs is not None:
            # the search seeds from the prefill distribution, so every beam
            # starts at its grammar's start state
            gids = self._grammar_ids(constraint, n, rows.stop)[rows]
            st = torch.as_tensor(self._cs.start_states(gids), device=self.device)[tile]

        def logprobs(hidden, state):
            # the constrained policy's distribution: mask, then renormalize
            return torch.log_softmax(self._constrain(self._head(hidden), state), dim=-1)

        lp0 = logprobs(last.to(self.model.config.dtype), st).reshape(groups, num_beams, -1)
        vocab = lp0.shape[-1]
        k0 = min(num_beams, vocab)
        # with num_beams > vocab the surplus beams start at -inf and join as the tree widens
        seed_scores, seed_tokens = _top_k(lp0[:, 0], k0)
        scores = torch.nn.functional.pad(seed_scores, (0, num_beams - k0), value=-math.inf)
        first = torch.nn.functional.pad(seed_tokens, (0, num_beams - k0), value=pad).reshape(batch)
        tok = torch.where(done, pad, first).to(torch.int32)
        beam_done = done | (tok == eos) if eos is not None else done
        out = torch.full((batch, cfg.max_new_tokens), pad, dtype=torch.int32, device=self.device)
        out[:, 0] = tok
        if st is not None:
            st = torch.where(done, st, self._cs_trans[st.long(), tok.long()])
        group_base = (torch.arange(groups, device=self.device) * num_beams)[:, None]
        for col in range(1, cfg.max_new_tokens):
            # feed each beam's pending token at its filled length
            hidden, cache = self.model(
                tok[:, None], positions=lengths[:, None], return_hidden=True, cache=cache,
                token_mask=(~beam_done)[:, None],
            )
            lengths = lengths + (~beam_done).to(lengths.dtype)
            lp = logprobs(hidden[:, 0], st).reshape(groups, num_beams, vocab)
            flat_done = beam_done.reshape(groups, num_beams)
            # a finished beam contributes one candidate, its pad continuation at its frozen score
            cand = scores[:, :, None] + lp.masked_fill(flat_done[:, :, None], -math.inf)
            pad_cand = scores.masked_fill(~flat_done, -math.inf)
            top_scores, top_idx = _top_k(torch.cat([cand.reshape(groups, -1), pad_cand], dim=1), num_beams)
            is_pad = top_idx >= num_beams * vocab
            parent = torch.where(is_pad, top_idx - num_beams * vocab, top_idx // vocab)
            token = torch.where(is_pad, pad, top_idx % vocab)
            flat_parent = (group_base + parent).reshape(batch)
            cache = _reorder(cache, flat_parent)
            out, lengths = out[flat_parent], lengths[flat_parent]
            prev_done = beam_done[flat_parent]
            tok = token.reshape(batch).to(torch.int32)
            beam_done = prev_done | (tok == eos) if eos is not None else prev_done
            out[:, col] = torch.where(prev_done, pad, tok)
            if st is not None:
                # states follow their parents, then advance on the chosen token
                stp = st[flat_parent]
                st = torch.where(prev_done, stp, self._cs_trans[stp.long(), tok.long()])
            scores = top_scores
        out_np = self._gather_rows(out.cpu().numpy().reshape(groups, num_beams, -1))[:n]
        return out_np, self._gather_rows(scores.cpu().numpy().reshape(groups, num_beams))[:n]

    def stream(
        self, prompts: Sequence[Sequence[int]], *, seed: int = 0, chunk_size: int = 16,
        prefix: Optional[PrefixCache] = None, constraint: Any = None,
    ) -> Iterator[np.ndarray]:
        """Yield ``[len(prompts), <=chunk_size]`` arrays of newly decoded tokens
        (the first yield is the prompt-sampled token); ends early once every
        row has emitted ``eos_id``. Total tokens equal ``__call__``'s, under
        the same ``prefix`` and ``constraint``. With ``config.draft`` set,
        yields follow :meth:`SpeculativeGenerator.stream`'s ragged shape (a
        list of per-row 1-D arrays): rows advance by whole rounds."""
        cfg = self.config
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if cfg.draft is not None:
            yield from self._speculative().stream(prompts, seed=seed, chunk_size=chunk_size, prefix=prefix,
                                                  constraint=constraint)
            return
        # the last chunk may overshoot max_new_tokens; give its cache writes room
        n_chunks = max(0, -(-(cfg.max_new_tokens - 1) // chunk_size))
        extra = n_chunks * chunk_size - (cfg.max_new_tokens - 1)
        n, tok0, _, carry = self._start(prompts, seed, extra_cache=extra, constraint=constraint, prefix=prefix)
        yield self._gather_rows(tok0.cpu().numpy())[:n, None]
        produced = 1
        while produced < cfg.max_new_tokens:
            if self._all_done(carry[3]):
                return  # every row finished with eos
            toks, _, carry = self._decode(*carry, steps=chunk_size)
            take = min(chunk_size, cfg.max_new_tokens - produced)
            yield self._gather_rows(toks.cpu().numpy())[:n, :take]
            produced += take
