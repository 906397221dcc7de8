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
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, module_device, resolve_device
from unionml_tpu_torch.defaults import serve_kv_cache_dtype, serve_quantize
from unionml_tpu_torch.ops.quant import quantize_params

__all__ = [
    "DraftSpec",
    "GenerationConfig",
    "Generator",
    "chunk_aligned",
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
    ``partition_rules`` is refused, as :class:`Generator`'s ``mesh`` is."""

    module: Any
    params: Any = None
    gamma: int = 4
    partition_rules: Optional[Any] = None
    quantize: Optional[str] = None

    def __post_init__(self):
        if self.params is not None:
            raise ValueError("DraftSpec.params must be None in the port: the draft module carries its own weights")
        if self.partition_rules is not None:
            raise NotImplementedError(
                "DraftSpec partition_rules is not ported yet (ROADMAP.md, Queue A: parallelism and the replica layer)"
            )


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decoding knobs. ``temperature == 0`` means greedy (argmax) decoding;
    ``top_k``/``top_p``/``min_p`` filter the distribution before sampling.
    ``prefill_chunk`` prefills long prompts through the cache in chunks of
    that many columns. ``constraints`` (a
    :class:`~unionml_tpu_torch.models.structured.ConstraintSet`) lets each
    call pick a grammar per row (``constraint=``). ``draft`` (a
    :class:`DraftSpec`) decodes speculatively. ``sp_prefill`` mirrors the JAX
    package's field; the port does not serve it yet and its
    :class:`Generator` raises when it is set."""

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


def filtered_logits(logits: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """Apply temperature, ``min_p``, ``top_k`` and ``top_p`` to ``[..., V]``
    logits (masked entries become -inf); softmax of the result is the policy's
    sampling distribution."""
    logits = logits / config.temperature
    neg_inf = torch.tensor(-math.inf, dtype=logits.dtype, device=logits.device)
    if config.min_p > 0.0:
        # prob(x) >= min_p * prob(argmax)  <=>  logit(x) >= max_logit + log(min_p)
        log_min_p = torch.log(torch.tensor(config.min_p, dtype=logits.dtype, device=logits.device))
        cutoff = logits.amax(dim=-1, keepdim=True) + log_min_p
        logits = torch.where(logits < cutoff, neg_inf, logits)
    if config.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -config.top_k][..., None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if config.top_p < 1.0:
        sorted_desc = torch.flip(torch.sort(logits, dim=-1).values, dims=[-1])
        probs = torch.softmax(sorted_desc, dim=-1)
        exclusive_cum = torch.cumsum(probs, dim=-1) - probs
        # keep the smallest prefix whose mass reaches top_p; its lowest logit
        # becomes the cutoff on the unsorted axis
        dropped = exclusive_cum >= config.top_p
        min_kept = torch.where(dropped, -neg_inf, sorted_desc).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < min_kept, neg_inf, logits)
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


class Generator:
    """Batch text generation over a cached decoder.

    >>> gen = Generator(model, GenerationConfig(max_new_tokens=64))
    >>> tokens = gen([[1, 5, 9], [3, 3]], seed=0)   # [2, 64] int32

    ``model`` follows :class:`~unionml_tpu_torch.models.llama.Llama`'s cache
    contract and must already live on ``device`` (``None`` = CUDA, which
    raises on a machine without one). ``prefill_traces``/``decode_traces``
    mirror the JAX engine's compile counters; eager PyTorch compiles nothing,
    so they stay 0.

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
        unported = {"mesh": mesh, "partition_rules": partition_rules, "config.sp_prefill": config.sp_prefill}
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(f"Generator {name} is not ported yet (ROADMAP.md, Queue A)")
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
        self.prefill_traces = 0
        self.decode_traces = 0
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
        tok0 = sample_tokens(self._constrain(self._head(last), state), generator, self.config)
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
        return sample_tokens(self._constrain(logits, state), generator, self.config)

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
            nxt = sample_tokens(logits, generator, cfg)
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

    def _start(self, prompts: Sequence[Sequence[int]], seed: int, extra_cache: int = 0, constraint: Any = None):
        """Pad/bucket the prompts, allocate the cache, prefill (in
        ``prefill_chunk`` slices when set and the bucket is wider), and return
        ``(n, tok0, last, carry)``; the batch is padded to a power of two and
        the padding rows start done. ``constraint`` (an int, or one int per
        prompt) selects each row's grammar from ``config.constraints``; rows
        start at its DFA start state, and the carry gains the per-row state,
        advanced past the first token, as its tail."""
        cfg = self.config
        if constraint is not None and self._cs is None:
            raise ValueError("constraint= requires GenerationConfig.constraints to be set")
        n = len(prompts)
        lengths = np.array([max(len(p), 1) for p in prompts], np.int32)
        bucket = self._bucket(int(lengths.max()))
        batch = 1 << max(0, (n - 1).bit_length())
        tokens = np.full((batch, bucket), cfg.pad_id, np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = np.asarray(p, np.int32)
        all_lengths = np.ones((batch,), np.int32)
        all_lengths[:n] = lengths
        chunk = cfg.prefill_chunk
        if chunk:
            bucket = chunk_aligned(bucket, chunk)  # bucket shape is moot once chunked
            tokens = np.pad(tokens, ((0, 0), (0, bucket - tokens.shape[1])), constant_values=cfg.pad_id)
        cache_len = max(bucket, max(cfg.prompt_buckets, default=0)) + cfg.max_new_tokens + extra_cache
        cache = init_cache(self.model.config, batch, cache_len, kv_dtype=cfg.kv_cache_dtype, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        row_valid = torch.arange(batch, device=self.device) < n
        lengths_t = torch.as_tensor(all_lengths, device=self.device)
        state = None
        if self._cs is not None:
            starts = self._cs.start_states(self._grammar_ids(constraint, n, batch))
            state = torch.as_tensor(starts, device=self.device)
        if chunk and bucket > chunk:
            last, cache = self._chunked_prefill_loop(tokens, lengths_t, cache, row_valid, chunk)
            tok0 = self._first_token(last, generator, state)
        else:
            tok0, cache, last = self._prefill(
                torch.as_tensor(tokens, device=self.device), lengths_t, cache, generator, row_valid, state
            )
        eos = cfg.eos_id
        done = (tok0 == eos) if eos is not None else torch.zeros_like(row_valid)
        done = done | ~row_valid  # synthetic batch-padding rows emit pads, never advance
        carry = (cache, tok0, lengths_t, done, generator)
        if state is not None:
            carry += (self._cs_trans[state.long(), tok0.long()],)
        return n, tok0, last, carry

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

    def _chunked_prefill_loop(self, tokens: np.ndarray, lengths, cache, row_valid, chunk: int):
        """Run right-padded ``tokens`` through :meth:`_prefill_chunk` in
        ``chunk``-column slices, keeping each row's last-real-token hidden
        state."""
        last = torch.zeros((tokens.shape[0], self.model.config.dim), dtype=torch.float32, device=self.device)
        for c in range(0, tokens.shape[1], chunk):
            chunk_last, has, cache = self._prefill_chunk(
                torch.as_tensor(tokens[:, c : c + chunk], device=self.device), c, lengths, cache, row_valid
            )
            last = torch.where(has[:, None], chunk_last, last)
        return last, cache

    @staticmethod
    def _unported(prefix: Any) -> None:
        if prefix is not None:
            raise NotImplementedError("prefix caches are not ported yet (ROADMAP.md, Queue A: prefix caches)")

    def _speculative(self):
        """The speculative engine behind ``config.draft``, built on first use:
        THIS generator (its model already quantized and placed) is the verify
        target."""
        if self._spec_engine is None:
            from unionml_tpu_torch.models.speculative import SpeculativeGenerator

            self._spec_engine = SpeculativeGenerator.from_target(self, self.config.draft)
        return self._spec_engine

    # ------------------------------------------------------------------ generate

    def __call__(
        self, prompts: Sequence[Sequence[int]], *, seed: int = 0, prefix: Any = None, constraint: Any = None
    ) -> np.ndarray:
        """Generate ``max_new_tokens`` per prompt; returns ``[len(prompts),
        max_new]`` int32 (``pad_id`` after each example's ``eos_id``).
        ``constraint`` (an int, or one int per prompt, indexing
        ``config.constraints``; 0 = the FREE grammar) masks each row's
        decoding by its grammar's token DFA."""
        self._unported(prefix)
        if self.config.draft is not None:
            return self._speculative()(prompts, seed=seed, constraint=constraint)
        n, tok0, _, carry = self._start(prompts, seed, constraint=constraint)
        steps = self.config.max_new_tokens - 1
        first = tok0.cpu().numpy()[:, None]
        if steps <= 0:
            return first[:n]
        rest, _, _ = self._decode(*carry, steps=steps)
        return np.concatenate([first, rest.cpu().numpy()], axis=1)[:n]

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
        # of groups, padding groups start done), then tile every cache row to
        # its beams as fresh tensors
        n, _, last, carry = self._start(prompts, 0, constraint=constraint)
        groups = last.shape[0]
        batch = groups * num_beams
        tile = torch.arange(batch, device=self.device) // num_beams
        cache = _reorder(carry[0], tile)
        last, lengths = last[tile], carry[2][tile]
        done = tile >= n
        st = None
        if self._cs is not None:
            # the search seeds from the prefill distribution, so every beam
            # starts at its grammar's start state
            gids = self._grammar_ids(constraint, n, groups)
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
        out_np = out.cpu().numpy().reshape(groups, num_beams, -1)[:n]
        return out_np, scores.cpu().numpy().reshape(groups, num_beams)[:n]

    def stream(
        self, prompts: Sequence[Sequence[int]], *, seed: int = 0, chunk_size: int = 16,
        prefix: Any = None, constraint: Any = None,
    ) -> Iterator[np.ndarray]:
        """Yield ``[len(prompts), <=chunk_size]`` arrays of newly decoded tokens
        (the first yield is the prompt-sampled token); ends early once every
        row has emitted ``eos_id``. Total tokens equal ``__call__``'s, under
        the same ``constraint``. With ``config.draft`` set, yields follow
        :meth:`SpeculativeGenerator.stream`'s ragged shape (a list of per-row
        1-D arrays): rows advance by whole rounds."""
        self._unported(prefix)
        cfg = self.config
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if cfg.draft is not None:
            yield from self._speculative().stream(prompts, seed=seed, chunk_size=chunk_size, constraint=constraint)
            return
        # the last chunk may overshoot max_new_tokens; give its cache writes room
        n_chunks = max(0, -(-(cfg.max_new_tokens - 1) // chunk_size))
        extra = n_chunks * chunk_size - (cfg.max_new_tokens - 1)
        n, tok0, _, carry = self._start(prompts, seed, extra_cache=extra, constraint=constraint)
        yield tok0.cpu().numpy()[:n, None]
        produced = 1
        while produced < cfg.max_new_tokens:
            if bool(carry[3].all()):
                return  # every row finished with eos
            toks, _, carry = self._decode(*carry, steps=chunk_size)
            take = min(chunk_size, cfg.max_new_tokens - produced)
            yield toks.cpu().numpy()[:n, :take]
            produced += take
