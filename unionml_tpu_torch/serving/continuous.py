"""Continuous (in-flight) batching for generation serving.

Counterpart of the monolithic-admission subset of
``unionml_tpu/serving/continuous.py``: dense slots or a paged KV pool with a
scratch block, lazy block growth and recompute preemption.

- The engine owns ``slots`` cache rows (dense ``[S, cache_len, ...]`` per
  layer, or a shared pool of ``block_size`` blocks addressed through a block
  table) plus the decode carry (``tok/lengths/done`` per slot).
- **Join at prefill**: an arriving prompt prefills through the Generator at
  batch 1 into a fresh ``[1, cache_len]`` row, which is pasted (dense) or
  scattered through the slot's table (paged) between decode chunks.
- **Shared decode**: a background engine thread runs the Generator's decode
  for ``decode_chunk`` steps over ALL slots and routes each row's new tokens
  to its request's queue.
- **Leave at eos/budget**: finished and never-used slots ride along masked —
  ``done`` rows emit pads, never advance, and (paged) point at the scratch
  block, so their ride-along writes never touch a live page.

- **Speculative mode**: over a Generator whose ``config.draft`` is set, a
  dispatch rolls draft-and-verify rounds until every resident row has gained
  ``decode_chunk`` tokens; the draft's cache (dense rows, or a pool of the
  same block count sharing the target's block table) is prefilled beside
  the target's at admission.
- **Grammars and logprobs**: ``submit(constraint=g)`` runs a request under
  grammar ``g`` of the generator's ``ConstraintSet`` (the DFA state rides as
  the carry's tail; a preemption resume replays it over the echo on the
  host), and ``submit(logprobs=True)`` records each emitted token's
  log-probability on the stream.
- **Serving surface**: ``trace=`` records lifecycle events on the request
  trace each submit captures from its context (observability/trace.py);
  ``slo=`` keeps windowed telemetry and an SLO tracker (read from the
  ``UNIONML_TPU_SLO_*`` exports by default) behind ``health()`` and
  ``stats()``; ``tenancy=`` and ``submit(tenant=, priority=)`` shed a tenant
  over its rate with ``TenantThrottled``, admit waiting prompts deficit
  round robin across tenants within strict priority tiers, and let a
  high-priority admission on a full paged engine preempt the
  lowest-priority resident (serving/tenancy.py).

With greedy decoding each stream's tokens equal a solo
``Generator.__call__([prompt], constraint=g)`` run. Thread model: ``submit`` may be called
from any thread; the engine thread is the only one touching device state.
Where JAX donates the pool through its jitted admission and decode, the port
updates the pool tensors in place.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from unionml_tpu_torch.defaults import (
    SERVE_MAX_WAITING,
    serve_admit_chunk,
    serve_dp_replicas,
    serve_max_admissions,
    serve_prefill_budget,
    serve_prefix_cache,
    serve_replica_roles,
)
from unionml_tpu_torch.models.generate import Generator, init_cache, init_paged_cache
from unionml_tpu_torch.models.speculative import seeded_streams
from unionml_tpu_torch.observability.slo import SLOConfig, SLOTracker, TenantSLORegistry
from unionml_tpu_torch.observability.timeseries import EngineTimeseries
from unionml_tpu_torch.observability.trace import current_trace
from unionml_tpu_torch.serving.metrics import LatencyWindow
from unionml_tpu_torch.serving.overload import DeadlineExceeded, QueueFullError, TenantThrottled, expired
from unionml_tpu_torch.serving.tenancy import (
    PRIORITY_HIGH,
    PRIORITY_NORMAL,
    active_registry,
    current_priority,
    current_tenant,
    parse_priority,
    priority_name,
)

__all__ = ["ContinuousBatcher"]

logger = logging.getLogger(__name__)

#: engine options of the JAX package that later slices of the port bring
#: (static shared prefixes, disaggregated roles, the AOT store), each with the
#: title of its ROADMAP.md Queue A item; chunked admission and the radix cache
#: are resolved as in JAX and refused below
_UNPORTED = {"prefix": "prefix caches", "role": "parallelism and the replica layer", "aot": "the rest"}

_SENTINEL = object()


def _tev(session: "_Session", name: str, **attrs: Any) -> None:
    """Record an event on a session's request trace, if it carries one (one
    ``is not None`` test when tracing is off)."""
    trace = session.trace
    if trace is not None:
        trace.event(name, **attrs)


def _refund_admission(registry: "Optional[Any]", tenant: "Optional[str]") -> None:
    """Credit back a :meth:`TenantRegistry.try_admit` charge on a submit path
    that failed after admission; no-op when tenancy is off."""
    if registry is not None:
        registry.refund(tenant)


@dataclasses.dataclass
class _Session:
    """Host-side state of one request."""

    slot: int
    out: "queue.Queue[Any]"
    max_new: int  # this request's token budget (<= config.max_new_tokens)
    produced: int = 0  # tokens emitted so far (includes the prefill token)
    finished: bool = False
    #: every token emitted so far — a PREEMPTED request resumes by prefilling
    #: (original prompt + echo), which reproduces its greedy continuation
    echo: "List[int]" = dataclasses.field(default_factory=list)
    #: ``produced`` at the start of the current residency
    resident_base: int = 0
    #: admission sequence number — preemption evicts the YOUNGEST resident
    admit_seq: int = 0
    #: absolute position of this residency's first decode write
    row_start: int = 0
    #: the ORIGINAL prompt from submit(); a resume prefills prompt + echo
    prompt: "List[int]" = dataclasses.field(default_factory=list)
    #: absolute ``time.monotonic()`` deadline while WAITING for a slot
    deadline: Optional[float] = None
    created_at: float = 0.0
    last_emit: Optional[float] = None
    #: block-table entries assigned (paged mode); lazy growth appends here
    table_len: int = 0
    #: grammar id in the generator's ConstraintSet (0 = FREE)
    grammar: int = 0
    #: submit(logprobs=True): each emitted token's log-probability lands in
    #: ``lp`` before the token is enqueued
    want_logprobs: bool = False
    lp: "List[float]" = dataclasses.field(default_factory=list)
    #: the submitting request's RequestTrace (None when tracing is off)
    trace: Any = None
    #: multi-tenant QoS: the request's tenant id (None = anonymous) and
    #: priority tier; all-default values keep admission plain FIFO
    tenant: Optional[str] = None
    priority: int = PRIORITY_NORMAL


@dataclasses.dataclass(eq=False)
class _Admission:
    """One admission: a slot-holding prompt whose batch-1 prefill runs as a
    single step (monolithic admission), then pastes into the pool."""

    session: _Session
    prompt: "List[int]"
    slot: int
    seed: int
    budget: int  # this request's remaining generation budget
    blocks_row: Optional[np.ndarray]  # paged-mode block table row (None = dense)
    tok0: Any = None
    row_len: Any = None
    row_cache: Any = None
    d_row_cache: Any = None  # the draft model's row (speculative mode)
    #: the request's DFA state at this admission (None = unconstrained
    #: generator): the grammar's start, walked through the echo on a resume
    dfa_state: Optional[int] = None
    #: last-token hidden row ``[1, dim]`` f32, for the first token's logprob
    last: Any = None


class _TokenStream:
    """The iterator :meth:`ContinuousBatcher.submit` returns. ``close()`` is
    callable from any thread and cancels the session; dropping the last
    reference cancels too."""

    def __init__(self, batcher: "ContinuousBatcher", session: _Session):
        self._batcher = batcher
        self._session = session

    def __iter__(self) -> "Iterator[np.ndarray]":
        return self

    def __next__(self) -> np.ndarray:
        item = self._session.out.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._batcher._cancel(self._session)

    @property
    def logprobs(self) -> "List[float]":
        """Log-probabilities of the tokens emitted so far (``submit(...,
        logprobs=True)`` streams only). The engine appends each chunk's
        logprobs BEFORE enqueueing its tokens, so after consuming k tokens at
        least k entries are here."""
        return list(self._session.lp)

    def __del__(self):  # pragma: no cover - refcount backstop
        try:
            self.close()
        except Exception:
            pass


class ContinuousBatcher:
    """Share decode dispatches across concurrent generation requests.

    >>> batcher = ContinuousBatcher(generator, slots=4, block_size=16)
    >>> for chunk in batcher.submit([1, 5, 9]):   # 1-D int32 arrays
    ...     ...
    >>> batcher.close()

    The engine runs on its generator's device. ``slots`` bounds resident
    concurrency; excess requests wait FIFO, and beyond ``max_waiting`` of them
    submit() sheds with :class:`QueueFullError`. ``decode_chunk`` is the
    number of decode steps per shared dispatch. ``block_size`` switches the
    KV cache to PAGED mode: a pool of ``pool_blocks`` blocks plus one scratch
    block, admissions allocated only the blocks their prompt and first chunk
    need, residents growing at chunk boundaries and the youngest preempted
    (and later resumed token-exactly) when the pool runs dry.
    ``trace``, ``slo`` and ``tenancy`` are the JAX engine's: ``trace=False``
    opts the engine out of request timelines; ``slo`` is an ``SLOConfig``,
    ``None``/``True`` (read the ``UNIONML_TPU_SLO_*`` exports) or ``False``
    (no windowed telemetry); ``tenancy`` pins a ``TenantRegistry`` (else the
    process-wide one the serving app installs is read at each submit).
    ``admit_chunk``, ``prefill_budget``, ``max_admissions`` and
    ``prefix_cache`` resolve as in the JAX engine (the kwarg, else the serve
    CLI's env export); the port admits monolithically without a radix cache
    and raises ``NotImplementedError`` for a value that selects either. It
    raises the same where the serve CLI's ``UNIONML_TPU_DP_REPLICAS`` or
    ``UNIONML_TPU_REPLICA_ROLES`` asks for more than one replica, where the
    JAX engine would build a fleet, and for any ``roles=``.
    """

    def __init__(
        self,
        generator: Generator,
        *,
        slots: int = 4,
        decode_chunk: int = 8,
        block_size: Optional[int] = None,
        pool_blocks: Optional[int] = None,
        max_waiting: Optional[int] = None,
        admit_chunk: Optional[int] = None,
        prefill_budget: Optional[int] = None,
        max_admissions: Optional[int] = None,
        trace: Optional[bool] = None,
        prefix_cache: Optional[bool] = None,
        slo: Optional[Any] = None,
        tenancy: Optional[Any] = None,
        **unported: Any,
    ):
        if "roles" in unported:
            raise NotImplementedError(
                "ContinuousBatcher roles= is not ported yet (ROADMAP.md, Queue A: parallelism and the replica layer)"
            )
        self._refuse_replicas()
        unknown = sorted(set(unported) - set(_UNPORTED))
        if unknown:
            raise TypeError(f"unexpected ContinuousBatcher arguments {unknown}")
        for name, value in unported.items():
            if value:  # None and False select what the port has
                raise NotImplementedError(
                    f"ContinuousBatcher {name}= is not ported yet (ROADMAP.md, Queue A: {_UNPORTED[name]})"
                )
        self._resolve_admission(generator, admit_chunk, prefill_budget, max_admissions, prefix_cache, block_size)
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        if block_size is not None and block_size < 1:
            raise ValueError("block_size must be >= 1")
        if max_waiting is not None and max_waiting < 1:
            raise ValueError("max_waiting must be >= 1")
        cfg = generator.config
        self.gen = generator
        self.device = generator.device
        self.max_waiting = SERVE_MAX_WAITING if max_waiting is None else max_waiting
        #: request-timeline annotation: lifecycle events land on the trace each
        #: submit() captured from its context; the HTTP layer's tracing switch
        #: decides whether a trace EXISTS, False opts this engine out
        self.trace_requests = True if trace is None else bool(trace)
        self.slots = slots
        self.decode_chunk = decode_chunk
        #: speculative mode: with ``config.draft`` set, resident rows advance
        #: by draft-and-verify ROUNDS (the SpeculativeGenerator's loop with
        #: per-row floors and budgets), so concurrent streams share the draft
        #: and verify dispatches and each greedy stream still equals its solo
        #: target-only run
        self._spec = generator._speculative() if cfg.draft is not None else None
        #: room for every bucketed prompt, the full budget and the overshoot:
        #: one chunk of decode, or one round's gamma + 1 verify writes in
        #: speculative mode (which never runs the plain decode)
        self._overshoot = self._spec.gamma + 1 if self._spec is not None else decode_chunk
        widest = max(cfg.prompt_buckets, default=64)
        self.cache_len = widest + cfg.max_new_tokens + self._overshoot
        self.block_size = block_size
        if block_size is not None:
            self.max_blocks = -(-self.cache_len // block_size)
            self.pool_blocks = pool_blocks if pool_blocks is not None else slots * self.max_blocks
            if self.pool_blocks < self.max_blocks:
                raise ValueError(
                    f"pool_blocks ({self.pool_blocks}) must cover one worst-case request "
                    f"({self.max_blocks} blocks of {block_size}) or admission could deadlock"
                )
            #: block index ``pool_blocks`` is the SCRATCH block: unused and
            #: finished table entries point there
            self._scratch_block = self.pool_blocks
            mcfg = generator.model.config
            head_dim = mcfg.dim // mcfg.n_heads
            if cfg.kv_cache_dtype == "int8":
                kv_itemsize, scale_bytes = 1, 8  # k_scale + v_scale, f32 each
            else:
                kv_itemsize, scale_bytes = torch.empty((), dtype=mcfg.dtype).element_size(), 0
            self._block_bytes = int(
                mcfg.n_layers * mcfg.n_kv_heads * block_size * (2 * head_dim * kv_itemsize + scale_bytes)
            )
            self._kv_dtype_label = cfg.kv_cache_dtype or str(mcfg.dtype).replace("torch.", "")
            self._free_blocks: "List[int]" = list(range(self.pool_blocks))
            self._slot_blocks: Dict[int, "List[int]"] = {}
        elif pool_blocks is not None:
            raise ValueError("pool_blocks requires block_size (paged mode)")
        self._lock = threading.Condition()
        self._pending: "List[tuple]" = []  # (prompt, session) awaiting a free slot
        self._admissions: "List[_Admission]" = []
        self._sessions: Dict[int, _Session] = {}
        self._free = list(range(slots))
        self._cancelled: "List[_Session]" = []
        self._closed = False
        self._carry: Optional[tuple] = None  # (cache, tok, lengths, done, generator)
        self._seed = 0
        self._thread: Optional[threading.Thread] = None
        self._admit_counter = 0
        #: dispatch/utilization counters for benchmarks and /metrics
        self.decode_dispatches = 0
        self.decoded_rows = 0
        self.preemptions = 0
        #: admissions that ran as one prefill (every admission: chunked
        #: admission is not ported, so ``stats()["prefill"]["chunks"]`` stays 0)
        self.prefill_monolithic = 0
        #: TTFT (submit -> first token) and TBT (gap between emissions)
        self._ttft = LatencyWindow()
        self._tbt = LatencyWindow()
        #: windowed telemetry and the SLO tracker: an SLOConfig uses it,
        #: None/True reads the UNIONML_TPU_SLO_* exports, False disables both
        if slo is False:
            self.timeseries: Optional[EngineTimeseries] = None
            self.slo: Optional[SLOTracker] = None
        else:
            if slo is None or slo is True:
                slo_config = SLOConfig.from_env()
            elif isinstance(slo, SLOConfig):
                slo_config = slo
            else:
                raise TypeError(
                    f"slo must be an SLOConfig, True/None (read the UNIONML_TPU_SLO_* "
                    f"exports) or False (disable), got {type(slo).__name__}"
                )
            self.slo = SLOTracker(slo_config)
            # the ring covers the slow burn-rate window; TTFT/TBT percentiles
            # ride the engine's own timestamped reservoirs
            self.timeseries = EngineTimeseries(horizon_s=slo_config.slow_window_s, ttft=self._ttft, tbt=self._tbt)
        #: per-tenant SLO state, only for tenants whose spec arms targets
        self._tenant_slo: Optional[TenantSLORegistry] = (
            TenantSLORegistry(self._tenant_slo_config) if self.timeseries is not None else None
        )
        #: cached health evaluation (observability/health.engine_health)
        self._health_lock = threading.Lock()
        self._health_cache: "Optional[tuple]" = None
        self._health_ttl = 0.5
        #: token-weighted load normalizer: one widest bucket of queued prefill
        #: counts as one unit of scheduling load (the DRR quantum too)
        self._load_norm = float(self.admit_chunk or widest)
        #: overload counters: waiting-queue-full sheds and deadline sheds
        self.shed_queue_full = 0
        self.shed_deadline = 0
        #: multi-tenant QoS: the pinned registry (None = the process-wide one)
        self._tenancy = tenancy
        self.shed_tenant_limit = 0
        self.priority_preemptions = 0
        #: deficit-round-robin state over WAITING tenants, pruned every pass
        self._drr_deficit: "Dict[str, float]" = {}
        self._drr_last: Optional[str] = None
        #: submissions per grammar id (constrained engines): /metrics telemetry
        self._grammar_counts: Dict[int, int] = {}
        #: the speculative carry's (rounds, accepted, proposed) when last
        #: folded into the acceptance telemetry, so each dispatch adds its delta
        self._spec_seen = (0, 0, 0)

    @staticmethod
    def _refuse_replicas() -> None:
        """Where the JAX engine's constructor returns a fleet of replicas (the
        serve CLI's ``UNIONML_TPU_DP_REPLICAS`` above 1, or a
        ``UNIONML_TPU_REPLICA_ROLES`` spec of more than one replica), the port
        raises rather than build one engine."""
        env_roles = serve_replica_roles()
        role_total, source = sum(env_roles.values()), f"UNIONML_TPU_REPLICA_ROLES={env_roles}"
        dp = serve_dp_replicas()
        if dp > 1:
            role_total, source = dp, f"UNIONML_TPU_DP_REPLICAS={dp}"
        if role_total > 1:
            raise NotImplementedError(
                f"ContinuousBatcher: {source} selects {role_total} engine replicas, which are not ported yet "
                "(ROADMAP.md, Queue A: parallelism and the replica layer)"
            )

    def _resolve_admission(self, generator, admit_chunk, prefill_budget, max_admissions, prefix_cache,
                           block_size) -> None:
        """Resolve the admission options as the JAX engine does: each
        constructor kwarg, else the serve CLI's env export, else (for the
        chunk) the Generator's ``prefill_chunk``. The port admits
        monolithically, without a radix cache: a value that selects chunked
        admission or the cache raises, naming where it came from."""

        def resolve(name, value, read, env_var):
            if value is not None:
                return value, f"{name}={value}"
            value = read()
            return value, f"{env_var}={value}"

        chunk, chunk_from = resolve("admit_chunk", admit_chunk, serve_admit_chunk, "UNIONML_TPU_ADMIT_CHUNK")
        if admit_chunk is None and not chunk and generator.config.prefill_chunk:
            chunk, chunk_from = generator.config.prefill_chunk, f"prefill_chunk={generator.config.prefill_chunk}"
        budget, budget_from = resolve("prefill_budget", prefill_budget, serve_prefill_budget,
                                      "UNIONML_TPU_PREFILL_BUDGET")
        cap, cap_from = resolve("max_admissions", max_admissions, serve_max_admissions, "UNIONML_TPU_MAX_ADMISSIONS")
        self.admit_chunk: Optional[int] = int(chunk) or None
        self.prefill_budget: Optional[int] = int(budget) or self.admit_chunk or None
        self.max_admissions = max(int(cap), 1) if cap else 1
        for selects, source in ((self.admit_chunk, chunk_from), (int(budget), budget_from),
                                (self.max_admissions > 1, cap_from)):
            if selects:
                raise NotImplementedError(
                    f"ContinuousBatcher: {source} selects chunked admission, which is not ported yet "
                    "(ROADMAP.md, Queue A: chunked admission)"
                )
        if prefix_cache:
            raise NotImplementedError(
                "ContinuousBatcher prefix_cache= is not ported yet (ROADMAP.md, Queue A: prefix caches)"
            )
        if prefix_cache is None and serve_prefix_cache():
            if block_size is None:
                # as in JAX: a fleet-wide export must not crash dense engines
                logger.warning(
                    "UNIONML_TPU_PREFIX_CACHE is set but this engine is not paged (block_size=None); prefix "
                    "caching disabled"
                )
            else:
                raise NotImplementedError(
                    "ContinuousBatcher: UNIONML_TPU_PREFIX_CACHE selects the radix prefix cache, which is not "
                    "ported yet (ROADMAP.md, Queue A: prefix caches)"
                )

    # ------------------------------------------------------------------ device fns

    @staticmethod
    def _admit_impl(cache, row_cache, tok, lengths, done, slot, row_tok, row_len) -> None:
        """Paste a prefilled ``[1, cache_len, ...]`` row into slot row ``slot``
        and activate its carry entries, in place."""
        for layer, row in zip(cache, row_cache):
            for name in row:
                layer[name][slot] = row[name][0].to(layer[name].dtype)
        tok[slot] = row_tok[0]
        lengths[slot] = row_len[0]
        done[slot] = False

    @staticmethod
    def _paged_admit_impl(cache, row_cache, tok, lengths, done, slot, row_tok, row_len, blocks_row) -> None:
        """Point slot ``slot``'s table row at ``blocks_row`` and scatter the
        dense ``[1, cache_len]`` row into those blocks, in place.
        ``blocks_row`` is scratch-padded past the allocation, so the row's
        unused tail lands in the scratch block, never in another request's
        pages; those colliding writes leave scratch holding arbitrary rows,
        which nothing reads as live data."""
        table = cache[0]["table"]  # one table tensor shared by every layer
        block_size = cache[0]["k"].shape[2]  # pools are heads-major [H_kv, NB, bs, last]
        blocks = torch.as_tensor(blocks_row, dtype=torch.int32, device=table.device)
        pos = torch.arange(row_cache[0]["k"].shape[1], device=table.device)
        blk, off = blocks[pos // block_size].long(), pos % block_size
        table[slot] = blocks
        for layer, row in zip(cache, row_cache):
            for name in row:
                layer[name][:, blk, off] = row[name][0].transpose(0, 1).to(layer[name].dtype)
        tok[slot] = row_tok[0]
        lengths[slot] = row_len[0]
        done[slot] = False

    def _init_pool(self, model_config: Any) -> tuple:
        """A zeroed KV cache of the engine's geometry for one model: the
        dense ``[slots, cache_len]`` rows or the paged pool (``pool_blocks +
        1`` blocks: the extra one is scratch; the table starts all-scratch so
        never-admitted slots' ride-along writes are harmless)."""
        kv_dtype = self.gen.config.kv_cache_dtype
        if self.block_size is not None:
            return init_paged_cache(
                model_config, self.slots, self.pool_blocks + 1, self.block_size, self.max_blocks,
                kv_dtype=kv_dtype, fill_block=self._scratch_block, device=self.device,
            )
        return init_cache(model_config, self.slots, self.cache_len, kv_dtype=kv_dtype, device=self.device)

    def _init_carry(self) -> tuple:
        cfg = self.gen.config
        cache = self._init_pool(self.gen.model.config)
        tok = torch.zeros((self.slots,), dtype=torch.int32, device=self.device)
        lengths = torch.ones((self.slots,), dtype=torch.int32, device=self.device)
        done = torch.ones((self.slots,), dtype=torch.bool, device=self.device)  # every slot starts free
        # constrained generators carry each slot's DFA state as the tail; free
        # slots ride the FREE grammar's state 0
        tail = (torch.zeros((self.slots,), dtype=torch.int32, device=self.device),) if self.gen._cs is not None else ()
        if self._spec is None:
            generator = torch.Generator(device=self.device).manual_seed(self._seed)
            return (cache, tok, lengths, done, generator, *tail)
        d_cache = self._init_pool(self._spec._draft.model.config)
        if self.block_size is not None:
            # the draft's pool has the same BLOCK COUNT (other shapes), so one
            # host allocation addresses both; its layers hold the target's
            # table tensor, so one in-place table update serves both pools
            table = cache[0]["table"]
            d_cache = tuple({**layer, "table": table} for layer in d_cache)
        out_buf = torch.full((self.slots, cfg.max_new_tokens + self._spec.gamma + 1), cfg.pad_id,
                             dtype=torch.int32, device=self.device)
        produced = torch.zeros((self.slots,), dtype=torch.int32, device=self.device)
        accepted = torch.zeros((2,), dtype=torch.int64, device=self.device)
        # the speculative loop's state layout (models/speculative.py); the DFA
        # state stays the tail, as in the plain carry
        return (cache, d_cache, tok, lengths, done, produced, out_buf, 0, accepted,
                seeded_streams(self._seed, self.device), *tail)

    def _prefill_row(self, prompt: Sequence[int], seed: int, budget: Optional[int] = None,
                     dfa_state: Optional[int] = None, gen: Optional[Generator] = None):
        """Prefill one prompt at batch 1 into a fresh ``[1, cache_len]`` cache
        with the Generator's own prefill, the first token masked by
        ``dfa_state`` when given. Returns ``(tok0, lengths, row_cache, last)``
        (``last``: the last-token hidden row, f32). ``budget`` is THIS
        request's remaining token budget; ``gen`` overrides the model
        (speculative mode prefills the draft's row too)."""
        gen = gen or self.gen
        cfg = gen.config
        if budget is None:
            budget = cfg.max_new_tokens
        bucket = self._prefill_width(prompt, budget)
        tokens = np.full((1, bucket), cfg.pad_id, np.int32)
        tokens[0, : len(prompt)] = np.asarray(prompt, np.int32)
        lengths = torch.tensor([max(len(prompt), 1)], dtype=torch.int32, device=self.device)
        row_cache = init_cache(gen.model.config, 1, self.cache_len, kv_dtype=cfg.kv_cache_dtype, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        row_valid = torch.ones((1,), dtype=torch.bool, device=self.device)
        state = None if dfa_state is None else torch.tensor([dfa_state], dtype=torch.int32, device=self.device)
        tok0, row_cache, last = gen._prefill(
            torch.as_tensor(tokens, device=self.device), lengths, row_cache, generator, row_valid, state
        )
        return tok0, lengths, row_cache, last

    def _prefill_width(self, prompt: Sequence[int], budget: int) -> int:
        """The prefill's padded width: the prompt's bucket, or its exact
        length where a PREEMPTED request resumed as prompt + emitted tokens
        outgrows every bucket while still fitting the cache contiguously."""
        bucket = self.gen._bucket(max(len(prompt), 1))
        if bucket + budget > self.cache_len:
            exact = max(len(prompt), 1)
            if exact + budget > self.cache_len:
                raise ValueError(
                    f"prompt of length {len(prompt)} needs bucket {bucket} + {budget} new tokens "
                    f"> cache_len {self.cache_len}"
                )
            bucket = exact
        return bucket

    def _first_logprob(self, adm: _Admission) -> float:
        """The prompt-sampled token's log-probability: head, mask and
        log-softmax over the admission's last hidden row — the constrained
        distribution the token was sampled from, as the decode steps'
        logprobs are."""
        gen = self.gen
        state = None if adm.dfa_state is None else torch.tensor([adm.dfa_state], dtype=torch.int32, device=self.device)
        with torch.no_grad():
            logits = gen._constrain(gen._head(adm.last.to(gen.model.config.dtype)), state)
            lp = torch.log_softmax(logits, dim=-1).gather(1, adm.tok0[:, None].long())
        return float(lp[0, 0])

    # ------------------------------------------------------------------ block allocator

    def _blocks_for_tokens(self, tokens: int) -> int:
        """Blocks (= block-table entries) covering positions ``[0, tokens)``.
        The prefill scatter also writes the bucket's pad columns, but those
        are hidden by the ``slot <= position`` mask until decode overwrites
        them in order, so they may land in the scratch block."""
        return -(-tokens // self.block_size)

    def _blocks_initial(self, prompt: Sequence[int], budget: int) -> int:
        """Blocks an ADMISSION needs: prompt + one chunk of lookahead, capped
        at the request's remaining budget — the target the first growth pass
        demands, so a fresh admission is never admit-then-instantly-preempted."""
        plen = max(len(prompt), 1)
        tokens = min(plen + self.decode_chunk + self._overshoot, plen + budget - 1 + self._overshoot)
        return self._blocks_for_tokens(tokens)

    def _blocks_lifetime(self, prompt: Sequence[int], budget: int) -> int:
        """Worst-case blocks over a request's whole life."""
        return self._blocks_for_tokens(max(len(prompt), 1) + budget + self._overshoot)

    def _release_blocks_locked(self, slot: int) -> None:
        """Return a slot's pool blocks to the allocator (caller holds the lock)."""
        if self.block_size is not None:
            self._free_blocks.extend(self._slot_blocks.pop(slot, []))

    def _extend_tables(self, slot: int, start_idx: int, ids: "List[int]") -> None:
        """Append freshly allocated block ids to a resident slot's table row
        (engine thread only)."""
        if not ids or self._carry is None:
            return
        table = self._carry[0][0]["table"]
        table[slot, start_idx : start_idx + len(ids)] = torch.as_tensor(ids, dtype=torch.int32, device=table.device)

    def _mask_slot_done(self, slot: int) -> None:
        """Set the device-side done flag of a slot (engine thread only); in
        paged mode also repoint its table row at the scratch block — its freed
        blocks may be reallocated at once, and the done row keeps issuing a
        ride-along K/V write per step."""
        if self._carry is None:
            return
        self._carry[3 if self._spec is None else 4][slot] = True
        if self.block_size is not None:  # the table tensor both pools share
            self._carry[0][0]["table"][slot] = self._scratch_block

    def _preempt_locked(self, slot: int, reason: str = "capacity") -> None:
        """Evict a resident under pool exhaustion (or for a higher-priority
        admission, ``reason="priority"``): free its slot/blocks, mask its row,
        and requeue it at the FIFO head as (original prompt + every token
        already emitted) — its greedy continuation is token-identical."""
        session = self._sessions.pop(slot)
        self.preemptions += 1
        _tev(session, "engine.preempt", produced=session.produced,
             **({"reason": reason} if reason != "capacity" else {}))
        self._free.append(slot)
        self._release_blocks_locked(slot)
        self._mask_slot_done(slot)
        session.slot = -1
        if not session.finished:
            self._pending.insert(0, (list(session.prompt) + list(session.echo), session))

    def _ensure_capacity_locked(self) -> None:
        """Lazy growth at every chunk boundary (engine thread, lock held): each
        resident's table must cover the NEXT dispatch's writes; when the pool
        cannot supply them the YOUNGEST resident is preempted and the check
        retried. A lone resident always fits (pool >= max_blocks)."""
        if self.block_size is None:
            return
        while True:
            deficits = {}
            for slot, session in self._sessions.items():
                produced_res = session.produced - session.resident_base
                tokens = min(
                    session.row_start + max(produced_res - 1, 0) + self.decode_chunk + self._overshoot,
                    session.row_start + (session.max_new - session.resident_base) - 1 + self._overshoot,
                )
                target = self._blocks_for_tokens(tokens)
                if target > session.table_len:
                    deficits[slot] = target - session.table_len
            if sum(deficits.values()) <= len(self._free_blocks):
                for slot, extra in deficits.items():
                    session = self._sessions[slot]
                    alloc = [self._free_blocks.pop(0) for _ in range(extra)]
                    self._slot_blocks[slot].extend(alloc)
                    self._extend_tables(slot, session.table_len, alloc)
                    session.table_len += extra
                return
            # lowest-priority first, youngest within a tier (with priorities
            # unset: the youngest resident)
            self._preempt_locked(
                max(self._sessions, key=lambda s: (self._sessions[s].priority, self._sessions[s].admit_seq))
            )

    # ------------------------------------------------------------------ public API

    def _registry(self) -> Optional[Any]:
        """The tenancy registry in effect: the engine's pinned one, else the
        process-wide active registry (installed by the serving app); None =
        tenancy off. Resolved per call, so a registry installed after the
        engine was built still applies."""
        return self._tenancy if self._tenancy is not None else active_registry()

    def _tenant_slo_config(self, tenant: str) -> "Optional[SLOConfig]":
        """A tenant's per-tenant SLO targets (None = none armed)."""
        registry = self._registry()
        if registry is None:
            return None
        return registry.spec(tenant).slo_config()

    def _tenant_shed(self, tenant: Optional[str]) -> None:
        """Feed a shed into the tenant's SLO timeseries."""
        if self._tenant_slo is not None and tenant is not None:
            self._tenant_slo.shed(tenant)

    def tenant_slo(self) -> "Dict[str, Any]":
        """Per-tenant SLO verdicts (``{}`` with none tracked)."""
        if self._tenant_slo is None:
            return {}
        return self._tenant_slo.evaluate()

    def submit(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None, constraint: Optional[int] = None,
        deadline: Optional[float] = None, tenant: Optional[str] = None, priority: Optional[Any] = None,
        logprobs: bool = False,
    ) -> Iterator[np.ndarray]:
        """Enqueue a prompt; returns an iterator of 1-D int32 arrays of new
        tokens (the first item is the prompt-sampled token). Safe from any
        thread. ``max_new_tokens`` caps THIS request below the config budget.
        ``constraint`` selects THIS request's grammar from the generator's
        ``config.constraints`` (0 = FREE); ``logprobs=True`` records each
        emitted token's log-probability on the stream's ``logprobs``.
        ``deadline`` (absolute ``time.monotonic()``) sheds the request with
        :class:`DeadlineExceeded` if it is still waiting past it; a full
        waiting queue sheds at once with :class:`QueueFullError`.

        ``tenant``/``priority`` default to the request contextvars the HTTP
        layer binds: a tenant with an empty token bucket is shed with
        :class:`TenantThrottled` (HTTP 429 whose ``Retry-After`` is the
        bucket's refill time), waiting prompts are admitted deficit round
        robin across tenants within strict priority tiers, and a
        high-priority admission on a full paged engine preempts the
        lowest-priority resident (which resumes token-identically)."""
        if len(prompt) == 0:
            raise ValueError("prompt must be non-empty")
        if logprobs and self._spec is not None:
            raise ValueError(
                "logprobs does not compose with speculative decoding (config.draft) yet: "
                "accepted draft tokens carry no per-token policy logprob"
            )
        req_trace = current_trace() if self.trace_requests else None
        if expired(deadline):
            # under the lock: the engine thread bumps the same counter
            with self._lock:
                self.shed_deadline += 1
                if self.timeseries is not None:
                    self.timeseries.sheds.add()
            self._tenant_shed(tenant if tenant is not None else current_tenant())
            if req_trace is not None:
                req_trace.event("engine.shed_deadline", phase="submit")
            raise DeadlineExceeded("deadline expired before the prompt was enqueued")
        budget = self.gen.config.max_new_tokens
        if max_new_tokens is not None:
            if not (1 <= max_new_tokens <= budget):
                raise ValueError(
                    f"max_new_tokens must be in [1, {budget}] (the config budget the cache is sized for)"
                )
            budget = max_new_tokens
        grammar = 0
        if constraint is not None:
            if self.gen._cs is None:
                raise ValueError("constraint= requires GenerationConfig.constraints on the Generator")
            self.gen._cs.start_states([constraint])  # range check
            grammar = int(constraint)
        # explicit kwargs win, else the contextvars the HTTP layer bound;
        # priority falls back to the tenant's default tier, then normal
        registry = self._registry()
        if tenant is None:
            tenant = current_tenant()
        if priority is None:
            priority = current_priority()
        if isinstance(priority, str):
            priority = parse_priority(priority)
        if priority is None:
            priority = (
                registry.default_priority(tenant) if registry is not None and tenant is not None else PRIORITY_NORMAL
            )
        if not (PRIORITY_HIGH <= priority <= 2):
            raise ValueError(f"priority must be in [0, 2] (high/normal/batch), got {priority!r}")
        session = _Session(
            slot=-1, out=queue.Queue(), max_new=budget, deadline=deadline, created_at=time.monotonic(),
            grammar=grammar, want_logprobs=bool(logprobs), trace=req_trace, tenant=tenant, priority=priority,
            # the original prompt is kept only where preemption can resume it
            prompt=list(prompt) if self.block_size is not None else [],
        )
        with self._lock:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            # admission control counts LIVE waiters only
            waiting = sum(1 for _, s in self._pending if not s.finished)
            if waiting >= self.max_waiting:
                self.shed_queue_full += 1
                if self.timeseries is not None:
                    self.timeseries.sheds.add()
                self._tenant_shed(tenant)
                if req_trace is not None:
                    req_trace.event("engine.shed_queue_full", waiting=waiting)
                raise QueueFullError(
                    f"continuous-batching waiting queue full ({self.max_waiting} prompts queued "
                    f"ahead of {self.slots} slots)"
                )
            if registry is not None:
                # AFTER the capacity check, so a full-queue shed never charges
                # the bucket; a failed try_admit leaves the buckets untouched
                retry_after = registry.try_admit(tenant)
                if retry_after is not None:
                    self.shed_tenant_limit += 1
                    if self.timeseries is not None:
                        self.timeseries.sheds.add()
                    self._tenant_shed(tenant)
                    if req_trace is not None:
                        req_trace.event(
                            "engine.shed_tenant_limit", tenant=tenant, retry_after_s=round(retry_after, 3),
                        )
                    raise TenantThrottled(
                        f"tenant {tenant!r} is over its rate limit",
                        retry_after_s=round(retry_after, 3), tenant=tenant,
                    )
            try:
                if self.gen._cs is not None:
                    self._grammar_counts[grammar] = self._grammar_counts.get(grammar, 0) + 1
                self._pending.append((list(prompt), session))
                if self._thread is None:
                    self._thread = threading.Thread(target=self._engine_loop, daemon=True)
                    self._thread.start()
                self._lock.notify_all()
            except BaseException:
                # the tenant paid for a request that will never be served
                _refund_admission(registry, tenant)
                raise
        try:
            if req_trace is not None:
                req_trace.event(
                    "engine.submit", prompt_tokens=len(prompt), queued_behind=waiting,
                    **({"tenant": tenant, "priority": priority_name(priority)}
                       if tenant is not None or priority != PRIORITY_NORMAL else {}),
                )
            return _TokenStream(self, session)
        except BaseException:
            _refund_admission(registry, tenant)
            raise

    def _cancel(self, session: _Session) -> None:
        """Stop producing for a session whose consumer went away. Pending
        sessions are dequeued here; RESIDENT slots are flagged and the engine
        frees and masks them at the next chunk boundary."""
        with self._lock:
            if session.finished:
                return
            session.finished = True
            if any(s is session for _, s in self._pending):
                self._pending = [(p, s) for p, s in self._pending if s is not session]
            elif session.slot >= 0 and self._sessions.get(session.slot) is session:
                self._cancelled.append(session)
            _tev(session, "engine.cancel", produced=session.produced)
            session.out.put(_SENTINEL)
            self._lock.notify_all()

    def _apply_cancellations_locked(self) -> None:
        """Engine thread: free and done-mask slots whose consumers went away,
        identity-checked against the resident session."""
        cancelled, self._cancelled = self._cancelled, []
        for session in cancelled:
            if self._sessions.get(session.slot) is session:
                self._sessions.pop(session.slot)
                self._free.append(session.slot)
                self._release_blocks_locked(session.slot)
                self._mask_slot_done(session.slot)

    def configure_slo(self, config: "SLOConfig") -> None:
        """Swap this engine's SLO targets at runtime. The tracker restarts at
        all-ok; the next ``health()`` evaluates fresh against the new targets."""
        if not isinstance(config, SLOConfig):
            raise TypeError(f"config must be an SLOConfig, got {type(config).__name__}")
        if self.timeseries is None:
            raise ValueError(
                "this engine was built with slo=False (windowed telemetry disabled); "
                "SLO targets need the timeseries feed"
            )
        with self._health_lock:
            self.slo = SLOTracker(config)
            self._health_cache = None

    def rates(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """Windowed rates (tok/s, admissions/s, sheds/s, time-decayed TTFT/TBT
        percentiles) plus the live prefill backlog; defaults to the SLO fast
        window. ``{}`` when the engine was built with ``slo=False``."""
        if self.timeseries is None:
            return {}
        if window_s is None:
            window_s = self.slo.config.fast_window_s if self.slo is not None else 60.0
        out = self.timeseries.rates(window_s)
        out["prefill_backlog_tokens"] = self.queued_prefill_tokens()
        return out

    def health(self, *, max_age_s: Optional[float] = None) -> Dict[str, Any]:
        """This engine's health (observability/health.py): SLO state x
        saturation as one score, cached for ``max_age_s`` (default 0.5 s);
        ``max_age_s=0`` forces a fresh evaluation."""
        from unionml_tpu_torch.observability.health import engine_health

        ttl = self._health_ttl if max_age_s is None else max_age_s
        now = time.monotonic()
        with self._health_lock:
            cached = self._health_cache
        if cached is not None and now - cached[0] < ttl:
            return cached[1]
        fresh = engine_health(self)
        with self._health_lock:
            self._health_cache = (now, fresh)
        return fresh

    def occupancy(self) -> "tuple[int, int]":
        """``(resident, live waiting)``; in-flight admissions count as waiting."""
        with self._lock:
            waiting = sum(1 for _, s in self._pending if not s.finished)
            waiting += sum(1 for a in self._admissions if not a.session.finished)
            return len(self._sessions), waiting

    def queued_prefill_tokens(self) -> int:
        """Prompt tokens standing between arrivals and their first token: live
        waiting prompts plus in-flight admissions' prompts."""
        with self._lock:
            return self._backlog_locked()

    def _backlog_locked(self) -> int:
        backlog = sum(len(p) for p, s in self._pending if not s.finished)
        for adm in self._admissions:
            if not adm.session.finished:
                # monolithic admissions owe their whole prompt until they finish
                backlog += max(len(adm.prompt), 1)
        return backlog

    def load(self) -> float:
        """Scheduling load: live residents + live waiters plus the prefill
        backlog in tokens normalized by the widest prompt bucket."""
        resident, waiting = self.occupancy()
        return resident + waiting + self.queued_prefill_tokens() / self._load_norm

    def stats(self) -> Dict[str, Any]:
        """Utilization snapshot for ``/metrics``, with the JAX engine's keys:
        resident/waiting streams, sheds, shared-dispatch counters, the prefill
        block, pool occupancy (paged mode), the TTFT/TBT percentiles, windowed
        rates and (armed) the SLO verdict. The lock is held only for the
        counter reads; percentile sorts and SLO evaluation run after it."""
        with self._lock:
            backlog = self._backlog_locked()
            snapshot: Dict[str, Any] = {
                "slots": self.slots,
                "resident": len(self._sessions),
                "waiting": len(self._pending),
                "admitting": len(self._admissions),
                "max_waiting": self.max_waiting,
                "shed_queue_full": self.shed_queue_full,
                "shed_deadline": self.shed_deadline,
                "draining": self._closed,
                "decode_dispatches": self.decode_dispatches,
                "rows_per_dispatch": round(
                    self.decoded_rows / self.decode_dispatches, 3
                ) if self.decode_dispatches else None,
                "speculative": self._spec is not None,
                "prefill": {
                    "mode": "chunked" if self.admit_chunk else "monolithic",
                    "admit_chunk": self.admit_chunk or 0,
                    "budget": self.prefill_budget or 0,
                    "max_admissions": self.max_admissions,
                    "chunks": 0,
                    "chunk_tokens": 0,
                    "monolithic_admissions": self.prefill_monolithic,
                    "backlog_tokens": backlog,
                },
            }
            if self.block_size is not None:
                used = self.pool_blocks - len(self._free_blocks)
                snapshot["kv_blocks"] = {
                    "total": self.pool_blocks,
                    "used": used,
                    # static shared prefixes are not ported: no shared pages
                    "shared_prefix": 0,
                    "block_size": self.block_size,
                    "preemptions": self.preemptions,
                    "block_bytes": self._block_bytes,
                    "used_bytes": used * self._block_bytes,
                    "kv_dtype": self._kv_dtype_label,
                }
            if self._registry() is not None or self.shed_tenant_limit or self.priority_preemptions:
                # absent entirely when QoS is off
                snapshot["tenancy"] = {
                    "shed_tenant_limit": self.shed_tenant_limit,
                    "priority_preemptions": self.priority_preemptions,
                }
            if self._spec is not None and self._spec.rounds:
                snapshot["acceptance_rate"] = round(
                    self._spec.accepted_tokens / (self._spec.rounds * self._spec.gamma), 3
                )
            if self.gen._cs is not None:
                snapshot["grammar_submissions"] = dict(sorted(self._grammar_counts.items()))
        # window work, OUTSIDE the engine lock
        snapshot["ttft_ms"] = self._ttft.snapshot()
        snapshot["tbt_ms"] = self._tbt.snapshot()
        if self.timeseries is not None:
            fast_s = self.slo.config.fast_window_s if self.slo is not None else 60.0
            snapshot["rates"] = {**self.timeseries.rates(fast_s), "prefill_backlog_tokens": backlog}
        if self.slo is not None and self.slo.armed:
            snapshot["slo"] = self.slo.evaluate(self.timeseries)
        if self._tenant_slo is not None and len(self._tenant_slo):
            snapshot["tenant_slo"] = self._tenant_slo.evaluate()
        return snapshot

    def warmup(self) -> None:
        """Pay the cold start before traffic arrives: a bucket-FILLING request
        runs through each prompt bucket (budget 1: admission only — each
        bucket is its own prefill shape and allocation), then short requests
        run the two decode dispatches (the first on the freshly made carry,
        the second on the steady-state one). Their first launches build and
        load the hand-written kernels the engine's path runs (``nvcc`` at
        first use, the port's counterpart of the JAX engine's XLA compile).
        Counters, the TTFT/TBT windows, the windowed rates and the SLO
        tracker are reset afterwards, so :meth:`stats` reflects real traffic
        only."""
        cfg = self.gen.config
        for bucket in sorted(cfg.prompt_buckets):
            # length == bucket: shorter prompts map to the smallest fitting
            # bucket, which would leave the larger shapes cold
            for _ in self.submit([cfg.pad_id + 1] * bucket, max_new_tokens=1):
                pass
        if cfg.max_new_tokens >= 2:
            # an eos-emitting model can finish a junk prompt at admission
            # without decoding: vary the prompt a few times
            vocab = int(getattr(self.gen.model.config, "vocab_size", 2))
            for salt in range(6):
                if self.decode_dispatches >= 2:
                    break
                tok = 1 + (cfg.pad_id + salt) % max(vocab - 1, 1)
                for _ in self.submit([tok], max_new_tokens=2):
                    pass
            if self.decode_dispatches < 2:
                logger.warning(
                    "warmup never reached the steady-state decode dispatch (eos at admission for every probe "
                    "prompt); the first streams may pay a cold start"
                )
        with self._lock:
            self.decode_dispatches = 0
            self.decoded_rows = 0
            self.prefill_monolithic = 0
            self._ttft.clear()  # warmup probes must not skew the percentiles
            self._tbt.clear()
            if self.timeseries is not None:
                self.timeseries.clear()  # probe tokens are not traffic rates
            if self.slo is not None:
                self.slo.reset()  # a slow first-launch probe is not a breach
            if self._tenant_slo is not None:
                self._tenant_slo.clear()
            self._grammar_counts.clear()  # warmup probes all ride FREE (id 0)
            if self._spec is not None:
                self._spec.rounds = self._spec.accepted_tokens = self._spec.proposed_tokens = 0
        with self._health_lock:
            self._health_cache = None

    def close(self, wait: bool = True, timeout: float = 120.0) -> None:
        """Stop admitting, drain resident streams to completion, stop the
        engine. Never-admitted pending requests get a clean end-of-stream."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        if wait and self._thread is not None:
            self._thread.join(timeout=timeout)

    # ------------------------------------------------------------------ engine

    def _engine_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    while not self._closed and not self._pending and not self._admissions and not self._sessions:
                        self._lock.wait()
                    self._apply_cancellations_locked()
                    if self._closed:
                        for _, session in self._pending:
                            session.out.put(_SENTINEL)
                        self._pending.clear()
                        if not self._sessions and not self._admissions:
                            break
                self._admit_pending()
                if self._sessions:
                    self._decode_chunk()
        except Exception as exc:  # engine death must not strand consumers
            logger.exception("continuous-batching engine failed")
            # postmortem: the timelines that explain the failure reach the log
            # before the consumers see the error (no-op without a recorder)
            from unionml_tpu_torch.observability.recorder import dump_active

            dump_active(f"continuous engine failed: {type(exc).__name__}")
            with self._lock:
                self._closed = True
                for _, session in self._pending:
                    session.out.put(exc)
                for adm in self._admissions:
                    if not adm.session.finished:
                        adm.session.out.put(exc)
                for session in self._sessions.values():
                    session.out.put(exc)
                self._pending.clear()
                self._admissions.clear()
                self._sessions.clear()
        finally:
            with self._lock:
                for _, session in self._pending:
                    session.out.put(_SENTINEL)
                for adm in self._admissions:
                    adm.session.out.put(_SENTINEL)
                for session in self._sessions.values():
                    session.out.put(_SENTINEL)

    def _admit_pending(self) -> None:
        """Move waiting prompts into free slots, one monolithic admission at
        a time. The lock is held only for queue/slot/block bookkeeping; the
        prefill runs unlocked so submit()/close() callers never wait on it."""
        while True:
            self._start_admissions()
            if not self._admissions:
                return
            for adm in list(self._admissions):
                if not self._admission_alive(adm):
                    continue
                self._set_dfa_state(adm)
                try:
                    # the whole batch-1 prefill, unlocked
                    adm.tok0, adm.row_len, adm.row_cache, adm.last = self._prefill_row(
                        adm.prompt, adm.seed, budget=adm.budget, dfa_state=adm.dfa_state
                    )
                    if self._spec is not None:
                        # the draft's row: the same prompt through the draft
                        # (its prompt-sampled token is discarded: emission #1
                        # is the target's)
                        adm.d_row_cache = self._prefill_row(
                            adm.prompt, adm.seed, budget=adm.budget, dfa_state=adm.dfa_state, gen=self._spec._draft
                        )[2]
                except ValueError as exc:
                    # a bad prompt fails its own stream; the admission built
                    # only a fresh [1, ...] row, so the engine carries on
                    self._abort_admission(adm, exc)
                    continue
                except BaseException as exc:
                    with self._lock:
                        if adm in self._admissions:
                            self._admissions.remove(adm)
                        if not adm.session.finished:
                            adm.session.finished = True
                            adm.session.out.put(exc)
                    raise
                with self._lock:
                    self.prefill_monolithic += 1
                _tev(adm.session, "engine.prefill", tokens=self._prefill_width(adm.prompt, adm.budget),
                     mode="monolithic")
                self._finalize_admission(adm)

    def _start_admissions(self) -> None:
        """Sweep dead/expired waiters, then move the head of the queue into a
        free slot as an admission (lock held; no device work). Paged mode
        allocates only the prompt + first dispatch; the head keeps its FIFO
        position while the pool cannot supply its initial blocks."""
        with self._lock:
            live = []
            for prompt_s, s in self._pending:
                if s.finished:
                    continue
                if expired(s.deadline):
                    s.finished = True
                    self.shed_deadline += 1
                    if self.timeseries is not None:
                        self.timeseries.sheds.add()
                    self._tenant_shed(s.tenant)
                    _tev(s, "engine.shed_deadline", phase="waiting")
                    s.out.put(DeadlineExceeded("deadline exceeded while waiting for a decode slot"))
                    continue
                live.append((prompt_s, s))
            self._pending = live
            if self._closed:
                return
            while self._pending and not self._admissions:
                self._select_pending_locked()
                if not self._free:
                    if self._preempt_for_priority_locked():
                        # the victim requeued at the head; re-select so the
                        # high-priority prompt rotates back in front of it
                        continue
                    break
                blocks_row = None
                needed = 0
                if self.block_size is not None:
                    head_prompt, head_session = self._pending[0]
                    head_budget = head_session.max_new - head_session.produced
                    lifetime = self._blocks_lifetime(head_prompt, head_budget)
                    if lifetime > self.max_blocks:
                        # an oversized prompt can never fit a table row: fail
                        # its stream now instead of wedging the FIFO head
                        _, session = self._pending.pop(0)
                        if not session.finished:
                            session.finished = True
                            session.out.put(ValueError(
                                f"prompt needs {lifetime} KV blocks but a slot's table holds {self.max_blocks}"
                            ))
                        continue
                    needed = self._blocks_initial(head_prompt, head_budget)
                    if needed > len(self._free_blocks):
                        return
                prompt, session = self._pending.pop(0)
                slot = self._free.pop(0)
                session.slot = slot
                session.admit_seq = self._admit_counter
                self._admit_counter += 1
                session.row_start = max(len(prompt), 1)
                if self.block_size is not None:
                    alloc = [self._free_blocks.pop(0) for _ in range(needed)]
                    self._slot_blocks[slot] = alloc
                    session.table_len = len(alloc)
                    blocks_row = np.full((self.max_blocks,), self._scratch_block, np.int32)
                    blocks_row[: len(alloc)] = alloc
                self._seed += 1
                _tev(
                    session, "engine.admission_start", slot=slot,
                    queue_wait_ms=round((time.monotonic() - session.created_at) * 1e3, 3),
                )
                self._admissions.append(_Admission(
                    session=session, prompt=prompt, slot=slot, seed=self._seed,
                    budget=session.max_new - session.produced, blocks_row=blocks_row,
                ))

    def _select_pending_locked(self) -> None:
        """Rotate the QoS-chosen waiting session to the head of ``_pending``
        (caller holds the lock), as the JAX engine does. FIFO fast path: with
        every live waiter at default tenant/priority nothing moves and the
        deficit map stays empty. With QoS traffic: strict priority tiers
        (high > normal > batch), and within the winning tier deficit round
        robin across tenants — each tenant's deficit accrues ``quantum x
        weight`` per round (quantum = the load normalizer, one widest bucket)
        and selection pays the head prompt's token cost. Zero-weight tenants
        are best-effort: they round only when no weighted tenant waits in the
        tier."""
        live = [(idx, s) for idx, (_, s) in enumerate(self._pending) if not s.finished]
        if not live or all(s.tenant is None and s.priority == PRIORITY_NORMAL for _, s in live):
            if self._drr_deficit:
                self._drr_deficit.clear()  # QoS traffic drained: drop tenant state
            return
        best_tier = min(s.priority for _, s in live)
        queues: "Dict[str, List[int]]" = {}
        for idx, s in live:
            if s.priority == best_tier:
                queues.setdefault(s.tenant or "", []).append(idx)
        for tenant in list(self._drr_deficit):
            if tenant not in queues:
                # deficits exist only for WAITING tenants (bounded by max_waiting)
                del self._drr_deficit[tenant]
        registry = self._registry()
        weights = {tenant: (registry.weight(tenant) if registry is not None else 1.0) for tenant in queues}
        candidates = [t for t in queues if weights[t] > 0] or list(queues)

        def head_cost(tenant: str) -> float:
            return float(max(len(self._pending[queues[tenant][0]][0]), 1))

        chosen: Optional[str] = None
        if len(candidates) == 1:
            chosen = candidates[0]
        elif self._drr_last in candidates and self._drr_deficit.get(self._drr_last, 0.0) >= head_cost(self._drr_last):
            # keep serving the pointer tenant while its banked deficit covers
            # the next head: throughput proportional to weight
            chosen = self._drr_last
            self._drr_deficit[chosen] -= head_cost(chosen)
        else:
            start = 0
            if self._drr_last in candidates:
                start = (candidates.index(self._drr_last) + 1) % len(candidates)
            order = candidates[start:] + candidates[:start]
            quantum = self._load_norm
            for _ in range(64):  # each full round accrues quantum x weight -> terminates
                for tenant in order:
                    deficit = self._drr_deficit.get(tenant, 0.0) + quantum * max(weights[tenant], 0.0)
                    if deficit >= head_cost(tenant):
                        self._drr_deficit[tenant] = deficit - head_cost(tenant)
                        chosen = tenant
                        break
                    self._drr_deficit[tenant] = deficit  # banked for the next round
                if chosen is not None:
                    break
                if all(weights[t] <= 0 for t in order):
                    break  # nothing accrues: degrade to plain round-robin
            if chosen is None:
                chosen = order[0]
        self._drr_last = chosen
        head = queues[chosen][0]
        if head != 0:
            self._pending.insert(0, self._pending.pop(head))

    def _preempt_for_priority_locked(self) -> bool:
        """With no free slot and a HIGH-priority prompt heading the queue,
        preempt exactly one lowest-priority resident (ties: youngest) through
        the paged preempt/resume path: the victim requeues at the head and
        later resumes token-identically. Paged mode only — dense sessions do
        not keep the prompt a resume needs. Returns True when a slot was
        freed (caller re-selects)."""
        if self.block_size is None or not self._pending:
            return False
        head = self._pending[0][1]
        if head.finished or head.priority != PRIORITY_HIGH:
            return False
        victims = [slot for slot, s in self._sessions.items() if s.priority > head.priority]
        if not victims:
            return False
        victim = max(victims, key=lambda slot: (self._sessions[slot].priority, self._sessions[slot].admit_seq))
        self.priority_preemptions += 1
        self._preempt_locked(victim, reason="priority")
        return True

    def tenant_census(self) -> "Dict[str, Dict[str, int]]":
        """Live per-tenant stream counts (resident + waiting, in-flight
        admissions included), scanned on demand; anonymous traffic is
        omitted."""
        census: "Dict[str, Dict[str, int]]" = {}

        def bump(tenant: Optional[str], kind: str) -> None:
            if tenant is None:
                return
            entry = census.setdefault(tenant, {"resident": 0, "waiting": 0})
            entry[kind] += 1

        with self._lock:
            for session in self._sessions.values():
                bump(session.tenant, "resident")
            for _, session in self._pending:
                if not session.finished:
                    bump(session.tenant, "waiting")
            for adm in self._admissions:
                if not adm.session.finished:
                    bump(adm.session.tenant, "waiting")
        return census

    def _set_dfa_state(self, adm: _Admission) -> None:
        """The admission's DFA state, a pure function of (grammar, emitted
        tokens): a fresh admission starts at the grammar's start state, a
        preemption resume walks the echo on the host, so the resumed row
        masks exactly where the evicted one stopped."""
        cs = self.gen._cs
        if cs is None:
            return
        state = int(cs.starts[adm.session.grammar])
        for t in adm.session.echo:
            state = int(cs.trans[state, t])
        adm.dfa_state = state

    def _admission_alive(self, adm: _Admission) -> bool:
        """Drop an admission whose consumer went away, or whose deadline passed,
        before its prefill ran: the slot and blocks come back at once."""
        with self._lock:
            session = adm.session
            if not session.finished and expired(session.deadline):
                session.finished = True
                self.shed_deadline += 1
                if self.timeseries is not None:
                    self.timeseries.sheds.add()
                self._tenant_shed(session.tenant)
                _tev(session, "engine.shed_deadline", phase="prefill")
                session.out.put(DeadlineExceeded("deadline exceeded mid-prefill; admission abandoned"))
            if adm.session.finished:
                if adm in self._admissions:
                    self._admissions.remove(adm)
                self._free.append(adm.slot)
                self._release_blocks_locked(adm.slot)
                return False
            return True

    def _abort_admission(self, adm: _Admission, exc: BaseException) -> None:
        """Fail one admission's stream without touching the engine."""
        with self._lock:
            if adm in self._admissions:
                self._admissions.remove(adm)
            self._free.append(adm.slot)
            self._release_blocks_locked(adm.slot)
            if not adm.session.finished:
                adm.session.finished = True
                adm.session.out.put(exc)

    def _finalize_admission(self, adm: _Admission) -> None:
        """Paste a completed admission's row into the pool and activate its
        session. A failure in the paste is engine-fatal: the pool may be
        half-written."""
        cfg = self.gen.config
        session, slot = adm.session, adm.slot
        lp0 = self._first_logprob(adm) if session.want_logprobs else None
        try:
            if self._carry is None:
                self._carry = self._init_carry()
            first = adm.tok0.cpu().numpy()
            hit_eos = cfg.eos_id is not None and int(first[0]) == cfg.eos_id
            # produced carries across preemptions; this residency adds one token
            start_done = hit_eos or session.produced + 1 >= session.max_new
            spec = self._spec is not None
            caches = self._carry[:2] if spec else self._carry[:1]
            rows = (adm.row_cache, adm.d_row_cache) if spec else (adm.row_cache,)
            tok, lengths, done = self._carry[len(caches): len(caches) + 3]
            with torch.no_grad():
                for cache, row_cache in zip(caches, rows):
                    if adm.blocks_row is not None:
                        self._paged_admit_impl(
                            cache, row_cache, tok, lengths, done, slot, adm.tok0, adm.row_len, adm.blocks_row
                        )
                    else:
                        self._admit_impl(cache, row_cache, tok, lengths, done, slot, adm.tok0, adm.row_len)
                if spec:
                    # the speculative activation: the slot's out_buf row reset
                    # (pad, then tok0), produced at 1 and the start-done flag
                    produced, out_buf = self._carry[5], self._carry[6]
                    out_buf[slot] = self.gen.config.pad_id
                    out_buf[slot, 0] = adm.tok0[0]
                    produced[slot] = 1
                    done[slot] = start_done
                if cstate := self._carry[10 if spec else 5:]:  # the DFA state tail
                    # advance past the (constrained) prompt-sampled token on the
                    # device: an indexed copy, no host round trip
                    trans = self.gen._cs_trans
                    cstate[0][slot : slot + 1].copy_(trans[adm.dfa_state][adm.tok0.long()])
            adm.row_cache = adm.d_row_cache = adm.last = None
        except BaseException as exc:
            with self._lock:
                if adm in self._admissions:
                    self._admissions.remove(adm)
                if not session.finished:
                    session.finished = True
                    session.out.put(exc)
            raise
        with self._lock:
            if adm in self._admissions:
                self._admissions.remove(adm)
            if session.finished:
                # cancelled during the unlocked prefill: mask the just
                # activated row back out and return the slot
                self._free.append(slot)
                self._release_blocks_locked(slot)
                self._mask_slot_done(slot)
                return
            if lp0 is not None:
                session.lp.append(lp0)  # before the token: k tokens => >= k logprobs
            session.out.put(first)
            now = time.monotonic()
            if session.produced == 0:  # a resume is a later residency, not a first token
                self._ttft.observe(now - session.created_at)
                if self.slo is not None:
                    self.slo.note_ttft(session.trace, (now - session.created_at) * 1e3)
                if self._tenant_slo is not None and session.tenant is not None:
                    self._tenant_slo.note_ttft(session.tenant, session.trace, now - session.created_at)
                _tev(session, "engine.first_token", ttft_ms=round((now - session.created_at) * 1e3, 3))
            _tev(session, "engine.emit", tokens=1, produced=session.produced + 1)
            if session.last_emit is not None:
                self._tbt.observe(now - session.last_emit)
                if self.slo is not None:
                    self.slo.note_tbt(session.trace, (now - session.last_emit) * 1e3)
                if self._tenant_slo is not None and session.tenant is not None:
                    self._tenant_slo.note_tbt(session.tenant, session.trace, now - session.last_emit)
            session.last_emit = now
            if self.timeseries is not None:
                self.timeseries.admissions.add()
                self.timeseries.tokens.add()
            if self._tenant_slo is not None and session.tenant is not None:
                self._tenant_slo.admitted(session.tenant)
                self._tenant_slo.tokens(session.tenant, 1)
            registry = self._registry()
            if registry is not None:
                registry.charge_tokens(session.tenant, 1)
            if self.block_size is not None:  # echo exists only for preemption resume
                session.echo.append(int(first[0]))
            session.resident_base = session.produced
            session.produced += 1
            self._sessions[slot] = session
            if start_done:
                # the plain decode only flags done on tokens IT samples, so the
                # prompt-sampled token's ending is masked here (speculative
                # mode flagged it on the device already)
                self._finish_locked(slot, device_done=self._spec is not None)

    def _finish_locked(self, slot: int, *, device_done: bool) -> None:
        session = self._sessions.pop(slot)
        session.finished = True
        _tev(session, "engine.finish", produced=session.produced)
        self._free.append(slot)
        self._release_blocks_locked(slot)
        if not device_done or self.block_size is not None:
            # paged mode masks unconditionally: the table repoint to scratch
            # must happen even when the device already flagged done
            self._mask_slot_done(slot)
        session.out.put(_SENTINEL)  # last: the engine state is consistent once the consumer wakes

    def _decode_chunk(self) -> None:
        with self._lock:
            self._ensure_capacity_locked()
            if not self._sessions:
                return  # growth preempted the last resident; re-admission next loop
        if self._spec is not None:
            return self._spec_chunk()
        cfg = self.gen.config
        toks, lps, carry = self.gen._decode(*self._carry, steps=self.decode_chunk)
        self._carry = carry
        toks_np = toks.cpu().numpy()  # [S, chunk]; also waits for the dispatch
        lps_np = lps.cpu().numpy()  # [S, chunk] f32: each sampled token's logprob
        done_np = carry[3].cpu().numpy()
        registry = self._registry()
        with self._lock:
            self.decode_dispatches += 1
            self.decoded_rows += len(self._sessions)
            now = time.monotonic()
            for slot in list(self._sessions):
                session = self._sessions[slot]
                row = toks_np[slot]
                take = min(self.decode_chunk, session.max_new - session.produced)
                if cfg.eos_id is not None:
                    hits = np.nonzero(row[:take] == cfg.eos_id)[0]
                    if hits.size:
                        take = min(take, int(hits[0]) + 1)  # emit the eos, stop after
                if take > 0:
                    if session.want_logprobs:
                        # BEFORE the tokens enqueue: a consumer holding k
                        # tokens must always find >= k logprobs on the stream
                        session.lp.extend(float(v) for v in lps_np[slot][:take])
                    session.out.put(row[:take].copy())
                    if registry is not None:
                        # post-charge the tenant's generated-tokens bucket
                        registry.charge_tokens(session.tenant, take)
                    if session.last_emit is not None:
                        self._tbt.observe(now - session.last_emit)
                        if self.slo is not None:
                            self.slo.note_tbt(session.trace, (now - session.last_emit) * 1e3)
                        if self._tenant_slo is not None and session.tenant is not None:
                            self._tenant_slo.note_tbt(session.tenant, session.trace, now - session.last_emit)
                    session.last_emit = now
                    if self.block_size is not None:
                        session.echo.extend(int(t) for t in row[:take])
                    session.produced += take
                    if self.timeseries is not None:
                        self.timeseries.tokens.add(take)
                    if self._tenant_slo is not None and session.tenant is not None:
                        self._tenant_slo.tokens(session.tenant, take)
                    _tev(session, "engine.emit", tokens=take, produced=session.produced)
                device_done = bool(done_np[slot])
                if session.produced >= session.max_new or device_done:
                    self._finish_locked(slot, device_done=device_done)

    def _spec_chunk(self) -> None:
        """Speculative shared dispatch: rounds (gamma draft steps, one verify
        forward, accept/reject) until every resident row has gained
        ``decode_chunk`` tokens or finished; concurrent streams share both
        the draft and the verify forwards."""
        spec = self._spec
        with self._lock:
            budget_np = np.zeros((self.slots,), np.int32)
            for slot, session in self._sessions.items():
                # the device counters are per RESIDENCY: a resumed session's
                # out_buf restarted at its re-admission
                budget_np[slot] = session.max_new - session.resident_base
        budget = torch.as_tensor(budget_np, device=self.device)
        floor = torch.minimum(self._carry[5] + self.decode_chunk, budget)
        state = spec._loop(self._carry, floor, budget)
        self._carry = state
        out_np = state[6].cpu().numpy()  # also waits for the dispatch
        prod_np = state[5].cpu().numpy()
        done_np = state[4].cpu().numpy()
        registry = self._registry()
        with self._lock:
            # fold the ride-along counters into the acceptance telemetry under
            # the lock, so stats() never sees rounds without their accepts
            self._spec_seen = spec._count(state[7], state[8], self._spec_seen)
            self.decode_dispatches += 1
            self.decoded_rows += len(self._sessions)
            now = time.monotonic()
            for slot in list(self._sessions):
                session = self._sessions[slot]
                new = out_np[slot, session.produced - session.resident_base: prod_np[slot]]
                if new.size:
                    session.out.put(new.copy())
                    if registry is not None:
                        registry.charge_tokens(session.tenant, int(new.size))
                    if session.last_emit is not None:
                        self._tbt.observe(now - session.last_emit)
                        if self.slo is not None:
                            self.slo.note_tbt(session.trace, (now - session.last_emit) * 1e3)
                        if self._tenant_slo is not None and session.tenant is not None:
                            self._tenant_slo.note_tbt(session.tenant, session.trace, now - session.last_emit)
                    session.last_emit = now
                    if self.block_size is not None:
                        session.echo.extend(int(t) for t in new)
                    session.produced = session.resident_base + int(prod_np[slot])
                    if self.timeseries is not None:
                        self.timeseries.tokens.add(int(new.size))
                    if self._tenant_slo is not None and session.tenant is not None:
                        self._tenant_slo.tokens(session.tenant, int(new.size))
                    _tev(session, "engine.emit", tokens=int(new.size), produced=session.produced)
                if bool(done_np[slot]):
                    self._finish_locked(slot, device_done=True)
