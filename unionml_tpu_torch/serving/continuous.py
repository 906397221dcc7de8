"""Continuous (in-flight) batching for generation serving.

Counterpart of ``unionml_tpu/serving/continuous.py``: dense slots or a paged
KV pool with a scratch block, lazy block growth and recompute preemption,
chunked admission, a static shared prefix, the radix prefix cache, the AOT
program store (``aot=``: the generator's programs captured as CUDA graphs,
their kernels from the store; serving/aot.py), and the engine half of the
replica layer (``role=``, the KV handoff pair, ``quiesce``; the fleet itself
is ``serving/replicas.py``).

- The engine owns ``slots`` cache rows (dense ``[S, cache_len, ...]`` per
  layer, or a shared pool of ``block_size`` blocks addressed through a block
  table) plus the decode carry (``tok/lengths/done`` per slot).
- **Join at prefill**: an arriving prompt prefills through the Generator at
  batch 1 into a fresh ``[1, cache_len]`` row, which is pasted (dense) or
  scattered through the slot's table (paged) between decode chunks. With
  ``admit_chunk`` the prefill runs ``admit_chunk`` columns at a time, at most
  ``prefill_budget`` columns between two decode dispatches, with up to
  ``max_admissions`` prompts in flight.
- **Shared prefixes**: ``prefix=`` (a ``PrefixCache``) is pasted into every
  row (its full blocks seeded once into the pool and shared by every table);
  ``prefix_cache=True`` publishes admitted prompts' full blocks into a radix
  tree (serving/prefix_cache.py), and a later prompt that extends a cached
  run gathers it from the pool and prefills only the rest.
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
- **Disaggregation**: ``submit(..., export_handoff=True)`` runs only the
  prefill, emits the first token and ends the stream with the prefilled KV
  (block-sized pages in paged mode, the dense row otherwise) on its
  ``handoff``; :meth:`ContinuousBatcher.import_handoff` on a sibling engine
  writes those pages into fresh blocks and decodes on from there, token for
  token what one engine would have produced.
- **Serving surface**: ``trace=`` records lifecycle events on the request
  trace each submit captures from its context (observability/trace.py);
  ``slo=`` keeps windowed telemetry and an SLO tracker (read from the
  ``UNIONML_TPU_SLO_*`` exports by default) behind ``health()`` and
  ``stats()``; ``tenancy=`` and ``submit(tenant=, priority=)`` shed a tenant
  over its rate with ``TenantThrottled``, admit waiting prompts deficit
  round robin across tenants within strict priority tiers, and let a
  high-priority admission on a full paged engine preempt the
  lowest-priority resident (serving/tenancy.py).

- **Over a mesh**: a Generator placed on a mesh with ``model``,
  ``sequence`` or ``expert`` axes is served by rank 0's engine, every other
  rank following its device steps, a speculative dispatch's rounds
  included (the design is in :mod:`unionml_tpu_torch.serving.mesh`).

With greedy decoding each stream's tokens equal a solo
``Generator.__call__([prompt], constraint=g)`` run. Thread model: ``submit`` may be called
from any thread; the engine thread is the only one touching device state,
and it does so only through the ``_op_*`` methods (:meth:`ContinuousBatcher._dev`).
Where JAX donates the pool through its jitted admission and decode, the port
updates the pool tensors in place.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from unionml_tpu_torch.defaults import (
    REPLICA_ROLES,
    SERVE_MAX_WAITING,
    serve_admit_chunk,
    serve_dp_replicas,
    serve_max_admissions,
    serve_prefill_budget,
    serve_prefix_cache,
    serve_replica_roles,
)
from unionml_tpu_torch.models.generate import (
    Generator,
    PrefixCache,
    _paste_prefix_rows,
    chunk_aligned,
    gather_paged_rows,
    init_cache,
    init_paged_cache,
)
from unionml_tpu_torch.models.speculative import seeded_streams
from unionml_tpu_torch.observability.slo import SLOConfig, SLOTracker, TenantSLORegistry
from unionml_tpu_torch.observability.timeseries import EngineTimeseries
from unionml_tpu_torch.observability.trace import current_trace
from unionml_tpu_torch.serving.aot import resolve_store
from unionml_tpu_torch.serving.mesh import HEARTBEAT_S, StepPlan
from unionml_tpu_torch.serving.metrics import LatencyWindow
from unionml_tpu_torch.serving.overload import DeadlineExceeded, QueueFullError, TenantThrottled, expired
from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache
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

_SENTINEL = object()

#: the engine's device operations that run collectives over a mesh (the
#: model's forwards and head): a step plan is sent before each of them
_COLLECTIVE_OPS = frozenset({"prefill_row", "row_chunk", "row_first", "first_logprob", "decode", "spec_rounds",
                             "export", "import_kv"})


#: the device carry's fields, in order: the plain decode carry, and under a
#: draft the speculative loop's state (models/speculative.py); a grammar's
#: DFA states ride as the tail of either (read them by name: ``_carried``)
_CARRY = ("cache", "tok", "lengths", "done", "generator")
_SPEC_CARRY = ("cache", "d_cache", "tok", "lengths", "done", "produced", "out_buf", "rounds", "accepted", "streams")


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
    #: leading block-table entries that are SHARED (the static prefix's
    #: pages, or radix-cached runs): read-only to this stream, so the
    #: admission scatter diverts their writes to scratch
    shared_blocks: int = 0
    #: block-table entries assigned (shared + private, in table order); lazy
    #: growth appends here. Ownership of an entry's block can move to the
    #: radix tree without changing the table, so this is the growth cursor
    table_len: int = 0
    #: radix-tree block ids this session holds pinned while its table reads
    #: them; released on finish/cancel/preempt
    pins: "List[int]" = dataclasses.field(default_factory=list)
    #: the block ids behind the first ``table_len`` table entries (paged
    #: mode), which the radix publish at finish reads
    table: "List[int]" = dataclasses.field(default_factory=list)
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
    #: an EXPORT session (``submit(export_handoff=True)``) runs its prefill
    #: here and never takes residency: at admission-complete the first token
    #: is emitted and the prefilled KV is packaged as ``handoff``
    export: bool = False
    #: the export payload, set just before the sentinel; the replica layer's
    #: relay reads it off the finished stream and imports it elsewhere
    handoff: "Optional[Dict[str, Any]]" = None
    #: an IMPORT session's inbound payload (a sibling's export): the
    #: admission runs no prefill, it writes the payload into fresh blocks
    pending_import: "Optional[Dict[str, Any]]" = None


@dataclasses.dataclass(eq=False)
class _Admission:
    """One in-flight admission: a slot-holding prompt whose prefill may be
    partly done. With ``admit_chunk`` set the engine steps it one chunk at
    a time between decode dispatches; otherwise (or for an exact-width
    resume whose aligned width would overflow the row) the whole prefill
    runs as one step."""

    session: _Session
    prompt: "List[int]"
    slot: int
    seed: int
    budget: int  # this request's remaining generation budget
    blocks_row: Optional[np.ndarray]  # paged-mode block table row (None = dense)
    # chunked-prefill progress (set by _admission_begin)
    chunk: int = 0  # 0 = monolithic (single-step) admission
    width: int = 0  # chunk-aligned prefill width
    pos: int = 0  # next column to prefill
    start: int = 0  # absolute offset of column 0 (the shared prefix length)
    tokens: Optional[np.ndarray] = None  # [1, width] padded prompt
    lengths: Any = None  # device [1] absolute sequence length
    generator: Any = None  # the first token's sampling stream
    row_valid: Any = None
    #: the request's DFA state at this admission (None = unconstrained
    #: generator): the grammar's start, walked through the echo on a resume
    dfa_state: Optional[int] = None
    row_cache: Any = None  # the target's [1, cache_len] row (filling up)
    #: last-real-token hidden row ``[1, dim]`` f32 (accumulated over chunks;
    #: also the first token's logprob input)
    last: Any = None
    d_row_cache: Any = None  # the draft model's row, chunked in lockstep
    # radix prefix cache: tokens of the logical sequence already cached (>
    # the prefix length on a hit) and the matched block ids, scratch-padded,
    # that the dense-row gather reads
    cached: int = 0
    gather_row: Optional[np.ndarray] = None
    #: an imported handoff's pages ``[H_kv, n_blocks, block_size, last]`` a
    #: layer, on this engine's device: finalize writes them whole-block
    import_pages: Optional[tuple] = None
    # completion products consumed by _finalize_admission
    tok0: Any = None
    row_len: Any = None
    done: bool = False


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

    @property
    def handoff(self) -> "Optional[Dict[str, Any]]":
        """The export payload of a ``submit(..., export_handoff=True)`` stream
        once it has finished (None while in flight, or when the stream ended
        at the prompt-sampled token, was shed or was cancelled)."""
        return self._session.handoff

    def __del__(self):  # pragma: no cover - refcount backstop
        try:
            self.close()
        except Exception:
            pass

def _kv_meta(kv: tuple) -> tuple:
    """The shapes and dtypes of a KV payload's buffers, layer by layer."""
    return tuple({name: (tuple(t.shape), t.dtype) for name, t in ((n, torch.as_tensor(b)) for n, b in layer.items())}
                 for layer in kv)


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _kv_nbytes(meta: tuple) -> int:
    return sum(_nbytes(shape, dtype) for layer in meta for shape, dtype in layer.values())


def _kv_bytes(kv: tuple) -> torch.Tensor:
    """A KV payload's host buffers as one byte buffer, in order."""
    return torch.cat([buf.contiguous().reshape(-1).view(torch.uint8) for layer in kv for buf in layer.values()])


def _kv_from_bytes(buf: torch.Tensor, meta: tuple) -> tuple:
    """The inverse of :func:`_kv_bytes` given the payload's ``meta``."""
    out, at = [], 0
    for layer in meta:
        row = {}
        for name, (shape, dtype) in layer.items():
            n = _nbytes(shape, dtype)
            row[name] = buf[at: at + n].clone().view(dtype).reshape(shape)
            at += n
        out.append(row)
    return tuple(out)


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
    ``admit_chunk`` enables stall-free admission: the prefill runs in
    ``admit_chunk``-token chunks interleaved with decode dispatches, at most
    ``prefill_budget`` prefill tokens an engine iteration (default one
    chunk), with up to ``max_admissions`` partly prefilled prompts in
    flight; each resolves as in the JAX engine (the kwarg, else the serve
    CLI's env export, else for the chunk ``GenerationConfig.prefill_chunk``).
    ``prefix`` (a ``PrefixCache`` from ``generator.cache_prefix``) is a
    server-wide prompt prefix: every submitted prompt is a suffix after it.
    ``prefix_cache=True`` (paged mode; default ``UNIONML_TPU_PREFIX_CACHE``)
    turns on the radix prefix cache: admitted prompts' full blocks are
    published into a radix tree, later prompts extending a cached run skip
    its prefill, cached blocks are pinned while a resident reads them,
    copied on write where a prompt diverges inside a shared block and
    evicted LRU under pool pressure; ``stats()["prefix_cache"]`` carries its
    counters.

    Where the serve CLI's ``UNIONML_TPU_DP_REPLICAS`` is above 1, or a
    ``roles=`` spec (else ``UNIONML_TPU_REPLICA_ROLES``) totals more than one
    replica, the constructor returns a
    :class:`~unionml_tpu_torch.serving.replicas.ReplicaSet` instead: that
    many engines behind one scheduler, with this surface. ``role``
    (``"prefill"``/``"decode"``/``"mixed"``) tags an engine of such a fleet
    and unlocks the KV handoff pair; ``None`` keeps ``stats()`` the role-less
    keys.
    """

    def __new__(cls, generator: Optional[Generator] = None, **engine_kwargs: Any):
        """Replica delegation, as in the JAX package: over a mesh with a
        batch axis above 1 (``data``/``fsdp``/``dcn_data``), with the serve
        CLI's ``--dp-replicas`` above 1 exported, or with a role spec (the
        ``roles=`` kwarg, else ``--replica-roles``'s export) of more than
        one replica, return a
        :class:`~unionml_tpu_torch.serving.replicas.ReplicaSet` of engines
        built with these knobs. Over a dp mesh the set is process-aware:
        each rank serves the replica whose submesh holds it."""
        if cls is ContinuousBatcher and generator is not None:
            mesh = generator.mesh
            dp = 1
            if mesh is not None:
                for axis in ("dcn_data", "data", "fsdp"):
                    dp *= int(mesh.shape.get(axis, 1))
            env = serve_dp_replicas()
            roles_kw = engine_kwargs.get("roles")
            if isinstance(roles_kw, dict):
                role_total = sum(roles_kw.values())
            elif isinstance(roles_kw, (list, tuple)):
                role_total = len(roles_kw)
            else:
                role_total = sum(serve_replica_roles().values())
            if dp > 1 or env > 1 or role_total > 1:
                from unionml_tpu_torch.serving.replicas import ReplicaSet

                return ReplicaSet.from_generator(generator, replicas=env or (role_total or None), **engine_kwargs)
        return super().__new__(cls)

    @classmethod
    def _single(cls, generator: Generator, **kwargs: Any) -> "ContinuousBatcher":
        """One plain engine, bypassing the replica delegation of
        :meth:`__new__`: the replica layer builds its engines through this."""
        self = object.__new__(cls)
        self.__init__(generator, **kwargs)
        return self

    def __init__(
        self,
        generator: Generator,
        *,
        slots: int = 4,
        decode_chunk: int = 8,
        prefix: Optional[PrefixCache] = None,
        block_size: Optional[int] = None,
        pool_blocks: Optional[int] = None,
        max_waiting: Optional[int] = None,
        admit_chunk: Optional[int] = None,
        prefill_budget: Optional[int] = None,
        max_admissions: Optional[int] = None,
        trace: Optional[bool] = None,
        prefix_cache: Optional[bool] = None,
        slo: Optional[Any] = None,
        role: Optional[str] = None,
        tenancy: Optional[Any] = None,
        aot: Optional[Any] = None,
    ):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if role is not None and role not in REPLICA_ROLES:
            raise ValueError(f"role must be one of 'prefill'/'decode'/'mixed' (or None), got {role!r}")
        if decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        if block_size is not None and block_size < 1:
            raise ValueError("block_size must be >= 1")
        if max_waiting is not None and max_waiting < 1:
            raise ValueError("max_waiting must be >= 1")
        if admit_chunk is not None and admit_chunk < 0:
            raise ValueError("admit_chunk must be >= 0 (0 = monolithic admission)")
        if prefill_budget is not None and prefill_budget < 0:
            raise ValueError("prefill_budget must be >= 0 (0 = one chunk per iteration)")
        if max_admissions is not None and max_admissions < 0:
            raise ValueError("max_admissions must be >= 0 (0 = default of 1)")
        cfg = generator.config
        mesh = generator.mesh
        if mesh is not None:
            # a batch-1 admission row cannot split a batch axis: normal
            # construction delegates such meshes to the replica layer in
            # __new__; this backstop catches an engine built directly over one
            for axis in ("dcn_data", "data", "fsdp"):
                if mesh.shape[axis] > 1:
                    raise ValueError(
                        f"a single continuous engine shards over model/TP axes only; mesh has {axis}="
                        f"{mesh.shape[axis]} (batch-1 admission prefills cannot split a "
                        "batch axis) — serve a dp mesh through serving.ReplicaSet"
                    )
        self.gen = generator
        self.device = generator.device
        self.max_waiting = SERVE_MAX_WAITING if max_waiting is None else max_waiting
        #: request-timeline annotation: lifecycle events land on the trace each
        #: submit() captured from its context; the HTTP layer's tracing switch
        #: decides whether a trace EXISTS, False opts this engine out
        self.trace_requests = True if trace is None else bool(trace)
        #: stall-free admission: the kwarg, else the serve CLI's export, else
        #: the model's own prefill_chunk; 0/None = monolithic admission
        if admit_chunk is None:
            admit_chunk = serve_admit_chunk() or (cfg.prefill_chunk or 0)
        self.admit_chunk: Optional[int] = int(admit_chunk) or None
        #: prefill tokens an engine iteration between decode dispatches
        if prefill_budget is None:
            prefill_budget = serve_prefill_budget()
        self.prefill_budget: Optional[int] = int(prefill_budget) or self.admit_chunk or None
        #: partly prefilled admissions in flight (chunked mode only)
        if max_admissions is None:
            max_admissions = serve_max_admissions()
        self.max_admissions = max(int(max_admissions), 1) if max_admissions else 1
        self.slots = slots
        self.decode_chunk = decode_chunk
        #: speculative mode: with ``config.draft`` set, resident rows advance
        #: by draft-and-verify ROUNDS (the SpeculativeGenerator's loop with
        #: per-row floors and budgets), so concurrent streams share the draft
        #: and verify dispatches and each greedy stream still equals its solo
        #: target-only run
        self._spec = generator._speculative() if cfg.draft is not None else None
        #: the AOT program store (serving/aot.py): a ProgramStore or directory
        #: pins it, None reads the serve CLI's UNIONML_TPU_AOT_PRELOAD
        #: export, False turns it off. Armed, the generator's (and the
        #: draft's) prefill, chunk, first-token and decode programs are
        #: captured as CUDA graphs per signature, their kernels installed from
        #: the store where it holds them; the admission scatters and the
        #: radix gather stay plain calls (they upload host block rows and
        #: launch no hand-written kernel, so a store has nothing to hold for
        #: them); off (the default) keeps the engine, stats() included, as it
        #: is without one. Over a mesh every rank arms its own generator:
        #: each program is captured in segments between its collectives
        self._aot = resolve_store(aot)
        if self._aot is not None:
            generator.enable_aot(self._aot)
            # the generator may already carry a store (an earlier engine, an
            # explicit enable_aot): report the one its programs go through
            self._aot = generator._aot_store
            if self._spec is not None:
                # the draft's programs load from the same store, under its own context
                self._spec._draft.enable_aot(self._aot)
        #: the disaggregated-serving role (None = a role-less engine, whose
        #: stats() keep the role-less keys)
        self.role = role
        if role == "prefill" and self._spec is not None:
            raise ValueError(
                "a prefill-role engine does not compose with speculative decoding "
                "(config.draft) yet: the draft's row cannot ride the KV handoff"
            )
        if prefix is not None and not isinstance(prefix, PrefixCache):
            raise TypeError(f"prefix must be a PrefixCache (from generator.cache_prefix), got {type(prefix).__name__}")
        #: the draft needs the system prompt in ITS cache too, prefilled once
        #: here from the prefix's token ids
        self._draft_prefix = self._spec.draft_prefix(prefix) if self._spec is not None and prefix is not None else None
        self.prefix = prefix
        #: the static prefix's length: where each prompt's own tokens start
        self._p0 = p0 = prefix.length if prefix is not None else 0
        #: room for the prefix, every bucketed prompt, the full budget and the
        #: overshoot: one chunk of decode, or one round's gamma + 1 verify
        #: writes in speculative mode (which never runs the plain decode)
        self._overshoot = self._spec.gamma + 1 if self._spec is not None else decode_chunk
        widest = max(cfg.prompt_buckets, default=64)
        buckets = cfg.prompt_buckets or (widest,)
        self.cache_len = p0 + widest + cfg.max_new_tokens + self._overshoot
        #: sp admission (sp_prefill over a >1 sequence axis, no shared
        #: prefix: Generator._start's rule): the row prefills sequence-
        #: parallel, each bucket padded to a multiple of the axis
        self._sp_seq = mesh.shape["sequence"] if mesh is not None else 1
        self._sp = bool(cfg.sp_prefill) and self._sp_seq > 1 and prefix is None
        if self._sp:
            self.cache_len = max(self.cache_len, max(chunk_aligned(b, self._sp_seq) for b in buckets))
        # each aligned prefill writes its whole chunk-aligned width at [p0,
        # p0 + aligned): the rows must hold the widest aligned bucket
        if prefix is not None and cfg.prefill_chunk:
            self.cache_len = max(self.cache_len, p0 + max(chunk_aligned(b, cfg.prefill_chunk) for b in buckets))
        if self.admit_chunk:
            self.cache_len = max(self.cache_len, p0 + max(chunk_aligned(b, self.admit_chunk) for b in buckets))
        #: the radix prefix cache: the kwarg, else UNIONML_TPU_PREFIX_CACHE;
        #: paged mode only (the env default warns on a dense engine, where an
        #: explicit True is a usage error)
        if prefix_cache is None:
            enable_radix = serve_prefix_cache()
            if enable_radix and block_size is None:
                # as in JAX: a fleet-wide export must not crash dense engines
                logger.warning(
                    "UNIONML_TPU_PREFIX_CACHE is set but this engine is not paged (block_size=None); prefix "
                    "caching disabled"
                )
                enable_radix = False
        else:
            enable_radix = bool(prefix_cache)
            if enable_radix and block_size is None:
                raise ValueError("prefix_cache=True requires paged KV (block_size=...)")
        if enable_radix:
            if cfg.draft is not None:
                raise ValueError("prefix_cache does not compose with speculative decoding (config.draft) yet")
            if prefix is not None and prefix.tokens is None:
                raise ValueError(
                    "prefix_cache with a shared prefix needs its token ids (build the PrefixCache with "
                    "generator.cache_prefix) so the prefix joins the radix key"
                )
            #: cache hits always prefill chunked, from an arbitrary start;
            #: block_size is the last fallback for engines without chunking
            self._radix_chunk = self.admit_chunk or (cfg.prefill_chunk or 0) or block_size
            # a hit's suffix is chunk-aligned from a non-aligned start, which
            # can reach one chunk past the cold path's widest aligned write
            aligned = max(chunk_aligned(b, self._radix_chunk) for b in buckets)
            self.cache_len = max(self.cache_len, p0 + aligned + self._radix_chunk)
        else:
            self._radix_chunk = 0
        self.block_size = block_size
        #: the static prefix's FULL blocks: written once into the pool, every
        #: slot's table points at them, nothing writes them again
        self._shared_prefix_blocks: "List[int]" = []
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
            mcfg = generator.cache_config  # this rank's KV heads on a mesh
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
            if prefix is not None:
                # (pool >= max_blocks covers shared + one worst-case private run)
                self._shared_prefix_blocks = [self._free_blocks.pop(0) for _ in range(prefix.length // block_size)]
        elif pool_blocks is not None:
            raise ValueError("pool_blocks requires block_size (paged mode)")
        #: the radix tree over paged blocks (None = prefix caching off); the
        #: static prefix's full blocks are its permanently pinned root run
        self._radix: Optional[RadixPrefixCache] = None
        if enable_radix:
            self._radix = RadixPrefixCache(block_size)
            self._insert_static_run_locked()
            self._radix.pin(self._shared_prefix_blocks)
        self._lock = threading.Condition()
        self._pending: "List[tuple]" = []  # (prompt, session) awaiting a free slot
        self._admissions: "List[_Admission]" = []
        self._sessions: Dict[int, _Session] = {}
        self._free = list(range(slots))
        self._cancelled: "List[_Session]" = []
        self._closed = False
        #: a quiesced engine (a fleet's scale-down) sheds NEW submits with
        #: QueueFullError, which the replica scheduler walks past, and drains
        #: what it holds
        self._quiesced = False
        self._carry: Optional[tuple] = None  # (cache, tok, lengths, done, generator)
        self._seed = 0
        self._thread: Optional[threading.Thread] = None
        self._admit_counter = 0
        #: dispatch/utilization counters for benchmarks and /metrics
        self.decode_dispatches = 0
        self.decoded_rows = 0
        self.preemptions = 0
        #: stall-free-admission telemetry: chunked prefill steps, the tokens
        #: they ran, and admissions that ran as one prefill
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.prefill_monolithic = 0
        #: prefix-cache telemetry (absent from stats() when the cache is
        #: off): admissions served partly from cache or not, prompt tokens
        #: whose prefill was skipped, partly shared tail blocks copied on write
        self.prefix_cache_hits = 0
        self.prefix_cache_misses = 0
        self.prefix_cache_tokens_avoided = 0
        self.prefix_cache_cow = 0
        #: disaggregated-serving telemetry: rows exported to a sibling, rows
        #: imported from one, and the export -> import latency
        self.handoffs_exported = 0
        self.handoffs_imported = 0
        self._handoff_ms = LatencyWindow()
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
        #: token-weighted load normalizer: one admit chunk (or one widest
        #: bucket) of queued prefill counts as one unit of scheduling load
        #: (the DRR quantum too)
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
        #: over a mesh of several ranks: rank 0's record of the device steps
        #: (or a follower's end of it), and a follower's admission rows by key
        self._plan: Optional[StepPlan] = None
        self._follower = False
        #: whether this rank's pools hold a share of the KV heads (a mesh's
        #: model axis splits them): a handoff gathers and scatters them
        self._kv_split = mesh is not None and generator.cache_config.n_kv_heads < generator.model.config.n_kv_heads
        self._rows: Dict[int, _Admission] = {}
        #: what ended a follower's loop early (``close`` raises it)
        self._follower_error: Optional[BaseException] = None
        if mesh is not None and mesh.devices > 1:
            self._plan = StepPlan(mesh)
            self._follower = mesh.rank != self._plan.leader
            # rank 0's engine thread runs from the start: it sends the idle
            # heartbeat the followers' wait needs
            self._thread = threading.Thread(target=self._follow if self._follower else self._engine_loop,
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ device steps

    def _dev(self, op: str, adm: Optional[_Admission], *args: Any) -> Any:
        """Run the device operation ``_op_<op>`` on ``adm``'s rows (None for
        the pool and carry) with host ``args``. Over a mesh rank 0 records it
        in the step plan first (see :mod:`unionml_tpu_torch.serving.mesh`);
        followers run the same operation from :meth:`_follow`."""
        if self._plan is not None:
            self._plan.record(op, None if adm is None else adm.seed, args, op in _COLLECTIVE_OPS)
        return getattr(self, "_op_" + op)(adm, *args)

    def _stop_followers(self) -> None:
        """Send the plan that ends the followers' loops (rank 0 of a mesh)."""
        if self._plan is not None:
            self._plan.record("stop", None, (), True)

    def _follow(self) -> None:
        """A follower rank's engine thread: run each received plan's
        operations in order on this rank's shards until rank 0 stops.

        A ``ValueError`` from an admission's operation is the refusal of a
        bad request, which rank 0 meets on the same arguments before any
        collective: it is let pass only when rank 0's next operation drops
        that admission's rows. Any other failure, that one included when
        rank 0 went on, ends the follower: it is logged, kept for
        :meth:`close` to raise, and rank 0 then waits in its next
        collective."""
        refused: Optional[Tuple[int, ValueError]] = None
        try:
            while True:
                for op, key, args in self._plan.receive():
                    if refused is not None and (op, key) != ("drop_row", refused[0]):
                        raise RuntimeError(
                            f"follower rank {self.gen.mesh.rank} alone refused an operation of admission "
                            f"{refused[0]}: rank 0 went on with {op!r}"
                        ) from refused[1]
                    refused = None
                    if op == "stop":
                        return
                    if op == "noop":
                        continue
                    adm = None
                    if key is not None:
                        adm = self._rows.get(key)
                        if adm is None:
                            adm = self._rows[key] = _Admission(
                                session=None, prompt=[], slot=-1, seed=key, budget=0, blocks_row=None)
                    try:
                        getattr(self, "_op_" + op)(adm, *args)
                    except ValueError as exc:
                        if key is None:
                            raise
                        refused = (key, exc)
                    if op in ("finalize", "drop_row", "export"):
                        self._rows.pop(key, None)
        except Exception as exc:  # a follower that fails leaves rank 0 waiting: say why before the thread ends
            logger.exception("continuous-batching follower failed")
            self._follower_error = exc
            raise

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
    def _paged_admit_impl(cache, row_cache, tok, lengths, done, slot, row_tok, row_len, blocks_row,
                          skip: int = 0) -> None:
        """Point slot ``slot``'s table row at ``blocks_row`` and scatter the
        dense ``[1, cache_len]`` row into those blocks, in place.
        ``blocks_row`` is scratch-padded past the allocation, so the row's
        unused tail lands in the scratch block, never in another request's
        pages; those colliding writes leave scratch holding arbitrary rows,
        which nothing reads as live data. The first ``skip`` blocks' writes
        go to scratch too: those entries are SHARED pages (the static
        prefix's, or radix-cached runs) that already hold exactly these rows
        and other rows read."""
        table = cache[0]["table"]  # one table tensor shared by every layer
        block_size = cache[0]["k"].shape[2]  # pools are heads-major [H_kv, NB, bs, last]
        scratch = cache[0]["k"].shape[1] - 1  # scratch is the last pool block
        blocks = torch.as_tensor(blocks_row, dtype=torch.int32, device=table.device)
        pos = torch.arange(row_cache[0]["k"].shape[1], device=table.device)
        blk, off = blocks[pos // block_size].long(), pos % block_size
        if skip:
            blk = torch.where(pos < skip * block_size, scratch, blk)
        table[slot] = blocks
        for layer, row in zip(cache, row_cache):
            for name in row:
                layer[name][:, blk, off] = row[name][0].transpose(0, 1).to(layer[name].dtype)
        tok[slot] = row_tok[0]
        lengths[slot] = row_len[0]
        done[slot] = False

    @staticmethod
    def _export_pages_impl(row_cache, n_blocks: int, block_size: int) -> tuple:
        """The first ``n_blocks`` block-sized pages of a prefilled dense
        ``[1, cache_len, H_kv, last]`` row in pool layout, ``[H_kv,
        n_blocks, block_size, last]`` a leaf: the block-native handoff
        payload, holding what the admission scatter would have written into
        those blocks. Each page is a fresh copy, never a view: nothing the
        exporting engine writes later can reach a payload in flight."""
        width = n_blocks * block_size
        return tuple(
            {
                name: buf[0, :width].transpose(0, 1).reshape(buf.shape[2], n_blocks, block_size, buf.shape[3])
                .clone(memory_format=torch.contiguous_format)
                for name, buf in layer.items()
            }
            for layer in row_cache
        )

    @staticmethod
    def _paged_page_admit_impl(cache, pages, tok, lengths, done, slot, row_tok, row_len, blocks_row,
                               skip: int = 0) -> None:
        """Block-native import, in place: point slot ``slot``'s table row at
        ``blocks_row`` and write the payload's pages whole-block into its
        first ``n_blocks`` entries. The first ``skip`` pages go to scratch:
        those entries are SHARED (the static prefix's pages), already holding
        exactly that content, as in :meth:`_paged_admit_impl`."""
        table = cache[0]["table"]
        scratch = cache[0]["k"].shape[1] - 1  # scratch is the last pool block
        n_blocks = pages[0]["k"].shape[1]
        blocks = torch.as_tensor(blocks_row, dtype=torch.int32, device=table.device)
        ids = blocks[:n_blocks].long()
        if skip:
            ids = torch.where(torch.arange(n_blocks, device=table.device) < skip, scratch, ids)
        table[slot] = blocks
        for layer, page in zip(cache, pages):
            for name in page:
                layer[name][:, ids] = page[name].to(layer[name].dtype)
        tok[slot] = row_tok[0]
        lengths[slot] = row_len[0]
        done[slot] = False

    def _seed_shared_prefix(self, cache: tuple, prefix_layers: tuple) -> None:
        """Write the prefix's FULL blocks into a pool once, in place; every
        admission's table then points at these ids and nothing writes them
        again (decode writes start at ``lengths >= p0``)."""
        ids = torch.as_tensor(self._shared_prefix_blocks, dtype=torch.long, device=self.device)
        width = len(self._shared_prefix_blocks) * self.block_size
        pos = torch.arange(width, device=self.device)
        blk, off = ids[pos // self.block_size], pos % self.block_size
        with torch.no_grad():
            for layer, pre in zip(cache, prefix_layers):
                for name, rows in pre.items():  # pools heads-major; prefix rows [1, p0, H, last]
                    layer[name][:, blk, off] = rows[0, :width].transpose(0, 1).to(layer[name].dtype)

    def _init_pool(self, model_config: Any, prefix: Optional[PrefixCache] = None) -> tuple:
        """A zeroed KV cache of the engine's geometry for one model: the
        dense ``[slots, cache_len]`` rows or the paged pool (``pool_blocks +
        1`` blocks: the extra one is scratch; the table starts all-scratch so
        never-admitted slots' ride-along writes are harmless), with
        ``prefix``'s full blocks seeded into the pool."""
        kv_dtype = self.gen.config.kv_cache_dtype
        if self.block_size is not None:
            cache = init_paged_cache(
                model_config, self.slots, self.pool_blocks + 1, self.block_size, self.max_blocks,
                kv_dtype=kv_dtype, fill_block=self._scratch_block, device=self.device,
            )
            if self._shared_prefix_blocks:
                self._seed_shared_prefix(cache, prefix.layers)
            return cache
        return init_cache(model_config, self.slots, self.cache_len, kv_dtype=kv_dtype, device=self.device)

    def _init_carry(self) -> tuple:
        cfg = self.gen.config
        cache = self._init_pool(self.gen.cache_config, self.prefix)
        tok = torch.zeros((self.slots,), dtype=torch.int32, device=self.device)
        lengths = torch.ones((self.slots,), dtype=torch.int32, device=self.device)
        done = torch.ones((self.slots,), dtype=torch.bool, device=self.device)  # every slot starts free
        # constrained generators carry each slot's DFA state as the tail; free
        # slots ride the FREE grammar's state 0
        tail = (torch.zeros((self.slots,), dtype=torch.int32, device=self.device),) if self.gen._cs is not None else ()
        if self._spec is None:
            generator = torch.Generator(device=self.device).manual_seed(self._seed)
            return (cache, tok, lengths, done, generator, *tail)
        d_cache = self._init_pool(self._spec._draft.cache_config, self._draft_prefix)
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
                     dfa_state: Optional[int] = None, gen: Optional[Generator] = None,
                     prefix: Optional[PrefixCache] = None):
        """Prefill one prompt at batch 1 into a fresh ``[1, cache_len]`` cache
        with the Generator's own prefill, the first token masked by
        ``dfa_state`` when given. With a shared prefix its rows are pasted
        at ``[0, p0)`` and the prompt (a suffix) flows through the offset
        chunked prefill, as ``Generator.__call__(..., prefix=...)`` does.
        Returns ``(tok0, lengths, row_cache, last)`` (``last``: the
        last-token hidden row, f32). ``budget`` is THIS request's remaining
        token budget; ``gen``/``prefix`` override the model and its prefix
        rows (speculative mode prefills the draft's row too)."""
        if gen is None:
            gen, prefix = self.gen, self.prefix
        cfg = gen.config
        if budget is None:
            budget = cfg.max_new_tokens
        p0 = self._p0  # the draft's prefix has the same length
        bucket = self._prefill_width(prompt, budget)
        tokens = np.full((1, bucket), cfg.pad_id, np.int32)
        tokens[0, : len(prompt)] = np.asarray(prompt, np.int32)
        lengths = torch.tensor([p0 + max(len(prompt), 1)], dtype=torch.int32, device=self.device)
        row_cache = init_cache(gen.cache_config, 1, self.cache_len, kv_dtype=cfg.kv_cache_dtype, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        row_valid = torch.ones((1,), dtype=torch.bool, device=self.device)
        state = None if dfa_state is None else torch.tensor([dfa_state], dtype=torch.int32, device=self.device)
        if prefix is not None:
            chunk = cfg.prefill_chunk or bucket
            aligned = chunk_aligned(bucket, chunk)
            if p0 + aligned > self.cache_len:  # the constructor sizes for every bucket; this guards others
                raise ValueError(
                    f"chunk-aligned prefill width {aligned} + prefix {p0} exceeds cache_len {self.cache_len}"
                )
            if aligned > bucket:
                tokens = np.pad(tokens, ((0, 0), (0, aligned - bucket)), constant_values=cfg.pad_id)
            row_cache = _paste_prefix_rows(row_cache, prefix.layers)
            last, row_cache = gen._chunked_prefill_loop(tokens, lengths, row_cache, row_valid, chunk, start=p0)
            tok0 = gen._first_token(last, generator, state)
        elif self._sp and chunk_aligned(bucket, self._sp_seq) <= self.cache_len:
            # long-context admission: the row prefills sequence-parallel over
            # the mesh's sequence axis, then pastes like any dense row (an
            # exact-width resume too wide to align falls through below:
            # both prefills give the same tokens); a draft's row too, as the
            # draft Generator shares the mesh and sp_prefill
            aligned = chunk_aligned(bucket, self._sp_seq)
            tokens = np.pad(tokens, ((0, 0), (0, aligned - bucket)), constant_values=cfg.pad_id)
            tok0, row_cache, last = gen._sp_prefill(
                torch.as_tensor(tokens, device=self.device), lengths, row_cache, generator, row_valid, state
            )
        else:
            tok0, row_cache, last = gen._prefill(
                torch.as_tensor(tokens, device=self.device), lengths, row_cache, generator, row_valid, state
            )
        return tok0, lengths, row_cache, last

    def _prefill_width(self, prompt: Sequence[int], budget: int) -> int:
        """The prefill's padded width: the prompt's bucket, or its exact
        length where a PREEMPTED request resumed as prompt + emitted tokens
        outgrows every bucket while still fitting the cache contiguously."""
        p0 = self._p0
        bucket = self.gen._bucket(max(len(prompt), 1))
        if p0 + bucket + budget > self.cache_len:
            exact = max(len(prompt), 1)
            if p0 + exact + budget > self.cache_len:
                raise ValueError(
                    f"prompt of length {len(prompt)} needs prefix {p0} + bucket {bucket} + {budget} new tokens "
                    f"> cache_len {self.cache_len}"
                )
            bucket = exact
        return bucket

    def _op_first_logprob(self, adm: _Admission, dfa_state: Optional[int]) -> float:
        """The prompt-sampled token's log-probability: head, mask and
        log-softmax over the admission's last hidden row — the constrained
        distribution the token was sampled from, as the decode steps'
        logprobs are."""
        gen = self.gen
        state = None if dfa_state is None else torch.tensor([dfa_state], dtype=torch.int32, device=self.device)
        with torch.no_grad():
            logits = gen._constrain(gen._head(adm.last.to(gen.model.config.dtype)), state)
            lp = torch.log_softmax(logits, dim=-1).gather(1, adm.tok0[:, None].long())
        return float(lp[0, 0])

    # ------------------------------------------------------------------ block allocator

    def _table_entries(self, tokens: int) -> int:
        """Block-table entries covering positions ``[0, tokens)``."""
        return -(-tokens // self.block_size)

    def _blocks_for_tokens(self, tokens: int, shared: Optional[int] = None) -> int:
        """Private (non-shared) blocks covering positions ``[0, tokens)``.
        The prefill scatter also writes the bucket's pad columns, but those
        are hidden by the ``slot <= position`` mask until decode overwrites
        them in order, so they may land in the scratch block. The ``shared``
        leading entries (default: the static prefix's pages) are excluded."""
        if shared is None:
            shared = len(self._shared_prefix_blocks)
        return max(0, self._table_entries(tokens) - shared)

    def _blocks_initial(self, prompt: Sequence[int], budget: int, shared: Optional[int] = None) -> int:
        """Blocks an ADMISSION needs: prefix + prompt + one chunk of
        lookahead, capped at the request's remaining budget, the target the
        first growth pass demands, so a fresh admission is never
        admit-then-instantly-preempted."""
        p0 = self._p0
        plen = max(len(prompt), 1)
        tokens = min(p0 + plen + self.decode_chunk + self._overshoot, p0 + plen + budget - 1 + self._overshoot)
        return self._blocks_for_tokens(tokens, shared)

    def _blocks_lifetime(self, prompt: Sequence[int], budget: int) -> int:
        """Worst-case private blocks over a request's whole life."""
        return self._blocks_for_tokens(self._p0 + max(len(prompt), 1) + budget + self._overshoot)

    def _release_blocks_locked(self, slot: int, session: Optional[_Session] = None) -> None:
        """Return a slot's PRIVATE pool blocks to the allocator and release
        the session's radix pins (caller holds the lock). Tree-owned blocks
        the session's table read stay cached, evictable again."""
        if self.block_size is not None:
            self._free_blocks.extend(self._slot_blocks.pop(slot, []))
        if session is not None and session.pins:
            self._radix.release(session.pins)
            session.pins = []

    def _reclaim_blocks_locked(self, n: int) -> None:
        """Evict least-recently-used unpinned radix runs until ``n`` more
        blocks are free (or nothing evictable remains), so cache pressure
        resolves before admission waits and before preemption fires (caller
        holds the lock)."""
        if self._radix is None or n <= 0:
            return
        self._free_blocks.extend(self._radix.evict(n))

    def _insert_static_run_locked(self) -> None:
        """Insert the static prefix's full blocks as the tree's root run
        (matches walk through it; the first admission caches its partial
        tail block on top). The constructor pins them for good."""
        if self._shared_prefix_blocks:
            ids = list(self._shared_prefix_blocks)
            self._radix.insert(list(self.prefix.tokens)[: len(ids) * self.block_size], ids)

    def _radix_insert_locked(self, adm: _Admission, session: _Session) -> None:
        """Publish a completed admission's full-token blocks into the radix
        tree (caller holds the lock). Only blocks every position of which
        holds a REAL token's K/V are insertable; the partial tail block stays
        private. The transferred blocks' ownership moves to the tree and the
        session keeps them pinned (its table still reads them) until
        release."""
        full = (self._p0 + max(len(adm.prompt), 1)) // self.block_size  # entries fully covered by real tokens
        shared = session.shared_blocks
        if full <= shared:
            return
        key = self._radix_key(adm.prompt)[: full * self.block_size]
        kept = self._radix.insert(key, [int(b) for b in adm.blocks_row[:full]])
        # a concurrent admission may have inserted a longer run first (kept >
        # shared): entries [shared, kept) keep their private duplicates
        lo, hi = max(kept, shared) - shared, full - shared
        if lo >= hi:
            return
        alloc = self._slot_blocks.get(adm.slot, [])
        transferred = alloc[lo:hi]
        self._slot_blocks[adm.slot] = alloc[:lo] + alloc[hi:]
        self._radix.pin(transferred)
        session.pins.extend(transferred)

    def _radix_publish_finished_locked(self, slot: int, session: _Session) -> None:
        """Publish a FINISHED stream's prompt + generated tokens into the
        radix tree (caller holds the lock): block-aligned only, and one token
        short of the emissions (the last sampled token was never fed back,
        so its K/V was never written). Leading blocks already in the tree are
        kept; the generated tail's blocks leave the slot's allocation
        unpinned, cached and evictable like any idle prefix."""
        if not session.table or not session.prompt:
            return
        full = (self._p0 + len(session.prompt) + len(session.echo) - 1) // self.block_size
        if full <= 0 or full > len(session.table):
            return
        key = self._radix_key(list(session.prompt) + list(session.echo))[: full * self.block_size]
        entries = [int(b) for b in session.table[:full]]
        kept = self._radix.insert(key, entries)
        alloc = self._slot_blocks.get(slot)
        if alloc is None:
            return
        for b in entries[kept:full]:
            # blocks the session never owned privately are covered by kept
            if b in alloc:
                alloc.remove(b)

    def _radix_reset_locked(self) -> None:
        """Drop every cached run and zero the cache counters (caller holds
        the lock; no stream may be live): warmup's probes must not leave
        junk prefixes cached. The static prefix's blocks are re-seeded as
        the root run."""
        static = set(self._shared_prefix_blocks)
        self._free_blocks.extend(b for b in self._radix.clear() if b not in static)
        self._radix.evictions = 0
        self._radix.evicted_blocks = 0
        self._insert_static_run_locked()  # clear() keeps the pins
        self.prefix_cache_hits = 0
        self.prefix_cache_misses = 0
        self.prefix_cache_tokens_avoided = 0
        self.prefix_cache_cow = 0

    def _radix_key(self, prompt: Sequence[int]) -> "List[int]":
        """The radix key of a prompt: the full LOGICAL token sequence, the
        static prefix's tokens followed by the prompt's."""
        key = list(self.prefix.tokens) if self.prefix is not None else []
        key.extend(int(t) for t in prompt)
        return key

    def cached_prefix_tokens(self, prompt: Sequence[int]) -> int:
        """Prompt tokens this engine could serve from its radix cache right
        now beyond the static prefix (0 when prefix caching is off)."""
        if self._radix is None:
            return 0
        p0 = self._p0
        total = p0 + max(len(prompt), 1)
        with self._lock:
            m = self._radix.match_len(self._radix_key(prompt))
        return max(0, min(m, total - 1) - p0)

    def _extend_tables(self, slot: int, start_idx: int, ids: "List[int]") -> None:
        """Append freshly allocated block ids to a resident slot's table row
        (engine thread only)."""
        if not ids or self._carry is None:
            return
        self._dev("extend_tables", None, slot, start_idx, list(ids))

    def _carried(self, name: str, state: Optional[tuple] = None) -> Any:
        """A field of the device carry by name (``_CARRY``/``_SPEC_CARRY``),
        or of ``state``, a carry the speculative loop returned; ``"tail"``
        is the tuple of DFA states, empty without a grammar."""
        fields = _CARRY if self._spec is None else _SPEC_CARRY
        state = self._carry if state is None else state
        return state[len(fields):] if name == "tail" else state[fields.index(name)]

    def _op_extend_tables(self, _: None, slot: int, start_idx: int, ids: "List[int]") -> None:
        table = self._carried("cache")[0]["table"]
        table[slot, start_idx : start_idx + len(ids)] = torch.as_tensor(ids, dtype=torch.int32, device=table.device)

    def _mask_slot_done(self, slot: int) -> None:
        """Set the device-side done flag of a slot (engine thread only); in
        paged mode also repoint its table row at the scratch block — its freed
        blocks may be reallocated at once, and the done row keeps issuing a
        ride-along K/V write per step."""
        if self._carry is None:
            return
        self._dev("mask_done", None, slot)

    def _op_mask_done(self, _: None, slot: int) -> None:
        self._carried("done")[slot] = True
        if self.block_size is not None:  # the table tensor both pools share
            self._carried("cache")[0]["table"][slot] = self._scratch_block

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
        self._release_blocks_locked(slot, session)
        self._mask_slot_done(slot)
        session.slot = -1
        session.table = []
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
                # measured against the table cursor, not the private list:
                # radix-transferred entries stay in the table
                target = self._table_entries(tokens)
                if target > session.table_len:
                    deficits[slot] = target - session.table_len
            need = sum(deficits.values())
            if need > len(self._free_blocks):
                # evict idle cached runs before preempting live residents
                self._reclaim_blocks_locked(need - len(self._free_blocks))
            if need <= len(self._free_blocks):
                for slot, extra in deficits.items():
                    session = self._sessions[slot]
                    alloc = [self._free_blocks.pop(0) for _ in range(extra)]
                    self._slot_blocks[slot].extend(alloc)
                    self._extend_tables(slot, session.table_len, alloc)
                    session.table_len += extra
                    session.table.extend(alloc)
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
        deadline: Optional[float] = None, export_handoff: bool = False, tenant: Optional[str] = None,
        priority: Optional[Any] = None, logprobs: bool = False,
    ) -> Iterator[np.ndarray]:
        """Enqueue a prompt; returns an iterator of 1-D int32 arrays of new
        tokens (the first item is the prompt-sampled token). Safe from any
        thread. ``max_new_tokens`` caps THIS request below the config budget.
        ``constraint`` selects THIS request's grammar from the generator's
        ``config.constraints`` (0 = FREE); ``logprobs=True`` records each
        emitted token's log-probability on the stream's ``logprobs``.
        ``deadline`` (absolute ``time.monotonic()``) sheds the request with
        :class:`DeadlineExceeded` if it is still waiting past it; a full
        waiting queue, or a quiesced engine, sheds at once with
        :class:`QueueFullError`.

        ``export_handoff`` (the prefill-role path) runs ONLY the prefill: the
        prompt-sampled token is emitted and the stream ends with the prefilled
        KV on its ``handoff`` for :meth:`import_handoff` on another engine.

        ``tenant``/``priority`` default to the request contextvars the HTTP
        layer binds: a tenant with an empty token bucket is shed with
        :class:`TenantThrottled` (HTTP 429 whose ``Retry-After`` is the
        bucket's refill time), waiting prompts are admitted deficit round
        robin across tenants within strict priority tiers, and a
        high-priority admission on a full paged engine preempts the
        lowest-priority resident (which resumes token-identically)."""
        if self._follower:
            raise RuntimeError(
                f"submit to rank 0 of the mesh: rank {self.gen.mesh.rank} runs rank 0's device steps"
            )
        if len(prompt) == 0:
            raise ValueError("prompt must be non-empty")
        if export_handoff and self._spec is not None:
            raise ValueError("export_handoff does not compose with speculative decoding (config.draft)")
        if logprobs and self._spec is not None:
            raise ValueError(
                "logprobs does not compose with speculative decoding (config.draft) yet: "
                "accepted draft tokens carry no per-token policy logprob"
            )
        if logprobs and export_handoff:
            raise ValueError(
                "logprobs does not compose with export_handoff: the logprob column "
                "does not ride the KV handoff payload (the replica layer routes "
                "logprobs requests onto a decode/mixed replica directly)"
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
            export=export_handoff,
            # the original prompt is kept only where preemption can resume it
            prompt=list(prompt) if self.block_size is not None else [],
        )
        with self._lock:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            if self._quiesced:
                # draining for a scale-down: the replica scheduler walks to a
                # sibling; routing, not load, so no shed counter moves
                raise QueueFullError("replica is quiescing for a fleet resize")
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

    def import_handoff(self, payload: Dict[str, Any]) -> Iterator[np.ndarray]:
        """Adopt a sibling engine's exported prefill (the decode-role path):
        at admission the payload's pages are copied onto this engine's device
        and written into freshly allocated blocks (a dense engine pastes the
        row); no prefill runs here. The stream carries every token AFTER the
        prompt-sampled one, which the exporting engine emitted, and equals
        what one engine serving the request would have produced: the KV is
        what this engine's own prefill would have written. Imports bypass
        ``max_waiting``: the prefill is paid for, and shedding here would
        waste it."""
        if self._spec is not None:
            raise ValueError("import_handoff does not compose with speculative decoding (config.draft)")
        trace = payload.get("trace") if self.trace_requests else None
        session = _Session(
            slot=-1, out=queue.Queue(), max_new=int(payload["max_new"]), produced=int(payload["produced"]),
            grammar=int(payload.get("grammar", 0)), deadline=payload.get("deadline"),
            created_at=payload.get("created_at", time.monotonic()), trace=trace, tenant=payload.get("tenant"),
            priority=int(payload.get("priority", PRIORITY_NORMAL)),
            prompt=list(payload["prompt"]) if self.block_size is not None else [],
            echo=list(payload["echo"]) if self.block_size is not None else [],
        )
        session.pending_import = dict(payload)
        with self._lock:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            if self._quiesced:
                raise QueueFullError("replica is quiescing for a fleet resize")
            self._pending.append((list(payload["prompt"]), session))
            if self._thread is None:
                self._thread = threading.Thread(target=self._engine_loop, daemon=True)
                self._thread.start()
            self._lock.notify_all()
        return _TokenStream(self, session)

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
                self._release_blocks_locked(session.slot, session)
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
                backlog += self._admission_backlog(adm)
        return backlog

    @staticmethod
    def _admission_backlog(adm: _Admission) -> int:
        """Prefill tokens an in-flight admission still owes: the unchunked
        remainder once stepping started, else the prompt minus its radix-
        cached run (``adm.start`` holds the static prefix length until
        :meth:`_admission_begin` runs). An imported handoff owes none."""
        if adm.session.pending_import is not None:
            return 0
        if adm.tokens is not None:
            return max(adm.width - adm.pos, 0)
        remaining = max(len(adm.prompt), 1)
        if adm.cached:
            remaining = max(remaining - max(adm.cached - adm.start, 0), 1)
        return remaining

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
                    "chunks": self.prefill_chunks,
                    "chunk_tokens": self.prefill_chunk_tokens,
                    "monolithic_admissions": self.prefill_monolithic,
                    "backlog_tokens": backlog,
                },
            }
            if self.block_size is not None:
                used = self.pool_blocks - len(self._free_blocks)
                snapshot["kv_blocks"] = {
                    "total": self.pool_blocks,
                    "used": used,  # includes the permanently resident shared-prefix pages
                    "shared_prefix": len(self._shared_prefix_blocks),
                    "block_size": self.block_size,
                    "preemptions": self.preemptions,
                    "block_bytes": self._block_bytes,
                    "used_bytes": used * self._block_bytes,
                    "kv_dtype": self._kv_dtype_label,
                }
                if self.prefix is not None:
                    # the prefix's partial tail block is not a shared page:
                    # each admission scatters it into a private block
                    snapshot["kv_blocks"]["shared_prefix_tail_tokens"] = (
                        self.prefix.length - len(self._shared_prefix_blocks) * self.block_size
                    )
            if self._radix is not None:
                snapshot["prefix_cache"] = {
                    "hits": self.prefix_cache_hits,
                    "misses": self.prefix_cache_misses,
                    "tokens_avoided": self.prefix_cache_tokens_avoided,
                    "cow_copies": self.prefix_cache_cow,
                    "evictions": self._radix.evictions,
                    "evicted_blocks": self._radix.evicted_blocks,
                    "cached_blocks": self._radix.cached_blocks(),
                    "cached_tokens": self._radix.cached_tokens(),
                    # at the pool dtype: int8 pools count their scale planes
                    "cached_bytes": self._radix.cached_bytes(self._block_bytes),
                    "pinned_blocks": self._radix.pinned_blocks(),
                    "nodes": self._radix.nodes(),
                }
            if self.role is not None:
                snapshot["role"] = self.role
            if self.role is not None or self.handoffs_exported or self.handoffs_imported:
                # absent on role-less engines that never handed off (ints
                # only; the latency window joins after the lock)
                snapshot["handoff"] = {"exported": self.handoffs_exported, "imported": self.handoffs_imported}
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
        if "handoff" in snapshot:
            # export -> import latency, observed where the import begins
            snapshot["handoff"]["transfer_ms"] = self._handoff_ms.snapshot()
        if self.timeseries is not None:
            fast_s = self.slo.config.fast_window_s if self.slo is not None else 60.0
            snapshot["rates"] = {**self.timeseries.rates(fast_s), "prefill_backlog_tokens": backlog}
        if self.slo is not None and self.slo.armed:
            snapshot["slo"] = self.slo.evaluate(self.timeseries)
        if self._tenant_slo is not None and len(self._tenant_slo):
            snapshot["tenant_slo"] = self._tenant_slo.evaluate()
        if self._aot is not None:
            snapshot["aot"] = self._aot.stats()
        return snapshot

    def warmup(self) -> None:
        """Pay the cold start before traffic arrives: a bucket-FILLING request
        runs through each prompt bucket (budget 1: admission only — each
        bucket is its own prefill shape and allocation), then short requests
        run the two decode dispatches (the first on the freshly made carry,
        the second on the steady-state one). Their first launches build and
        load the hand-written kernels the engine's path runs (``nvcc`` at
        first use, the port's counterpart of the JAX engine's XLA compile);
        with an AOT store armed they resolve every program through it: each
        bucket's prefill and the decode are captured as CUDA graphs, their
        kernels installed from the store where it holds them.
        Counters, the TTFT/TBT windows, the windowed rates and the SLO
        tracker are reset afterwards, so :meth:`stats` reflects real traffic
        only. A follower rank of a mesh returns at once: its engine thread
        runs the leader's warmup as it runs every plan."""
        if self._follower:
            return
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
            self.prefill_chunks = 0
            self.prefill_chunk_tokens = 0
            self.prefill_monolithic = 0
            if self._radix is not None:
                # drop the probes' junk prefixes and counts: real traffic
                # starts from a clean tree
                self._radix_reset_locked()
            self._ttft.clear()  # warmup probes must not skew the percentiles
            self._tbt.clear()
            self.handoffs_exported = 0
            self.handoffs_imported = 0
            self._handoff_ms.clear()
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

    def quiesce(self) -> None:
        """Stop ACCEPTING new submissions and imports (they shed with
        :class:`QueueFullError`, which the replica scheduler routes around)
        while everything queued or resident runs to completion: the first
        phase of a zero-loss scale-down; :meth:`close` is the second, once
        :meth:`occupancy` reads empty."""
        with self._lock:
            self._quiesced = True

    def close(self, wait: bool = True, timeout: float = 120.0) -> None:
        """Stop admitting, drain resident streams to completion, stop the
        engine. Never-admitted pending requests get a clean end-of-stream."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        # (a follower's thread ends when rank 0's engine closes)
        if wait and self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._follower_error is not None:
            raise RuntimeError("this rank's follower loop failed; rank 0 and this rank fell out of step") from (
                self._follower_error)

    # ------------------------------------------------------------------ engine

    def _engine_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    idle = False
                    while not self._closed and not self._pending and not self._admissions and not self._sessions:
                        if self._plan is None:
                            self._lock.wait()
                        elif not self._lock.wait(timeout=HEARTBEAT_S):
                            idle = True
                            break
                    if not idle:
                        self._apply_cancellations_locked()
                        if self._closed:
                            for _, session in self._pending:
                                session.out.put(_SENTINEL)
                            self._pending.clear()
                            if not self._sessions and not self._admissions:
                                break
                if idle:
                    # an idle mesh engine's empty plan, sent unlocked: no
                    # follower waits in a collective past the group's timeout
                    self._plan.record("noop", None, (), True)
                    continue
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
            self._stop_followers()

    def _admit_pending(self) -> None:
        """Move waiting prompts toward residency. The lock is held only for
        queue/slot/block bookkeeping; the prefill runs unlocked so
        submit()/close() callers never wait on it. With ``admit_chunk`` set,
        each in-flight admission advances ONE chunk a pass and this returns
        once ``prefill_budget`` prefill tokens have run, so the caller's
        decode dispatch interleaves with long prefills; monolithic admissions
        complete in a single step."""
        budget = self.prefill_budget
        spent = 0
        while True:
            self._start_admissions()
            if not self._admissions:
                return
            for adm in list(self._admissions):
                if not self._admission_alive(adm):
                    continue
                try:
                    spent += self._admission_step(adm)
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
                if adm.done:
                    if adm.session.export:
                        self._export_admission(adm)
                    else:
                        self._finalize_admission(adm)
                if budget is not None and spent >= budget:
                    return

    def _start_admissions(self) -> None:
        """Sweep dead/expired waiters, then move head-of-queue prompts into
        free slots as in-flight admissions (lock held; no device work): one
        at a time, or up to ``max_admissions`` in chunked mode. Paged mode
        allocates only the prompt + first dispatch, past the shared leading
        entries (the static prefix's pages, or a radix hit's cached run,
        pinned here); the head keeps its FIFO position while the pool
        cannot supply its initial blocks, once idle cached runs are
        evicted."""
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
            limit = self.max_admissions if self.admit_chunk else 1
            p0 = self._p0
            while self._pending and len(self._admissions) < limit:
                self._select_pending_locked()
                if not self._free:
                    if self._preempt_for_priority_locked():
                        # the victim requeued at the head; re-select so the
                        # high-priority prompt rotates back in front of it
                        continue
                    break
                blocks_row = gather_row = None
                cached = 0
                pins: "List[int]" = []
                if self.block_size is not None:
                    head_prompt, head_session = self._pending[0]
                    head_budget = head_session.max_new - head_session.produced
                    lifetime = self._blocks_lifetime(head_prompt, head_budget)
                    if len(self._shared_prefix_blocks) + lifetime > self.max_blocks:
                        # an oversized prompt can never fit a table row: fail
                        # its stream now instead of wedging the FIFO head
                        _, session = self._pending.pop(0)
                        if not session.finished:
                            session.finished = True
                            session.out.put(ValueError(
                                f"prompt needs {len(self._shared_prefix_blocks) + lifetime} KV blocks but a "
                                f"slot's table holds {self.max_blocks}"
                            ))
                        continue
                    # seeded leading table entries: the static prefix's full
                    # blocks, or (on a radix hit) the matched cached run
                    seeded = list(self._shared_prefix_blocks)
                    # an imported handoff skips the radix match: its row
                    # arrives whole, so there is no prefill to skip
                    if self._radix is not None and head_session.pending_import is None:
                        # the last prompt token always prefills: the first
                        # sampled token needs its hidden row
                        m, mblocks = self._radix.match(self._radix_key(head_prompt))
                        m = min(m, p0 + max(len(head_prompt), 1) - 1)
                        if m > p0:
                            cached = m
                            pins = mblocks[: -(-m // self.block_size)]
                            seeded = pins[: m // self.block_size]
                            # pin every matched block (the partial tail too:
                            # the gather reads it) until this stream releases
                            self._radix.pin(pins)
                    try:
                        needed = self._blocks_initial(head_prompt, head_budget, shared=len(seeded))
                        if needed > len(self._free_blocks):
                            # cached-but-idle prefixes are the memory the next
                            # admission may take back
                            self._reclaim_blocks_locked(needed - len(self._free_blocks))
                        if needed > len(self._free_blocks):
                            if pins:
                                self._radix.release(pins)
                            return
                        prompt, session = self._pending.pop(0)
                        slot = self._free.pop(0)
                    except BaseException:
                        # admission died between pin and handoff: unpin, or the
                        # matched prefix blocks stay unevictable forever
                        if pins:
                            self._radix.release(pins)
                        raise
                else:
                    prompt, session = self._pending.pop(0)
                    slot = self._free.pop(0)
                # the session owns the pins from here: every exit releases them
                session.pins = pins
                session.slot = slot
                session.admit_seq = self._admit_counter
                self._admit_counter += 1
                session.row_start = p0 + max(len(prompt), 1)
                if self.block_size is not None:
                    alloc = [self._free_blocks.pop(0) for _ in range(needed)]
                    self._slot_blocks[slot] = alloc
                    session.shared_blocks = len(seeded)
                    session.table_len = len(seeded) + len(alloc)
                    session.table = seeded + alloc
                    blocks_row = np.full((self.max_blocks,), self._scratch_block, np.int32)
                    blocks_row[: session.table_len] = session.table
                    if cached:
                        gather_row = np.full((self.max_blocks,), self._scratch_block, np.int32)
                        gather_row[: len(pins)] = pins
                self._seed += 1
                _tev(
                    session, "engine.admission_start", slot=slot,
                    queue_wait_ms=round((time.monotonic() - session.created_at) * 1e3, 3),
                )
                self._admissions.append(_Admission(
                    session=session, prompt=prompt, slot=slot, seed=self._seed,
                    budget=session.max_new - session.produced, blocks_row=blocks_row, start=p0,
                    cached=cached, gather_row=gather_row,
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
                self._release_blocks_locked(adm.slot, session)
                self._dev("drop_row", adm)
                return False
            return True

    def _abort_admission(self, adm: _Admission, exc: BaseException) -> None:
        """Fail one admission's stream without touching the engine."""
        with self._lock:
            if adm in self._admissions:
                self._admissions.remove(adm)
            self._free.append(adm.slot)
            self._release_blocks_locked(adm.slot, adm.session)
            self._dev("drop_row", adm)
            if not adm.session.finished:
                adm.session.finished = True
                adm.session.out.put(exc)

    def _admission_begin(self, adm: _Admission) -> int:
        """Classify an admission and set up its prefill. A radix hit goes to
        :meth:`_begin_cached`; a monolithic admission (chunking off, or an
        exact-width resume whose chunk-aligned width would overflow the row)
        runs its whole prefill here through :meth:`_prefill_row` and returns
        its token cost; a chunked one gets its row(s) and padded prompt and
        leaves the stepping to :meth:`_admission_step` (cost 0)."""
        cfg, gen = self.gen.config, self.gen
        prompt, session = adm.prompt, adm.session
        if session.pending_import is not None:
            return self._import_begin(adm)
        if gen._cs is not None:
            # the DFA state is a pure function of (grammar, emitted tokens): a
            # fresh admission starts at the grammar's start state, a
            # preemption resume walks the echo on the host
            cs = gen._cs
            state = int(cs.starts[session.grammar])
            for t in session.echo:
                state = int(cs.trans[state, t])
            adm.dfa_state = state
        p0 = self._p0
        if adm.gather_row is not None and self._begin_cached(adm):
            return 0
        if self._radix is not None:
            with self._lock:
                self.prefix_cache_misses += 1
        bucket = self._prefill_width(prompt, adm.budget)
        chunk = self.admit_chunk
        aligned = chunk_aligned(bucket, chunk) if chunk else bucket
        if not chunk or self._sp or p0 + aligned > self.cache_len:
            # monolithic: chunking off, a sequence-parallel prefill (already
            # spread over the ranks), or an exact-width resume whose aligned
            # width would overflow the row
            self._dev("prefill_row", adm, list(prompt), adm.budget, adm.dfa_state)
            adm.done = True
            with self._lock:
                self.prefill_monolithic += 1
            _tev(session, "engine.prefill", tokens=p0 + bucket, mode="monolithic")
            return p0 + bucket
        adm.chunk, adm.width = chunk, aligned
        tokens = np.full((1, aligned), cfg.pad_id, np.int32)
        tokens[0, : len(prompt)] = np.asarray(prompt, np.int32)
        adm.tokens = tokens
        self._dev("row_begin", adm, p0 + max(len(prompt), 1), None)
        return 0

    def _op_prefill_row(self, adm: _Admission, prompt: "List[int]", budget: int, dfa_state: Optional[int]) -> None:
        """A monolithic admission's prefill (:meth:`_prefill_row`) into its
        row, and the draft's row in speculative mode: the same prompt
        through the draft with the DRAFT's prefix rows (its prompt-sampled
        token is discarded: emission #1 is the target's)."""
        adm.tok0, adm.row_len, adm.row_cache, adm.last = self._prefill_row(
            prompt, adm.seed, budget=budget, dfa_state=dfa_state
        )
        if self._spec is not None:
            adm.d_row_cache = self._prefill_row(
                prompt, adm.seed, budget=budget, dfa_state=dfa_state, gen=self._spec._draft,
                prefix=self._draft_prefix,
            )[2]

    def _op_row_begin(self, adm: _Admission, total: int, gather_row: Optional[np.ndarray]) -> None:
        """A chunked admission's row and prefill carry (:meth:`_chunk_state`):
        a fresh row with the static prefix pasted, or, on a radix hit, the
        matched blocks gathered from the pool (the inverse of the admission
        scatter; positions past the cached run read scratch, which the
        suffix prefill overwrites before anything can attend to it). In
        speculative mode the draft's row chunks in LOCKSTEP with the
        target's, so speculative admissions stall residents no longer than
        plain ones."""
        cfg = self.gen.config
        self._chunk_state(adm, total)
        if gather_row is not None:
            adm.row_cache = gather_paged_rows(self._carried("cache"), gather_row, self.cache_len)
            return
        row_cache = init_cache(self.gen.cache_config, 1, self.cache_len, kv_dtype=cfg.kv_cache_dtype,
                               device=self.device)
        if self.prefix is not None:
            row_cache = _paste_prefix_rows(row_cache, self.prefix.layers)
        adm.row_cache = row_cache
        if self._spec is not None:
            draft = self._spec._draft
            d_row = init_cache(draft.cache_config, 1, self.cache_len, kv_dtype=cfg.kv_cache_dtype,
                               device=self.device)
            if self._draft_prefix is not None:
                d_row = _paste_prefix_rows(d_row, self._draft_prefix.layers)
            adm.d_row_cache = d_row

    def _chunk_state(self, adm: _Admission, total: int) -> None:
        """The chunked prefill's carry: the row's absolute length, the first
        token's sampling stream (derived as :meth:`_prefill_row` derives it,
        so chunked, monolithic and cache-hit admissions sample the same first
        token) and the accumulated last hidden row."""
        adm.lengths = torch.tensor([total], dtype=torch.int32, device=self.device)
        adm.generator = torch.Generator(device=self.device).manual_seed(adm.seed)
        adm.row_valid = torch.ones((1,), dtype=torch.bool, device=self.device)
        adm.last = torch.zeros((1, self.gen.model.config.dim), dtype=torch.float32, device=self.device)

    def _import_begin(self, adm: _Admission) -> int:
        """Set up an imported-handoff admission (engine thread): copy the
        payload's pages (or a dense engine's row) onto this engine's device
        and mark the admission complete; no prefill runs. The grammar state
        is recovered from the payload's emitted tokens as a preemption resume
        recovers it, stopping one short so :meth:`_finalize_admission`'s
        advance past the first token lands on the right state."""
        payload = adm.session.pending_import
        pages = payload.get("pages")
        if pages is not None:
            if self.block_size is None:
                raise ValueError(
                    "a block-native (paged) handoff cannot import into a dense engine; "
                    "disaggregated replicas must be built with identical engine knobs"
                )
            if int(payload.get("block_size") or 0) != self.block_size:
                raise ValueError(
                    f"handoff block_size {payload.get('block_size')} != this engine's {self.block_size}; "
                    "disaggregated replicas must be built with identical engine knobs"
                )
            if int(payload["lengths"]) > self.cache_len:
                raise ValueError(
                    f"handoff covers {payload['lengths']} positions but this engine's cache_len is "
                    f"{self.cache_len}; disaggregated replicas must be built with identical engine knobs"
                )
            kv, paged = pages, True
        else:
            row = payload["row"]
            width = int(row[0]["k"].shape[1])
            if width != self.cache_len:
                raise ValueError(
                    f"handoff row width {width} != this engine's cache_len {self.cache_len}; "
                    "disaggregated replicas must be built with identical engine knobs"
                )
            kv, paged = row, False
        # allocated on THIS engine's device (a no-op where the exporter shares it)
        self._dev("import_kv", adm, _kv_meta(kv), paged, int(payload["first"]), int(payload["lengths"]))
        if self.gen._cs is not None:
            cs = self.gen._cs
            state = int(cs.starts[adm.session.grammar])
            for t in list(payload["echo"])[:-1]:
                state = int(cs.trans[state, int(t)])
            adm.dfa_state = state
        adm.done = True
        exported_at = payload.get("exported_at")
        if exported_at is not None:
            self._handoff_ms.observe(time.monotonic() - exported_at)
        _tev(adm.session, "engine.handoff_import", tokens=int(payload["lengths"]), produced=adm.session.produced)
        return 0

    def _begin_cached(self, adm: _Admission) -> bool:
        """Set up a radix-cache HIT: gather the matched blocks into a dense
        row and arrange chunked prefill of only the uncached suffix, from the
        first uncached token (an arbitrary, possibly non-block-aligned
        offset). The gathered K/V is bit-identical to what a cold prefill
        writes at those positions (one wrote it), so the stream's tokens equal
        its cold run's. Returns False to fall back to the cold path where the
        suffix would overflow the row (exact-width preemption resumes): the
        admission then prefills everything but still shares the matched
        blocks through its table."""
        p0 = self._p0
        start = adm.cached  # > p0 by the hit condition
        chunk = self._radix_chunk
        suffix = list(adm.prompt)[start - p0:]
        width = chunk_aligned(len(suffix), chunk)
        if start + width > self.cache_len or self._carry is None:
            # (a tree hit implies a prior finalize built the carry)
            return False
        tokens = np.full((1, width), self.gen.config.pad_id, np.int32)
        tokens[0, : len(suffix)] = np.asarray(suffix, np.int32)
        adm.tokens = tokens
        adm.chunk, adm.width, adm.start, adm.pos = chunk, width, start, 0
        self._dev("row_begin", adm, p0 + max(len(adm.prompt), 1), adm.gather_row)
        with self._lock:
            self.prefix_cache_hits += 1
            self.prefix_cache_tokens_avoided += start - p0
            if start % self.block_size:
                # the partly shared tail block was gathered into the row and
                # scatters back into THIS request's private block: copy on write
                self.prefix_cache_cow += 1
        _tev(adm.session, "prefill.cache_hit", tokens=start - p0, cached=start)
        return True

    def _admission_step(self, adm: _Admission) -> int:
        """Advance one admission's prefill by one unit (engine thread; device
        work unlocked): a monolithic admission completes inside
        :meth:`_admission_begin`; a chunked one runs one ``chunk``-wide slice
        through the Generator's chunked prefill and samples the first token
        once the last chunk lands. Returns the prefill tokens spent (the
        per-iteration budget's unit)."""
        if adm.tokens is None:
            cost = self._admission_begin(adm)
            if adm.done:
                return cost
        c = adm.pos
        self._dev("row_chunk", adm, adm.tokens[:, c: c + adm.chunk], adm.start + c)
        adm.pos = c + adm.chunk
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_chunk_tokens += adm.chunk
        _tev(adm.session, "engine.prefill_chunk", pos=adm.pos, width=adm.width, chunk=adm.chunk)
        if adm.pos >= adm.width:
            self._dev("row_first", adm, adm.dfa_state)
            adm.done = True
        return adm.chunk

    def _op_row_chunk(self, adm: _Admission, tokens: np.ndarray, start: int) -> None:
        """One ``chunk``-wide slice of a chunked admission through the
        Generator's chunked prefill (and the draft's, in lockstep)."""
        sl = torch.as_tensor(tokens, device=self.device)
        chunk_last, has, adm.row_cache = self.gen._prefill_chunk(sl, start, adm.lengths, adm.row_cache,
                                                                 adm.row_valid)
        adm.last = torch.where(has[:, None], chunk_last, adm.last)
        if self._spec is not None:
            _, _, adm.d_row_cache = self._spec._draft._prefill_chunk(sl, start, adm.lengths, adm.d_row_cache,
                                                                     adm.row_valid)

    def _op_row_first(self, adm: _Admission, dfa_state: Optional[int]) -> None:
        """Sample a chunked admission's first token once its last chunk landed."""
        state = None if dfa_state is None else torch.tensor([dfa_state], dtype=torch.int32, device=self.device)
        adm.tok0 = self.gen._first_token(adm.last, adm.generator, state)
        adm.row_len = adm.lengths

    def _export_admission(self, adm: _Admission) -> None:
        """Complete an EXPORT admission (the prefill-role path): emit the
        prompt-sampled first token, free the slot and blocks (the row is
        never pasted into this engine's pool) and package the prefilled KV
        as the session's handoff payload: the ``ceil(lengths / block_size)``
        pages the prompt occupies in a paged engine, the dense row in a dense
        one. A request whose first token already ends it (eos, or a budget
        of 1) finishes here with no handoff."""
        cfg = self.gen.config
        session, slot = adm.session, adm.slot
        first = adm.tok0.cpu().numpy()
        hit_eos = cfg.eos_id is not None and int(first[0]) == cfg.eos_id
        done_now = hit_eos or session.produced + 1 >= session.max_new
        row_len = int(adm.row_len[0])
        kv = None
        if done_now:
            self._dev("drop_row", adm)
        else:
            kv = self._dev("export", adm, -(-row_len // self.block_size) if self.block_size is not None else None)
        with self._lock:
            if adm in self._admissions:
                self._admissions.remove(adm)
            self._free.append(slot)
            self._release_blocks_locked(slot, session)
            if session.finished:
                # cancelled (or shed) during the unlocked prefill: the
                # consumer already holds its sentinel
                return
            self._emit_first_locked(session, first, None)
            session.finished = True
            if done_now:
                _tev(session, "engine.finish", produced=session.produced)
            else:
                self.handoffs_exported += 1
                session.handoff = {
                    "prompt": list(adm.prompt),
                    "first": int(first[0]),
                    **({"pages": kv, "block_size": self.block_size} if self.block_size is not None else {"row": kv}),
                    "lengths": row_len,
                    "max_new": session.max_new,
                    "produced": session.produced,
                    "echo": [int(first[0])],
                    "grammar": session.grammar,
                    "deadline": session.deadline,
                    "created_at": session.created_at,
                    "trace": session.trace,
                    "tenant": session.tenant,
                    "priority": session.priority,
                    "exported_at": session.last_emit,
                }
                _tev(session, "engine.handoff_export", tokens=row_len, produced=session.produced)
            session.out.put(_SENTINEL)

    def _op_export(self, adm: _Admission, n_blocks: Optional[int]) -> Optional[tuple]:
        """An export admission's prefilled KV, whole, and its rows dropped:
        the first ``n_blocks`` pages in a paged engine (the dense row never
        leaves it), the dense row otherwise. Over a mesh whose ``model``
        axis splits the KV heads each rank holds its heads: the leader
        gathers them in head order (the other ranks return None), so the
        payload carries every head, as the JAX package's does."""
        with torch.no_grad():
            kv = adm.row_cache if n_blocks is None else self._export_pages_impl(adm.row_cache, n_blocks,
                                                                                self.block_size)
            if self._kv_split:
                kv = self._heads_to_leader(kv, 2 if n_blocks is None else 0)
        self._op_drop_row(adm)
        return kv

    def _heads_to_leader(self, kv: tuple, dim: int) -> Optional[tuple]:
        """Every KV head of ``kv`` (split over ``model`` along ``dim``) on
        the leader, on the host; None on the other ranks. The leader's
        ``model`` peers each send it their heads in one buffer over the
        plan group; the ranks beside them hold copies and send nothing."""
        mesh, leader, group = self.gen.mesh, self._plan.leader, self._plan.group
        line = mesh.peers("model")
        if line[0] != leader:
            return None
        host = tuple({name: buf.cpu() for name, buf in layer.items()} for layer in kv)  # one copy per buffer
        if mesh.rank != leader:
            dist.send(_kv_bytes(host), dst=leader, group=group)
            return None
        parts = [host]
        meta = _kv_meta(host)
        for peer in line[1:]:
            buf = torch.empty(_kv_nbytes(meta), dtype=torch.uint8)
            dist.recv(buf, src=peer, group=group)
            parts.append(_kv_from_bytes(buf, meta))
        return tuple({name: torch.cat([part[i][name] for part in parts], dim) for name in layer}
                     for i, layer in enumerate(host))

    def _op_import_kv(self, adm: _Admission, meta: tuple, paged: bool, first: int, lengths: int) -> None:
        """An imported handoff onto this engine's device: its KV pages
        (``adm.import_pages``) or dense row (``adm.row_cache``), its
        prompt-sampled token and its length. ``meta`` is the payload's
        shapes and dtypes, all heads. Over a mesh the leader holds the
        payload and sends every other rank its heads (those of its ``model``
        index where that axis splits them, else all) over the plan group."""
        adm.tok0 = torch.tensor([first], dtype=torch.int32, device=self.device)
        adm.row_len = torch.tensor([lengths], dtype=torch.int32, device=self.device)
        if self._plan is None or not self._follower:
            payload = adm.session.pending_import
            kv = tuple({name: torch.as_tensor(buf) for name, buf in layer.items()}
                       for layer in (payload["pages"] if paged else payload["row"]))
        if self._plan is not None:
            kv = self._heads_from_leader(kv if not self._follower else None, meta, 0 if paged else 2)
        placed = tuple({name: buf.to(self.device) for name, buf in layer.items()} for layer in kv)
        if paged:
            adm.import_pages = placed
        else:
            adm.row_cache = placed

    def _heads_from_leader(self, kv: Optional[tuple], meta: tuple, dim: int) -> tuple:
        """This rank's heads of the payload ``kv`` the leader holds (None
        elsewhere), split along ``dim``: the leader sends each ``model``
        index's slice, as one host buffer, to every rank of that index."""
        mesh, leader, group = self.gen.mesh, self._plan.leader, self._plan.group
        local = self.gen.cache_config.n_kv_heads
        split = self._kv_split

        def heads(tree: tuple, index: int) -> tuple:
            lo = index * local if split else 0
            return tuple({name: buf.narrow(dim, lo, local) for name, buf in layer.items()} for layer in tree)

        if mesh.rank == leader:
            for index in range(mesh.size("model")):
                ranks = [r for r in mesh.grid[..., index].reshape(-1).tolist() if r != leader]
                if ranks:
                    buf = _kv_bytes(tuple({name: t.cpu() for name, t in layer.items()} for layer in heads(kv, index)))
                    for r in ranks:
                        dist.send(buf, dst=r, group=group)
            return heads(kv, 0)
        mine = tuple({name: (shape[:dim] + (local,) + shape[dim + 1:], dtype) for name, (shape, dtype) in layer.items()}
                     for layer in meta)
        buf = torch.empty(_kv_nbytes(mine), dtype=torch.uint8)
        dist.recv(buf, src=leader, group=group)
        return _kv_from_bytes(buf, mine)

    def _finalize_admission(self, adm: _Admission) -> None:
        """Paste a completed admission's row (or an imported handoff's pages)
        into the pool and activate its session. A failure in the paste is
        engine-fatal: the pool may be half-written."""
        cfg = self.gen.config
        session, slot = adm.session, adm.slot
        imported = session.pending_import is not None
        lp0 = self._dev("first_logprob", adm, adm.dfa_state) if session.want_logprobs and not imported else None
        try:
            first = adm.tok0.cpu().numpy()
            hit_eos = cfg.eos_id is not None and int(first[0]) == cfg.eos_id
            # produced carries across preemptions; this residency adds one
            # token. An import's first token was emitted (and its eos/budget
            # ending handled) by the exporting engine: never start-done here
            start_done = not imported and (hit_eos or session.produced + 1 >= session.max_new)
            self._dev("finalize", adm, slot, adm.blocks_row, session.shared_blocks, adm.dfa_state, start_done)
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
            if self._radix is not None and adm.blocks_row is not None:
                # the prompt's full blocks now hold exactly the K/V a cold
                # prefill writes: publish them (even a cancelled stream's)
                self._radix_insert_locked(adm, session)
            if session.finished:
                # cancelled during the unlocked prefill: mask the just
                # activated row back out and return the slot
                self._free.append(slot)
                self._release_blocks_locked(slot, session)
                self._mask_slot_done(slot)
                return
            if imported:
                # the exporting engine emitted the first token and took the
                # TTFT; this residency decodes on from produced = 1, the
                # state one engine holds right after its own finalize
                session.pending_import = None
                session.resident_base = 0
                session.last_emit = time.monotonic()
                if self.timeseries is not None:
                    self.timeseries.admissions.add()
                if self._tenant_slo is not None and session.tenant is not None:
                    self._tenant_slo.admitted(session.tenant)
                self.handoffs_imported += 1
            else:
                self._emit_first_locked(session, first, lp0)
            self._sessions[slot] = session
            if start_done:
                # the plain decode only flags done on tokens IT samples, so the
                # prompt-sampled token's ending is masked here (speculative
                # mode flagged it on the device already)
                self._finish_locked(slot, device_done=self._spec is not None)

    def _op_finalize(self, adm: _Admission, slot: int, blocks_row: Optional[np.ndarray], shared: int,
                     dfa_state: Optional[int], start_done: bool) -> None:
        """Paste a completed admission's row (or an imported handoff's
        pages) into slot ``slot`` of the pool, activate its carry entries
        and drop the row (the carry is made at the first admission)."""
        if self._carry is None:
            self._carry = self._init_carry()
        spec = self._spec is not None
        caches = tuple(self._carried(name) for name in (("cache", "d_cache") if spec else ("cache",)))
        rows = (adm.row_cache, adm.d_row_cache) if spec else (adm.row_cache,)
        tok, lengths, done = (self._carried(name) for name in ("tok", "lengths", "done"))
        with torch.no_grad():
            for cache, row_cache in zip(caches, rows):
                if adm.import_pages is not None:
                    self._paged_page_admit_impl(
                        cache, adm.import_pages, tok, lengths, done, slot, adm.tok0, adm.row_len, blocks_row, shared,
                    )
                elif blocks_row is not None:
                    self._paged_admit_impl(
                        cache, row_cache, tok, lengths, done, slot, adm.tok0, adm.row_len, blocks_row, shared,
                    )
                else:
                    self._admit_impl(cache, row_cache, tok, lengths, done, slot, adm.tok0, adm.row_len)
            if spec:
                # the speculative activation: the slot's out_buf row reset
                # (pad, then tok0), produced at 1 and the start-done flag
                produced, out_buf = self._carried("produced"), self._carried("out_buf")
                out_buf[slot] = self.gen.config.pad_id
                out_buf[slot, 0] = adm.tok0[0]
                produced[slot] = 1
                done[slot] = start_done
            if cstate := self._carried("tail"):
                # advance past the (constrained) prompt-sampled token on the
                # device: an indexed copy, no host round trip
                trans = self.gen._cs_trans
                cstate[0][slot : slot + 1].copy_(trans[dfa_state][adm.tok0.long()])
        self._op_drop_row(adm)

    def _op_drop_row(self, adm: _Admission) -> None:
        """Release an admission's device rows (finalized, or abandoned)."""
        adm.row_cache = adm.d_row_cache = adm.last = adm.import_pages = None

    def _emit_first_locked(self, session: _Session, first: np.ndarray, lp0: Optional[float]) -> None:
        """Emit an admission's prompt-sampled token (caller holds the lock):
        the stream, TTFT (a resume is a later residency, not a first token),
        TBT, rates, tenant accounting and the echo."""
        if lp0 is not None:
            session.lp.append(lp0)  # before the token: k tokens => >= k logprobs
        session.out.put(first)
        now = time.monotonic()
        if session.produced == 0:
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

    def _finish_locked(self, slot: int, *, device_done: bool) -> None:
        session = self._sessions.pop(slot)
        session.finished = True
        _tev(session, "engine.finish", produced=session.produced)
        self._free.append(slot)
        if self._radix is not None:
            # the finished stream's prompt + generated tokens become a
            # cacheable prefix: the next turn of a conversation hits it all
            self._radix_publish_finished_locked(slot, session)
        self._release_blocks_locked(slot, session)
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
        toks, lps = self._dev("decode", None, self.decode_chunk)
        toks_np = toks.cpu().numpy()  # [S, chunk]; also waits for the dispatch
        lps_np = lps.cpu().numpy()  # [S, chunk] f32: each sampled token's logprob
        done_np = self._carried("done").cpu().numpy()
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

    def _op_decode(self, _: None, steps: int) -> tuple:
        """One shared decode dispatch of ``steps`` steps over every slot."""
        toks, lps, self._carry = self.gen._decode(*self._carry, steps=steps)
        return toks, lps

    def _op_spec_rounds(self, _: None, budget_np: np.ndarray) -> tuple:
        """One speculative dispatch over every slot: rounds until each live
        row has gained ``decode_chunk`` tokens or met its ``budget_np``
        (host ``[slots]`` int32). Over a mesh every rank rolls the rounds on
        its own shards from the same carry: greedy acceptance compares
        argmaxes of gathered logits, and sampled draws are the leader's,
        broadcast (``Generator._draw``), so each round's stop condition
        reads the same value on every rank."""
        budget = torch.as_tensor(budget_np, device=self.device)
        floor = torch.minimum(self._carried("produced") + self.decode_chunk, budget)
        self._carry = self._spec._loop(self._carry, floor, budget)
        return self._carry

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
        state = self._dev("spec_rounds", None, budget_np)
        out_np = self._carried("out_buf", state).cpu().numpy()  # also waits for the dispatch
        prod_np = self._carried("produced", state).cpu().numpy()
        done_np = self._carried("done", state).cpu().numpy()
        registry = self._registry()
        with self._lock:
            # fold the ride-along counters into the acceptance telemetry under
            # the lock, so stats() never sees rounds without their accepts
            self._spec_seen = spec._count(self._carried("rounds", state), self._carried("accepted", state), self._spec_seen)
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
