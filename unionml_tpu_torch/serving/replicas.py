"""Replica serving: N continuous engines behind one scheduler.

Counterpart of ``unionml_tpu/serving/replicas.py``.

- :class:`ReplicaScheduler` admits requests least-loaded first on each
  engine's token-weighted ``load()`` (live residents + live waiters + the
  prefill backlog in admission chunks), with prefix affinity: each engine's
  radix probe (``cached_prefix_tokens``) where an engine runs the prefix
  cache, else a bounded LRU of prompt-prefix keys, then tenant session
  affinity; a replica more than ``affinity_margin`` busier than the least
  loaded never heads the order (the hotspot fallback), and replicas in SLO
  breach or of the prefill role sort last but stay in the walk. Pure host
  code, the JAX package's semantics unchanged.
- :class:`ReplicaSet` builds one ``Generator`` + ``ContinuousBatcher`` per
  replica and places them round-robin over a device list (default: every
  visible CUDA device when the model is on one, its own device otherwise).
  A replica on the model's own device shares the module; one on another
  device gets a copy. It mirrors the engine's surface (``submit``,
  ``warmup``, ``stats``, ``close``, ``load``, ``health``), so the serving
  app drives a fleet as it drives one engine.
- **Disaggregation**: replicas may carry a role (``prefill``, ``decode`` or
  ``mixed``, via ``roles=`` or ``serve --replica-roles``). A prompt of at
  least ``prefill_threshold`` tokens prefills on a prefill replica with
  ``export_handoff=True`` and its KV pages hand off to a decode replica's
  ``import_handoff``: the stream is token for token one engine's, and
  resident decode streams never wait behind that prefill. A warm multi-turn
  prompt that a decode replica's radix cache mostly covers admits there
  directly (the shortcut).
- **Elasticity**: :meth:`ReplicaSet.scale_to` adds a replica on the next
  device (warmed before it joins the scheduler) or drains the tail one with
  no stream lost (unrouted, quiesced, drained, closed); a watermark
  autoscaler on the fleet's load and health drives it on a thread that
  :meth:`ReplicaSet.close` joins.

An expired deadline sheds before routing (:class:`DeadlineExceeded`), and a
prompt sheds with :class:`QueueFullError` only when every replica's waiting
queue is full. ``ContinuousBatcher(generator, ...)`` returns a set where the
serve CLI's ``--dp-replicas`` or ``--replica-roles`` asks for more than one
replica.

**Over a mesh** (``mesh=``, ``partition_rules=``): :func:`slice_mesh` cuts a
mesh along its batch axes into per-replica submeshes, as the JAX package
does. A port process is one rank, so a set over a dp mesh is process-aware,
in the JAX package's multi-host sense: each rank builds only the replica
whose submesh holds it, that replica's ranks serving it as one TP engine
(:mod:`unionml_tpu_torch.serving.mesh`), and routing across replicas is
:class:`~unionml_tpu_torch.serving.cluster.FleetCoordinator`'s. A single
engine over a model/sequence/expert mesh is ``ContinuousBatcher`` itself.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import module_device, resolve_device
from unionml_tpu_torch.defaults import (
    REPLICA_ROLES,
    serve_autoscale_high,
    serve_autoscale_interval_s,
    serve_autoscale_low,
    serve_dp_replicas,
    serve_max_replicas,
    serve_min_replicas,
    serve_prefill_threshold,
    serve_replica_roles,
)
from unionml_tpu_torch.models.generate import Generator
from unionml_tpu_torch.observability.trace import current_trace
from unionml_tpu_torch.parallel.mesh import BATCH_AXES, Mesh, process_local_submeshes
from unionml_tpu_torch.serving.continuous import ContinuousBatcher
from unionml_tpu_torch.serving.overload import DeadlineExceeded, QueueFullError, TenantThrottled, expired
from unionml_tpu_torch.serving.tenancy import current_tenant

__all__ = ["ReplicaScheduler", "ReplicaSet", "dp_extent", "slice_mesh"]

logger = logging.getLogger(__name__)

def dp_extent(mesh: Any) -> int:
    """Product of a mesh's batch (data-parallel) axis sizes: the natural
    replica count of :func:`slice_mesh`. 1 for ``None`` or a TP-only mesh."""
    if mesh is None:
        return 1
    extent = 1
    for axis in BATCH_AXES:
        extent *= int(mesh.shape.get(axis, 1))
    return extent


def slice_mesh(mesh: Any, replicas: Optional[int] = None) -> "List[Any]":
    """Slice a mesh along its batch axes into per-replica TP submeshes, as
    the JAX package slices its device mesh.

    Each submesh keeps the full axis-name set with every batch axis at size
    1 (``sequence``/``expert``/``pipe`` extents unchanged), so a Generator
    built over it behaves as a TP-only engine. With ``replicas`` equal to
    the batch-axis product (the default) each replica owns one batch slice;
    a smaller ``replicas`` that divides it folds the leftover batch extent
    into the ``model`` axis (fewer, fatter replicas from the same ranks);
    any other count raises a ``ValueError`` naming the batch-axis extents.
    A submesh is a :class:`~unionml_tpu_torch.parallel.mesh.Mesh` over its
    ranks: every rank of the world slices the same mesh at the same point
    (the submeshes' groups are made then), and a rank holds the slices
    without it with ``local`` False."""
    names = tuple(mesh.axis_names)
    ranks = mesh.grid.numpy()
    batch_dims = [i for i, n in enumerate(names) if n in BATCH_AXES and ranks.shape[i] > 1]
    total = int(np.prod([ranks.shape[i] for i in batch_dims])) if batch_dims else 1
    if replicas is None:
        replicas = total
    extents = ", ".join(f"{names[i]}={ranks.shape[i]}" for i in batch_dims) or "none > 1"
    if replicas < 1 or total % replicas:
        raise ValueError(
            f"replicas ({replicas}) must divide the mesh's data-parallel extent ({total}; "
            f"batch axes: {extents}) — each replica owns a whole number of batch slices, "
            "with any leftover extent folded into the model axis"
        )
    if total == 1:
        return [mesh]
    group = total // replicas
    if group > 1 and "model" not in names:
        raise ValueError(
            f"cannot group {group} batch slices per replica: the mesh has no 'model' "
            f"axis to fold the leftover extent (batch axes: {extents}) into"
        )
    # batch axes to the front, flattened: grouped[g] is one batch slice's ranks
    grouped = np.moveaxis(ranks, batch_dims, range(len(batch_dims))).reshape(
        (total,) + tuple(ranks.shape[i] for i in range(ranks.ndim) if i not in batch_dims)
    )
    rest_names = [names[i] for i in range(ranks.ndim) if i not in batch_dims]
    out = []
    for r in range(replicas):
        sub = grouped[r * group: (r + 1) * group]
        if group > 1:
            # fold the grouped batch extent into the model axis: move the
            # group dim to just before model, then merge the two
            m = rest_names.index("model")
            sub = np.moveaxis(sub, 0, m)
            shape = list(sub.shape)
            shape[m: m + 2] = [shape[m] * shape[m + 1]]
            sub = sub.reshape(shape)
        else:
            sub = sub[0]
        # re-expand to the full axis-name set with batch axes at size 1
        final = [1] * len(names)
        for i, name in enumerate(names):
            if i not in batch_dims:
                final[i] = sub.shape[rest_names.index(name)]
        sub_mesh = Mesh(torch.as_tensor(sub.reshape(final)), mesh.device)
        sub_mesh.slice_index = r  # the replica's (a fleet host's) global index
        out.append(sub_mesh)
    return out


class ReplicaScheduler:
    """Least-loaded-first routing over N replicas, with optional prefix affinity.

    Load is supplied by the caller per decision (the engine's token-weighted
    ``load()``; ints or floats both rank); ties break toward the lowest
    index, so an idle fleet fills in order. ``affinity_tokens > 0`` steers
    requests sharing their first ``affinity_tokens`` prompt tokens to the
    replica that last served that prefix, whose pool already holds it,
    unless that replica is more than ``affinity_margin`` load units busier
    than the least-loaded one. The affinity maps are bounded LRUs.
    """

    def __init__(
        self,
        replicas: int,
        *,
        affinity_tokens: int = 0,
        affinity_margin: int = 2,
        affinity_capacity: int = 4096,
        tenant_affinity_capacity: int = 1024,
    ):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if affinity_tokens < 0 or affinity_margin < 0 or affinity_capacity < 1:
            raise ValueError("affinity knobs must be non-negative (capacity >= 1)")
        if tenant_affinity_capacity < 1:
            raise ValueError("tenant_affinity_capacity must be >= 1")
        self.replicas = replicas
        self.affinity_tokens = affinity_tokens
        self.affinity_margin = affinity_margin
        self._affinity_capacity = affinity_capacity
        self._affinity: "OrderedDict[Tuple[int, ...], int]" = OrderedDict()
        #: tenant session affinity: tenant id -> the replica that last served
        #: it (its radix tier holds the tenant's recent sessions)
        self._tenant_affinity_capacity = tenant_affinity_capacity
        self._tenant_affinity: "OrderedDict[str, int]" = OrderedDict()
        self._lock = threading.Lock()
        #: routing telemetry: submissions per replica, and how many rode the
        #: affinity maps rather than plain load order
        self.submitted = [0] * replicas
        self.affinity_hits = 0
        self.tenant_affinity_hits = 0

    def _key(self, prompt: Optional[Sequence[int]]) -> Optional[Tuple[int, ...]]:
        if not self.affinity_tokens or prompt is None:
            return None
        if len(prompt) < self.affinity_tokens:
            return None  # shorter than the affinity window: nothing shared to exploit
        return tuple(int(t) for t in prompt[: self.affinity_tokens])

    def resize(self, replicas: int) -> None:
        """Track a fleet resize at the tail: kept indexes keep their counts;
        affinity entries pointing past the new count are dropped."""
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        with self._lock:
            if replicas > len(self.submitted):
                self.submitted.extend([0] * (replicas - len(self.submitted)))
            else:
                del self.submitted[replicas:]
                self._affinity = OrderedDict((key, idx) for key, idx in self._affinity.items() if idx < replicas)
                self._tenant_affinity = OrderedDict(
                    (t, idx) for t, idx in self._tenant_affinity.items() if idx < replicas
                )
            self.replicas = replicas

    def order(
        self,
        loads: Sequence[float],
        prompt: Optional[Sequence[int]] = None,
        cached: Optional[Sequence[int]] = None,
        breaching: Optional[Sequence[bool]] = None,
        deprioritized: Optional[Sequence[bool]] = None,
        tenant: Optional[str] = None,
    ) -> "Tuple[List[int], Any]":
        """``(indices to try best-first, head flag)``: the caller walks the
        list past full replicas; the flag is ``True`` when the head came from
        prefix affinity, ``"tenant"`` from tenant affinity, else ``False``.

        ``cached`` (per-replica radix probes) takes precedence over the LRU
        keys; ``breaching`` and ``deprioritized`` (SLO breach, a prefill
        role) sort those replicas below every other and keep them from
        heading by affinity, while leaving them in the walk."""
        avoid = (
            [bool(flag) for flag in breaching]
            if breaching is not None and len(breaching) == len(loads)
            else [False] * len(loads)
        )
        if deprioritized is not None and len(deprioritized) == len(loads):
            avoid = [a or bool(d) for a, d in zip(avoid, deprioritized)]
        ranked = sorted(range(len(loads)), key=lambda i: (avoid[i], loads[i], i))
        if cached is not None and len(cached) == len(loads) and max(cached, default=0) > 0:
            candidates = [i for i in range(len(loads)) if cached[i] > 0 and not avoid[i]]
            if candidates:
                preferred = min(candidates, key=lambda i: (-cached[i], loads[i], i))
                if loads[preferred] <= loads[ranked[0]] + self.affinity_margin:
                    return [preferred] + [i for i in ranked if i != preferred], True
            return self._tenant_head(ranked, loads, avoid, tenant)
        key = self._key(prompt)
        if key is not None:
            with self._lock:
                preferred = self._affinity.get(key)
            if (
                preferred is not None
                and not avoid[preferred]
                and loads[preferred] <= loads[ranked[0]] + self.affinity_margin
            ):
                return [preferred] + [i for i in ranked if i != preferred], True
        return self._tenant_head(ranked, loads, avoid, tenant)

    def _tenant_head(
        self, ranked: "List[int]", loads: Sequence[float], avoid: "List[bool]", tenant: Optional[str]
    ) -> "Tuple[List[int], Any]":
        """The tenant-session-affinity fallback head (see :meth:`order`)."""
        if tenant is None or not ranked:
            return ranked, False
        with self._lock:
            preferred = self._tenant_affinity.get(tenant)
        if (
            preferred is not None
            and preferred < len(loads)
            and not avoid[preferred]
            and loads[preferred] <= loads[ranked[0]] + self.affinity_margin
        ):
            return [preferred] + [i for i in ranked if i != preferred], "tenant"
        return ranked, False

    def note(
        self, replica: int, prompt: Optional[Sequence[int]] = None, *, affinity: Any = False,
        tenant: Optional[str] = None,
    ) -> None:
        """Record a successful routing decision (updates the affinity maps);
        ``affinity`` is :meth:`order`'s head flag when this replica headed."""
        key = self._key(prompt)
        with self._lock:
            if replica >= len(self.submitted):
                # a routing snapshot can outlive a concurrent resize
                self.submitted.extend([0] * (replica + 1 - len(self.submitted)))
            self.submitted[replica] += 1
            if affinity == "tenant":
                self.tenant_affinity_hits += 1
            elif affinity:
                self.affinity_hits += 1
            if key is not None:
                self._affinity[key] = replica
                self._affinity.move_to_end(key)
                while len(self._affinity) > self._affinity_capacity:
                    self._affinity.popitem(last=False)
            if tenant is not None:
                self._tenant_affinity[tenant] = replica
                self._tenant_affinity.move_to_end(tenant)
                while len(self._tenant_affinity) > self._tenant_affinity_capacity:
                    self._tenant_affinity.popitem(last=False)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "policy": "least-loaded",
                "submitted": list(self.submitted),
                "affinity_tokens": self.affinity_tokens,
                "affinity_hits": self.affinity_hits,
                "affinity_entries": len(self._affinity),
                "tenant_affinity_hits": self.tenant_affinity_hits,
                "tenant_affinity_entries": len(self._tenant_affinity),
            }


class _Placement:
    """Where a fleet's replicas live and what each device serves: the
    devices in round-robin order, and per device the model (the original on
    its own device, one copy on each other) and its ``GenerationConfig``
    (a speculative draft copied beside the model)."""

    def __init__(self, model: Any, config: Any, quantize: Optional[str], devices: Optional[Sequence[Any]]):
        own = module_device(model) or resolve_device(None)
        if devices is None:
            devices = [own]
            if own.type == "cuda":
                devices += [d for d in (torch.device("cuda", i) for i in range(torch.cuda.device_count())) if d != own]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a ReplicaSet needs at least one device")
        self.quantize = quantize
        self._served: Dict[torch.device, Tuple[Any, Any]] = {own: (model, config)}
        self._lock = threading.Lock()

    def generator(self, index: int) -> Generator:
        """A Generator for replica ``index``, on ``devices[index % len]``."""
        device = self.devices[index % len(self.devices)]
        with self._lock:
            if device not in self._served:
                model, config = next(iter(self._served.values()))
                # a pre-quantized (int8) module is copied as it is: the JAX
                # package dequantizes and re-quantizes per replica, an exact
                # round trip, so skipping it changes no weight
                if config.draft is not None:
                    draft = config.draft
                    config = dataclasses.replace(
                        config, draft=dataclasses.replace(draft, module=copy.deepcopy(draft.module).to(device))
                    )
                self._served[device] = (copy.deepcopy(model).to(device), config)
            model, config = self._served[device]
        # quantize is idempotent on an int8 module: a shared one stays as it is
        return Generator(model, config, device=device, quantize=self.quantize)


class _NoSpare:
    """The placement of replicas over one TP-only mesh: there is no other
    submesh to scale onto."""

    devices: "List[Any]" = []

    def generator(self, index: int) -> Generator:
        raise RuntimeError(
            "no spare submesh to place a new replica on (the mesh is fully "
            "occupied); build with fewer initial replicas to keep headroom"
        )


class _MeshPlacement:
    """The placement of a fleet over a dp mesh: replica ``i`` serves on
    submesh ``i`` of :func:`slice_mesh`, and a port rank holds the one it is
    part of (``index``). ``active`` counts the fleet's replicas: a
    scale-down parks the submeshes from ``active`` on (their ranks close
    their replica and keep its weights), and a scale-up builds the replica
    again on its revisited submesh."""

    devices: "List[Any]" = []

    def __init__(self, model: Any, config: Any, partition_rules: Any, quantize: Optional[str], index: int,
                 submesh: Any, slices: int):
        self.model, self.config, self.partition_rules, self.quantize = model, config, partition_rules, quantize
        self.index, self.submesh, self.slices = index, submesh, slices
        self.active = slices

    def generator(self, index: int) -> Generator:
        """A new Generator for this rank's replica (``index``, the only one
        it can build) on its submesh: the weights gathered back whole over
        the submesh they were cut on (every rank of it calls this at the
        same point) and cut again."""
        from unionml_tpu_torch.parallel.sharding import unplace_module

        unplace_module(self.model)
        if self.config.draft is not None:
            unplace_module(self.config.draft.module)
        return Generator(self.model, self.config, mesh=self.submesh, partition_rules=self.partition_rules,
                         quantize=self.quantize)


class ReplicaSet:
    """N :class:`ContinuousBatcher` replicas behind one scheduler.

    >>> rs = ReplicaSet.build(model, gen_config, replicas=2, slots=4, decode_chunk=8, block_size=16)
    >>> for chunk in rs.submit([1, 5, 9]):
    ...     ...
    >>> rs.close()

    Engine knobs (``slots``, ``decode_chunk``, ``block_size``,
    ``pool_blocks``, ``max_waiting``, ``admit_chunk``/``prefill_budget``/
    ``max_admissions``, ``prefix_cache``, ``slo``, ``tenancy``, ``trace``
    and ``prefix``) apply per replica; a shared ``prefix`` (token ids or a
    ``PrefixCache`` from ``cache_prefix``) is prefilled once per replica.
    ``roles`` (``{"prefill": 1, "decode": 3}``, a per-replica list, or the
    ``serve --replica-roles`` export) splits the fleet into a prefill and a
    decode tier with KV handoff between them; ``prefill_threshold`` is the
    prompt length that takes that path; ``autoscale`` (a watermark dict,
    ``None`` = the ``UNIONML_TPU_AUTOSCALE_*`` exports, ``False`` = off)
    arms the resize loop around :meth:`scale_to`.
    """

    def __init__(
        self,
        generators: Optional[Sequence[Any]] = None,
        *,
        engines: Optional[Sequence[Any]] = None,
        slots: int = 4,
        decode_chunk: int = 8,
        prefix: Optional[Any] = None,
        block_size: Optional[int] = None,
        pool_blocks: Optional[int] = None,
        max_waiting: Optional[int] = None,
        admit_chunk: Optional[int] = None,
        prefill_budget: Optional[int] = None,
        max_admissions: Optional[int] = None,
        affinity_tokens: int = 0,
        affinity_margin: int = 2,
        trace: Optional[bool] = None,
        prefix_cache: Optional[bool] = None,
        slo: Optional[Any] = None,
        roles: Optional[Any] = None,
        prefill_threshold: Optional[int] = None,
        autoscale: Optional[Any] = None,
        tenancy: Optional[Any] = None,
        aot: Optional[Any] = None,
    ):
        if (generators is None) == (engines is None):
            raise ValueError("pass exactly one of generators= or engines=")
        prefix_tokens = self._prefix_tokens(prefix) if generators is not None else None
        count = len(list(engines)) if engines is not None else len(list(generators))
        self._roles = self._resolve_roles(roles, count)
        has_roles = any(r != "mixed" for r in self._roles)
        #: engine knobs kept for scale-up: a new replica is built exactly as
        #: its siblings (the KV handoff needs identical geometry)
        self._engine_kwargs = dict(
            slots=slots, decode_chunk=decode_chunk, block_size=block_size, pool_blocks=pool_blocks,
            max_waiting=max_waiting, admit_chunk=admit_chunk, prefill_budget=prefill_budget,
            max_admissions=max_admissions, trace=trace, prefix_cache=prefix_cache, slo=slo, tenancy=tenancy,
            aot=aot,
        )
        self._prefix_tokens_saved = prefix_tokens
        if engines is not None:
            self._batchers: "List[Any]" = list(engines)
            if has_roles:
                for batcher, role in zip(self._batchers, self._roles):
                    batcher.role = role
        else:
            self._batchers = []
            try:
                for gen, role in zip(generators, self._roles):
                    self._batchers.append(self._new_engine(gen, role if has_roles else None))
            except BaseException:
                for batcher in self._batchers:
                    batcher.close(wait=False)
                raise
        if not self._batchers:
            raise ValueError("a ReplicaSet needs at least one replica")
        self._scheduler = ReplicaScheduler(
            len(self._batchers), affinity_tokens=affinity_tokens, affinity_margin=affinity_margin
        )
        #: counter and snapshot granular: routing never waits behind a drain
        self._lock = threading.Lock()
        #: serializes resizes (scale_to callers and the autoscaler thread)
        self._scale_lock = threading.Lock()
        if prefill_threshold is None:
            prefill_threshold = serve_prefill_threshold()
        if prefill_threshold < 0:
            raise ValueError("prefill_threshold must be >= 0")
        #: prompts at least this long take the prefill -> decode handoff
        #: (0 = every admission, once roles exist)
        self._prefill_threshold = int(prefill_threshold)
        #: where build()/from_generator() place replicas; None = scale_to can
        #: only shrink (a set of pre-made generators or engines)
        self._placement: Optional[_Placement] = None
        #: fleet-level sheds: a deadline expired before routing, and prompts
        #: turned away because every replica's queue was full
        self.shed_deadline = 0
        self.shed_queue_full = 0
        #: routing decisions that walked past an SLO-breaching replica
        self.breach_avoided = 0
        #: admissions sent down the handoff path, and warm multi-turn prompts
        #: admitted directly on a decode replica whose radix cache held them
        self.handoff_routes = 0
        self.handoff_shortcuts = 0
        #: replicas added and removed; each counts under the lock that
        #: changes the fleet, so no reader sees a new size beside an old count
        self.scaled_up = 0
        self.scaled_down = 0
        self._autoscale: "Optional[Dict[str, Any]]" = None
        self._autoscale_stop = threading.Event()
        self._autoscale_thread: Optional[threading.Thread] = None
        if autoscale is None:
            high = serve_autoscale_high()
            if high > 0:
                self.configure_autoscaler(
                    high=high, low=serve_autoscale_low(), interval_s=serve_autoscale_interval_s(),
                    min_replicas=serve_min_replicas(), max_replicas=serve_max_replicas(),
                )
        elif autoscale is not False:
            if not isinstance(autoscale, dict):
                raise TypeError(
                    f"autoscale must be a dict of watermarks, None (read the "
                    f"UNIONML_TPU_AUTOSCALE_* exports) or False, got {type(autoscale).__name__}"
                )
            self.configure_autoscaler(**autoscale)

    @staticmethod
    def _prefix_tokens(prefix: Optional[Any]) -> "Optional[List[int]]":
        if prefix is None:
            return None
        tokens = getattr(prefix, "tokens", prefix)  # PrefixCache or raw ids
        if tokens is None:
            raise ValueError(
                "a shared prefix for a ReplicaSet needs its token ids (build it with "
                "cache_prefix(...) or pass the ids directly); hand-built PrefixCaches "
                "cannot be re-prefilled per replica"
            )
        return [int(t) for t in tokens]

    @staticmethod
    def _resolve_roles(roles: Optional[Any], count: int) -> "List[str]":
        """Per-replica roles from a ``{role: count}`` dict, a per-replica
        list, or (``None``) the ``serve --replica-roles`` export. An explicit
        spec that does not cover the fleet raises; the export warns and falls
        back to an all-mixed fleet. Expansion order is prefill, decode,
        mixed, so scale-down (at the tail) drains capacity before the
        prefill tier."""
        strict = roles is not None
        if roles is None:
            roles = serve_replica_roles() or None
        if roles is None:
            return ["mixed"] * count
        if isinstance(roles, dict):
            bad = [r for r in roles if r not in REPLICA_ROLES]
            if bad:
                raise ValueError(f"unknown replica roles {bad}; expected {REPLICA_ROLES}")
            expanded: "List[str]" = []
            for role in ("prefill", "decode", "mixed"):
                expanded.extend([role] * int(roles.get(role, 0)))
        else:
            expanded = [str(r) for r in roles]
            bad = [r for r in expanded if r not in REPLICA_ROLES]
            if bad:
                raise ValueError(f"unknown replica roles {bad}; expected {REPLICA_ROLES}")
        problem = None
        if len(expanded) != count:
            problem = f"replica roles {expanded} cover {len(expanded)} replicas but the fleet has {count}"
        elif expanded and all(r == "prefill" for r in expanded):
            problem = (
                "an all-prefill fleet has nowhere to hand decode work off to; "
                "include at least one decode or mixed replica"
            )
        if problem:
            if strict:
                raise ValueError(problem)
            logger.warning(f"ignoring {problem}; falling back to a symmetric (all-mixed) fleet")
            return ["mixed"] * count
        return expanded

    def _new_engine(self, gen: Any, role: Optional[str]) -> Any:
        """One replica's engine: construction and scale-up build through
        here, so every replica has its siblings' knobs."""
        prefix_tokens = self._prefix_tokens_saved
        return ContinuousBatcher._single(
            gen, prefix=gen.cache_prefix(prefix_tokens) if prefix_tokens else None, role=role, **self._engine_kwargs
        )

    # ------------------------------------------------------------------ construction

    @classmethod
    def build(
        cls,
        model: Any,
        config: Any,
        *,
        mesh: Optional[Any] = None,
        partition_rules: Optional[Any] = None,
        quantize: Optional[str] = None,
        replicas: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
        **engine_kwargs: Any,
    ) -> "ReplicaSet":
        """Build per-replica Generators and engines over one model.
        ``replicas`` defaults to the ``serve --dp-replicas`` export, else the
        ``--replica-roles`` total (or the ``roles=`` kwarg's), else 1.

        With a dp>1 ``mesh`` (from ``MeshSpec(...).build()`` or
        ``build_hybrid()``) the build is process-aware, as the JAX package's
        is over a mesh that spans hosts: every rank slices the mesh
        (:func:`slice_mesh`) and builds only the replica whose submesh holds
        it, its ranks serving it as one TP engine (the first rank leads, the
        others follow; see :mod:`unionml_tpu_torch.serving.mesh`). Routing
        across replicas is then :class:`~unionml_tpu_torch.serving.cluster.FleetCoordinator`'s.
        A port process is one rank, so a rank's host-local extent is one
        submesh: ``replicas`` above 1 raises. :meth:`scale_to` then counts
        the fleet's replicas, every rank calling it at the same point: a
        scale-down parks the tail submeshes (their ranks close their
        replica), and a scale-up builds each parked replica again on the
        submesh it left, which an AOT store (``aot=``) has seen.

        Without a dp mesh the replicas are placed round-robin over
        ``devices`` (default: the model's device, then every other visible
        CUDA device when it is on one); replicas beyond the device count
        share devices, and their weights. A TP-only ``mesh`` of one rank
        serves each replica over it; over several ranks one replica only,
        since replicas there would run their collectives on the same groups
        from several engine threads."""
        if replicas is None:
            replicas = serve_dp_replicas() or None
        if replicas is None:
            # a role spec implies its own fleet size (prefill=1,decode=3 = 4)
            roles_kw = engine_kwargs.get("roles")
            if isinstance(roles_kw, dict):
                replicas = sum(roles_kw.values()) or None
            elif isinstance(roles_kw, (list, tuple)):
                replicas = len(roles_kw) or None
            elif roles_kw is None:
                replicas = sum(serve_replica_roles().values()) or None
        if mesh is None:
            placement = _Placement(model, config, quantize, devices)
            if (replicas or 1) > len(placement.devices):
                logger.warning(
                    f"ReplicaSet: {replicas} replicas over {len(placement.devices)} devices; replicas beyond the "
                    "device count share devices round-robin"
                )
            rs = cls([placement.generator(i) for i in range(replicas or 1)], **engine_kwargs)
            rs._placement = placement
            return rs
        if dp_extent(mesh) > 1:
            all_submeshes = slice_mesh(mesh)
            local = process_local_submeshes(all_submeshes)
            if not local:
                raise ValueError(
                    "no replica submesh of this mesh is local to this process — "
                    "put the replica axes (dcn_data/data) on DCN "
                    "(MeshSpec.build_hybrid) so each batch slice stays host-local"
                )
            logger.info(
                f"multi-process mesh: this host owns replica submeshes "
                f"{[index for index, _ in local]} of {len(all_submeshes)}"
            )
            extent = len(local)
            if replicas is None:
                replicas = extent
            if replicas > extent:
                raise ValueError(
                    f"replicas ({replicas}) exceed the mesh's host-local data-parallel extent ({extent}); "
                    "a dp mesh cannot host more replicas than batch slices"
                )
            submeshes = [sub for _, sub in local][:replicas]
            placement = _MeshPlacement(model, config, partition_rules, quantize, local[0][0], local[0][1],
                                       len(all_submeshes))
        elif replicas is None or replicas == 1:
            submeshes = [mesh]
        elif mesh.devices == 1:
            logger.warning(
                f"ReplicaSet.build: {replicas} replicas over one TP-only mesh share "
                "its devices (time-sliced); add a data axis to give each replica its own chips"
            )
            submeshes = [mesh] * replicas
        else:
            raise ValueError(
                f"{replicas} replicas over one TP-only mesh of {mesh.devices} ranks would run their collectives on "
                "the same groups from several engine threads; add a data axis to give each replica its own ranks"
            )
        generators = [Generator(model, config, mesh=sm, partition_rules=partition_rules, quantize=quantize)
                      for sm in submeshes]
        rs = cls(generators, **engine_kwargs)
        rs._placement = placement if dp_extent(mesh) > 1 else _NoSpare()
        return rs

    @classmethod
    def from_generator(
        cls, generator: Any, *, replicas: Optional[int] = None, devices: Optional[Sequence[Any]] = None,
        **engine_kwargs: Any,
    ) -> "ReplicaSet":
        """Re-host an existing Generator's model as a replica set (the
        ``ContinuousBatcher`` delegation path); a pre-quantized model
        replicates as it is. A Generator over a dp mesh cut the model to its
        shards there: each leaf is gathered back whole over that mesh (every
        rank calls this at the same point) and cut again to the replica's
        submesh."""
        mesh = generator.mesh
        if mesh is not None:
            from unionml_tpu_torch.parallel.sharding import unplace_module

            unplace_module(generator.model)
            if generator.config.draft is not None:
                # a draft that served over the dp mesh was cut there too (a
                # no-op otherwise); each replica cuts it again to its submesh
                unplace_module(generator.config.draft.module)
        return cls.build(
            generator.model, generator.config, mesh=mesh, partition_rules=generator.partition_rules,
            quantize=generator.quantize, replicas=replicas, devices=devices, **engine_kwargs,
        )

    # ------------------------------------------------------------------ public API

    @property
    def replicas(self) -> int:
        with self._lock:
            return len(self._batchers)

    @property
    def batchers(self) -> "Tuple[Any, ...]":
        """The per-replica engines (a read-only snapshot)."""
        with self._lock:
            return tuple(self._batchers)

    def submit(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: Optional[int] = None,
        constraint: Optional[int] = None,
        deadline: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[Any] = None,
        export_handoff: bool = False,
        logprobs: bool = False,
    ) -> "Iterator[np.ndarray]":
        """Route a prompt to the least-loaded replica (affinity permitting)
        and return its engine's token stream; shed with
        :class:`DeadlineExceeded` if the deadline already expired, and with
        :class:`QueueFullError` only when every replica's queue is full.
        With roles configured, a prompt of at least ``prefill_threshold``
        tokens takes the handoff path (logprobs requests admit directly: the
        logprob column does not ride the payload); ``export_handoff`` runs
        only a prefill here and leaves the payload on the stream."""
        req_trace = current_trace()
        if expired(deadline):
            with self._lock:
                self.shed_deadline += 1
            if req_trace is not None:
                req_trace.event("engine.shed_deadline", phase="routing")
            raise DeadlineExceeded("deadline expired before the prompt was routed to a replica")
        with self._lock:
            batchers = list(self._batchers)
            roles = list(self._roles)
        if not batchers:
            raise RuntimeError("this rank's replica is scaled down: submit to a rank of a replica that serves")
        kw = dict(max_new_tokens=max_new_tokens, constraint=constraint, deadline=deadline, tenant=tenant,
                  priority=priority)
        if export_handoff:
            return self._submit_export(batchers, roles, prompt, **kw)
        if any(role == "prefill" for role in roles) and not logprobs:
            stream = self._submit_disaggregated(batchers, roles, prompt, req_trace=req_trace, **kw)
            if stream is not None:
                return stream
        return self._submit_routed(batchers, roles, prompt, req_trace=req_trace, logprobs=logprobs, **kw)

    def _submit_routed(
        self, batchers: "List[Any]", roles: "List[str]", prompt: Sequence[int], *, req_trace: Any,
        logprobs: bool = False, **kw: Any,
    ) -> "Iterator[np.ndarray]":
        """The least-loaded walk over a resize-stable snapshot. Prefill-role
        replicas sort last but stay in the walk, so a saturated decode tier
        degrades onto them rather than shedding."""
        tenant = kw["tenant"]
        # tenant affinity is a routing concern: the kwarg, else the contextvar the HTTP layer bound
        route_tenant = tenant if tenant is not None else current_tenant()
        loads = [batcher.load() for batcher in batchers]
        cached = None
        if any(getattr(b, "_radix", None) is not None for b in batchers):
            cached = [int(getattr(b, "cached_prefix_tokens", lambda _p: 0)(prompt)) for b in batchers]
        breaching = None
        if any(callable(getattr(b, "health", None)) for b in batchers):
            breaching = [
                callable(getattr(b, "health", None)) and b.health().get("state") == "breach" for b in batchers
            ]
        deprioritized = [role == "prefill" for role in roles] if any(role == "prefill" for role in roles) else None
        order, affinity_head = self._scheduler.order(loads, prompt, cached, breaching, deprioritized,
                                                     tenant=route_tenant)
        if breaching is not None and any(breaching):
            # pure load order would have picked this replica; health demoted it
            pure_head = min(range(len(loads)), key=lambda i: (loads[i], i))
            if breaching[pure_head] and order and order[0] != pure_head:
                with self._lock:
                    self.breach_avoided += 1
        last_exc: Optional[QueueFullError] = None
        for replica in order:
            if req_trace is not None:
                req_trace.event(
                    "engine.routed", replica=replica, load=round(loads[replica], 3),
                    affinity=bool(affinity_head) and replica == order[0],
                    breaching=bool(breaching[replica]) if breaching is not None else False,
                )
            try:
                stream = batchers[replica].submit(prompt, logprobs=logprobs, **kw)
            except TenantThrottled:
                # every replica shares the tenant registry: walking on could
                # only re-shed, so the bucket's Retry-After propagates intact
                raise
            except QueueFullError as exc:
                last_exc = exc
                continue
            self._scheduler.note(
                replica, prompt, affinity=affinity_head if replica == order[0] else False, tenant=route_tenant
            )
            return stream
        with self._lock:
            self.shed_queue_full += 1
        if req_trace is not None:
            req_trace.event("engine.shed_queue_full", replicas=len(batchers))
        raise QueueFullError(f"all {len(batchers)} replicas' waiting queues are full") from last_exc

    # ------------------------------------------------------------- disaggregation

    def _submit_export(
        self, batchers: "List[Any]", roles: "List[str]", prompt: Sequence[int], **kw: Any
    ) -> "Iterator[np.ndarray]":
        """An EXPORT prefill on this fleet (prefill replicas first, then least
        loaded): the stream carries the payload for another fleet's decode
        replica, and this fleet never takes the residency."""
        rank = {"prefill": 0, "mixed": 1, "decode": 2}
        loads = [batcher.load() for batcher in batchers]
        order = sorted(range(len(batchers)), key=lambda i: (rank.get(roles[i], 1), loads[i], i))
        last_exc: Optional[QueueFullError] = None
        for replica in order:
            try:
                stream = batchers[replica].submit(prompt, export_handoff=True, **kw)
            except TenantThrottled:
                raise
            except QueueFullError as exc:
                last_exc = exc
                continue
            self._scheduler.note(replica, prompt)
            return stream
        with self._lock:
            self.shed_queue_full += 1
        raise QueueFullError(f"all {len(batchers)} replicas' waiting queues are full") from last_exc

    def import_handoff(self, payload: Dict[str, Any]) -> "Iterator[np.ndarray]":
        """Adopt an exported prefill on this fleet's best decode replica
        (decode, then mixed, then prefill)."""
        return self._import_payload(payload, current_trace())

    def _submit_disaggregated(
        self, batchers: "List[Any]", roles: "List[str]", prompt: Sequence[int], *, req_trace: Any, **kw: Any
    ) -> "Optional[Iterator[np.ndarray]]":
        """The prefill -> decode handoff path; None = not applicable (a short
        prompt, no prefill/decode pair, or every prefill replica full): the
        caller falls back to the plain walk, so disaggregation redirects
        work and never sheds it."""
        prefills = [i for i, role in enumerate(roles) if role == "prefill"]
        targets = [i for i, role in enumerate(roles) if role == "decode"] or [
            i for i, role in enumerate(roles) if role == "mixed"
        ]
        if not prefills or not targets or len(prompt) < self._prefill_threshold:
            return None
        loads = [batcher.load() for batcher in batchers]
        tenant = kw["tenant"]
        # warm multi-turn shortcut: a decode replica whose radix cache covers
        # most of this prompt admits it directly; its gather replaces the
        # prefill a prefill replica would re-run
        warm = [
            (int(getattr(batchers[t], "cached_prefix_tokens", lambda _p: 0)(prompt)), -loads[t], t)
            for t in targets
            if getattr(batchers[t], "_radix", None) is not None
        ]
        if warm:
            cached_len, _, warm_t = max(warm)
            # direct when the cache covers MORE than half the prompt (or the
            # uncached suffix is under the threshold)
            suffix = len(prompt) - cached_len
            if cached_len > 0 and suffix < max(self._prefill_threshold, (len(prompt) + 1) // 2):
                try:
                    stream = batchers[warm_t].submit(prompt, **kw)
                except TenantThrottled:
                    raise
                except QueueFullError:
                    pass
                else:
                    if req_trace is not None:
                        req_trace.event(
                            "engine.routed", replica=warm_t, load=round(loads[warm_t], 3), role=roles[warm_t],
                            cached=cached_len,
                        )
                    self._scheduler.note(warm_t, prompt, tenant=tenant if tenant is not None else current_tenant())
                    with self._lock:
                        self.handoff_shortcuts += 1
                    return stream
        for p in sorted(prefills, key=lambda i: (loads[i], i)):
            if req_trace is not None:
                req_trace.event("engine.routed", replica=p, load=round(loads[p], 3), role="prefill")
            try:
                pstream = batchers[p].submit(prompt, export_handoff=True, **kw)
            except TenantThrottled:
                raise
            except QueueFullError:
                continue
            self._scheduler.note(p, prompt)
            with self._lock:
                self.handoff_routes += 1
            return self._relay(pstream, req_trace)
        return None  # every prefill replica full: degrade to the plain walk

    def _relay(self, pstream: Any, req_trace: Any) -> "Iterator[np.ndarray]":
        """One consumer-facing iterator over the prefill replica's one-token
        export stream, then the decode replica's stream. Closing the relay
        closes whichever leg is active."""
        active = pstream
        try:
            for item in pstream:
                yield item
            payload = pstream.handoff
            if payload is None:
                return  # finished at the prompt-sampled token
            dstream = self._import_payload(payload, req_trace)
            active = dstream
            for item in dstream:
                yield item
        finally:
            try:
                active.close()
            except Exception:  # pragma: no cover - defensive
                pass

    def _import_payload(self, payload: Dict[str, Any], req_trace: Any) -> Any:
        """Land an exported prefill on the best live replica (decode, mixed,
        prefill; a quiescing or closed replica is walked past, so a resize
        mid-relay re-targets instead of failing)."""
        with self._lock:
            batchers = list(self._batchers)
            roles = list(self._roles)
        rank = {"decode": 0, "mixed": 1, "prefill": 2}
        loads = [batcher.load() for batcher in batchers]
        order = sorted(range(len(batchers)), key=lambda i: (rank.get(roles[i], 1), loads[i], i))
        last_exc: Optional[BaseException] = None
        for t in order:
            try:
                stream = batchers[t].import_handoff(payload)
            except (QueueFullError, RuntimeError) as exc:
                last_exc = exc
                continue
            if req_trace is not None:
                req_trace.event("engine.routed", replica=t, load=round(loads[t], 3), role=roles[t], handoff=True)
            # the DECODE replica holds the session's KV now: tenant affinity records it
            self._scheduler.note(t, payload.get("prompt"), tenant=payload.get("tenant"))
            return stream
        raise RuntimeError(f"no replica of {len(batchers)} could adopt the handed-off prefill") from last_exc

    def warmup(self) -> None:
        """Warm every replica (each engine's ``warmup``) concurrently."""
        from concurrent.futures import ThreadPoolExecutor

        batchers = self.batchers
        with ThreadPoolExecutor(max_workers=len(batchers)) as pool:
            list(pool.map(lambda batcher: batcher.warmup(), batchers))  # list(): the first failure propagates

    def load(self) -> float:
        """Aggregate token-weighted load."""
        return sum(batcher.load() for batcher in self.batchers)

    def cached_prefix_tokens(self, prompt: Sequence[int]) -> int:
        """Longest radix-cached run of ``prompt`` across the replicas (0 with
        no prefix caches)."""
        best = 0
        for batcher in self.batchers:
            probe = getattr(batcher, "cached_prefix_tokens", None)
            if callable(probe):
                best = max(best, int(probe(prompt)))
        return best

    def health(self) -> Dict[str, Any]:
        """Fleet health (observability/health.py): mean and worst replica
        scores and the worst SLO state, the ``GET /healthz`` body."""
        from unionml_tpu_torch.observability.health import fleet_health

        return fleet_health(self)

    def configure_slo(self, config: Any, replica: Optional[int] = None) -> None:
        """Swap SLO targets on every replica (or just ``replica``)."""
        batchers = self.batchers
        for batcher in batchers if replica is None else [batchers[replica]]:
            batcher.configure_slo(config)

    # ------------------------------------------------------------------ elasticity

    @property
    def roles(self) -> "List[str]":
        """Per-replica roles, index-aligned with :attr:`batchers`."""
        with self._lock:
            return list(self._roles)

    def scale_to(self, n: int, *, role: Optional[str] = None, timeout: float = 120.0) -> int:
        """Resize the fleet to ``n`` replicas, returning the new count.
        Scale-up builds a replica on the next device round-robin, warms it
        and only then joins it to the scheduler; ``role`` tags added replicas
        (default ``decode`` in a role-split fleet, else ``mixed``).
        Scale-down unroutes and quiesces the TAIL replica, lets its residents
        and queue finish within ``timeout``, then closes it: no stream is
        lost. Serialized against the autoscaler; safe from any thread."""
        if n < 1:
            raise ValueError("a fleet cannot scale below 1 replica")
        if role is not None and role not in REPLICA_ROLES:
            raise ValueError(f"role must be one of {REPLICA_ROLES}, got {role!r}")
        with self._scale_lock:
            if isinstance(self._placement, _MeshPlacement):
                return self._scale_mesh(n, role, timeout)
            while True:
                with self._lock:
                    cur = len(self._batchers)
                if cur == n:
                    return n
                if n > cur:
                    self._add_replica(role)
                else:
                    self._remove_replica(timeout)

    def _scale_mesh(self, n: int, role: Optional[str], timeout: float) -> int:
        """:meth:`scale_to` over a dp mesh, where ``n`` counts the fleet's
        replicas and every rank of the world calls it at the same point: the
        ranks of replicas ``n`` and above drain and close theirs (they serve
        nothing until a later scale-up), and the ranks of a parked submesh
        below ``n`` build and warm its replica again (the ``_scale_lock``
        holder)."""
        placement = self._placement
        if n > placement.slices:
            raise RuntimeError(
                f"no spare submesh to place replica {n - 1} on (the dp mesh has {placement.slices} batch "
                "slices); build with fewer initial replicas to keep headroom"
            )
        if n <= placement.index < placement.active:
            self._remove_replica(timeout, keep=0)
        elif placement.active <= placement.index < n:
            self._add_replica(role)
        placement.active = n
        return n

    def spare_capacity(self) -> int:
        """Replicas :meth:`scale_to` could add without sharing a device
        beyond round-robin: the length of the device list (placement is
        round-robin, so it never runs out), 0 without a placement (a set of
        pre-made generators or engines)."""
        with self._lock:
            return len(self._placement.devices) if self._placement is not None else 0

    def _add_replica(self, role: Optional[str]) -> None:
        """Build, warm and join one replica (the ``_scale_lock`` holder)."""
        with self._lock:
            placement = self._placement
            if placement is None:
                raise RuntimeError(
                    "scale-up needs the placement a ReplicaSet.build()/from_generator() fleet keeps; this set "
                    "was built from pre-made generators or engines"
                )
            index = len(self._batchers)
            has_roles = any(r != "mixed" for r in self._roles)
        resolved = role or ("decode" if has_roles else "mixed")
        if isinstance(placement, _MeshPlacement):
            index = placement.index
        engine = self._new_engine(placement.generator(index), resolved if (has_roles or role) else None)
        try:
            # warm BEFORE joining the scheduler: no routed request pays the cold start
            engine.warmup()
        except BaseException:
            engine.close(wait=False)
            raise
        with self._lock:
            self._batchers.append(engine)
            self._roles.append(resolved)
            self._scheduler.resize(len(self._batchers))
            self.scaled_up += 1
        logger.info(f"replica {index} joined the fleet (role={resolved})")

    def _remove_replica(self, timeout: float, keep: int = 1) -> None:
        """Unroute, drain and close the tail replica (the ``_scale_lock``
        holder); surviving replicas keep their scheduler indexes. ``keep=0``
        lets a rank over a dp mesh park its only replica."""
        with self._lock:
            if len(self._batchers) <= keep:
                raise ValueError("a fleet cannot scale below 1 replica")
            engine = self._batchers.pop()
            role = self._roles.pop()
            if self._batchers:
                self._scheduler.resize(len(self._batchers))
            self.scaled_down += 1
        # quiesce before draining: a routing snapshot taken before the pop
        # may still hold this engine; its submit now bounces to a sibling
        engine.quiesce()
        deadline = time.monotonic() + max(timeout, 0.0)
        while time.monotonic() < deadline:
            resident, waiting = engine.occupancy()
            if resident == 0 and waiting == 0:
                break
            time.sleep(0.01)
        else:
            resident, waiting = engine.occupancy()
            logger.warning(
                f"scale-down drain timed out with {resident} resident / {waiting} waiting streams; closing anyway "
                "(stragglers finish on the engine thread)"
            )
        engine.close(wait=True, timeout=max(deadline - time.monotonic(), 1.0))
        logger.info(f"replica drained and left the fleet (role={role})")

    # ------------------------------------------------------------------ autoscaler

    def configure_autoscaler(
        self,
        *,
        high: float,
        low: float = 0.0,
        interval_s: float = 10.0,
        min_replicas: int = 1,
        max_replicas: int = 0,
        role: str = "decode",
    ) -> "ReplicaSet":
        """Arm (or retune) the autoscaler: every ``interval_s`` it reads the
        fleet's mean token-weighted ``load()`` (forced over ``high`` while a
        replica's SLO state is breach) and adds a ``role`` replica above
        ``high`` (while ``max_replicas``, 0 = the device count, allows) or
        drains one below ``low`` (never under ``min_replicas``; ``low=0``
        never scales down). :meth:`close` stops and joins its thread."""
        if high <= 0:
            raise ValueError("high watermark must be > 0 (use close/False to disable)")
        if low < 0 or low >= high:
            raise ValueError("low watermark must be in [0, high)")
        if interval_s <= 0 or min_replicas < 1 or max_replicas < 0:
            raise ValueError("interval_s > 0, min_replicas >= 1, max_replicas >= 0 required")
        if role not in REPLICA_ROLES:
            raise ValueError(f"role must be one of {REPLICA_ROLES}, got {role!r}")
        with self._lock:
            self._autoscale = {
                "high": float(high), "low": float(low), "interval_s": float(interval_s),
                "min_replicas": int(min_replicas), "max_replicas": int(max_replicas), "role": role,
            }
            if self._autoscale_thread is None:
                self._autoscale_thread = threading.Thread(target=self._autoscale_loop, daemon=True)
                self._autoscale_thread.start()
        return self

    def _autoscale_pressure(self) -> float:
        """The watermark quantity: mean per-replica load, saturated past the
        high watermark while any replica breaches its SLO."""
        with self._lock:
            batchers = list(self._batchers)
            config = self._autoscale
        load = sum(batcher.load() for batcher in batchers) / max(len(batchers), 1)
        breaching = any(
            callable(getattr(b, "health", None)) and b.health().get("state") == "breach" for b in batchers
        )
        if breaching and config is not None:
            load = max(load, config["high"] + 1.0)
        return load

    def _autoscale_loop(self) -> None:
        while True:
            with self._lock:
                config = self._autoscale
            interval = config["interval_s"] if config is not None else 1.0
            if self._autoscale_stop.wait(interval):
                return
            try:
                self._autoscale_step()
            except Exception:  # pragma: no cover - the loop must survive
                logger.exception("autoscaler step failed")

    def _autoscale_step(self) -> None:
        with self._lock:
            config = self._autoscale
            n = len(self._batchers)
        if config is None:
            return
        pressure = self._autoscale_pressure()
        ceiling = config["max_replicas"] or (n + self.spare_capacity())
        if pressure > config["high"] and n < ceiling and self.spare_capacity() > 0:
            logger.info(f"autoscaler: pressure {pressure:.2f} > high {config['high']:.2f}; scaling {n} -> {n + 1}")
            self.scale_to(n + 1, role=config["role"])
        elif config["low"] > 0 and pressure < config["low"] and n > config["min_replicas"]:
            logger.info(f"autoscaler: pressure {pressure:.2f} < low {config['low']:.2f}; scaling {n} -> {n - 1}")
            self.scale_to(n - 1)

    # ------------------------------------------------------------------ observability

    def tenant_slo(self) -> "Dict[str, Any]":
        """Fleet-wide per-tenant SLO verdicts (the worst replica's entry per
        tenant; ``{}`` when no tenant carries targets)."""
        from unionml_tpu_torch.observability.health import merge_tenant_slo

        return merge_tenant_slo(list(self.batchers))

    def tenant_census(self) -> "Dict[str, Dict[str, int]]":
        """Fleet-wide live per-tenant stream counts, each replica's summed."""
        census: "Dict[str, Dict[str, int]]" = {}
        for batcher in self.batchers:
            fn = getattr(batcher, "tenant_census", None)
            if not callable(fn):
                continue
            for tenant, counts in fn().items():
                entry = census.setdefault(tenant, {"resident": 0, "waiting": 0})
                for key, value in counts.items():
                    entry[key] = entry.get(key, 0) + int(value)
        return census

    def queued_prefill_tokens(self) -> int:
        """Fleet-wide prefill backlog in tokens."""
        return sum(int(getattr(batcher, "queued_prefill_tokens", lambda: 0)()) for batcher in self.batchers)

    def replica_loads(self) -> "List[Dict[str, Any]]":
        """Per-replica occupancy for live gauges (no full stats dict)."""
        with self._lock:
            snapshot = list(zip(self._batchers, self._roles))
        out = []
        for i, (batcher, role) in enumerate(snapshot):
            resident, waiting = batcher.occupancy()
            out.append({
                "replica": i,
                "role": role,
                "resident": resident,
                "waiting": waiting,
                "free_slots": max(int(getattr(batcher, "slots", 0)) - resident, 0),
                "prefill_backlog_tokens": int(getattr(batcher, "queued_prefill_tokens", lambda: 0)()),
                "shed_queue_full": getattr(batcher, "shed_queue_full", 0),
                "shed_deadline": getattr(batcher, "shed_deadline", 0),
            })
        return out

    def stats(self) -> Dict[str, Any]:
        """Fleet snapshot for ``/metrics``, with the JAX package's keys:
        aggregates, the scheduler's routing telemetry, the role census and
        handoff totals (role-split fleets), resize events (once any), and
        each replica's engine stats under ``per_replica``."""
        with self._lock:
            batchers = list(self._batchers)
            roles = list(self._roles)
        per_replica = [batcher.stats() for batcher in batchers]

        def total(key: str) -> int:
            return sum(int(entry.get(key) or 0) for entry in per_replica)

        def section_total(section: str, key: str) -> int:
            return sum(int((entry.get(section) or {}).get(key) or 0) for entry in per_replica)

        def summed(section: str, keys: Sequence[str]) -> Dict[str, Any]:
            """``{section: {key: total}}`` where some replica reports the
            section, else ``{}`` (the section stays absent)."""
            if not any(section in entry for entry in per_replica):
                return {}
            return {section: {key: section_total(section, key) for key in keys}}

        with self._lock:
            shed_deadline, shed_queue_full = self.shed_deadline, self.shed_queue_full
            breach_avoided = self.breach_avoided
            handoff_routes, handoff_shortcuts = self.handoff_routes, self.handoff_shortcuts
            scaled_up, scaled_down = self.scaled_up, self.scaled_down
            autoscale = dict(self._autoscale) if self._autoscale is not None else None
        # the fleet health headline; per-replica detail rides per_replica
        fleet = {key: value for key, value in self.health().items() if key != "replicas"}
        has_roles = any(role != "mixed" for role in roles)
        return {
            "replicas": len(batchers),
            "scheduler": self._scheduler.stats(),
            **(
                {
                    "roles": {role: sum(1 for r in roles if r == role) for role in ("prefill", "decode", "mixed")},
                    "handoffs": {
                        "routed": handoff_routes,
                        "shortcuts": handoff_shortcuts,
                        "exported": section_total("handoff", "exported"),
                        "imported": section_total("handoff", "imported"),
                    },
                }
                if has_roles
                else {}
            ),
            **(
                {
                    "resize": {
                        "scaled_up": scaled_up,
                        "scaled_down": scaled_down,
                        "spare_capacity": self.spare_capacity(),
                        **({"autoscaler": autoscale} if autoscale is not None else {}),
                    }
                }
                if (scaled_up or scaled_down or autoscale is not None)
                else {}
            ),
            "slots": total("slots"),
            "resident": total("resident"),
            "waiting": total("waiting"),
            "admitting": total("admitting"),
            "decode_dispatches": total("decode_dispatches"),
            "decoded_rows": total("decoded_rows"),
            "prefill_chunks": section_total("prefill", "chunks"),
            "prefill_backlog_tokens": section_total("prefill", "backlog_tokens"),
            **summed("prefix_cache", ("hits", "misses", "tokens_avoided", "evictions", "cow_copies",
                                      "cached_blocks", "cached_bytes", "pinned_blocks")),
            **summed("aot", ("programs_loaded", "programs_compiled", "programs_serialized", "load_failures",
                             "serialize_failures")),
            **summed("tenancy", ("shed_tenant_limit", "priority_preemptions")),
            **({"tenant_slo": self.tenant_slo()} if any("tenant_slo" in entry for entry in per_replica) else {}),
            "shed_queue_full": shed_queue_full + total("shed_queue_full"),
            "shed_deadline": shed_deadline + total("shed_deadline"),
            "health": fleet,
            "breach_avoided": breach_avoided,
            "per_replica": per_replica,
        }

    def close(self, wait: bool = True, timeout: float = 120.0) -> None:
        """Stop and join the autoscaler (a resize must not race the
        shutdown), stop admissions fleet-wide, then wait out the drains under
        one shared timeout."""
        self._autoscale_stop.set()
        thread = self._autoscale_thread
        if thread is not None:
            thread.join(timeout=10.0)
        with self._lock:
            batchers = list(self._batchers)
        for batcher in batchers:
            batcher.close(wait=False)
        if wait:
            deadline = time.monotonic() + timeout
            for batcher in batchers:
                batcher.close(wait=True, timeout=max(deadline - time.monotonic(), 0.0))
