"""Deterministic fault injection for the serving fleet, counterpart of
``unionml_tpu/serving/faults.py`` (the same schema, the same seeded draws:
one plan against one fleet fires the same faults at the same virtual
instants in both packages).

The fleet's failure modes — a worker process dying, a control RPC dropped or
delayed by a congested DCN link, a token stream cut mid-flight — are exactly
the events a tier-1 CPU test cannot produce on demand by SIGKILLing
subprocesses at the right microsecond. This module makes them *schedulable*:
a :class:`FaultPlan` is a versioned, seeded list of events keyed on **virtual
time** (seconds since the plan was armed) and **host id**, and an
:class:`ArmedFaultPlan` is the live injector the cluster layer consults at
its transport boundaries (``RemoteHost._call`` / ``_stream_call`` on the
coordinator side, the ``WorkerAgent`` control handler on the worker side).
Every fault a plan fires is reproducible: the same plan against the same
fleet produces the same drops at the same virtual instants, so the lifecycle
state machine (suspect → dead → probation → live), the zero-token stream
retry, and coordinator failover are all pinned by ordinary deterministic
tests.

Event kinds (all windowed — an event is active for ``for_s`` seconds from
its ``t``):

- ``worker_kill`` — the host is unreachable for the window: coordinator-side
  RPCs to it raise :class:`FaultInjected` (a ``ConnectionError``, so the
  lifecycle machinery treats it exactly like a real dead worker);
  worker-side, the control handler drops the connection without answering.
- ``rpc_drop`` — individual control RPCs in the window fail with
  :class:`FaultInjected` (probability ``p`` per call, drawn from the plan's
  seeded RNG — ``p=1.0`` drops every call, deterministically).
- ``rpc_delay`` — RPCs in the window sleep ``delay_s`` before proceeding
  (the slow-scrape case that must cost a retry, not a host).
- ``stream_cut`` — a token stream *started* in the window is severed after
  ``after_tokens`` chunks (0 = before the first token, the retryable case).

Plans are armed via ``serve --fault-plan`` / ``UNIONML_TPU_FAULT_PLAN``
(a path to a plan JSON, or the JSON inline) with the same early-export
contract as every serve knob, or programmatically
(``FleetCoordinator.arm_faults`` / ``WorkerAgent(fault_plan=...)``).
"""

from __future__ import annotations

import json
import random
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import serve_fault_plan

__all__ = [
    "ArmedFaultPlan",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultInjected",
    "FaultPlan",
    "PLAN_VERSION",
    "default_chaos_plan",
]

#: plan schema version: a reader rejects plans from a future schema instead
#: of silently misreading them
PLAN_VERSION = 1

FAULT_KINDS = ("worker_kill", "rpc_drop", "rpc_delay", "stream_cut")


class FaultInjected(ConnectionError):
    """An injected transport failure. A ``ConnectionError`` subclass so every
    existing dead-host path (``_DEAD_ERRORS`` in serving/cluster.py) treats
    it exactly like the real thing — the point of injection is that the
    production machinery cannot tell the difference."""


class FaultEvent:
    """One scheduled fault: ``kind`` at virtual second ``t`` for ``for_s``
    seconds, scoped to ``host`` (``None`` = every host)."""

    __slots__ = ("t", "kind", "host", "for_s", "delay_s", "after_tokens", "p")

    def __init__(
        self,
        t: float,
        kind: str,
        *,
        host: Optional[int] = None,
        for_s: Optional[float] = None,
        delay_s: float = 0.05,
        after_tokens: int = 0,
        p: float = 1.0,
    ):
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; expected one of {FAULT_KINDS}")
        if t < 0:
            raise ValueError(f"fault time must be >= 0 (got {t})")
        if for_s is None:
            for_s = 1.0 if kind == "worker_kill" else 0.25
        if for_s <= 0:
            raise ValueError(f"fault window for_s must be > 0 (got {for_s})")
        if not (0.0 < p <= 1.0):
            raise ValueError(f"fault probability p must be in (0, 1] (got {p})")
        if delay_s < 0 or after_tokens < 0:
            raise ValueError("delay_s and after_tokens must be >= 0")
        self.t = float(t)
        self.kind = kind
        self.host = None if host is None else int(host)
        self.for_s = float(for_s)
        self.delay_s = float(delay_s)
        self.after_tokens = int(after_tokens)
        self.p = float(p)

    def matches(self, host_id: Optional[int]) -> bool:
        return self.host is None or host_id is None or self.host == int(host_id)

    def active_at(self, vnow: float) -> bool:
        return self.t <= vnow < self.t + self.for_s

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"t": self.t, "kind": self.kind, "for_s": self.for_s}
        if self.host is not None:
            out["host"] = self.host
        if self.kind == "rpc_delay":
            out["delay_s"] = self.delay_s
        if self.kind == "stream_cut":
            out["after_tokens"] = self.after_tokens
        if self.p != 1.0:
            out["p"] = self.p
        return out


class FaultPlan:
    """An ordered, seeded schedule of :class:`FaultEvent` s.

    Pure data: parsing and serialization are canonical (sorted events,
    version stamped), and every probabilistic choice an armed plan makes
    rides one ``random.Random(seed)`` — the same plan is the same chaos,
    byte for byte and drop for drop."""

    def __init__(self, events: "Sequence[FaultEvent]", *, seed: int = 0, version: int = PLAN_VERSION):
        if int(version) != PLAN_VERSION:
            raise ValueError(
                f"unsupported fault-plan version {version} (this build reads {PLAN_VERSION})"
            )
        self.version = PLAN_VERSION
        self.seed = int(seed)
        self.events: "List[FaultEvent]" = sorted(
            events, key=lambda e: (e.t, e.kind, -1 if e.host is None else e.host)
        )

    @classmethod
    def parse(cls, spec: "str | Dict[str, Any]") -> "FaultPlan":
        """Build a plan from its JSON text or already-parsed dict; raises
        ``ValueError`` on schema violations (the CLI surfaces it as a usage
        error; the env reader degrades instead)."""
        if isinstance(spec, str):
            try:
                spec = json.loads(spec)
            except ValueError as exc:
                raise ValueError(f"fault plan is not valid JSON: {exc}")
        if not isinstance(spec, dict):
            raise ValueError("a fault plan must be a JSON object with an 'events' list")
        raw_events = spec.get("events")
        if not isinstance(raw_events, list):
            raise ValueError("a fault plan must carry an 'events' list")
        events = []
        for entry in raw_events:
            if not isinstance(entry, dict) or "t" not in entry or "kind" not in entry:
                raise ValueError(f"bad fault event {entry!r}: needs at least 't' and 'kind'")
            kwargs = {
                key: entry[key]
                for key in ("host", "for_s", "delay_s", "after_tokens", "p")
                if entry.get(key) is not None
            }
            events.append(FaultEvent(float(entry["t"]), str(entry["kind"]), **kwargs))
        return cls(events, seed=int(spec.get("seed", 0)), version=int(spec.get("version", PLAN_VERSION)))

    @classmethod
    def load(cls, path: "str | Path") -> "FaultPlan":
        return cls.parse(Path(path).read_text())

    @classmethod
    def from_env(cls) -> "Optional[FaultPlan]":
        """The plan named by ``UNIONML_TPU_FAULT_PLAN`` (a path, or inline
        JSON starting with ``{``); ``None`` when unset. A garbage value warns
        and degrades to no plan — a typo'd chaos knob must never take a
        production serve down (the serve-export contract)."""
        raw = serve_fault_plan()
        if raw is None:
            return None
        try:
            if raw.lstrip().startswith("{"):
                return cls.parse(raw)
            return cls.load(raw)
        except (OSError, ValueError) as exc:
            logger.warning(f"ignoring UNIONML_TPU_FAULT_PLAN ({exc}); serving without fault injection")
            return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "seed": self.seed,
            "events": [event.to_dict() for event in self.events],
        }

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))

    @property
    def horizon_s(self) -> float:
        """Virtual second the last event window closes (0.0 for an empty
        plan) — the chaos lane uses it to size the replay."""
        return max((event.t + event.for_s for event in self.events), default=0.0)

    def fault_times(self) -> "List[float]":
        """Onset instants of the disruptive events (worker_kill/rpc_drop/
        stream_cut) — the recovery-accounting inputs for
        an availability verdict."""
        return sorted({e.t for e in self.events if e.kind != "rpc_delay"})

    def arm(self, *, clock: Any = time.monotonic) -> "ArmedFaultPlan":
        return ArmedFaultPlan(self, clock=clock)


class ArmedFaultPlan:
    """A :class:`FaultPlan` bound to a start instant — the live injector.

    One armed plan may be shared by every coordinator-side host handle AND a
    worker agent: virtual time is common, and the injection counters
    aggregate. All methods are thread-safe; the fast path (no event active)
    is a couple of float compares."""

    def __init__(self, plan: FaultPlan, *, clock: Any = time.monotonic):
        self.plan = plan
        self._clock = clock
        self._t0 = float(clock())
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        self._injected: Dict[str, int] = {kind: 0 for kind in FAULT_KINDS}

    def elapsed_s(self) -> float:
        return float(self._clock()) - self._t0

    def _active(self, kind: str, host_id: Optional[int]) -> "Optional[FaultEvent]":
        vnow = self.elapsed_s()
        for event in self.plan.events:
            if event.kind == kind and event.active_at(vnow) and event.matches(host_id):
                return event
        return None

    def _fires(self, event: FaultEvent) -> bool:
        if event.p >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < event.p

    def _count(self, kind: str) -> None:
        with self._lock:
            self._injected[kind] += 1

    def worker_down(self, host_id: Optional[int]) -> bool:
        """Whether a ``worker_kill`` window currently covers ``host_id``."""
        event = self._active("worker_kill", host_id)
        if event is None:
            return False
        self._count("worker_kill")
        return True

    def check_rpc(self, host_id: Optional[int], what: str = "rpc") -> None:
        """Consult the plan before a control RPC to ``host_id``: raises
        :class:`FaultInjected` for ``worker_kill``/``rpc_drop`` windows,
        sleeps through an ``rpc_delay`` window, and is a no-op otherwise."""
        if self.worker_down(host_id):
            raise FaultInjected(
                f"fault-injected worker_kill: host {host_id} is down ({what})"
            )
        event = self._active("rpc_drop", host_id)
        if event is not None and self._fires(event):
            self._count("rpc_drop")
            raise FaultInjected(f"fault-injected rpc_drop: {what} to host {host_id}")
        event = self._active("rpc_delay", host_id)
        if event is not None and self._fires(event):
            self._count("rpc_delay")
            time.sleep(event.delay_s)

    def stream_cut_after(self, host_id: Optional[int]) -> Optional[int]:
        """Chunk count after which a stream STARTED now should be severed
        (``None`` = no cut scheduled)."""
        event = self._active("stream_cut", host_id)
        if event is None or not self._fires(event):
            return None
        self._count("stream_cut")
        return event.after_tokens

    def stats(self) -> Dict[str, int]:
        """Injection counters (ints only — the /metrics no-None contract)."""
        with self._lock:
            out = dict(self._injected)
        out["events"] = len(self.plan.events)
        return out


def default_chaos_plan(
    seed: int = 0, *, host: int = 1, kill_at_s: float = 0.75, down_s: float = 1.0
) -> FaultPlan:
    """The kill-and-rejoin plan to pair with a recorded mix: drop a few
    control RPCs to warm the suspect path, then take the host down for
    ``down_s`` — recovery is the lifecycle machine's job, and the replay's
    availability verdict is the judge."""
    return FaultPlan(
        [
            FaultEvent(max(kill_at_s - 0.3, 0.0), "rpc_drop", host=host, for_s=0.2),
            FaultEvent(kill_at_s, "worker_kill", host=host, for_s=down_s),
        ],
        seed=seed,
    )
