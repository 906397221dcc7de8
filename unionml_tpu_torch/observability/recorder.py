"""Flight recorder: the last N completed request timelines + a live in-flight table.

A copy of ``unionml_tpu/observability/recorder.py``: the port never imports the
JAX package.

A production incident rarely coincides with a debugger being attached. The
flight recorder keeps a bounded ring of the most recent completed
:class:`~unionml_tpu_torch.observability.trace.RequestTrace` timelines plus every
trace still in flight, served at ``GET /debug/requests`` (filterable by route
and status) and ``GET /debug/requests/<id>`` — so "which request stalled, and
where" is answerable after the fact from the serving process itself. On
graceful drain, and on an unhandled continuous-engine error, the recorder
dumps its tables to the log: the timelines that explain the failure leave the
process before the process does.

Memory is bounded by construction: ``capacity`` completed traces (each capped
at a few hundred events — trace.py's ``_MAX_EVENTS``), plus the in-flight
table whose size the serving stack's admission control already bounds.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from unionml_tpu_torch._logging import logger

__all__ = ["FlightRecorder", "active_recorder", "set_active_recorder"]

#: default ring capacity (completed timelines retained)
DEFAULT_CAPACITY = 256

#: the process-wide recorder, installed by the serving app so layers that are
#: not construction-wired to the app (the continuous engine's failure handler)
#: can still dump timelines on the way down. One serving app per process is
#: the deployment shape; a second app installing replaces the first.
_active: "Optional[FlightRecorder]" = None
_active_lock = threading.Lock()


def set_active_recorder(recorder: "Optional[FlightRecorder]") -> None:
    global _active
    with _active_lock:
        _active = recorder


def active_recorder() -> "Optional[FlightRecorder]":
    with _active_lock:
        return _active


class FlightRecorder:
    """Bounded ring of completed request traces + live in-flight table.

    A second, dedicated ring holds **SLO-breach exemplars**: completed
    timelines whose request individually blew a declared latency target
    (``RequestTrace.slo_breach`` set by the SLO tracker). Breaches are rare by
    construction but the main ring churns fast under load — without the
    separate ring the offending timeline an alert points at would usually be
    evicted before anyone looks. ``/debug/requests?slo=breach`` serves it.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, exemplar_capacity: int = 64):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        if exemplar_capacity < 1:
            raise ValueError("flight recorder exemplar capacity must be >= 1")
        self.capacity = capacity
        self.exemplar_capacity = exemplar_capacity
        self._lock = threading.Lock()
        #: completed timelines, oldest evicted first (deque maxlen = the ring)
        self._completed: "deque[Any]" = deque(maxlen=capacity)
        #: completed timelines that breached an SLO target — pinned separately
        #: so heavy healthy traffic cannot evict the evidence
        self._exemplars: "deque[Any]" = deque(maxlen=exemplar_capacity)
        #: request_id -> trace for requests still in flight; insertion-ordered
        #: so the table reads oldest-first (the stalled request floats to the top)
        self._inflight: "OrderedDict[str, Any]" = OrderedDict()

    # ------------------------------------------------------------------ producers

    def start(self, trace: Any) -> None:
        """Register a newly created trace in the in-flight table."""
        with self._lock:
            self._inflight[trace.request_id] = trace

    def complete(self, trace: Any) -> None:
        """Move a finished trace from the in-flight table into the ring —
        and, when its request breached an SLO target, pin it as an exemplar."""
        with self._lock:
            self._inflight.pop(trace.request_id, None)
            self._completed.append(trace)
            if getattr(trace, "slo_breach", None):
                self._exemplars.append(trace)

    # ------------------------------------------------------------------ consumers

    def __len__(self) -> int:
        with self._lock:
            return len(self._completed)

    @property
    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    @property
    def exemplar_count(self) -> int:
        with self._lock:
            return len(self._exemplars)

    def get(self, request_id: str) -> "Optional[Dict[str, Any]]":
        """One request's timeline by id — in-flight first (the live view wins),
        then the completed ring, newest first (re-used ids resolve to the most
        recent occurrence), then the exemplar ring (a breach outlives its
        eviction from the main ring)."""
        with self._lock:
            trace = self._inflight.get(request_id)
            if trace is None:
                for candidate in reversed(self._completed):
                    if candidate.request_id == request_id:
                        trace = candidate
                        break
            if trace is None:
                for candidate in reversed(self._exemplars):
                    if candidate.request_id == request_id:
                        trace = candidate
                        break
        return None if trace is None else trace.snapshot()

    def snapshot(
        self,
        *,
        route: Optional[str] = None,
        status: Optional[int] = None,
        limit: Optional[int] = None,
        min_ms: Optional[float] = None,
        slo_breach: bool = False,
        tenant: Optional[str] = None,
    ) -> "Dict[str, Any]":
        """The ``/debug/requests`` payload: in-flight table (oldest first) and
        completed ring (newest first), optionally filtered by route substring
        and/or exact status. ``limit`` bounds EACH list (the wire payload for a
        full 10k-deep ring would be megabytes). ``min_ms`` keeps only timelines
        whose total duration reached that many milliseconds (slow-request
        triage without dumping the whole ring — in-flight entries count their
        live duration so a currently stalled request still surfaces).
        ``slo_breach`` draws the completed list from the exemplar ring instead
        and keeps only in-flight requests already marked breaching. ``tenant``
        keeps only timelines stamped with that tenant id (multi-tenant QoS —
        "show me what tenant X's requests are doing")."""
        with self._lock:
            inflight = list(self._inflight.values())
            completed = list(reversed(self._exemplars if slo_breach else self._completed))
            exemplars = len(self._exemplars)
        def keep(snap: "Dict[str, Any]") -> bool:
            if route is not None and route not in snap["route"]:
                return False
            if status is not None and snap["status"] != status:
                return False
            if min_ms is not None and snap["duration_ms"] < min_ms:
                return False
            if slo_breach and "slo_breach" not in snap:
                return False
            if tenant is not None and snap.get("tenant") != tenant:
                return False
            return True

        inflight_out = [s for s in (t.snapshot() for t in inflight) if keep(s)]
        completed_out = [s for s in (t.snapshot() for t in completed) if keep(s)]
        if limit is not None:
            inflight_out = inflight_out[:limit]
            completed_out = completed_out[:limit]
        return {
            "capacity": self.capacity,
            "exemplars": exemplars,
            "inflight": inflight_out,
            "completed": completed_out,
        }

    def dump(self, reason: str, *, limit: int = 20) -> None:
        """Write the recorder's tables to the log (one JSON line per timeline)
        — the drain / engine-failure postmortem. ``limit`` bounds each table so
        a full ring doesn't flood the log at exactly the wrong moment."""
        snap = self.snapshot(limit=limit)
        logger.warning(
            f"flight recorder dump ({reason}): {len(snap['inflight'])} in flight, "
            f"{len(snap['completed'])} completed retained"
        )
        for table in ("inflight", "completed"):
            for entry in snap[table]:
                logger.warning(f"flight-recorder {table}: {json.dumps(entry, default=str)}")


def dump_active(reason: str) -> None:
    """Dump the process-wide recorder if one is installed (the continuous
    engine's failure path calls this without holding an app reference)."""
    recorder = active_recorder()
    if recorder is not None:
        try:
            recorder.dump(reason)
        except Exception:  # pragma: no cover - the dump must never mask the failure
            logger.exception("flight recorder dump failed")
