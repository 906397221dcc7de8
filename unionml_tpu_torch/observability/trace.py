"""Request-timeline tracing primitives: request ids, spans, and event records.

A copy of ``unionml_tpu/observability/trace.py``: the port never imports the
JAX package.

The serving stack's aggregate metrics (route percentiles, overload counters,
TTFT/TBT windows — serving/metrics.py) can say *that* p99 moved but not *which*
request stalled, *where* (queue, admission, prefill chunk, decode residency,
replica choice), or *why*. This module is the per-request causality layer, in
the style of Dapper-like always-on tracing: every request gets a **request id**
(inbound ``X-Request-Id`` honored, generated otherwise, echoed on every
response including errors and sheds) carried down the stack by a contextvar,
and — when tracing is enabled — a :class:`RequestTrace` recording
monotonic-clock events at each lifecycle stage (HTTP accept, queue wait,
replica routed, admission start, each prefill chunk, per-emission,
finish/shed/cancel).

Zero-cost contract: with tracing off no :class:`RequestTrace` is ever
allocated — :func:`current_trace` returns ``None``, producers store that
``None`` alongside their sessions, and every instrumentation site is a single
``is not None`` test. The request-id contextvar always flows (one
``uuid4().hex`` per request), because correlating an error response with a log
line must not require turning tracing on first.

Thread model: the HTTP layer creates and finishes traces on the event loop;
engine threads append events through the reference a session captured at
``submit()``. :meth:`RequestTrace.event` takes the trace's own lock, so
timestamps within one trace are strictly non-decreasing no matter which thread
records them.
"""

from __future__ import annotations

import contextvars
import dataclasses
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "REQUEST_ID_HEADER",
    "RequestTrace",
    "Span",
    "Tracer",
    "current_request_id",
    "current_trace",
    "new_request_id",
    "sanitize_request_id",
]

#: the wire header carrying a caller-chosen request id (lower-cased, the
#: serving stack's header-dict convention)
REQUEST_ID_HEADER = "x-request-id"

#: a client-supplied id is echoed back into a response header, so it must not
#: be a header-injection vector: only these characters survive sanitization
_SAFE_ID = re.compile(r"[A-Za-z0-9._\-]+")
_MAX_ID_LEN = 128

#: events per trace before new ones are dropped (counted): a runaway stream
#: must not grow one trace without bound inside the flight recorder
_MAX_EVENTS = 512

_request_id: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "unionml_tpu_request_id", default=None
)
_active_trace: "contextvars.ContextVar[Optional[RequestTrace]]" = contextvars.ContextVar(
    "unionml_tpu_active_trace", default=None
)


def new_request_id() -> str:
    """A fresh 32-hex-char request id (uuid4)."""
    return uuid.uuid4().hex


def sanitize_request_id(raw: Optional[str]) -> Optional[str]:
    """An inbound ``X-Request-Id`` value made safe to echo: header-illegal
    characters stripped (a raw echo would be a CR/LF response-splitting
    vector), bounded length. ``None`` when nothing usable remains."""
    if not raw:
        return None
    kept = "".join(_SAFE_ID.findall(raw))[:_MAX_ID_LEN]
    return kept or None


def current_request_id() -> Optional[str]:
    """The id of the request currently being handled (contextvar)."""
    return _request_id.get()


def current_trace() -> "Optional[RequestTrace]":
    """The active request's trace, or ``None`` — the zero-cost off switch every
    instrumentation site keys on."""
    return _active_trace.get()


def bind(request_id: str, trace: "Optional[RequestTrace]" = None) -> "Tuple[Any, Any]":
    """Set the request-id (and optionally trace) contextvars; returns the reset
    tokens for :func:`unbind`. Called by the HTTP layer around each handler."""
    return _request_id.set(request_id), _active_trace.set(trace)


def unbind(tokens: "Tuple[Any, Any]") -> None:
    _request_id.reset(tokens[0])
    _active_trace.reset(tokens[1])


@dataclasses.dataclass(frozen=True)
class Span:
    """One named interval (or instant) on a request's timeline.

    ``t`` is seconds since the trace's start (monotonic clock); instants have
    ``dur_ms`` of ``None``. ``attrs`` carry stage-specific detail — the routed
    replica and the load it saw, a prefill chunk's position, an emission's
    token count."""

    name: str
    t: float
    dur_ms: Optional[float] = None
    attrs: "Optional[Dict[str, Any]]" = None

    def render(self) -> "Dict[str, Any]":
        out: "Dict[str, Any]" = {"event": self.name, "t_ms": round(self.t * 1e3, 3)}
        if self.dur_ms is not None:
            out["dur_ms"] = round(self.dur_ms, 3)
        if self.attrs:
            out.update(self.attrs)
        return out


class RequestTrace:
    """The timeline of one request, shared across threads.

    Created by the HTTP layer (when tracing is on), carried by contextvar into
    handlers, and captured by engine sessions at ``submit()`` so the engine
    thread can keep appending events after the handler returned a stream.
    Events are monotonic-clock offsets from ``t0``; :meth:`snapshot` renders
    the whole timeline as plain JSON-able dicts for ``/debug/requests``."""

    __slots__ = (
        "request_id", "method", "path", "created_at", "t0",
        "status", "detail", "duration_ms", "dropped_events",
        "slo_breach", "tenant", "priority", "_events", "_lock", "_finished",
    )

    def __init__(self, request_id: str, method: str, path: str):
        self.request_id = request_id
        self.method = method
        self.path = path
        #: multi-tenant QoS (serving/tenancy.py): the requesting tenant id and
        #: priority tier, stamped by the HTTP layer when the request carried
        #: them — None/absent otherwise, so anonymous timelines are unchanged
        self.tenant: Optional[str] = None
        self.priority: Optional[str] = None
        self.created_at = time.time()  # wall clock, display only — never subtracted
        self.t0 = time.monotonic()
        self.status: Optional[int] = None
        self.detail: Optional[str] = None
        self.duration_ms: Optional[float] = None
        self.dropped_events = 0
        #: set by SLOTracker.note_* when THIS request's latency exceeded a
        #: declared target: the flight recorder pins such timelines into its
        #: exemplar ring (/debug/requests?slo=breach)
        self.slo_breach: "Optional[Dict[str, Any]]" = None
        self._events: "List[Span]" = []
        self._lock = threading.Lock()
        self._finished = False

    @property
    def route(self) -> str:
        return f"{self.method} {self.path}"

    @property
    def finished(self) -> bool:
        return self._finished

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instant on the timeline (safe from any thread)."""
        now = time.monotonic()
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                self.dropped_events += 1
                return
            self._events.append(Span(name, now - self.t0, None, attrs or None))

    def span(self, name: str, **attrs: Any) -> "_SpanRecorder":
        """Context manager recording ``name`` as an interval with ``dur_ms``::

            with trace.span("engine.prefill", tokens=512):
                ...
        """
        return _SpanRecorder(self, name, attrs)

    def _add_span(self, name: str, start: float, end: float, attrs: "Dict[str, Any]") -> None:
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                self.dropped_events += 1
                return
            self._events.append(
                Span(name, start - self.t0, (end - start) * 1e3, attrs or None)
            )

    def mark_slo_breach(self, objective: str, observed_ms: float, target_ms: float) -> None:
        """Stamp this timeline as an SLO-breach exemplar (first breach records
        a ``slo.breach`` event; repeats bump the count and keep the worst
        observation, so a stuttering stream reads as one exemplar, not 50)."""
        with self._lock:
            entry = self.slo_breach
            if entry is not None:
                entry["count"] += 1
                if entry["objective"] == objective and observed_ms > entry["observed_ms"]:
                    entry["observed_ms"] = round(observed_ms, 3)
                return
            self.slo_breach = {
                "objective": objective,
                "observed_ms": round(observed_ms, 3),
                "target_ms": target_ms,
                "count": 1,
            }
        # outside the breach bookkeeping: event() takes the same lock
        self.event(
            "slo.breach", objective=objective,
            observed_ms=round(observed_ms, 3), target_ms=target_ms,
        )

    def finish(self, status: int, detail: Optional[str] = None) -> None:
        """Seal the timeline (idempotent — the first finish wins, so a stream
        abort racing normal exhaustion records one terminal status)."""
        now = time.monotonic()
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.status = status
            self.detail = detail
            self.duration_ms = round((now - self.t0) * 1e3, 3)

    def snapshot(self) -> "Dict[str, Any]":
        """JSON-able view for ``/debug/requests``: id, route, status, wall-clock
        start, duration, and the full event timeline (offsets in ms)."""
        with self._lock:
            events = [span.render() for span in self._events]
            out: "Dict[str, Any]" = {
                "request_id": self.request_id,
                "route": self.route,
                "status": self.status,
                "started_at": self.created_at,
                "duration_ms": self.duration_ms
                if self._finished
                else round((time.monotonic() - self.t0) * 1e3, 3),
                "in_flight": not self._finished,
                "events": events,
            }
            if self.tenant is not None:
                out["tenant"] = self.tenant
            if self.priority is not None:
                out["priority"] = self.priority
            if self.detail:
                out["detail"] = self.detail
            if self.dropped_events:
                out["dropped_events"] = self.dropped_events
            if self.slo_breach:
                out["slo_breach"] = dict(self.slo_breach)
            return out


class _SpanRecorder:
    """The object :meth:`RequestTrace.span` returns (plain class, no
    contextlib overhead on the traced path)."""

    __slots__ = ("_trace", "_name", "_attrs", "_start")

    def __init__(self, trace: RequestTrace, name: str, attrs: "Dict[str, Any]"):
        self._trace = trace
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_SpanRecorder":
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self._trace._add_span(self._name, self._start, time.monotonic(), self._attrs)


class Tracer:
    """The serving app's trace factory: the enabled switch plus the flight
    recorder new traces register with.

    ``start()`` is the only allocation site — with ``enabled`` False it
    returns ``None`` and the whole request runs with the request id alone
    (the strictly zero-cost path the bench lane pins)."""

    def __init__(self, enabled: bool = False, recorder: Any = None):
        self.enabled = bool(enabled)
        #: a :class:`~unionml_tpu_torch.observability.recorder.FlightRecorder` (or
        #: None): completed traces ring-buffer + live in-flight table
        self.recorder = recorder

    def start(self, method: str, path: str, request_id: str) -> Optional[RequestTrace]:
        if not self.enabled:
            return None
        trace = RequestTrace(request_id, method, path)
        if self.recorder is not None:
            self.recorder.start(trace)
        return trace

    def finish(self, trace: Optional[RequestTrace], status: int, detail: Optional[str] = None) -> None:
        if trace is None:
            return
        trace.finish(status, detail)
        if self.recorder is not None:
            self.recorder.complete(trace)
