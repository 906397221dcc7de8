"""Serving-side observability: :class:`LatencyWindow` and
:class:`ServingMetrics` (request counters and latency percentiles per route,
overload counters, live gauges, queue waits), copies of the classes of the
same names in ``unionml_tpu/serving/metrics.py``."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

_WINDOW = 10_000  # most recent samples per series


def _percentile(ordered: "list[float]", q: float) -> float:
    # nearest-rank on the sorted window; ordered is non-empty
    rank = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
    return ordered[rank]


class LatencyWindow:
    """Thread-safe bounded reservoir of durations with a percentile snapshot.

    Producers :meth:`observe` seconds on their own threads; :meth:`snapshot`
    reports exact percentiles in milliseconds over the most recent ``window``
    samples, plus the age of the newest and oldest sample, optionally over
    only the trailing ``window_s`` seconds. An empty window snapshots as
    ``{"window": 0}``. Producers pay only an append under the lock; the
    snapshot copies under the lock and sorts outside it.
    """

    def __init__(self, window: int = _WINDOW, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._samples: deque = deque(maxlen=window)  # (monotonic ts, seconds)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append((self._clock(), seconds))

    def clear(self) -> None:
        """Drop accumulated samples."""
        with self._lock:
            self._samples.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def snapshot(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """Percentiles (+ freshness ages) over the retained samples —
        restricted to the trailing ``window_s`` seconds when given."""
        with self._lock:
            pairs = list(self._samples)
            now = self._clock()
        if window_s is not None:
            cutoff = now - window_s
            pairs = [pair for pair in pairs if pair[0] >= cutoff]
        if not pairs:
            return {"window": 0}
        ordered = sorted(value for _, value in pairs)
        oldest_ts, newest_ts = pairs[0][0], pairs[-1][0]
        return {
            "window": len(ordered),
            "mean_ms": round(sum(ordered) / len(ordered) * 1e3, 3),
            "p50_ms": round(_percentile(ordered, 0.50) * 1e3, 3),
            "p95_ms": round(_percentile(ordered, 0.95) * 1e3, 3),
            "p99_ms": round(_percentile(ordered, 0.99) * 1e3, 3),
            "max_ms": round(ordered[-1] * 1e3, 3),
            "newest_age_ms": round(max(now - newest_ts, 0.0) * 1e3, 3),
            "oldest_age_ms": round(max(now - oldest_ts, 0.0) * 1e3, 3),
        }


class ServingMetrics:
    """Thread-safe request counters and a sliding-window latency reservoir."""

    def __init__(self, window: int = _WINDOW):
        self._window = window
        self._lock = threading.Lock()
        self._requests: Dict[str, int] = {}
        self._errors: Dict[str, int] = {}
        self._latencies: "Dict[str, deque]" = {}
        #: overload accounting (serving/overload.py): sheds, deadline timeouts,
        #: and mid-flight cancellations — the counters that say WHY error totals
        #: moved under load, not just that they did
        self._overload: Dict[str, int] = {}
        #: live gauges (queue depths, in-flight count): registered callables
        #: evaluated at snapshot time, so /metrics reads current state without
        #: the producers pushing samples on their hot paths
        self._gauges: Dict[str, Callable[[], Any]] = {}
        #: queue-wait reservoirs per queue (admission -> dispatch latency):
        #: the leading indicator of overload — waits climb before sheds start
        self._queue_waits: "Dict[str, deque]" = {}

    def record(self, route: str, status: int, latency_s: float) -> None:
        with self._lock:
            self._requests[route] = self._requests.get(route, 0) + 1
            if status >= 400:
                self._errors[route] = self._errors.get(route, 0) + 1
            bucket = self._latencies.setdefault(route, deque(maxlen=self._window))
            bucket.append(latency_s)

    def inc(self, counter: str, n: int = 1) -> None:
        """Bump an overload counter (``shed_inflight``, ``shed_queue_full``,
        ``shed_draining``, ``deadline_timeouts``, ``cancelled``...)."""
        with self._lock:
            self._overload[counter] = self._overload.get(counter, 0) + n

    def observe_queue_wait(self, queue: str, wait_s: float) -> None:
        """Record one request's admission-queue wait for ``queue``."""
        with self._lock:
            bucket = self._queue_waits.setdefault(queue, deque(maxlen=self._window))
            bucket.append(wait_s)

    def register_gauge(self, name: str, fn: Callable[[], Any]) -> None:
        """Expose a live value (queue depth, in-flight count) in snapshots."""
        with self._lock:
            self._gauges[name] = fn

    @staticmethod
    def _percentile(ordered: "list[float]", q: float) -> float:
        return _percentile(ordered, q)

    def prometheus(self) -> str:
        """This sink's :meth:`snapshot` rendered as Prometheus text exposition
        (the serving app's ``/metrics?format=prometheus`` renders its MERGED
        snapshot — generation/predictor sections included — through the same
        :func:`unionml_tpu_torch.observability.prometheus.render`)."""
        from unionml_tpu_torch.observability.prometheus import render

        return render(self.snapshot())

    def snapshot(self) -> Dict[str, Any]:
        """Counts + latency percentiles (milliseconds) per route, plus overload
        counters, live gauges, and queue-wait percentiles."""
        with self._lock:
            routes = {r: list(lat) for r, lat in self._latencies.items()}
            requests = dict(self._requests)
            errors = dict(self._errors)
            overload = dict(self._overload)
            gauges = dict(self._gauges)
            queue_waits = {q: list(w) for q, w in self._queue_waits.items()}
        out: Dict[str, Any] = {
            "requests_total": sum(requests.values()),
            "errors_total": sum(errors.values()),
            "overload": overload,
            "routes": {},
        }
        # gauges run unlocked: a provider that itself takes a lock (queue sizes)
        # must not nest inside ours; a failing provider reports its error string
        # instead of breaking the whole snapshot. A provider returning None is
        # registered-but-inactive (e.g. per-replica occupancy on an app whose
        # generation engine is a single ContinuousBatcher) and stays out of the
        # snapshot entirely.
        gauge_out: Dict[str, Any] = {}
        for name, fn in gauges.items():
            try:
                value = fn()
            except Exception as exc:  # pragma: no cover - defensive
                gauge_out[name] = f"<error: {type(exc).__name__}>"
                continue
            if value is not None:
                gauge_out[name] = value
        if gauge_out:
            out["gauges"] = gauge_out
        if queue_waits:
            out["queues"] = {}
            for queue, waits in queue_waits.items():
                ordered = sorted(waits)
                out["queues"][queue] = {
                    "window": len(ordered),
                    "wait_p50_ms": round(self._percentile(ordered, 0.50) * 1e3, 3),
                    "wait_p99_ms": round(self._percentile(ordered, 0.99) * 1e3, 3),
                } if ordered else {"window": 0}
        for route, latencies in routes.items():
            ordered = sorted(latencies)
            entry: Dict[str, Any] = {
                "requests": requests.get(route, 0),
                "errors": errors.get(route, 0),
            }
            if ordered:
                entry.update(
                    window=len(ordered),
                    mean_ms=round(sum(ordered) / len(ordered) * 1e3, 3),
                    p50_ms=round(self._percentile(ordered, 0.50) * 1e3, 3),
                    p95_ms=round(self._percentile(ordered, 0.95) * 1e3, 3),
                    p99_ms=round(self._percentile(ordered, 0.99) * 1e3, 3),
                )
            out["routes"][route] = entry
        return out
