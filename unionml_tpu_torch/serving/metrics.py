"""Serving-side latency percentiles: :class:`LatencyWindow`, the counterpart of
the class of the same name in ``unionml_tpu/serving/metrics.py``."""

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
