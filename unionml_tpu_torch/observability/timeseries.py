"""Windowed time-series telemetry: time buckets that turn counters into rates.

A copy of ``unionml_tpu/observability/timeseries.py``: the port never imports the
JAX package.

The serving stack's counters (``decoded_rows``, ``shed_queue_full``, ...) are
monotonic — they say how much has EVER happened, not how much is happening NOW
— and the TTFT/TBT reservoirs are keyed on sample *count*, so a quiet engine's
p99 can be hours-old samples. Autoscaling and SLO evaluation both need
*time-windowed* quantities: tokens per second over the last minute, the shed
ratio over the last ten. This module is that layer.

:class:`BucketRing` is a lock-protected ring of fixed-width time buckets over
an injectable monotonic clock (``time.monotonic`` by default — never the wall
clock, which jumps under NTP; tpu-lint TPU006 territory). Each ``add`` lands in
the bucket covering "now"; a bucket is lazily zeroed when the clock re-enters
its slot a full revolution later, so clock skips (a stalled engine thread, a
suspended laptop) read as silence rather than stale counts. ``rate``/``count``
sum the trailing window including the current partial bucket — cheap enough to
call per routing decision.

:class:`EngineTimeseries` bundles the rings one continuous engine needs
(tokens, admissions, sheds) with references to its TTFT/TBT
:class:`~unionml_tpu_torch.serving.metrics.LatencyWindow` reservoirs (which carry
per-sample timestamps, so ``snapshot(window_s=...)`` yields *time-decaying*
percentiles), and renders one ``rates()`` dict — the per-replica windowed
health quantity the SLO engine (observability/slo.py), the health score
(observability/health.py), ``/healthz``, and the replica scheduler all consume.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Optional

__all__ = ["BucketRing", "EngineTimeseries"]


class BucketRing:
    """Lock-protected ring of fixed-width time buckets accumulating counts.

    ``add(n)`` lands ``n`` in the bucket covering the clock's current instant;
    ``count(window_s)``/``rate(window_s)`` sum the trailing window (current
    partial bucket included). The ring holds ``buckets`` slots of ``width_s``
    seconds each; asking for a window wider than the ring's horizon reads what
    the ring holds (the horizon), never double-counts a revisited slot. Buckets
    carry the epoch that last wrote them, so a slot the clock skipped (or that
    aged a full revolution) reads zero instead of a stale count.
    """

    def __init__(
        self,
        *,
        width_s: float = 1.0,
        buckets: int = 600,
        clock: Callable[[], float] = time.monotonic,
    ):
        if width_s <= 0:
            raise ValueError("bucket width_s must be > 0")
        if buckets < 1:
            raise ValueError("buckets must be >= 1")
        self._width = float(width_s)
        self._n = int(buckets)
        self._clock = clock
        self._lock = threading.Lock()
        #: per-slot (epoch that last wrote it, count); epoch -1 = never written
        self._epochs = [-1] * self._n
        self._counts = [0] * self._n
        self._total = 0

    @property
    def horizon_s(self) -> float:
        """Seconds of history the ring can hold (buckets x width)."""
        return self._n * self._width

    def _epoch(self) -> int:
        return int(self._clock() / self._width)

    def add(self, n: int = 1) -> None:
        """Record ``n`` events at the clock's current instant."""
        epoch = self._epoch()
        slot = epoch % self._n
        with self._lock:
            if self._epochs[slot] != epoch:
                # the clock advanced into (or skipped to) a slot last written a
                # revolution ago: lazily zero it before accumulating
                self._epochs[slot] = epoch
                self._counts[slot] = 0
            self._counts[slot] += n
            self._total += n

    def total(self) -> int:
        """Lifetime total (the monotonic counter the rates derive from)."""
        with self._lock:
            return self._total

    def count(self, window_s: float) -> int:
        """Events recorded in the trailing ``window_s`` seconds (the current
        partial bucket included); 0 for an empty or fully aged-out window."""
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        epoch = self._epoch()
        spread = min(max(int(math.ceil(window_s / self._width)), 1), self._n)
        with self._lock:
            out = 0
            for e in range(epoch - spread + 1, epoch + 1):
                if e < 0:
                    continue
                slot = e % self._n
                if self._epochs[slot] == e:
                    out += self._counts[slot]
            return out

    def rate(self, window_s: float) -> float:
        """Events per second over the trailing window; 0.0 when empty."""
        return self.count(window_s) / float(window_s)

    def clear(self) -> None:
        """Drop all history (warmup probes must not skew the first window)."""
        with self._lock:
            self._epochs = [-1] * self._n
            self._counts = [0] * self._n
            self._total = 0


class EngineTimeseries:
    """One continuous engine's windowed telemetry: token/admission/shed rings
    plus its (timestamped) TTFT/TBT reservoirs, snapshot as one rates dict.

    Fed per-iteration from the engine's emission/admission/shed sites (each
    feed is one ring-lock acquire and an int add — cheap enough for the decode
    hot loop); read by the SLO tracker, the health score, ``stats()`` and the
    replica scheduler. ``ttft``/``tbt`` are the engine's own
    :class:`~unionml_tpu_torch.serving.metrics.LatencyWindow` instances — held by
    reference so there is exactly one bookkeeping path for percentiles.
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float] = time.monotonic,
        width_s: float = 1.0,
        horizon_s: float = 600.0,
        ttft: Optional[Any] = None,
        tbt: Optional[Any] = None,
    ):
        if horizon_s <= 0:
            raise ValueError("horizon_s must be > 0")
        buckets = int(math.ceil(horizon_s / width_s)) + 1
        self.clock = clock
        self.tokens = BucketRing(width_s=width_s, buckets=buckets, clock=clock)
        self.admissions = BucketRing(width_s=width_s, buckets=buckets, clock=clock)
        self.sheds = BucketRing(width_s=width_s, buckets=buckets, clock=clock)
        self.ttft = ttft
        self.tbt = tbt

    def shed_ratio(self, window_s: float) -> float:
        """Sheds as a fraction of arrivals (admissions + sheds) over the
        window; 0.0 when the window saw no arrivals."""
        sheds = self.sheds.count(window_s)
        arrivals = self.admissions.count(window_s) + sheds
        return sheds / arrivals if arrivals else 0.0

    def arrivals(self, window_s: float) -> int:
        """Admissions + sheds over the window (the shed-ratio denominator —
        the SLO tracker's min-sample gate keys on it)."""
        return self.admissions.count(window_s) + self.sheds.count(window_s)

    def rates(self, window_s: float) -> Dict[str, Any]:
        """The windowed-rates snapshot (``/healthz`` per-replica shape): every
        value numeric — an idle window reads 0.0, never ``None``; the latency
        windows keep their ``{"window": 0}``-when-empty contract."""
        out: Dict[str, Any] = {
            "window_s": float(window_s),
            "tokens_per_s": round(self.tokens.rate(window_s), 3),
            "admissions_per_s": round(self.admissions.rate(window_s), 4),
            "sheds_per_s": round(self.sheds.rate(window_s), 4),
            "shed_ratio": round(self.shed_ratio(window_s), 4),
        }
        if self.ttft is not None:
            out["ttft_ms"] = self.ttft.snapshot(window_s=window_s)
        if self.tbt is not None:
            out["tbt_ms"] = self.tbt.snapshot(window_s=window_s)
        return out

    def clear(self) -> None:
        """Reset the rings (the reservoirs are cleared by their owner — the
        engine's warmup already resets TTFT/TBT)."""
        self.tokens.clear()
        self.admissions.clear()
        self.sheds.clear()
