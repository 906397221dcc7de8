"""Declarative serving SLOs evaluated with multi-window burn rates.

A copy of ``unionml_tpu/observability/slo.py``: the port never imports the
JAX package.

An SLO here is a target on a windowed quantity the engine already measures
(observability/timeseries.py): TTFT p95, TBT p99, and the shed ratio. Each
armed objective is evaluated over TWO windows — a **fast** window (default
60 s) that pages quickly, and a **slow** window (default 600 s) that confirms a
trend — the multi-window burn-rate idiom from the SRE workbook, collapsed to
the smallest state machine that still decays sanely:

- **breach**: both windows over target — the condition is real and sustained;
- **warn**: exactly one window over target — either a fresh regression the
  slow window has not confirmed yet (early warning on the way up), or a
  recovering breach whose fast window already cleared (decay on the way down:
  breach never snaps straight to ok, it drains through warn as the slow
  window empties);
- **ok**: both windows under target.

The **burn rate** reported per window is observed/target — 1.0 is exactly at
target, 2.0 means the error budget burns twice as fast as it accrues; it is
what an alert rule thresholds on (docs/observability.md has example Prometheus
rules). A window with fewer than ``min_samples`` samples never breaches — an
idle engine is healthy, not failing.

Targets resolve kwarg -> ``serve --slo-ttft-p95-ms/--slo-tbt-p99-ms/
--slo-shed-ratio`` -> ``UNIONML_TPU_SLO_*`` env (the defaults.py warn-and-
fall-back readers; a typo'd deployment env degrades to "no SLO", never a
crash). Besides the window state machine, the tracker stamps **per-request
breaches**: a request whose own TTFT/TBT exceeded target gets its timeline
marked (``RequestTrace.mark_slo_breach``) so the flight recorder pins it as an
exemplar — the ``/debug/requests?slo=breach`` ring an alert links into.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

__all__ = ["SLOConfig", "SLOTracker", "STATE_CODES", "TenantSLORegistry", "worst_state"]

#: state -> numeric code, the Prometheus-safe rendering of the state machine
#: (strings are skipped by the exposition; the code is the series)
STATE_CODES = {"ok": 0, "warn": 1, "breach": 2}


def worst_state(states) -> str:
    """The most severe of an iterable of state strings (empty -> "ok")."""
    worst = "ok"
    for state in states:
        if STATE_CODES.get(state, 0) > STATE_CODES[worst]:
            worst = state
    return worst


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Declarative targets; ``None``/0 disarms an objective entirely.

    ``ttft_p95_ms``/``tbt_p99_ms`` are latency ceilings in milliseconds;
    ``shed_ratio`` is the tolerated fraction of arrivals shed (429/503) over a
    window. ``min_samples`` gates breaching: a window with fewer samples (or
    fewer arrivals, for the shed ratio) reports its value but cannot breach.
    """

    ttft_p95_ms: Optional[float] = None
    tbt_p99_ms: Optional[float] = None
    shed_ratio: Optional[float] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    min_samples: int = 3

    def __post_init__(self):
        for name in ("ttft_p95_ms", "tbt_p99_ms", "shed_ratio"):
            value = getattr(self, name)
            if value is not None and value < 0:
                raise ValueError(f"SLO target {name} must be >= 0 (None/0 = disarmed)")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError("SLO windows must be > 0 seconds")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(
                "the fast window must not exceed the slow window "
                f"({self.fast_window_s} > {self.slow_window_s})"
            )
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")

    @classmethod
    def from_env(cls) -> "SLOConfig":
        """Targets from the ``UNIONML_TPU_SLO_*`` exports (the serve CLI sets
        them before the app module imports — the --dp-replicas contract); 0 or
        unset disarms an objective."""
        from unionml_tpu_torch._logging import logger
        from unionml_tpu_torch.defaults import (
            serve_slo_fast_window_s,
            serve_slo_min_samples,
            serve_slo_shed_ratio,
            serve_slo_slow_window_s,
            serve_slo_tbt_p99_ms,
            serve_slo_ttft_p95_ms,
        )

        fast = serve_slo_fast_window_s()
        slow = serve_slo_slow_window_s()
        if fast > slow:
            # the env readers tolerate garbage per value; the cross-value
            # constraint degrades the same way — never a crash at app import
            logger.warning(
                f"SLO fast window ({fast}s) exceeds the slow window ({slow}s); "
                f"widening the slow window to {fast}s"
            )
            slow = fast
        return cls(
            ttft_p95_ms=serve_slo_ttft_p95_ms() or None,
            tbt_p99_ms=serve_slo_tbt_p99_ms() or None,
            shed_ratio=serve_slo_shed_ratio() or None,
            fast_window_s=fast,
            slow_window_s=slow,
            min_samples=serve_slo_min_samples(),
        )

    @property
    def armed(self) -> bool:
        return any((self.ttft_p95_ms, self.tbt_p99_ms, self.shed_ratio))


class SLOTracker:
    """One engine's SLO evaluator: the ok→warn→breach state machine over an
    :class:`~unionml_tpu_torch.observability.timeseries.EngineTimeseries`, plus the
    per-request breach stamp the exemplar ring keys on.

    Thread model: ``note_ttft``/``note_tbt`` run on the engine thread per
    emission (a target comparison and, on breach, one counter bump — the hot
    path is two float compares when nothing breaches); ``evaluate`` runs on
    whatever thread snapshots health (``/healthz``, ``stats()``, the replica
    scheduler's cached health) under the tracker's own lock.
    """

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config if config is not None else SLOConfig.from_env()
        self._lock = threading.Lock()
        #: objective name -> last evaluated state (the machine's memory — kept
        #: so /debug/fleet can show states between evaluations too)
        self._states: Dict[str, str] = {}
        #: requests whose OWN latency exceeded a target (the exemplar count)
        self.breached_requests = 0

    @property
    def armed(self) -> bool:
        return self.config.armed

    # ------------------------------------------------------------- per-request

    def note_ttft(self, trace: Optional[Any], observed_ms: float) -> None:
        """Stamp a request whose time-to-first-token exceeded target (called
        at the engine's first-token site)."""
        self._note("ttft_p95_ms", self.config.ttft_p95_ms, trace, observed_ms)

    def note_tbt(self, trace: Optional[Any], observed_ms: float) -> None:
        """Stamp a request whose between-token gap exceeded target."""
        self._note("tbt_p99_ms", self.config.tbt_p99_ms, trace, observed_ms)

    def _note(
        self, objective: str, target: Optional[float], trace: Optional[Any], observed_ms: float
    ) -> None:
        if not target or observed_ms <= target:
            return
        with self._lock:
            self.breached_requests += 1
        if trace is not None:
            # the timeline self-identifies as a breach exemplar; the flight
            # recorder pins it into the dedicated ring at complete()
            trace.mark_slo_breach(objective, observed_ms, target)

    # -------------------------------------------------------------- evaluation

    def _observe(self, timeseries: Any, objective: str, window_s: float) -> "tuple[float, int]":
        """(observed value, samples) for one objective over one window; an
        empty window observes 0.0 — never None."""
        if objective == "ttft_p95_ms":
            snap = timeseries.ttft.snapshot(window_s=window_s) if timeseries.ttft else {"window": 0}
            return float(snap.get("p95_ms", 0.0)), int(snap.get("window", 0))
        if objective == "tbt_p99_ms":
            snap = timeseries.tbt.snapshot(window_s=window_s) if timeseries.tbt else {"window": 0}
            return float(snap.get("p99_ms", 0.0)), int(snap.get("window", 0))
        return float(timeseries.shed_ratio(window_s)), int(timeseries.arrivals(window_s))

    def evaluate(self, timeseries: Any) -> Dict[str, Any]:
        """Evaluate every armed objective against the engine's timeseries and
        advance the state machine. Returns the ``slo`` section ``/healthz``
        and ``stats()`` expose — every leaf numeric or a state string (which
        the Prometheus exposition skips; ``state_code`` is the series)."""
        cfg = self.config
        objectives: Dict[str, Any] = {}
        for name, target in (
            ("ttft_p95_ms", cfg.ttft_p95_ms),
            ("tbt_p99_ms", cfg.tbt_p99_ms),
            ("shed_ratio", cfg.shed_ratio),
        ):
            if not target:
                continue
            fast_value, fast_n = self._observe(timeseries, name, cfg.fast_window_s)
            slow_value, slow_n = self._observe(timeseries, name, cfg.slow_window_s)
            fast_burn = fast_value / target
            slow_burn = slow_value / target
            fast_breaching = fast_n >= cfg.min_samples and fast_value > target
            slow_breaching = slow_n >= cfg.min_samples and slow_value > target
            if fast_breaching and slow_breaching:
                state = "breach"
            elif fast_breaching or slow_breaching:
                state = "warn"
            else:
                state = "ok"
            objectives[name] = {
                "target": target,
                "state": state,
                "state_code": STATE_CODES[state],
                "fast": {
                    "window_s": cfg.fast_window_s,
                    "value": round(fast_value, 4),
                    "burn_rate": round(fast_burn, 3),
                    "samples": fast_n,
                },
                "slow": {
                    "window_s": cfg.slow_window_s,
                    "value": round(slow_value, 4),
                    "burn_rate": round(slow_burn, 3),
                    "samples": slow_n,
                },
            }
        overall = worst_state(entry["state"] for entry in objectives.values())
        with self._lock:
            self._states = {name: entry["state"] for name, entry in objectives.items()}
            breached = self.breached_requests
        return {
            "state": overall,
            "state_code": STATE_CODES[overall],
            "breached_requests": breached,
            "objectives": objectives,
        }

    def states(self) -> Dict[str, str]:
        """The last evaluated per-objective states (no re-evaluation)."""
        with self._lock:
            return dict(self._states)

    def reset(self) -> None:
        """Back to all-ok with zeroed breach accounting (the engine's warmup
        reset: probe traffic must not leave a pre-breached fleet)."""
        with self._lock:
            self._states = {}
            self.breached_requests = 0


class _TenantSLOEntry:
    """One tenant's SLO state on one engine: its own windowed timeseries
    (TTFT/TBT reservoirs + token/admission/shed rings) and burn-rate tracker.
    Created lazily by :class:`TenantSLORegistry` — only tenants whose
    :class:`~unionml_tpu_torch.serving.tenancy.TenantSpec` arms a target ever get
    one."""

    __slots__ = ("timeseries", "tracker")

    def __init__(self, config: SLOConfig, clock: Callable[[], float]):
        from unionml_tpu_torch.observability.timeseries import EngineTimeseries
        from unionml_tpu_torch.serving.metrics import LatencyWindow

        self.timeseries = EngineTimeseries(
            clock=clock,
            horizon_s=config.slow_window_s,
            ttft=LatencyWindow(clock=clock),
            tbt=LatencyWindow(clock=clock),
        )
        self.tracker = SLOTracker(config)


class TenantSLORegistry:
    """Per-tenant SLO evaluation state, bounded (the TPU009 discipline).

    The engine-level :class:`SLOTracker` judges the WHOLE engine; at
    millions-of-users fidelity the question is per tenant — a hostile burst
    tenant breaching its own targets while the well-behaved tenants stay
    green is the multi-tenant QoS story told in SLO terms. This registry
    keys one (timeseries, tracker) pair per tenant whose ``TenantSpec``
    declares targets, in a **bounded LRU** (``max_tenants``, least-recently-
    FED eviction) so request-controlled tenant-id cardinality can never grow
    host memory — exactly the bug class tpu-lint TPU009 exists for.

    Feed methods (``note_ttft``/``note_tbt``/``admitted``/``tokens``/
    ``shed``) run on the engine thread at the existing observation sites and
    cost one dict probe when the tenant has no armed targets; ``evaluate``
    runs at scrape cadence on whatever thread snapshots ``stats()``.
    ``config_for`` is the spec lookup (None = no targets armed = no state
    ever created), injected so this module stays import-light."""

    def __init__(
        self,
        config_for: "Callable[[str], Optional[SLOConfig]]",
        *,
        max_tenants: int = 64,
        clock: "Optional[Callable[[], float]]" = None,
    ):
        import time as _time

        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self._config_for = config_for
        self._max_tenants = max_tenants
        self._clock = clock if clock is not None else _time.monotonic
        self._lock = threading.Lock()
        #: tenant -> entry, least-recently-fed first (move_to_end per touch;
        #: eviction pops the front — bounded by construction)
        self._entries: "OrderedDict[str, _TenantSLOEntry]" = OrderedDict()
        self.evicted = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _entry(self, tenant: Optional[str]) -> "Optional[_TenantSLOEntry]":
        if tenant is None:
            return None
        with self._lock:
            entry = self._entries.get(tenant)
            if entry is not None:
                self._entries.move_to_end(tenant)
                return entry
        config = self._config_for(tenant)
        if config is None or not config.armed:
            return None
        with self._lock:
            entry = self._entries.get(tenant)
            if entry is None:
                entry = _TenantSLOEntry(config, self._clock)
                self._entries[tenant] = entry
                while len(self._entries) > self._max_tenants:
                    self._entries.popitem(last=False)
                    self.evicted += 1
            self._entries.move_to_end(tenant)
            return entry

    # ------------------------------------------------------------------ feeds

    def note_ttft(self, tenant: Optional[str], trace: Any, seconds: float) -> None:
        entry = self._entry(tenant)
        if entry is not None:
            entry.timeseries.ttft.observe(seconds)
            entry.tracker.note_ttft(trace, seconds * 1e3)

    def note_tbt(self, tenant: Optional[str], trace: Any, seconds: float) -> None:
        entry = self._entry(tenant)
        if entry is not None:
            entry.timeseries.tbt.observe(seconds)
            entry.tracker.note_tbt(trace, seconds * 1e3)

    def admitted(self, tenant: Optional[str]) -> None:
        entry = self._entry(tenant)
        if entry is not None:
            entry.timeseries.admissions.add()

    def tokens(self, tenant: Optional[str], n: int) -> None:
        entry = self._entry(tenant)
        if entry is not None and n > 0:
            entry.timeseries.tokens.add(int(n))

    def shed(self, tenant: Optional[str]) -> None:
        entry = self._entry(tenant)
        if entry is not None:
            entry.timeseries.sheds.add()

    # ------------------------------------------------------------------ reads

    def evaluate(self) -> "Dict[str, Dict[str, Any]]":
        """Every tracked tenant's SLO section (the ``tenant_slo`` block on
        ``stats()``/``/metrics``/``/healthz``): ``{}`` when no tenant ever
        armed — the tenancy-off byte-for-byte contract rides on that."""
        with self._lock:
            entries = list(self._entries.items())
        return {
            tenant: entry.tracker.evaluate(entry.timeseries)
            for tenant, entry in sorted(entries)
        }

    def clear(self) -> None:
        """Drop every tenant's state (the engine's warmup reset)."""
        with self._lock:
            self._entries.clear()
