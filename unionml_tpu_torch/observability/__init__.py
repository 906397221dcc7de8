"""End-to-end request observability for the serving stack.

The port's copy of ``unionml_tpu/observability``.

Three layers, each usable alone (docs/observability.md):

- :mod:`~unionml_tpu_torch.observability.trace` — request ids (always on: honored
  from ``X-Request-Id``, generated otherwise, echoed on every response) and
  per-request :class:`~unionml_tpu_torch.observability.trace.RequestTrace` timelines
  recording monotonic-clock events at each lifecycle stage, strictly zero-cost
  while tracing is off;
- :mod:`~unionml_tpu_torch.observability.recorder` — a
  :class:`~unionml_tpu_torch.observability.recorder.FlightRecorder` ring of the last
  N completed timelines plus the live in-flight table, served at
  ``GET /debug/requests`` and dumped to the log on drain / engine failure;
- :mod:`~unionml_tpu_torch.observability.prometheus` — the Prometheus text
  exposition of the ``/metrics`` snapshot
  (``GET /metrics?format=prometheus``);
- :mod:`~unionml_tpu_torch.observability.timeseries` — windowed time-series
  telemetry (:class:`~unionml_tpu_torch.observability.timeseries.BucketRing` /
  :class:`~unionml_tpu_torch.observability.timeseries.EngineTimeseries`): the
  engine's counters as rates over trailing windows, time-decaying TTFT/TBT
  percentiles;
- :mod:`~unionml_tpu_torch.observability.slo` — declarative SLO targets evaluated
  with multi-window burn rates through an ok→warn→breach state machine, plus
  per-request breach exemplars;
- :mod:`~unionml_tpu_torch.observability.health` — per-engine and fleet-wide health
  scores (SLO state x saturation) behind ``GET /healthz`` /
  ``GET /debug/fleet`` and the replica scheduler's route-around-breach.

Knobs flow the established serving path: engine/app kwargs <- ``serve
--trace/--flight-recorder-size/--log-format/--profile-dir/--slo-*`` <-
``UNIONML_TPU_*`` env vars via :mod:`unionml_tpu_torch.defaults`.
"""

from unionml_tpu_torch.observability.health import engine_health, fleet_debug, fleet_health
from unionml_tpu_torch.observability.prometheus import render as render_prometheus
from unionml_tpu_torch.observability.recorder import FlightRecorder, active_recorder, set_active_recorder
from unionml_tpu_torch.observability.slo import SLOConfig, SLOTracker, TenantSLORegistry
from unionml_tpu_torch.observability.timeseries import BucketRing, EngineTimeseries
from unionml_tpu_torch.observability.trace import (
    REQUEST_ID_HEADER,
    RequestTrace,
    Span,
    Tracer,
    current_request_id,
    current_trace,
    new_request_id,
    sanitize_request_id,
)

__all__ = [
    "BucketRing",
    "EngineTimeseries",
    "FlightRecorder",
    "REQUEST_ID_HEADER",
    "RequestTrace",
    "SLOConfig",
    "SLOTracker",
    "TenantSLORegistry",
    "Span",
    "Tracer",
    "active_recorder",
    "current_request_id",
    "current_trace",
    "engine_health",
    "fleet_debug",
    "fleet_health",
    "new_request_id",
    "render_prometheus",
    "sanitize_request_id",
    "set_active_recorder",
]
