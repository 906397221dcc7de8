"""The model serving application, the port's copy of ``unionml_tpu/serving/app.py``.

Parity: reference unionml/fastapi.py:15-70 — routes ``POST /predict`` (accepting
``inputs`` = reader kwargs or ``features`` = raw records), ``GET /health``, and a
``GET /`` banner; startup loads the model from ``UNIONML_MODEL_PATH`` or from the
remote backend's model registry.

Deviations, both deliberate:

- the reference pushes features through ``dataset.get_features`` twice (fastapi.py:61
  and again inside ``model.predict`` — SURVEY.md §3.2 notes the quirk); we process
  them exactly once.
- prediction requests flow through a :class:`~unionml_tpu_torch.serving.batcher.MicroBatcher`
  when the predictor has a :class:`ServingConfig`, so concurrent requests share device
  dispatches; the predictor is warmed up at startup over the configured bucket sizes,
  so no request pays a bucket's first call.

``remote=True`` loads the artifact of the backend registry's latest (or
``model_version``) training execution at ``startup()``
(:meth:`unionml_tpu_torch.remote.Backend.fetch_latest_artifact`). A replica
fleet (``--dp-replicas``, ``--replica-roles``) is built by the engine's
constructor and resized by ``POST /debug/scale``.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import os
import re
import time
from http import HTTPStatus
from typing import Any, Optional

from unionml_tpu_torch._logging import logger, set_log_format
from unionml_tpu_torch.defaults import (
    MODEL_PATH_ENV_VAR,
    SERVE_DEFAULT_DEADLINE_MS,
    SERVE_DP_REPLICAS_ENV_VAR,
    SERVE_LOG_FORMAT_ENV_VAR,
    SERVE_KV_CACHE_DTYPE_ENV_VAR,
    SERVE_MAX_INFLIGHT,
    SERVE_PROFILE_MAX_MS,
    SERVE_QUANTIZE_ENV_VAR,
    serve_flight_recorder_size,
    serve_kv_cache_dtype,
    serve_profile_dir,
    serve_quantize,
    serve_trace,
)
from unionml_tpu_torch.observability import (
    FlightRecorder,
    Tracer,
    render_prometheus,
    set_active_recorder,
)
from unionml_tpu_torch.serving.batcher import MicroBatcher, ServingConfig
from unionml_tpu_torch.serving.http import HTTPError, HTTPServer, current_query
from unionml_tpu_torch.serving.metrics import ServingMetrics
from unionml_tpu_torch.serving.overload import DeadlineExceeded, QueueFullError, current_deadline

_BANNER = """
<html>
  <head><title>unionml-tpu</title></head>
  <body>
    <h1>unionml-tpu</h1>
    <p>The easiest way to build and deploy models — on an NVIDIA GPU.</p>
  </body>
</html>
"""


class ServingApp:
    """HTTP serving app bound to a :class:`unionml_tpu_torch.model.Model`."""

    def __init__(
        self,
        model: Any,
        remote: bool = False,
        app_version: Optional[str] = None,
        model_version: str = "latest",
        batcher: Optional[MicroBatcher] = None,
    ):
        self.model = model
        self.remote = remote
        self.app_version = app_version
        self.model_version = model_version
        self.server = HTTPServer()
        # the bare HTTPServer is unbounded for back-compat; the APP is where
        # production overload posture turns on: bounded in-flight admission
        # (429 + Retry-After past the cap) and a default per-request deadline
        # (503 shed for work the client has given up on). Tunable via
        # configure_overload() / the serve CLI flags.
        self.server.max_inflight = SERVE_MAX_INFLIGHT
        self.server.default_deadline_ms = SERVE_DEFAULT_DEADLINE_MS
        self.server.on_drained = self._on_drained
        self.metrics = ServingMetrics()
        #: serve-time --dp-replicas override (None until configure_replicas)
        self.dp_replicas: Optional[int] = None
        #: serve-time quantization knobs (--quantize/--kv-cache-dtype, or the
        #: ambient UNIONML_TPU_QUANTIZE/_KV_CACHE_DTYPE exports): recorded here
        #: for introspection; the Generators the app builds resolve the env
        #: directly at construction (docs/serving.md "Quantized serving")
        self.quantize: Optional[str] = serve_quantize()
        self.kv_cache_dtype: Optional[str] = serve_kv_cache_dtype()
        self._started = False
        # ---- observability (docs/observability.md): flight recorder + tracer,
        # defaults from the UNIONML_TPU_TRACE / _FLIGHT_RECORDER_SIZE /
        # _PROFILE_DIR env exports (the serve CLI sets them before the app
        # module imports); configure_observability() overrides per app.
        self.recorder = FlightRecorder(serve_flight_recorder_size())
        self.tracer = Tracer(enabled=serve_trace(), recorder=self.recorder)
        self.server.tracer = self.tracer
        # installed process-wide so the continuous engine's failure handler can
        # dump timelines without holding an app reference
        set_active_recorder(self.recorder)
        #: torch.profiler capture directory for POST /debug/profile (None = off)
        self.profile_dir: Optional[str] = serve_profile_dir()
        self._profiling = False
        # ---- multi-tenant QoS (docs/serving.md "Multi-tenant QoS"): the
        # tenant registry from the serve --tenant-config/--default-tenant-rate
        # env exports (None = tenancy off — the anonymous-and-equal stack,
        # byte for byte). Installed process-wide like the flight recorder, so
        # generation engines built by app code consult it with no wiring.
        from unionml_tpu_torch.serving.tenancy import TenantRegistry, set_active_registry

        self.tenancy = TenantRegistry.from_env()
        set_active_registry(self.tenancy)
        # ---- traffic capture (docs/workloads.md): serve --record-traffic DIR
        # captures parsed /v1 + /predict-stream requests into replayable
        # traces through the process-wide TraceRecorder (the flight-recorder
        # install pattern). None = capture off, the zero-cost default.
        from unionml_tpu_torch.defaults import serve_record_traffic, serve_record_traffic_hash
        from unionml_tpu_torch.workloads.traces import TraceRecorder, set_active_traffic_recorder

        self.traffic_recorder: Optional[TraceRecorder] = None
        record_dir = serve_record_traffic()
        if record_dir is not None:
            try:
                self.traffic_recorder = TraceRecorder(
                    record_dir, hash_prompts=serve_record_traffic_hash()
                )
            except OSError as exc:  # unwritable dir: warn and serve uncaptured
                logger.warning(
                    f"could not open traffic capture directory {record_dir!r} ({exc}); "
                    "capture disabled"
                )
        set_active_traffic_recorder(self.traffic_recorder)
        # correlated access logs come free once either correlation signal is
        # on: tracing (timeline ids) or JSON log lines (request_id field)
        self.server.access_log = (
            self.tracer.enabled
            or os.environ.get(SERVE_LOG_FORMAT_ENV_VAR, "").strip().lower() == "json"
        )

        config = getattr(model, "_predictor_config", None)
        if batcher is not None:
            self.batcher: Optional[MicroBatcher] = batcher
        elif isinstance(config, ServingConfig) and config.max_batch_size <= 1:
            # the explicit opt-out: requests run straight through the
            # predictor, one at a time, with no coalescing wait
            self.batcher = None
        elif isinstance(config, ServingConfig):
            # while the compiled predictor pads to bucket itself, skip the batcher's
            # pandas-level padding; if it falls back to eager, batcher padding
            # resumes honoring config.pad_to_bucket
            compiled = getattr(model, "_compiled_predictor", None)
            pad = None if compiled is None else (lambda: config.pad_to_bucket and compiled._eager)
            self.batcher = MicroBatcher(
                self._predict_features_sync, config, pad_to_bucket=pad, metrics=self.metrics
            )
        else:
            # DEFAULT micro-batching: predictors registered without a
            # ServingConfig still coalesce concurrent requests — a vectorized
            # predict amortizes per-dispatch cost (a 16-row sklearn predict
            # costs about the same as 1 row), measured ~2x end-to-end on the
            # digits quickstart at 16-way concurrency. Safe by construction:
            # single-request dispatches hand the output through whole (exact
            # no-batcher semantics), mismatched feature signatures never share
            # a concat, and a non-row-aligned output falls back to per-request
            # reruns and pins the solo path (batcher.py:_dispatch).
            # ``ServingConfig(max_batch_size=1)`` on the predictor opts out.
            self.batcher = MicroBatcher(
                self._predict_features_sync,
                ServingConfig(max_batch_size=64, max_wait_ms=2.0, jit=False,
                              warmup=False, pad_to_bucket=False),
                metrics=self.metrics,
            )

        self.server.metrics = self.metrics
        # live overload gauges: queue depths + in-flight count at snapshot time
        self.metrics.register_gauge("inflight", lambda: self.server.inflight)
        # per-replica occupancy when the generation engine is a ReplicaSet;
        # evaluated lazily at snapshot time (the engine is usually built at
        # warmup or first request, after this constructor) and None — hence
        # absent from /metrics — on single-engine apps
        self.metrics.register_gauge("generation_replicas", self._replica_gauge)
        if self.batcher is not None:
            self.metrics.register_gauge(
                "micro_batcher_queue_depth", lambda: self.batcher.queue_depth
            )
        self.server.route("GET", "/", self._root)
        self.server.route("GET", "/health", self._health)
        self.server.route("GET", "/healthz", self._healthz)
        self.server.route("GET", "/metrics", self._metrics)
        self.server.route("POST", "/predict", self._predict)
        self.server.route("POST", "/predict-stream", self._predict_stream)
        self.server.route("GET", "/debug/requests", self._debug_requests)
        # the OpenAI-compatible surface (serving/openai_api.py): always
        # routed — without a generation engine the handlers answer a clear
        # 404, mirroring /predict-stream's no-stream-predictor contract
        from unionml_tpu_torch.serving.openai_api import register_openai_routes

        register_openai_routes(self)
        self.server.route_prefix("GET", "/debug/requests/", self._debug_request_by_id)
        self.server.route("GET", "/debug/fleet", self._debug_fleet)
        self.server.route("POST", "/debug/scale", self._debug_scale)
        self.server.route("POST", "/debug/profile", self._debug_profile)

    # ------------------------------------------------------------------ lifecycle

    def configure_overload(
        self,
        *,
        max_inflight: Optional[int] = None,
        default_deadline_ms: Optional[float] = None,
        max_deadline_ms: Optional[float] = None,
        drain_timeout_s: Optional[float] = None,
    ) -> "ServingApp":
        """Override the overload-protection knobs (the ``serve`` CLI flags land
        here). ``None`` leaves a knob at its current value; pass ``0`` for
        ``max_inflight``/``default_deadline_ms`` to disable that bound."""
        if max_inflight is not None:
            self.server.max_inflight = max_inflight or None
        if default_deadline_ms is not None:
            self.server.default_deadline_ms = default_deadline_ms or None
        if max_deadline_ms is not None:
            self.server.max_deadline_ms = max_deadline_ms or None
        if drain_timeout_s is not None:
            self.server.drain_timeout_s = drain_timeout_s
        return self

    def configure_observability(
        self,
        *,
        trace: Optional[bool] = None,
        flight_recorder_size: Optional[int] = None,
        log_format: Optional[str] = None,
        profile_dir: Optional[str] = None,
        access_log: Optional[bool] = None,
    ) -> "ServingApp":
        """Override the observability knobs (the ``serve
        --trace/--flight-recorder-size/--log-format/--profile-dir`` flags land
        here; docs/observability.md). ``None`` leaves a knob at its current
        value. ``log_format="json"`` also turns the per-request access log on
        (that is the correlation the structured lines exist for) unless
        ``access_log`` explicitly says otherwise."""
        if flight_recorder_size is not None and flight_recorder_size != self.recorder.capacity:
            self.recorder = FlightRecorder(flight_recorder_size)
            self.tracer.recorder = self.recorder
            set_active_recorder(self.recorder)
        if trace is not None:
            self.tracer.enabled = bool(trace)
            if access_log is None and trace:
                access_log = True
        if log_format is not None:
            set_log_format(log_format)
            if access_log is None:
                access_log = str(log_format).strip().lower() == "json"
        if profile_dir is not None:
            self.profile_dir = str(profile_dir) or None
        if access_log is not None:
            self.server.access_log = bool(access_log)
        return self

    def configure_replicas(
        self,
        dp_replicas: Optional[int] = None,
        *,
        replica_roles: Optional[str] = None,
        prefill_threshold: Optional[int] = None,
    ) -> "ServingApp":
        """Record the serve-time ``--dp-replicas`` / ``--replica-roles`` /
        ``--prefill-threshold`` overrides and export them so generation
        engines built after startup (warmup hooks, first-request
        construction) replicate — and disaggregate:
        ``ContinuousBatcher(...)`` consults the env vars and builds a
        :class:`~unionml_tpu_torch.serving.replicas.ReplicaSet` from them,
        which ``POST /debug/scale`` then resizes."""
        if dp_replicas is not None:
            if dp_replicas < 0:
                raise ValueError("dp_replicas must be >= 0 (0 = derive from the mesh)")
            self.dp_replicas = dp_replicas
            os.environ[SERVE_DP_REPLICAS_ENV_VAR] = str(dp_replicas)
        if replica_roles is not None:
            from unionml_tpu_torch.defaults import SERVE_REPLICA_ROLES_ENV_VAR, parse_replica_roles

            parse_replica_roles(replica_roles)  # explicit config must not degrade silently
            os.environ[SERVE_REPLICA_ROLES_ENV_VAR] = replica_roles
        if prefill_threshold is not None:
            from unionml_tpu_torch.defaults import SERVE_PREFILL_THRESHOLD_ENV_VAR

            if prefill_threshold < 0:
                raise ValueError("prefill_threshold must be >= 0")
            os.environ[SERVE_PREFILL_THRESHOLD_ENV_VAR] = str(prefill_threshold)
        return self

    def configure_cold_start(
        self,
        compile_cache: Optional[str] = None,
        aot_preload: Optional[str] = None,
    ) -> "ServingApp":
        """Record the serve-time ``--compile-cache``/``--aot-preload``
        overrides and export them: the :meth:`configure_replicas` env
        contract, so generation engines built after startup (warmup hooks,
        first-request construction) arm the AOT program store. ``None``
        leaves a knob alone; an empty string (or ``"0"`` and the other
        off-flags) turns it off. ``compile_cache`` also points the kernel
        build directory at the cache now (the package-import hook already
        ran by the time this executes); a directory that cannot be made
        warns and keeps the old one."""
        from unionml_tpu_torch.defaults import (
            _FALSY_FLAGS,
            SERVE_AOT_PRELOAD_ENV_VAR,
            SERVE_COMPILE_CACHE_ENV_VAR,
        )

        if compile_cache is not None:
            os.environ[SERVE_COMPILE_CACHE_ENV_VAR] = str(compile_cache)
            if str(compile_cache).strip().lower() not in _FALSY_FLAGS:
                from unionml_tpu_torch.compile_cache import enable_compile_cache

                try:
                    enable_compile_cache(str(compile_cache))
                except OSError as exc:  # an unwritable dir degrades, never crashes
                    logger.warning(f"could not enable the kernel build cache: {exc}")
        if aot_preload is not None:
            os.environ[SERVE_AOT_PRELOAD_ENV_VAR] = str(aot_preload)
        return self

    def configure_quantization(
        self,
        quantize: Optional[str] = None,
        kv_cache_dtype: Optional[str] = None,
    ) -> "ServingApp":
        """Record the serve-time ``--quantize``/``--kv-cache-dtype`` overrides
        and export them so generation Generators built after startup (warmup
        hooks, first-request construction) resolve them — the same env-export
        contract as :meth:`configure_replicas` (docs/serving.md "Quantized
        serving"). ``None`` leaves a knob alone; ``"none"`` explicitly forces
        full precision over an inherited fleet-wide export; ``"int8"`` is the
        only quantized mode today (the same values the env readers accept —
        anything else raises here, matching the Generator's own rejection)."""
        for value, what, env_name in (
            (quantize, "quantize mode", SERVE_QUANTIZE_ENV_VAR),
            (kv_cache_dtype, "kv_cache_dtype", SERVE_KV_CACHE_DTYPE_ENV_VAR),
        ):
            if value is None:
                continue
            if value not in ("int8", "none"):
                raise ValueError(f"unsupported {what} {value!r}; expected 'int8' or 'none'")
            os.environ[env_name] = value
        if quantize is not None:
            self.quantize = None if quantize == "none" else quantize
        if kv_cache_dtype is not None:
            self.kv_cache_dtype = None if kv_cache_dtype == "none" else kv_cache_dtype
        return self

    def configure_tenancy(
        self,
        tenant_config: Optional[str] = None,
        default_tenant_rate: Optional[float] = None,
    ) -> "ServingApp":
        """Record the serve-time ``--tenant-config``/``--default-tenant-rate``
        overrides, export them (the :meth:`configure_replicas` env contract),
        and rebuild + reinstall the process-wide
        :class:`~unionml_tpu_torch.serving.tenancy.TenantRegistry`. ``None`` leaves
        a knob alone; an empty string path clears the config."""
        from unionml_tpu_torch.defaults import (
            SERVE_DEFAULT_TENANT_RATE_ENV_VAR,
            SERVE_TENANT_CONFIG_ENV_VAR,
        )
        from unionml_tpu_torch.serving.tenancy import TenantRegistry, set_active_registry

        if tenant_config is not None:
            if tenant_config:
                os.environ[SERVE_TENANT_CONFIG_ENV_VAR] = str(tenant_config)
            else:
                os.environ.pop(SERVE_TENANT_CONFIG_ENV_VAR, None)
        if default_tenant_rate is not None:
            if default_tenant_rate < 0:
                raise ValueError("default_tenant_rate must be >= 0 (0 = unlimited)")
            os.environ[SERVE_DEFAULT_TENANT_RATE_ENV_VAR] = repr(float(default_tenant_rate))
        if tenant_config is not None or default_tenant_rate is not None:
            self.tenancy = TenantRegistry.from_env()
            set_active_registry(self.tenancy)
        return self

    def configure_traffic_capture(
        self,
        record_traffic: Optional[str] = None,
        hash_prompts: Optional[bool] = None,
    ) -> "ServingApp":
        """Override the ``serve --record-traffic`` capture knobs
        (docs/workloads.md): ``record_traffic`` points (or, empty string,
        clears) the capture directory, ``hash_prompts`` switches the privacy
        digest mode. Rebuilds and reinstalls the process-wide recorder, like
        :meth:`configure_tenancy` does its registry."""
        import os as _os

        from unionml_tpu_torch.defaults import (
            SERVE_RECORD_TRAFFIC_ENV_VAR,
            SERVE_RECORD_TRAFFIC_HASH_ENV_VAR,
            serve_record_traffic,
            serve_record_traffic_hash,
        )
        from unionml_tpu_torch.workloads.traces import TraceRecorder, set_active_traffic_recorder

        if record_traffic is None and hash_prompts is None:
            return self
        if record_traffic is not None:
            if record_traffic:
                _os.environ[SERVE_RECORD_TRAFFIC_ENV_VAR] = str(record_traffic)
            else:
                _os.environ.pop(SERVE_RECORD_TRAFFIC_ENV_VAR, None)
        if hash_prompts is not None:
            _os.environ[SERVE_RECORD_TRAFFIC_HASH_ENV_VAR] = "1" if hash_prompts else "0"
        if self.traffic_recorder is not None:
            self.traffic_recorder.close()
            self.traffic_recorder = None
        directory = serve_record_traffic()
        if directory is not None:
            try:
                self.traffic_recorder = TraceRecorder(
                    directory, hash_prompts=serve_record_traffic_hash()
                )
            except OSError as exc:
                logger.warning(
                    f"could not open traffic capture directory {directory!r} ({exc}); "
                    "capture disabled"
                )
        set_active_traffic_recorder(self.traffic_recorder)
        return self

    def _replica_gauge(self) -> Optional[Any]:
        batcher = getattr(self.model, "generation_batcher", None)
        loads = getattr(batcher, "replica_loads", None)
        return loads() if callable(loads) else None

    def _on_drained(self) -> None:
        """Server drain hook: after in-flight HTTP work finishes, close the
        model's continuous-batching engine (residents already drained — any
        stragglers finish on the engine thread) so its decode thread and device
        pool don't outlive the server."""
        batcher = getattr(self.model, "generation_batcher", None)
        if batcher is not None and hasattr(batcher, "close"):
            try:
                batcher.close(wait=False)
            except Exception:  # pragma: no cover - defensive
                logger.exception("generation batcher close failed during drain")
        # a live traffic capture flushes per line; the drain close makes the
        # trace file complete (and logs where it went) before the process exits
        if self.traffic_recorder is not None:
            try:
                path = self.traffic_recorder.close()
                if path is not None:
                    logger.info(f"traffic capture written to {path}")
            except Exception:  # pragma: no cover - defensive
                logger.exception("traffic capture close failed during drain")
        # postmortem on the way out: whatever timelines the recorder holds
        # (requests that never finished included) reach the log before the
        # process exits — skipped when tracing never recorded anything
        if len(self.recorder) or self.recorder.inflight_count:
            try:
                self.recorder.dump("graceful drain")
            except Exception:  # pragma: no cover - defensive
                logger.exception("flight recorder dump failed during drain")

    def startup(self) -> None:
        """Load the model artifact (reference fastapi.py:22-34 startup hook)."""
        if self._started:
            return
        if self.model.artifact is None:
            model_path = os.getenv(MODEL_PATH_ENV_VAR)
            if self.remote:
                self.model.artifact = self.model._backend.fetch_latest_artifact(
                    self.model, app_version=self.app_version, model_version=self.model_version
                )
            elif model_path is not None:
                self.model.load(model_path)
            else:
                raise ValueError(
                    "Model artifact path not specified. Make sure to specify the --model-path option of "
                    "`python -m unionml_tpu_torch.cli serve` when starting the prediction service in local mode."
                )
        self._warmup()
        self._started = True

    def _warmup(self) -> None:
        """Run the predictor once over every configured batch-size bucket, and
        the app's generation warmup (engine build, kernel builds at first
        launch): paying them at startup keeps request p50 flat.
        """
        config = getattr(self.model, "_predictor_config", None)
        if isinstance(config, ServingConfig) and config.warmup:
            warmup_fn = getattr(self.model, "_predictor_warmup", None)
            if warmup_fn is not None:
                # one call: CompiledPredictor.warmup sweeps EVERY configured
                # bucket itself (per-bucket calls here would re-sweep the
                # whole set len(buckets) times)
                try:
                    warmup_fn()
                except Exception as exc:  # warmup is best-effort
                    logger.warning(f"predictor warmup failed: {exc}")
        # generation apps register a callable (e.g. building + warming their
        # ContinuousBatcher) to run once at startup, after the artifact loads —
        # first streams then skip the cold compiles
        gen_warmup = getattr(self.model, "generation_warmup", None)
        if callable(gen_warmup):
            try:
                gen_warmup()
            except Exception as exc:  # warmup is best-effort
                logger.warning(f"generation warmup failed: {exc}")

    _FEATURES_ENVELOPE = re.compile(rb'\A\s*\{\s*"features"\s*:\s*(?=\[)')

    def _predict_features_fast(self, body: bytes) -> Any:
        """Parse a pure-features envelope via the native records parser; None = use
        the Python path (custom feature pipeline, inputs present, non-flat records,
        or no native toolchain). Requires a loaded artifact like the slow path."""
        if self.model.artifact is None:
            return None
        match = self._FEATURES_ENVELOPE.match(body)
        if match is None:
            return None
        try:
            parsed = self.model._dataset.get_features_from_bytes(body[match.end():], allow_trailing=True)
        except Exception:
            return None
        if parsed is None:
            return None
        features, consumed = parsed
        if body[match.end() + consumed:].strip() != b"}":
            return None  # envelope has other keys (e.g. inputs) -> slow path
        return features

    def _predict_features_sync(self, features: Any) -> Any:
        # features arriving here are already model-ready (the handler ran
        # dataset.get_features before enqueueing) — go straight to the
        # predict-from-features graph so loader/transformer don't run twice
        return self.model.predict_from_features_workflow()(
            model_object=self.model.artifact.model_object, features=features
        )

    # ------------------------------------------------------------------ handlers

    async def _root(self, body: bytes):
        return 200, _BANNER, "text/html"

    async def _health(self, body: bytes):
        """Liveness + readiness in one probe: ``ready`` is the rolling-restart
        signal — a draining server answers 503/ready=false so the load balancer
        stops routing to it while in-flight streams finish."""
        if self.model.artifact is None:
            raise HTTPError(500, "Model artifact not found.")
        if self.server.draining:
            return (
                503,
                {"message": "draining", "status": 503, "ready": False},
                "application/json",
            )
        return (
            200,
            {"message": HTTPStatus.OK.phrase, "status": int(HTTPStatus.OK), "ready": True},
            "application/json",
        )

    async def _healthz(self, body: bytes):
        """Detailed fleet health (``/health`` stays the bare readiness bool the
        reference shipped): the fleet health score with per-replica windowed
        rates, SLO states, and saturation (observability/health.py,
        docs/observability.md "SLOs and fleet health"). Draining answers 503
        like ``/health`` so a load balancer probing either behaves the same."""
        from unionml_tpu_torch.observability.health import fleet_health

        payload = fleet_health(getattr(self.model, "generation_batcher", None))
        ready = self.model.artifact is not None and not self.server.draining
        payload["ready"] = ready
        status = 503 if self.server.draining else 200
        payload["status"] = status
        return status, payload, "application/json"

    async def _debug_fleet(self, body: bytes):
        """The routing-and-health view in one fetch: fleet + per-replica
        health, live replica loads, the scheduler's telemetry, and the
        exemplar count — "who is unhealthy AND where is traffic going"."""
        from unionml_tpu_torch.observability.health import fleet_debug

        payload = fleet_debug(getattr(self.model, "generation_batcher", None))
        payload["tracing"] = self.tracer.enabled
        payload["exemplars"] = self.recorder.exemplar_count
        return 200, payload, "application/json"

    async def _debug_scale(self, body: bytes):
        """Operator-driven elastic resize: ``POST /debug/scale`` with
        ``{"replicas": N}`` (optional ``"role"`` for added replicas) calls the
        generation fleet's ``scale_to`` — scale-up places params on a spare
        submesh and warms before joining the scheduler; scale-down drains the
        tail replica with zero in-flight streams lost. The resize (warmup
        included) runs in the default executor so the event loop keeps
        serving while it completes; the response reports the new fleet
        health, which ``/healthz``/``/metrics`` already reflect."""
        batcher = getattr(self.model, "generation_batcher", None)
        scale = getattr(batcher, "scale_to", None)
        if not callable(scale):
            raise HTTPError(
                400,
                "no elastic generation fleet to scale; serve a ReplicaSet "
                "(e.g. --dp-replicas/--replica-roles) and set model.generation_batcher",
            )
        payload = self._parse_json_object(body)
        replicas = payload.get("replicas")
        if not isinstance(replicas, int) or isinstance(replicas, bool) or replicas < 1:
            raise HTTPError(400, f"replicas must be a positive integer, got {replicas!r}")
        role = payload.get("role")
        if role is not None and role not in ("prefill", "decode", "mixed"):
            raise HTTPError(400, f"role must be prefill/decode/mixed, got {role!r}")
        loop = asyncio.get_running_loop()
        try:
            count = await loop.run_in_executor(None, lambda: scale(replicas, role=role))
        except (ValueError, RuntimeError) as exc:
            raise HTTPError(400, f"scale_to failed: {exc}")
        from unionml_tpu_torch.observability.health import fleet_health

        return 200, {"replicas": count, "health": fleet_health(batcher)}, "application/json"

    async def _metrics(self, body: bytes):
        """Request counters and latency percentiles per route (SURVEY.md §5.5 —
        p50/p99 are the BASELINE serving metric, measured in-server, not just by
        the external benchmark client). ``?format=prometheus`` renders the SAME
        snapshot as Prometheus text exposition for scrape-based monitoring."""
        fmt = current_query().get("format", "json").strip().lower()
        if fmt not in ("json", "prometheus"):
            raise HTTPError(400, f"unknown metrics format {fmt!r} (json or prometheus)")
        snapshot = self.metrics.snapshot()
        compiled = getattr(self.model, "_compiled_predictor", None)
        if compiled is not None:
            # makes the bounded-compile guarantee observable: traces must stay at
            # len(buckets) no matter how many request shapes arrive
            snapshot["predictor"] = {"traces": compiled.traces, "eager_fallback": compiled._eager}
        # generation serving: apps that set model.generation_batcher (e.g. the
        # text-generation template's shared ContinuousBatcher) surface slot
        # utilization, shared-dispatch counts, and speculative acceptance here
        batcher = getattr(self.model, "generation_batcher", None)
        if batcher is not None and hasattr(batcher, "stats"):
            snapshot["generation"] = batcher.stats()
        if self.batcher is not None:
            # coalescing effectiveness is the serving-throughput lever — make
            # it observable (avg rows per dispatch -> how much of the
            # vectorization win concurrency is actually realizing)
            snapshot["micro_batcher"] = self.batcher.stats()
        if self.tenancy is not None:
            # multi-tenant QoS: per-tenant admission/shed/generated-token
            # counters and fair-share weights — the registry's state map is
            # bounded, so the label cardinality this mints is too. Absent
            # entirely when tenancy is off (the byte-for-byte contract).
            snapshot["tenants"] = self.tenancy.stats()
        if self.traffic_recorder is not None:
            # traffic capture counters (serve --record-traffic): absent with
            # capture off, ints only — the no-None-gauge contract
            snapshot["traffic_capture"] = self.traffic_recorder.stats()
        if fmt == "prometheus":
            return 200, render_prometheus(snapshot), "text/plain; version=0.0.4"
        return 200, snapshot, "application/json"

    # ------------------------------------------------------------------ debug surface

    async def _debug_requests(self, body: bytes):
        """The flight recorder's tables: live in-flight request timelines plus
        the ring of recently completed ones. Filters: ``?route=`` (substring
        of ``METHOD /path``), ``?status=`` (exact), ``?limit=`` (per table,
        default 100), ``?min_ms=`` (only timelines at least that long —
        slow-request triage without dumping the whole ring), ``?slo=breach``
        (the pinned SLO-breach exemplar ring), and ``?tenant=`` (only
        timelines stamped with that tenant id — multi-tenant QoS triage)."""
        query = current_query()
        status: Optional[int] = None
        if query.get("status"):
            try:
                status = int(query["status"])
            except ValueError:
                raise HTTPError(400, f"status filter must be an integer, got {query['status']!r}")
        limit = 100
        if query.get("limit"):
            try:
                limit = max(int(query["limit"]), 0)
            except ValueError:
                raise HTTPError(400, f"limit must be an integer, got {query['limit']!r}")
        min_ms: Optional[float] = None
        if query.get("min_ms"):
            try:
                min_ms = float(query["min_ms"])
            except ValueError:
                raise HTTPError(400, f"min_ms filter must be a number, got {query['min_ms']!r}")
        slo = query.get("slo", "").strip().lower()
        if slo and slo != "breach":
            raise HTTPError(400, f"unknown slo filter {slo!r} (only 'breach' is recorded)")
        snapshot = self.recorder.snapshot(
            route=query.get("route") or None, status=status, limit=limit,
            min_ms=min_ms, slo_breach=slo == "breach",
            tenant=query.get("tenant") or None,
        )
        snapshot["tracing"] = self.tracer.enabled
        return 200, snapshot, "application/json"

    async def _debug_request_by_id(self, body: bytes, request_id: str):
        """One request's full timeline by id (the value every response echoes
        in ``X-Request-Id``)."""
        found = self.recorder.get(request_id)
        if found is None:
            detail = f"no recorded timeline for request id {request_id!r}"
            if not self.tracer.enabled:
                detail += " (tracing is off; enable with serve --trace or UNIONML_TPU_TRACE=1)"
            raise HTTPError(404, detail)
        return 200, found, "application/json"

    async def _debug_profile(self, body: bytes):
        """On-demand ``torch.profiler`` capture: traces host activity, and the
        card's where CUDA is available, for ``duration_ms`` and writes a
        Chrome trace into ``profile_dir``, bounded by ``SERVE_PROFILE_MAX_MS``.
        One capture at a time — overlapping requests get 409 (the profiler is
        process-global state)."""
        if self.profile_dir is None:
            raise HTTPError(
                400,
                "profiling is not configured; start serve with --profile-dir "
                "(or set UNIONML_TPU_PROFILE_DIR)",
            )
        payload = self._parse_json_object(body) if body.strip() else {}
        duration_ms = payload.get("duration_ms", 1000.0)
        try:
            duration_ms = float(duration_ms)
        except (TypeError, ValueError):
            raise HTTPError(400, f"duration_ms must be a number, got {duration_ms!r}")
        if duration_ms <= 0:
            raise HTTPError(400, "duration_ms must be > 0")
        duration_ms = min(duration_ms, SERVE_PROFILE_MAX_MS)
        if self._profiling:
            # process-global profiler state: a second capture would raise
            # inside torch.profiler — shed the overlap cleanly instead
            raise HTTPError(409, "a profile capture is already in progress")
        self._profiling = True
        try:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.profile_dir, exist_ok=True)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
            try:
                # the capture window; a handler cancellation (deadline) still
                # stops the trace via the finally
                await asyncio.sleep(duration_ms / 1000.0)
            finally:
                profiler.stop()
                profiler.export_chrome_trace(
                    os.path.join(self.profile_dir, f"serve-{os.getpid()}-{time.time_ns()}.trace.json")
                )
        finally:
            self._profiling = False
        logger.info(f"profile capture complete: {duration_ms:.0f} ms -> {self.profile_dir}")
        return 200, {"profile_dir": self.profile_dir, "duration_ms": duration_ms}, "application/json"

    async def _submit_batched(self, features: Any) -> Any:
        """Batcher submit with the request deadline attached and overload
        errors re-raised untouched — the HTTP layer maps QueueFullError to 429
        + Retry-After and DeadlineExceeded to 503; everything else is a 500."""
        try:
            return await self.batcher.submit(features, deadline=current_deadline())
        except (QueueFullError, DeadlineExceeded):
            raise
        except HTTPError:
            raise
        except Exception as exc:
            raise HTTPError(500, f"prediction failed: {type(exc).__name__}: {exc}")

    async def _predict(self, body: bytes):
        # native fast path: a {"features": [flat numeric records]} envelope is parsed
        # straight from the wire bytes into a float64 DataFrame by the C++ records
        # parser — json.loads and its dict-of-PyObjects intermediate never run.
        # Dtype caveat: the fast path coerces every numeric column to float64,
        # while the Python path preserves int64/bool dtypes from
        # pd.DataFrame(records); values are identical, but a dtype-sensitive
        # custom predictor may behave differently between the two paths.
        fast = self._predict_features_fast(body)
        if fast is not None:
            if len(fast) == 0:
                return 200, [], "application/json"  # no rows -> no predictions
            try:
                if self.batcher is not None:
                    return 200, _to_jsonable(await self._submit_batched(fast)), "application/json"
                return 200, _to_jsonable(self._predict_features_sync(fast)), "application/json"
            except (HTTPError, QueueFullError, DeadlineExceeded):
                raise
            except Exception as exc:
                raise HTTPError(500, f"prediction failed: {type(exc).__name__}: {exc}")
        payload = self._parse_json_object(body)

        inputs = payload.get("inputs")
        features = payload.get("features")
        if inputs is None and features is None:
            raise HTTPError(500, "inputs or features must be supplied.")
        if inputs is None and isinstance(features, (list, tuple)) and len(features) == 0:
            return 200, [], "application/json"  # no rows -> no predictions
        if self.model.artifact is None:
            raise HTTPError(500, "Model artifact not found.")

        try:
            if inputs is not None:
                predictions = self.model.predict(**inputs)
            elif self.batcher is not None:
                predictions = await self._submit_batched(self.model._dataset.get_features(features))
            else:
                predictions = self.model.predict(features=features)
        except (HTTPError, QueueFullError, DeadlineExceeded):
            raise
        except Exception as exc:
            raise HTTPError(500, f"prediction failed: {type(exc).__name__}: {exc}")
        return 200, _to_jsonable(predictions), "application/json"

    @staticmethod
    def _parse_json_object(body: bytes) -> dict:
        """Shared request-body contract for /predict and /predict-stream."""
        try:
            payload = json.loads(body.decode() or "{}")
        except json.JSONDecodeError as exc:
            raise HTTPError(400, f"invalid JSON body: {exc}")
        if not isinstance(payload, dict):
            raise HTTPError(400, "request body must be a JSON object")
        return payload

    async def _predict_stream(self, body: bytes):
        """Incremental predictions as newline-delimited JSON over chunked transfer.

        Requires a registered ``@model.stream_predictor`` — an
        ``fn(model_object, features) -> iterator of chunks`` (e.g. wrapping
        :meth:`unionml_tpu.models.generate.Generator.stream`). Each yielded chunk
        is one ND-JSON line on the wire, emitted as it materializes. The blocking
        iterator is advanced in the default executor so device steps never stall
        the event loop. The FIRST chunk is produced before the response starts:
        generator-function predictors defer their body to the first ``next()``,
        so without this a setup error would surface as a truncated 200 instead
        of a 500 — and it makes the in-server latency metric for this route mean
        time-to-first-chunk."""
        if self.model._stream_predictor is None:
            raise HTTPError(404, "no stream predictor registered; use @model.stream_predictor")
        payload = self._parse_json_object(body)
        features = payload.get("features")
        if features is None:
            raise HTTPError(500, "features must be supplied.")
        if self.model.artifact is None:
            raise HTTPError(500, "Model artifact not found.")
        from unionml_tpu_torch.workloads.traces import active_traffic_recorder

        traffic = active_traffic_recorder()
        if traffic is not None:
            # the /predict-stream capture keeps the raw (validated) body: its
            # features need not be token ids, so the replayer re-sends the
            # body verbatim (docs/workloads.md)
            from unionml_tpu_torch.serving.tenancy import current_priority, current_tenant, priority_name

            priority = current_priority()
            traffic.record(
                "/predict-stream", body=payload, tenant=current_tenant(),
                priority=priority_name(priority) if priority is not None else None,
            )
        loop = asyncio.get_running_loop()
        sentinel = object()
        # run_in_executor does NOT propagate contextvars — but a generator
        # stream predictor's body runs at first next(), on the executor, and
        # that body is where ContinuousBatcher.submit captures the request
        # id/trace. ctx.run carries the handler's context across; the nexts
        # are strictly sequential, so re-entering the copy is safe.
        ctx = contextvars.copy_context()
        try:
            features = self.model._dataset.get_features(features)
            iterator = iter(self.model._stream_predictor(self.model.artifact.model_object, features))
            first = await loop.run_in_executor(None, ctx.run, next, iterator, sentinel)
        except (HTTPError, QueueFullError, DeadlineExceeded):
            # a continuous-batching engine shedding at admission (queue full /
            # deadline) surfaces through the predictor's first next(); let the
            # HTTP layer map it to 429/503 instead of burying it in a 500
            raise
        except Exception as exc:
            raise HTTPError(500, f"stream predictor failed: {type(exc).__name__}: {exc}")

        async def chunks():
            completed = False
            try:
                item = first
                while item is not sentinel:
                    yield (json.dumps(_to_jsonable(item), default=str) + "\n").encode()
                    item = await loop.run_in_executor(None, ctx.run, next, iterator, sentinel)
                completed = True
            finally:
                # the server acloses this generator when the client goes away;
                # closing the underlying iterator releases the producer (e.g. a
                # ContinuousBatcher slot stops decoding to a dead connection).
                # A normally-exhausted iterator needs no close — skip the
                # executor round-trip on the happy path.
                if not completed:
                    close = getattr(iterator, "close", None)
                    if close is not None:
                        # DETACHED task: the server may cancel this handler
                        # while acloseing it, and a cancelled await here would
                        # abandon the retry loop with the producer still
                        # decoding — the release must outlive the handler
                        task = loop.create_task(_close_iterator(loop, close))
                        _pending_closes.add(task)
                        task.add_done_callback(_pending_closes.discard)

        return 200, chunks(), "application/x-ndjson"

    # ------------------------------------------------------------------ entry points

    def run(self, host: str = "127.0.0.1", port: int = 8000, *, reuse_port: bool = False) -> None:
        """Blocking server loop (used by the ``serve`` CLI command)."""
        self.startup()
        self.server.run(host, port, reuse_port=reuse_port)

    async def dispatch(self, method: str, path: str, body: bytes = b"", headers: Optional[dict] = None):
        """In-process request dispatch — the test-client surface. ``headers``
        (lower-cased names) participate in deadline propagation exactly like
        wire requests (``x-request-deadline-ms``)."""
        self.startup()
        return await self.server.dispatch(method, path, body, headers)


#: strong refs to in-flight detached close tasks (the loop only holds weak ones)
_pending_closes: set = set()


async def _close_iterator(loop, close) -> None:
    """Close a stream-predictor iterator, tolerating an in-flight ``next()``:
    a disconnect can race the executor thread still blocked on the next chunk,
    in which case a GENERATOR's ``close()`` raises "already executing" — retry
    until that call returns. The wait is bounded by the producer's chunk
    cadence, which can include a multi-minute first-dispatch kernel build — the exponential backoff (0.2s doubling to 5s,
    ~20 min total) outlives even that worst case, so a disconnect during the
    compile window still releases the producer. Each ``close()`` attempt is a
    fast executor call and every wait happens on the EVENT LOOP, so no executor
    thread is parked for the duration — a pile-up of disconnected clients can't
    starve the shared default executor that live streams advance on.
    (ContinuousBatcher streams are plain objects whose close works immediately
    — no retry needed.)"""
    delay, waited = 0.2, 0.0
    while True:
        try:
            await loop.run_in_executor(None, close)
            return
        # CPython raises ValueError("generator already executing") from
        # gen.close() against a generator blocked in next() on another thread
        # (RuntimeError kept for alternative iterator implementations)
        except (RuntimeError, ValueError) as exc:
            if "already executing" not in str(exc):
                # a cleanup failure, not the in-flight race: retrying won't help
                logger.warning(f"stream iterator close failed: {exc}")
                return
            if waited >= 1200.0:
                break
            await asyncio.sleep(delay)
            waited += delay
            delay = min(delay * 2, 5.0)
    logger.warning("could not close stream iterator after disconnect; producer may leak")


def _to_jsonable(obj: Any) -> Any:
    import numpy as np

    try:
        import pandas as pd

        if isinstance(obj, (pd.DataFrame, pd.Series)):
            return json.loads(obj.to_json(orient="records"))
    except ImportError:  # pragma: no cover
        pass
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    import torch

    if isinstance(obj, torch.Tensor):
        # to the CPU first; bf16 (and f16) values become Python floats
        obj = obj.detach().cpu()
        if obj.is_floating_point() and obj.element_size() < 4:
            obj = obj.float()
        return obj.tolist()
    return obj


def serving_app(
    model: Any,
    app: Any = None,
    remote: bool = False,
    app_version: Optional[str] = None,
    model_version: str = "latest",
    batcher: Optional[MicroBatcher] = None,
) -> ServingApp:
    """Create (or bind) the serving app for a model.

    ``app`` exists for signature parity with the reference (which mutates a FastAPI
    instance, unionml/fastapi.py:15); passing an existing :class:`ServingApp` rebinds
    it, anything else is ignored in favor of a fresh app.
    """
    if isinstance(app, ServingApp):
        return app
    if app is not None:
        logger.warning(
            f"serving_app received an app of type {type(app).__name__}; unlike the reference "
            "(which mutates a FastAPI instance in place), unionml-tpu builds its own ServingApp — "
            "the passed object is ignored. Use the returned ServingApp."
        )
    return ServingApp(model, remote=remote, app_version=app_version, model_version=model_version, batcher=batcher)
