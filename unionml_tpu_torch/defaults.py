"""Default execution settings and serve-time knobs read from the environment.

The subset of ``unionml_tpu/defaults.py`` that the port reads:

- ``Resources``, ``DEFAULT_RESOURCES`` and ``MODEL_PATH_ENV_VAR`` for the app
  protocol (``stage.py``, ``model.py``);
- the serve CLI's exports, read when an object is built, after the CLI has
  set them: every ``Generator`` resolves an unset ``quantize=`` and
  ``config.kv_cache_dtype`` from ``UNIONML_TPU_QUANTIZE`` and
  ``UNIONML_TPU_KV_CACHE_DTYPE``; every engine resolves an unset
  ``admit_chunk``, ``prefill_budget``, ``max_admissions`` and
  ``prefix_cache`` from the four admission knobs; the engine's constructor
  reads ``UNIONML_TPU_DP_REPLICAS`` and ``UNIONML_TPU_REPLICA_ROLES`` to
  build a replica fleet, which reads the prefill threshold and the
  autoscaler's watermarks, interval and fleet bounds;
- the serving app's overload limits (``SERVE_MAX_INFLIGHT`` and its
  siblings) and the serve readers it and the engine call at construction:
  tracing, the flight recorder, the profile directory, the log format,
  tenancy, traffic capture and the six ``UNIONML_TPU_SLO_*`` targets;
- the multi-process bootstrap's three knobs (``UNIONML_TPU_COORDINATOR``,
  ``UNIONML_TPU_NUM_PROCESSES``, ``UNIONML_TPU_PROCESS_ID``), which
  :mod:`unionml_tpu_torch.distributed` reads beside torchrun's;
- the multi-host fleet's knobs (the rendezvous directory, the fault plan,
  the probe interval, probation and dead-after streaks, the coordinator's
  lease TTL and the per-host roles), read by ``serving/cluster.py`` and
  ``serving/faults.py`` at construction.

A copy, not an import: the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Resources:
    """Resource request attached to a :class:`unionml_tpu_torch.stage.Stage`.

    The JAX package's fields, kept for the stage interface: ``accelerator``
    names an accelerator topology and ``chips`` how many; ``None`` means
    host-only execution, the default for data-plumbing stages. Nothing in
    the port schedules on them: the remote backend takes its accelerator
    from ``Model.remote(accelerator=...)``, as in JAX.
    """

    cpu: str = "1"
    mem: str = "1Gi"
    accelerator: Optional[str] = None
    chips: int = 0


DEFAULT_RESOURCES = Resources()

#: Environment variable used by ``load_from_env`` (and the serve CLI), the
#: name the JAX package and UnionML use.
MODEL_PATH_ENV_VAR = "UNIONML_MODEL_PATH"

#: concurrent requests executing handlers before the HTTP layer sheds with 429.
SERVE_MAX_INFLIGHT = 256

#: micro-batcher admission queue bound (requests waiting to join a dispatch);
#: a full queue sheds with 429 instead of growing without bound.
SERVE_QUEUE_MAXSIZE = 1024

#: continuous-batching engine waiting-queue bound (prompts waiting for a free
#: decode slot) — ahead of the fixed slot pool itself.
SERVE_MAX_WAITING = 256

#: server-default per-request deadline (ms); a request still queued past it is
#: shed with 503, one mid-handler is cancelled. ``X-Request-Deadline-Ms`` lets
#: a client tighten (or, up to the max below, extend) it per request.
SERVE_DEFAULT_DEADLINE_MS = 30_000.0

#: ceiling on client-requested deadlines (ms): a client cannot pin server
#: resources longer than this no matter what header it sends.
SERVE_MAX_DEADLINE_MS = 300_000.0

#: seconds a SIGTERM-initiated drain waits for in-flight requests and streams
#: to finish before the process exits anyway.
SERVE_DRAIN_TIMEOUT_S = 30.0

#: ``Retry-After`` seconds attached to 429/503 shed responses.
SERVE_RETRY_AFTER_S = 1

#: the serve CLI's ``--dp-replicas`` export: a count above 1 asks for that
#: many engine replicas
SERVE_DP_REPLICAS_ENV_VAR = "UNIONML_TPU_DP_REPLICAS"

#: the serve CLI's ``--replica-roles`` export, e.g. ``prefill=1,decode=3``
#: (roles: prefill / decode / mixed; the counts sum to the fleet size)
SERVE_REPLICA_ROLES_ENV_VAR = "UNIONML_TPU_REPLICA_ROLES"

#: roles a replica may carry; "mixed" prefills and decodes in one engine
REPLICA_ROLES = ("prefill", "decode", "mixed")

#: "int8" = weight-only int8 for serving Generators (ops/quant.py:
#: per-channel symmetric); "none"/unset = full precision. Garbage values warn
#: and fall back (never crash serve at app-import time); explicit API calls
#: still raise the Generator's own "unsupported quantize mode" ValueError.
SERVE_QUANTIZE_ENV_VAR = "UNIONML_TPU_QUANTIZE"

#: "int8" = int8 KV cache (per-(position, head) symmetric scales, dense rows
#: and paged pools both); "none"/unset = the compute dtype. Same
#: warn-and-fall-back contract.
SERVE_KV_CACHE_DTYPE_ENV_VAR = "UNIONML_TPU_KV_CACHE_DTYPE"

#: admission prefill slice width in tokens; 0 = unset (fall back to
#: ``GenerationConfig.prefill_chunk``, else monolithic admission).
SERVE_ADMIT_CHUNK_ENV_VAR = "UNIONML_TPU_ADMIT_CHUNK"

#: prefill tokens the engine may run per iteration between decode dispatches;
#: 0 = unset (one admission chunk per iteration).
SERVE_PREFILL_BUDGET_ENV_VAR = "UNIONML_TPU_PREFILL_BUDGET"

#: concurrent partially-prefilled admissions; 0 = unset (one at a time).
SERVE_MAX_ADMISSIONS_ENV_VAR = "UNIONML_TPU_MAX_ADMISSIONS"

#: 1 = enable the radix prefix cache on paged continuous engines; 0/unset = off.
SERVE_PREFIX_CACHE_ENV_VAR = "UNIONML_TPU_PREFIX_CACHE"


#: the persistent kernel build cache (compile_cache.py) and the AOT program
#: store (serving/aot.py): path-or-flag exports, where a truthy flag means
#: the default directory beside each
SERVE_COMPILE_CACHE_ENV_VAR = "UNIONML_TPU_COMPILE_CACHE"
SERVE_AOT_PRELOAD_ENV_VAR = "UNIONML_TPU_AOT_PRELOAD"
COMPILE_CACHE_DEFAULT_DIR = "~/.cache/unionml_tpu/xla"
AOT_PRELOAD_DEFAULT_DIR = "~/.cache/unionml_tpu/aot"

#: prompt-length threshold (tokens) at which an admission routes to a
#: prefill-role replica and its finished KV hands off to a decode replica;
#: 0 (the default) disaggregates every admission once roles are configured
SERVE_PREFILL_THRESHOLD_ENV_VAR = "UNIONML_TPU_PREFILL_THRESHOLD"

#: autoscaler high watermark on per-replica scheduling load (the engines'
#: token-weighted ``load()`` averaged over the fleet); 0 = autoscaler off
SERVE_AUTOSCALE_HIGH_ENV_VAR = "UNIONML_TPU_AUTOSCALE_HIGH"

#: autoscaler low watermark (scale down below it); 0 = never scale down
SERVE_AUTOSCALE_LOW_ENV_VAR = "UNIONML_TPU_AUTOSCALE_LOW"

#: seconds between autoscaler evaluations
SERVE_AUTOSCALE_INTERVAL_S_ENV_VAR = "UNIONML_TPU_AUTOSCALE_INTERVAL_S"
SERVE_AUTOSCALE_INTERVAL_S = 10.0

#: fleet-size floor the autoscaler never drains below
SERVE_MIN_REPLICAS_ENV_VAR = "UNIONML_TPU_MIN_REPLICAS"

#: fleet-size ceiling; 0 = bounded by the devices a fleet places on
SERVE_MAX_REPLICAS_ENV_VAR = "UNIONML_TPU_MAX_REPLICAS"

#: path to a tenants.json (per-tenant weights, req/s + generated-tokens/s
#: bucket rates, default priority tier, api-key -> tenant mapping). A missing
#: or malformed file warns and degrades to --default-tenant-rate only.
SERVE_TENANT_CONFIG_ENV_VAR = "UNIONML_TPU_TENANT_CONFIG"

#: requests/s bucket rate for identified tenants NOT named in the config file
#: (anonymous traffic is never bucket-limited); 0/unset = unlimited.
SERVE_DEFAULT_TENANT_RATE_ENV_VAR = "UNIONML_TPU_DEFAULT_TENANT_RATE"

#: 1 = record a per-request timeline (spans at every lifecycle stage) into the
#: flight recorder; 0 = off (request ids still flow — tracing is the only part
#: with a cost, and it allocates nothing while off).
SERVE_TRACE_ENV_VAR = "UNIONML_TPU_TRACE"

#: completed request timelines the flight recorder retains (ring buffer).
SERVE_FLIGHT_RECORDER_ENV_VAR = "UNIONML_TPU_FLIGHT_RECORDER_SIZE"
SERVE_FLIGHT_RECORDER_SIZE = 256

#: log line format: "text" (classic prefix) or "json" (one JSON object a line).
SERVE_LOG_FORMAT_ENV_VAR = "UNIONML_TPU_LOG_FORMAT"

#: directory ``POST /debug/profile`` writes torch.profiler traces into; unset
#: disables the endpoint (it answers 400 with a pointer to the flag).
SERVE_PROFILE_DIR_ENV_VAR = "UNIONML_TPU_PROFILE_DIR"

#: ceiling on one on-demand profile capture (ms): a runaway duration request
#: must not leave the profiler running for hours.
SERVE_PROFILE_MAX_MS = 60_000.0

#: directory live traffic is captured into as replayable traces
#: (workloads/traces.py TraceRecorder); unset = capture off.
SERVE_RECORD_TRAFFIC_ENV_VAR = "UNIONML_TPU_RECORD_TRAFFIC"

#: record SHA-256 digests + lengths instead of prompt token ids; 0/unset =
#: literal ids.
SERVE_RECORD_TRAFFIC_HASH_ENV_VAR = "UNIONML_TPU_RECORD_TRAFFIC_HASH"

#: TTFT p95 target in ms over the burn-rate windows (0 = disarmed).
SERVE_SLO_TTFT_P95_MS_ENV_VAR = "UNIONML_TPU_SLO_TTFT_P95_MS"

#: TBT p99 target in ms (0 = disarmed).
SERVE_SLO_TBT_P99_MS_ENV_VAR = "UNIONML_TPU_SLO_TBT_P99_MS"

#: tolerated shed fraction of arrivals, e.g. 0.01 (0 = disarmed).
SERVE_SLO_SHED_RATIO_ENV_VAR = "UNIONML_TPU_SLO_SHED_RATIO"

#: fast burn-rate window (seconds): the paging window.
SERVE_SLO_FAST_WINDOW_S_ENV_VAR = "UNIONML_TPU_SLO_FAST_WINDOW_S"
SERVE_SLO_FAST_WINDOW_S = 60.0

#: slow burn-rate window (seconds): the trend confirmation — breach requires
#: BOTH windows over target; one alone is warn.
SERVE_SLO_SLOW_WINDOW_S_ENV_VAR = "UNIONML_TPU_SLO_SLOW_WINDOW_S"
SERVE_SLO_SLOW_WINDOW_S = 600.0

#: samples (or arrivals, for the shed ratio) a window needs before it can
#: breach: an idle engine is healthy, not failing.
SERVE_SLO_MIN_SAMPLES_ENV_VAR = "UNIONML_TPU_SLO_MIN_SAMPLES"
SERVE_SLO_MIN_SAMPLES = 3

#: rendezvous address (``host:port``) of a multi-process runtime; unset =
#: single process. torchrun's ``MASTER_ADDR``/``MASTER_PORT`` are read too
#: (:mod:`unionml_tpu_torch.distributed`).
DISTRIBUTED_COORDINATOR_ENV_VAR = "UNIONML_TPU_COORDINATOR"

#: total processes in the runtime (1 = single process).
DISTRIBUTED_NUM_PROCESSES_ENV_VAR = "UNIONML_TPU_NUM_PROCESSES"

#: this process's id in ``[0, num_processes)``.
DISTRIBUTED_PROCESS_ID_ENV_VAR = "UNIONML_TPU_PROCESS_ID"

#: rendezvous directory for the serving fleet's control plane
#: (serving/cluster.py): each host's leader announces its loopback control
#: address as a ``host-<id>.json`` file there, and the coordinator connects by
#: polling it. Unset = ``.unionml_fleet`` under the working directory.
FLEET_DIR_ENV_VAR = "UNIONML_TPU_FLEET_DIR"

#: per-host role spec for the fleet coordinator (``prefill=1,decode=1`` at
#: host granularity, the cross-host analog of SERVE_REPLICA_ROLES_ENV_VAR);
#: unset/empty = every host mixed. Garbage warns and degrades to symmetric.
FLEET_HOST_ROLES_ENV_VAR = "UNIONML_TPU_HOST_ROLES"

#: a deterministic fault plan (serving/faults.py): a path to a plan JSON, or
#: the JSON inline (starts with ``{``). Unset = no injection. A garbage value
#: warns and degrades to no plan.
SERVE_FAULT_PLAN_ENV_VAR = "UNIONML_TPU_FAULT_PLAN"

#: seconds between coordinator reconciliation ticks (lease heartbeat,
#: suspect/dead re-probes, rendezvous-dir announce scans).
FLEET_PROBE_INTERVAL_S_ENV_VAR = "UNIONML_TPU_PROBE_INTERVAL_S"
FLEET_PROBE_INTERVAL_S = 1.0

#: consecutive successful probes a returning host must pass in probation
#: before it takes traffic again.
FLEET_PROBATION_PROBES_ENV_VAR = "UNIONML_TPU_PROBATION_PROBES"
FLEET_PROBATION_PROBES = 2

#: consecutive probe failures that move a suspect host to dead.
FLEET_DEAD_AFTER_PROBES_ENV_VAR = "UNIONML_TPU_DEAD_AFTER_PROBES"
FLEET_DEAD_AFTER_PROBES = 3

#: coordinator heartbeat-lease TTL (seconds): workers treat a lease older
#: than this as an expired coordinator and the lowest-id live worker promotes.
FLEET_LEASE_TTL_S_ENV_VAR = "UNIONML_TPU_LEASE_TTL_S"
FLEET_LEASE_TTL_S = 5.0


def env_int(name: str, default: int, *, minimum: Optional[int] = None) -> int:
    """Parse an integer env var, tolerating garbage: unset/empty -> ``default``,
    a non-integer value warns and falls back to ``default`` instead of raising
    at whatever moment the knob happens to be read. ``minimum`` clamps the
    parsed value (with a warning)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        value = int(raw.strip())
    except ValueError:
        logger.warning(f"ignoring non-integer {name}={raw!r}; falling back to {default}")
        return default
    if minimum is not None and value < minimum:
        logger.warning(f"clamping {name}={value} to the minimum {minimum}")
        return minimum
    return value



def env_float(name: str, default: float, *, minimum: Optional[float] = None) -> float:
    """:func:`env_int` for float-valued knobs (same warn-and-fall-back
    contract; a garbage value must never crash the reader)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        value = float(raw.strip())
    except ValueError:
        logger.warning(f"ignoring non-numeric {name}={raw!r}; falling back to {default}")
        return default
    if minimum is not None and value < minimum:
        logger.warning(f"clamping {name}={value} to the minimum {minimum}")
        return minimum
    return value

def env_choice(name: str, choices: Tuple[str, ...], what: str) -> Optional[str]:
    """Parse a choice-valued env var: unset/empty/"none"/"off"/"0" mean None
    (the knob's off state), a listed choice is returned normalized, and
    anything else warns and falls back to None instead of raising at whatever
    moment the knob happens to be read. ``what`` names the knob in the
    warning, mirroring the ValueError text the explicit API raises."""
    raw = os.environ.get(name)
    if raw is None:
        return None
    value = raw.strip().lower()
    if value in ("", "none", "off", "0"):
        return None
    if value in choices:
        return value
    logger.warning(
        f"ignoring {name}={raw!r}: unsupported {what}; expected one of "
        f"{choices + ('none',)} — falling back to full precision"
    )
    return None


def serve_quantize() -> Optional[str]:
    """The serve-time weight-quantization mode ("int8" or None), read at
    ``Generator`` construction."""
    return env_choice(SERVE_QUANTIZE_ENV_VAR, ("int8",), "quantize mode")


def serve_kv_cache_dtype() -> Optional[str]:
    """The serve-time KV-cache storage dtype ("int8" or None = compute
    dtype), read at ``Generator`` construction."""
    return env_choice(SERVE_KV_CACHE_DTYPE_ENV_VAR, ("int8",), "kv_cache_dtype")


def serve_admit_chunk() -> int:
    """Serve-time admission prefill chunk width; 0 = unset. Read at engine
    construction, after the CLI's export."""
    return env_int(SERVE_ADMIT_CHUNK_ENV_VAR, 0, minimum=0)


def serve_prefill_budget() -> int:
    """Serve-time per-iteration prefill-token budget; 0 = unset (one chunk)."""
    return env_int(SERVE_PREFILL_BUDGET_ENV_VAR, 0, minimum=0)


def serve_max_admissions() -> int:
    """Serve-time cap on concurrent partially-prefilled admissions; 0 = unset."""
    return env_int(SERVE_MAX_ADMISSIONS_ENV_VAR, 0, minimum=0)


def serve_prefix_cache() -> bool:
    """Whether the serve-time radix prefix cache is on
    (``UNIONML_TPU_PREFIX_CACHE=1``), read at engine construction."""
    return env_int(SERVE_PREFIX_CACHE_ENV_VAR, 0, minimum=0) > 0


def serve_dp_replicas() -> int:
    """The serve-time data-parallel replica override; 0 = unset. Read at
    engine construction; garbage (``UNIONML_TPU_DP_REPLICAS=abc``) warns and
    falls back to 0."""
    return env_int(SERVE_DP_REPLICAS_ENV_VAR, 0, minimum=0)


def parse_replica_roles(raw: str) -> Dict[str, int]:
    """Parse a ``prefill=1,decode=3`` role spec into ``{role: count}``.
    Raises ``ValueError`` naming the offending entry; the env reader below
    degrades instead."""
    out: Dict[str, int] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        role, sep, count = entry.partition("=")
        role = role.strip().lower()
        if not sep or role not in REPLICA_ROLES:
            raise ValueError(
                f"bad replica-role entry {entry!r}; expected role=count with role in "
                f"{REPLICA_ROLES} (e.g. 'prefill=1,decode=3')"
            )
        try:
            n = int(count.strip())
        except ValueError:
            raise ValueError(f"bad replica-role count in {entry!r}; expected an integer")
        if n < 0:
            raise ValueError(f"replica-role count must be >= 0 in {entry!r}")
        out[role] = out.get(role, 0) + n
    return {role: n for role, n in out.items() if n > 0}


def serve_replica_roles() -> Dict[str, int]:
    """The serve-time ``--replica-roles`` export parsed to ``{role: count}``;
    ``{}`` = unset. Garbage warns and falls back to ``{}``."""
    raw = os.environ.get(SERVE_REPLICA_ROLES_ENV_VAR)
    if raw is None or not raw.strip():
        return {}
    try:
        return parse_replica_roles(raw)
    except ValueError as exc:
        logger.warning(
            f"ignoring {SERVE_REPLICA_ROLES_ENV_VAR}={raw!r} ({exc}); "
            "falling back to a symmetric (all-mixed) fleet"
        )
        return {}


def serve_prefill_threshold() -> int:
    """Prompt-length threshold (tokens) for routing to prefill-role replicas;
    0 = every admission disaggregates once roles are configured."""
    return env_int(SERVE_PREFILL_THRESHOLD_ENV_VAR, 0, minimum=0)


def serve_autoscale_high() -> float:
    """Autoscaler high watermark on per-replica load; 0.0 = autoscaler off."""
    return env_float(SERVE_AUTOSCALE_HIGH_ENV_VAR, 0.0, minimum=0.0)


def serve_autoscale_low() -> float:
    """Autoscaler low watermark; 0.0 = never scale down."""
    return env_float(SERVE_AUTOSCALE_LOW_ENV_VAR, 0.0, minimum=0.0)


def serve_autoscale_interval_s() -> float:
    """Seconds between autoscaler evaluations."""
    return env_float(SERVE_AUTOSCALE_INTERVAL_S_ENV_VAR, SERVE_AUTOSCALE_INTERVAL_S, minimum=0.05)


def serve_min_replicas() -> int:
    """Fleet-size floor for the autoscaler."""
    return env_int(SERVE_MIN_REPLICAS_ENV_VAR, 1, minimum=1)


def serve_max_replicas() -> int:
    """Fleet-size ceiling for the autoscaler; 0 = bounded by the devices."""
    return env_int(SERVE_MAX_REPLICAS_ENV_VAR, 0, minimum=0)


#: env values that mean "on, default location" / "off" for path-or-flag knobs
_TRUTHY_FLAGS = ("1", "true", "yes", "on")
_FALSY_FLAGS = ("", "0", "false", "no", "off")


def _env_path_flag(name: str, default_dir: str) -> Optional[str]:
    """Parse a path-or-flag env var: off-flags (and unset) mean None, truthy
    flags mean ``default_dir``, anything else is the path itself."""
    raw = os.environ.get(name)
    if raw is None:
        return None
    value = raw.strip()
    if value.lower() in _FALSY_FLAGS:
        return None
    if value.lower() in _TRUTHY_FLAGS:
        return default_dir
    return value


def serve_compile_cache() -> Optional[str]:
    """The compile-cache directory export (``UNIONML_TPU_COMPILE_CACHE``);
    None = off."""
    return _env_path_flag(SERVE_COMPILE_CACHE_ENV_VAR, COMPILE_CACHE_DEFAULT_DIR)


def serve_aot_preload() -> Optional[str]:
    """The AOT program store export (``UNIONML_TPU_AOT_PRELOAD``); None = off."""
    return _env_path_flag(SERVE_AOT_PRELOAD_ENV_VAR, AOT_PRELOAD_DEFAULT_DIR)


def serve_tenant_config() -> Optional[str]:
    """Path to the serve-time tenants.json (``UNIONML_TPU_TENANT_CONFIG``);
    None = unset. Existence/validity is the registry's concern — it warns and
    degrades on a bad file."""
    raw = os.environ.get(SERVE_TENANT_CONFIG_ENV_VAR)
    if raw is None or not raw.strip():
        return None
    return raw.strip()


def serve_default_tenant_rate() -> float:
    """Requests/s bucket rate for identified-but-unconfigured tenants; 0 =
    unlimited (and, with no config file either, tenancy entirely off)."""
    return env_float(SERVE_DEFAULT_TENANT_RATE_ENV_VAR, 0.0, minimum=0.0)


def serve_trace() -> bool:
    """Whether serve-time request tracing is on (``UNIONML_TPU_TRACE=1``);
    read at app construction."""
    return env_int(SERVE_TRACE_ENV_VAR, 0, minimum=0) > 0


def serve_flight_recorder_size() -> int:
    """Completed request timelines the flight recorder retains; garbage or
    sub-1 values degrade to the default (the recorder requires >= 1)."""
    return env_int(SERVE_FLIGHT_RECORDER_ENV_VAR, SERVE_FLIGHT_RECORDER_SIZE, minimum=1)


def serve_profile_dir() -> Optional[str]:
    """Directory for on-demand ``POST /debug/profile`` captures; None = the
    endpoint is disabled."""
    raw = os.environ.get(SERVE_PROFILE_DIR_ENV_VAR)
    return raw.strip() or None if raw is not None else None


def serve_record_traffic() -> Optional[str]:
    """Directory live traffic is captured into as replayable traces; None =
    capture off. An unusable directory degrades at TraceRecorder
    construction (warn, capture off), never at read time."""
    raw = os.environ.get(SERVE_RECORD_TRAFFIC_ENV_VAR)
    return raw.strip() or None if raw is not None else None


def serve_record_traffic_hash() -> bool:
    """Whether captured traces carry prompt digests instead of token ids."""
    return env_int(SERVE_RECORD_TRAFFIC_HASH_ENV_VAR, 0, minimum=0) > 0


def serve_slo_ttft_p95_ms() -> float:
    """Serve-time TTFT p95 SLO target in ms; 0.0 = disarmed. Read at engine
    construction; garbage warns and falls back."""
    return env_float(SERVE_SLO_TTFT_P95_MS_ENV_VAR, 0.0, minimum=0.0)


def serve_slo_tbt_p99_ms() -> float:
    """Serve-time TBT p99 SLO target in ms; 0.0 = disarmed."""
    return env_float(SERVE_SLO_TBT_P99_MS_ENV_VAR, 0.0, minimum=0.0)


def serve_slo_shed_ratio() -> float:
    """Serve-time shed-ratio SLO target (fraction of arrivals); 0.0 = disarmed."""
    return env_float(SERVE_SLO_SHED_RATIO_ENV_VAR, 0.0, minimum=0.0)


def serve_slo_fast_window_s() -> float:
    """Fast burn-rate window in seconds (the paging window)."""
    return env_float(SERVE_SLO_FAST_WINDOW_S_ENV_VAR, SERVE_SLO_FAST_WINDOW_S, minimum=1.0)


def serve_slo_slow_window_s() -> float:
    """Slow burn-rate window in seconds (the trend-confirmation window)."""
    return env_float(SERVE_SLO_SLOW_WINDOW_S_ENV_VAR, SERVE_SLO_SLOW_WINDOW_S, minimum=1.0)


def serve_slo_min_samples() -> int:
    """Samples a window needs before it can breach (idle engines stay healthy)."""
    return env_int(SERVE_SLO_MIN_SAMPLES_ENV_VAR, SERVE_SLO_MIN_SAMPLES, minimum=1)


def distributed_coordinator() -> Optional[str]:
    """The multi-process rendezvous address (``host:port``); None = single
    process."""
    raw = os.environ.get(DISTRIBUTED_COORDINATOR_ENV_VAR)
    if raw is None or not raw.strip():
        return None
    return raw.strip()


def distributed_num_processes() -> int:
    """Total processes in the runtime; garbage warns and degrades to 1."""
    return env_int(DISTRIBUTED_NUM_PROCESSES_ENV_VAR, 1, minimum=1)


def distributed_process_id() -> int:
    """This process's id in ``[0, num_processes)``; garbage warns and
    degrades to 0 (a mis-set worker then fails at the rendezvous)."""
    return env_int(DISTRIBUTED_PROCESS_ID_ENV_VAR, 0, minimum=0)


def fleet_dir() -> str:
    """The serving fleet's control-plane rendezvous directory
    (``UNIONML_TPU_FLEET_DIR``); defaults to ``.unionml_fleet`` under the
    working directory so a local fleet needs no configuration."""
    raw = os.environ.get(FLEET_DIR_ENV_VAR)
    if raw is None or not raw.strip():
        return ".unionml_fleet"
    return raw.strip()


def serve_fault_plan() -> Optional[str]:
    """The fault-plan spec (``UNIONML_TPU_FAULT_PLAN``): a path or inline
    JSON; None = no injection. ``FaultPlan.from_env`` warns and degrades on
    garbage."""
    raw = os.environ.get(SERVE_FAULT_PLAN_ENV_VAR)
    if raw is None or not raw.strip():
        return None
    return raw.strip()


def fleet_probe_interval_s() -> float:
    """Seconds between coordinator reconciliation ticks; garbage warns and
    degrades to the default."""
    return env_float(FLEET_PROBE_INTERVAL_S_ENV_VAR, FLEET_PROBE_INTERVAL_S, minimum=0.05)


def fleet_probation_probes() -> int:
    """Consecutive probe successes a returning host needs before going live."""
    return env_int(FLEET_PROBATION_PROBES_ENV_VAR, FLEET_PROBATION_PROBES, minimum=1)


def fleet_dead_after_probes() -> int:
    """Consecutive probe failures that move a suspect host to dead."""
    return env_int(FLEET_DEAD_AFTER_PROBES_ENV_VAR, FLEET_DEAD_AFTER_PROBES, minimum=1)


def fleet_lease_ttl_s() -> float:
    """Coordinator heartbeat-lease TTL in seconds."""
    return env_float(FLEET_LEASE_TTL_S_ENV_VAR, FLEET_LEASE_TTL_S, minimum=0.1)


def fleet_host_roles() -> Dict[str, int]:
    """The per-host role census for the fleet coordinator, parsed as
    :func:`serve_replica_roles` parses its spec (garbage warns and degrades);
    ``{}`` = every host mixed."""
    raw = os.environ.get(FLEET_HOST_ROLES_ENV_VAR)
    if raw is None or not raw.strip():
        return {}
    try:
        return parse_replica_roles(raw)
    except ValueError as exc:
        logger.warning(f"ignoring {FLEET_HOST_ROLES_ENV_VAR}={raw!r} ({exc}); "
                       "falling back to a symmetric (all-mixed) host fleet")
        return {}
