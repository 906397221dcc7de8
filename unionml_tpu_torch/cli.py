"""The port's command-line interface: ``python -m unionml_tpu_torch.cli``.

Counterpart of ``unionml_tpu/cli.py``, with the same command names, options
and behaviors, on ``argparse`` from the standard library (the JAX package's
CLI is a ``click`` group). :func:`app` takes an argument list and raises
``SystemExit`` with click's codes: 0 on success, 1 when a check of the
command fails (printed as ``Error: <message>`` on stderr), 2 for a usage
error such as an unknown option.

- ``init`` renders a project template and ``templates`` lists them
  (:mod:`unionml_tpu_torch.templating`).
- ``serve`` boots the HTTP prediction service of an app's ``Model`` (or a
  ``ServingApp``), with ``--workers`` and ``--reload``. Every knob of a
  ported part is validated and exported as an environment variable before
  the app module is imported, as in the JAX package, so engines built at
  import time see it.
- The in-process replica fleet's flags (``--dp-replicas``,
  ``--replica-roles``, ``--prefill-threshold``, the autoscaler's
  ``--autoscale-high/-low/-interval`` and ``--min/--max-replicas``) are
  validated and exported as the JAX CLI exports them; the engine's
  constructor reads them and builds a ``ReplicaSet``.
- ``--compile-cache [DIR]`` points the kernel build directory at a
  persistent cache in this process and exports it; ``--aot-preload [DIR]``
  exports the AOT program store, which every engine then arms
  (:mod:`unionml_tpu_torch.serving.aot`). Both are exported before the app
  module imports.
- ``--num-hosts``/``--coordinator``/``--process-id`` make this process one
  host of a multi-host fleet (:mod:`unionml_tpu_torch.serving.cluster`):
  process 0 serves the front door over a ``FleetCoordinator``, the others
  only their control servers; ``--fault-plan``, ``--probe-interval``,
  ``--probation-probes`` and ``--lease-ttl`` arm fault injection and tune
  the host lifecycle. All are validated and exported as the JAX CLI exports
  them, before the app module imports.
- What the port does not have is refused at boot, before any export and
  before the app module is imported, naming its ROADMAP.md item:
  ``--remote`` and the ``deploy``, ``train``, ``predict``,
  ``list-model-versions``, ``fetch-model``, ``replay`` and ``lint`` commands
  (Queue A: the rest). Each of those commands exists and refuses.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Any, List, Optional, Sequence

from unionml_tpu_torch.defaults import MODEL_PATH_ENV_VAR

PROG = "unionml-tpu-torch"
_THE_REST = "the rest"
#: commands of the JAX CLI that the port refuses: the remote backend, the replayer and the linter
_REFUSED_COMMANDS = ("deploy", "train", "predict", "list-model-versions", "fetch-model", "replay", "lint")


class UsageError(Exception):
    """A failed check of a command: ``Error: <message>`` on stderr, exit 1
    (``click.ClickException``)."""


def _not_ported(what: str, item: str) -> UsageError:
    return UsageError(f"{what} is not ported yet (ROADMAP.md, Queue A: {item})")


def _locate_model(app_ref: str) -> Any:
    """Import ``module:variable`` from the working directory and return it."""
    from unionml_tpu_torch.resolver import locate

    sys.path.insert(0, os.getcwd())
    return locate(app_ref)


# ---------------------------------------------------------------------- init, templates


def init(app_name: str, template: str) -> None:
    """Initialize a new project from a template."""
    from unionml_tpu_torch.templating import render_template

    try:
        project_dir = render_template(template, app_name, Path.cwd())
    except (ValueError, FileExistsError) as exc:
        raise UsageError(str(exc))
    print(f"Created unionml-tpu project at {project_dir}")


def templates() -> None:
    """List available project templates."""
    from unionml_tpu_torch.templating import list_templates

    for name in list_templates():
        print(name)


# ---------------------------------------------------------------------- serve


def _refuse_unported(args: argparse.Namespace) -> None:
    """Raise on the serve flag that selects a part the port does not have:
    the remote backend."""
    if args.remote:
        raise _not_ported("--remote (the remote backend)", _THE_REST)


def _export_knobs(args: argparse.Namespace) -> None:
    """Validate the knobs of ported parts and export them before the app
    module imports: engines, loggers and the serving app built at import
    time (and ``--reload``/``--workers`` children) read them from there."""
    from unionml_tpu_torch import defaults

    if args.num_hosts is not None or args.coordinator is not None or args.process_id is not None:
        # the fleet's bootstrap knobs: engines built at import time must see
        # the multi-process world
        hosts = args.num_hosts if args.num_hosts is not None else 1
        if hosts < 1:
            raise UsageError("--num-hosts must be >= 1")
        if hosts > 1 and args.coordinator is None:
            raise UsageError("--num-hosts > 1 needs --coordinator HOST:PORT (the process group's rendezvous)")
        if args.process_id is not None and not (0 <= args.process_id < hosts):
            raise UsageError(f"--process-id must be in [0, {hosts}); got {args.process_id}")
        if args.num_hosts is not None:
            os.environ[defaults.DISTRIBUTED_NUM_PROCESSES_ENV_VAR] = str(args.num_hosts)
        if args.coordinator is not None:
            os.environ[defaults.DISTRIBUTED_COORDINATOR_ENV_VAR] = args.coordinator
        if args.process_id is not None:
            os.environ[defaults.DISTRIBUTED_PROCESS_ID_ENV_VAR] = str(args.process_id)
    if args.fault_plan is not None:
        from unionml_tpu_torch.serving.faults import FaultPlan

        try:
            if args.fault_plan.lstrip().startswith("{"):
                FaultPlan.parse(args.fault_plan)
            else:
                FaultPlan.load(args.fault_plan)
        except (OSError, ValueError) as exc:
            raise UsageError(f"--fault-plan: {exc}")
        os.environ[defaults.SERVE_FAULT_PLAN_ENV_VAR] = args.fault_plan
    if args.probe_interval is not None:
        if args.probe_interval <= 0:
            raise UsageError("--probe-interval must be > 0 seconds")
        os.environ[defaults.FLEET_PROBE_INTERVAL_S_ENV_VAR] = repr(args.probe_interval)
    if args.probation_probes is not None:
        if args.probation_probes < 1:
            raise UsageError("--probation-probes must be >= 1")
        os.environ[defaults.FLEET_PROBATION_PROBES_ENV_VAR] = str(args.probation_probes)
    if args.lease_ttl is not None:
        if args.lease_ttl <= 0:
            raise UsageError("--lease-ttl must be > 0 seconds")
        os.environ[defaults.FLEET_LEASE_TTL_S_ENV_VAR] = repr(args.lease_ttl)
    if args.dp_replicas is not None:
        if args.dp_replicas < 0:
            raise UsageError("--dp-replicas must be >= 0 (0 = derive from the mesh)")
        os.environ[defaults.SERVE_DP_REPLICAS_ENV_VAR] = str(args.dp_replicas)
    if args.replica_roles is not None:
        # a typo'd flag is a usage error (an inherited export only warns)
        try:
            defaults.parse_replica_roles(args.replica_roles)
        except ValueError as exc:
            raise UsageError(f"--replica-roles: {exc}")
        os.environ[defaults.SERVE_REPLICA_ROLES_ENV_VAR] = args.replica_roles
    for flag, value, env_name, cast in (
        ("--prefill-threshold", args.prefill_threshold, defaults.SERVE_PREFILL_THRESHOLD_ENV_VAR, int),
        ("--autoscale-high", args.autoscale_high, defaults.SERVE_AUTOSCALE_HIGH_ENV_VAR, float),
        ("--autoscale-low", args.autoscale_low, defaults.SERVE_AUTOSCALE_LOW_ENV_VAR, float),
        ("--autoscale-interval", args.autoscale_interval, defaults.SERVE_AUTOSCALE_INTERVAL_S_ENV_VAR, float),
        ("--min-replicas", args.min_replicas, defaults.SERVE_MIN_REPLICAS_ENV_VAR, int),
        ("--max-replicas", args.max_replicas, defaults.SERVE_MAX_REPLICAS_ENV_VAR, int),
    ):
        if value is not None:
            floor = 1 if flag == "--min-replicas" else 0
            if value < floor:
                raise UsageError(f"{flag} must be >= {floor}")
            os.environ[env_name] = repr(cast(value))
    if args.prefix_cache is not None:
        os.environ[defaults.SERVE_PREFIX_CACHE_ENV_VAR] = "1" if args.prefix_cache else "0"
    if args.compile_cache is not None:
        os.environ[defaults.SERVE_COMPILE_CACHE_ENV_VAR] = args.compile_cache
        if args.compile_cache.strip().lower() not in defaults._FALSY_FLAGS:
            # now: this process's package-import hook already ran
            from unionml_tpu_torch.compile_cache import enable_compile_cache

            try:
                enable_compile_cache(args.compile_cache)
            except OSError as exc:
                raise UsageError(f"--compile-cache {args.compile_cache}: {exc}")
    if args.aot_preload is not None:
        os.environ[defaults.SERVE_AOT_PRELOAD_ENV_VAR] = args.aot_preload
    # "none" exports too: it must override an inherited export in reload/fork children
    if args.quantize is not None:
        os.environ[defaults.SERVE_QUANTIZE_ENV_VAR] = args.quantize
    if args.kv_cache_dtype is not None:
        os.environ[defaults.SERVE_KV_CACHE_DTYPE_ENV_VAR] = args.kv_cache_dtype
    for flag, value, env_name in (
        ("--admit-chunk", args.admit_chunk, defaults.SERVE_ADMIT_CHUNK_ENV_VAR),
        ("--prefill-budget", args.prefill_budget, defaults.SERVE_PREFILL_BUDGET_ENV_VAR),
        ("--max-admissions", args.max_admissions, defaults.SERVE_MAX_ADMISSIONS_ENV_VAR),
    ):
        if value is not None:
            if value < 0:
                raise UsageError(f"{flag} must be >= 0 (0 = default)")
            os.environ[env_name] = str(value)
    for flag, value, env_name in (
        ("--slo-ttft-p95-ms", args.slo_ttft_p95_ms, defaults.SERVE_SLO_TTFT_P95_MS_ENV_VAR),
        ("--slo-tbt-p99-ms", args.slo_tbt_p99_ms, defaults.SERVE_SLO_TBT_P99_MS_ENV_VAR),
        ("--slo-shed-ratio", args.slo_shed_ratio, defaults.SERVE_SLO_SHED_RATIO_ENV_VAR),
    ):
        if value is not None:
            if value < 0:
                raise UsageError(f"{flag} must be >= 0 (0 = disarmed)")
            os.environ[env_name] = repr(value)
    if args.tenant_config is not None:
        if not args.tenant_config.exists():
            raise UsageError(f"--tenant-config {args.tenant_config} does not exist")
        os.environ[defaults.SERVE_TENANT_CONFIG_ENV_VAR] = str(args.tenant_config)
    if args.default_tenant_rate is not None:
        if args.default_tenant_rate < 0:
            raise UsageError("--default-tenant-rate must be >= 0 (0 = unlimited)")
        os.environ[defaults.SERVE_DEFAULT_TENANT_RATE_ENV_VAR] = repr(args.default_tenant_rate)
    if args.trace is not None:
        os.environ[defaults.SERVE_TRACE_ENV_VAR] = "1" if args.trace else "0"
    if args.flight_recorder_size is not None:
        if args.flight_recorder_size < 1:
            raise UsageError("--flight-recorder-size must be >= 1")
        os.environ[defaults.SERVE_FLIGHT_RECORDER_ENV_VAR] = str(args.flight_recorder_size)
    if args.profile_dir is not None:
        os.environ[defaults.SERVE_PROFILE_DIR_ENV_VAR] = str(args.profile_dir)
    if args.record_traffic is not None:
        os.environ[defaults.SERVE_RECORD_TRAFFIC_ENV_VAR] = str(args.record_traffic)
        if args.record_traffic_hash:
            os.environ[defaults.SERVE_RECORD_TRAFFIC_HASH_ENV_VAR] = "1"
    if args.log_format is not None:
        from unionml_tpu_torch._logging import set_log_format

        set_log_format(args.log_format)
        os.environ[defaults.SERVE_LOG_FORMAT_ENV_VAR] = args.log_format
    if args.log_level is not None:
        from unionml_tpu_torch._logging import logger as package_logger

        package_logger.setLevel(args.log_level.upper())
        os.environ["UNIONML_TPU_LOGLEVEL"] = args.log_level.upper()  # reload/fork children inherit it
    if args.model_path is not None:
        if os.getenv(MODEL_PATH_ENV_VAR) is not None:
            raise UsageError(
                f"{MODEL_PATH_ENV_VAR} environment variable is already set, which takes precedence "
                "over the --model-path option. Unset it to use --model-path."
            )
        if not args.model_path.exists():
            raise UsageError(f"model path {args.model_path} does not exist")
        os.environ[MODEL_PATH_ENV_VAR] = str(args.model_path)


def serve(args: argparse.Namespace, argv: Sequence[str]) -> None:
    """Start the HTTP prediction service.

    ``--model-path`` reaches the app through ``UNIONML_MODEL_PATH``, and a
    pre-set variable is refused. ``--workers N`` loads the artifact once
    (``startup()``), then forks N processes that share the port through
    ``SO_REUSEPORT``: right for host-side (sklearn) predictors. CUDA does not
    survive a fork, so an app whose startup touched the card is refused
    before forking; it serves from one process and scales through the
    engine's batching. ``--reload`` runs the server in a child process and
    restarts it when the app's sources change."""
    _refuse_unported(args)
    _export_knobs(args)

    if args.reload:
        _serve_with_reload(args.app_ref, argv)
        return

    target = _locate_model(args.app_ref)
    from unionml_tpu_torch.serving import ServingApp

    if isinstance(target, ServingApp):
        serving = target
    else:
        serving = target.serve()
    serving.configure_overload(
        max_inflight=args.max_inflight,
        default_deadline_ms=args.deadline_ms,
        max_deadline_ms=args.max_deadline_ms,
        drain_timeout_s=args.drain_timeout,
    ).configure_replicas(
        args.dp_replicas, replica_roles=args.replica_roles, prefill_threshold=args.prefill_threshold
    ).configure_quantization(
        quantize=args.quantize, kv_cache_dtype=args.kv_cache_dtype
    ).configure_cold_start(
        compile_cache=args.compile_cache, aot_preload=args.aot_preload
    ).configure_observability(
        trace=args.trace,
        flight_recorder_size=args.flight_recorder_size,
        log_format=args.log_format,
        profile_dir=str(args.profile_dir) if args.profile_dir is not None else None,
    ).configure_tenancy(
        tenant_config=str(args.tenant_config) if args.tenant_config is not None else None,
        default_tenant_rate=args.default_tenant_rate,
    )

    from unionml_tpu_torch.defaults import distributed_num_processes

    if distributed_num_processes() > 1:
        # multi-host fleet: host 0 serves the public front door over a
        # FleetCoordinator; hosts > 0 run only the control server
        if args.workers > 1:
            raise UsageError("--workers does not compose with --num-hosts; scale via hosts")
        from unionml_tpu_torch.serving.cluster import enable_serve_cluster

        enable_serve_cluster(serving, host=args.host, port=args.port)
        return

    if args.workers > 1:
        import signal

        import torch

        # load the artifact once, then fork: children inherit it copy-on-write and
        # the kernel balances accepted connections across the shared port
        serving.startup()
        if torch.cuda.is_initialized():
            raise UsageError(
                f"--workers {args.workers}: the app's startup initialized CUDA, which does not survive a fork; "
                "serve a model on the card from one process (--workers 1)"
            )
        children: List[int] = []
        for _ in range(args.workers - 1):
            pid = os.fork()
            if pid == 0:
                serving.run(host=args.host, port=args.port, reuse_port=True)
                os._exit(0)
            children.append(pid)

        def stop_children(signum=None, frame=None):
            # killing the parent must not orphan workers holding the port
            for child_pid in children:
                try:
                    os.kill(child_pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
            for child_pid in children:
                try:
                    os.waitpid(child_pid, 0)
                except ChildProcessError:
                    pass
            if signum is not None:
                raise SystemExit(0)

        signal.signal(signal.SIGTERM, stop_children)
        try:
            serving.run(host=args.host, port=args.port, reuse_port=True)
        finally:
            stop_children()
    else:
        serving.run(host=args.host, port=args.port)


def _app_source_files(app_ref: str) -> "dict[Path, float]":
    """Snapshot mtimes of every .py under the app module's directory."""
    module_name = app_ref.split(":", 1)[0]
    import importlib.util

    spec = importlib.util.find_spec(module_name)
    root = Path(spec.origin).parent if spec and spec.origin else Path.cwd()
    return {p: p.stat().st_mtime for p in root.rglob("*.py") if ".git" not in p.parts}


def _reload_argv(argv: Sequence[str]) -> List[str]:
    """The child's command: this module under the interpreter (``-m``, so the
    child's ``sys.path`` starts at the working directory as the parent's
    did), with ``--reload`` dropped and ``--model-path`` too: the parent
    validated it and exported ``UNIONML_MODEL_PATH``, which the child
    inherits (passing both would trip the env-var guard)."""
    out = [sys.executable, "-m", "unionml_tpu_torch.cli"]
    skip_next = False
    for arg in argv:
        if skip_next:
            skip_next = False
            continue
        if arg == "--reload":
            continue
        if arg == "--model-path":
            skip_next = True
            continue
        if arg.startswith("--model-path="):
            continue
        out.append(arg)
    return out


def _serve_with_reload(app_ref: str, argv: Sequence[str], poll_interval: float = 0.5) -> None:
    """Run the server as a child process; restart it when app source changes.
    The watcher itself never imports the app, nor touches the card."""
    import signal
    import subprocess
    import time

    command = _reload_argv(argv)
    current: "list[Any]" = [None]

    def forward_term(signum, frame):  # terminating the watcher must stop the server
        if current[0] is not None and current[0].poll() is None:
            current[0].terminate()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, forward_term)

    def stop_child(child) -> None:
        child.send_signal(signal.SIGTERM)
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:  # slow drain / ignored SIGTERM
            child.kill()
            child.wait()

    while True:
        snapshot = _app_source_files(app_ref)
        child = subprocess.Popen(command, env=os.environ)
        current[0] = child
        try:
            while child.poll() is None:
                time.sleep(poll_interval)
                if _app_source_files(app_ref) != snapshot:
                    print("source change detected; restarting server", file=sys.stderr)
                    stop_child(child)
                    break
            else:
                if child.returncode == 0:
                    sys.exit(0)  # clean self-exit
                # crashed (e.g. a transient syntax error was saved): keep watching
                # and respawn on the NEXT source change
                print(f"server exited with code {child.returncode}; waiting for a source change", file=sys.stderr)
                while _app_source_files(app_ref) == snapshot:
                    time.sleep(poll_interval)
                print("source change detected; restarting server", file=sys.stderr)
        except KeyboardInterrupt:  # pragma: no cover
            stop_child(child)
            raise


# ---------------------------------------------------------------------- the parser


def _version() -> str:
    from importlib.metadata import PackageNotFoundError, version

    try:
        return version("unionml-tpu")
    except PackageNotFoundError:
        return "unknown"


def _serve_parser(sub: Any) -> None:
    p = sub.add_parser("serve", help="start the HTTP prediction service")
    p.add_argument("app_ref", metavar="APP", help="module:variable of a Model or ServingApp")
    add = p.add_argument
    add("--model-path", type=Path, default=None, help="path to the saved model object")
    add("--host", default="127.0.0.1")
    add("--port", type=int, default=8000)
    add("--workers", type=int, default=1, help="server processes sharing the port (SO_REUSEPORT); host-side apps only")
    add("--reload", action="store_true", help="restart the server when app source changes (development)")
    add("--log-level", choices=["debug", "info", "warning", "error"], default=None)
    add("--log-format", choices=["text", "json"], default=None,
        help="json emits structured lines carrying the request id and turns on the access log")
    add("--max-inflight", type=int, default=None,
        help="concurrent-request cap; excess requests shed with 429 + Retry-After (0 = unbounded)")
    add("--deadline-ms", type=float, default=None, help="default per-request deadline in ms (0 = none)")
    add("--max-deadline-ms", type=float, default=None, help="ceiling on client X-Request-Deadline-Ms values")
    add("--drain-timeout", type=float, default=None, help="seconds a SIGTERM drain waits for in-flight work")
    add("--admit-chunk", type=int, default=None,
        help="prefill tokens an admission chunk; chunks interleave with decode (0 = monolithic admission)")
    add("--prefill-budget", type=int, default=None, help="prefill tokens an engine iteration (0 = one chunk)")
    add("--max-admissions", type=int, default=None, help="partially prefilled admissions at once (0 = 1)")
    add("--prefix-cache", action=argparse.BooleanOptionalAction, default=None,
        help="radix prefix cache on paged continuous engines")
    add("--quantize", choices=["int8", "none"], default=None, help="weight-only int8 for the serving Generators")
    add("--kv-cache-dtype", choices=["int8", "none"], default=None, help="KV-cache storage dtype")
    add("--trace", action=argparse.BooleanOptionalAction, default=None,
        help="record per-request timelines into the flight recorder (/debug/requests)")
    add("--flight-recorder-size", type=int, default=None, help="completed timelines the flight recorder keeps")
    add("--profile-dir", type=Path, default=None,
        help="directory of POST /debug/profile torch.profiler captures (unset disables the endpoint)")
    add("--record-traffic", type=Path, default=None, help="capture live traffic into ndjson traces here")
    add("--record-traffic-hash", action="store_true", help="record prompt digests instead of token ids")
    add("--slo-ttft-p95-ms", type=float, default=None, help="SLO: TTFT p95 target in ms (0 = disarmed)")
    add("--slo-tbt-p99-ms", type=float, default=None, help="SLO: TBT p99 target in ms (0 = disarmed)")
    add("--slo-shed-ratio", type=float, default=None, help="SLO: tolerated shed fraction (0 = disarmed)")
    add("--tenant-config", type=Path, default=None, help="tenants.json of per-tenant weights, rates and keys")
    add("--default-tenant-rate", type=float, default=None, help="req/s for tenants not in --tenant-config")
    add("--dp-replicas", type=int, default=None,
        help="replica engines for generation serving, placed round-robin over the visible devices and routed "
        "least-loaded first (0 and 1 are one engine)")
    add("--replica-roles", default=None,
        help="disaggregated serving: per-role replica counts, e.g. 'prefill=1,decode=3'; prompts of at least "
        "--prefill-threshold tokens prefill on a prefill replica and hand their KV pages to a decode replica; "
        "implies the fleet size when --dp-replicas is unset")
    add("--prefill-threshold", type=int, default=None,
        help="prompt length (tokens) at which an admission takes the prefill->decode handoff (0 = every one)")
    add("--autoscale-high", type=float, default=None,
        help="per-replica load above which the fleet adds a replica (also while a replica's SLO state is breach); "
        "0/unset = autoscaler off")
    add("--autoscale-low", type=float, default=None,
        help="per-replica load below which the fleet drains one replica (no stream lost); 0 = never scale down")
    add("--autoscale-interval", type=float, default=None, help="seconds between autoscaler evaluations")
    add("--min-replicas", type=int, default=None, help="fleet-size floor the autoscaler never drains below")
    add("--max-replicas", type=int, default=None, help="fleet-size ceiling for the autoscaler (0 = the device count)")
    add("--compile-cache", default=None, metavar="DIR",
        help="build and load the CUDA kernels under DIR, a cache kept across processes ('1' = "
        "~/.cache/unionml_tpu/xla, '0' = off: the package's own _build/); exported as UNIONML_TPU_COMPILE_CACHE")
    add("--aot-preload", nargs="?", const="1", default=None, metavar="DIR",
        help="arm the AOT program store at DIR (bare: ~/.cache/unionml_tpu/aot): engines capture their programs "
        "as CUDA graphs and load their kernels from the store; exported as UNIONML_TPU_AOT_PRELOAD")
    add("--num-hosts", type=int, default=None,
        help="hosts of a multi-host fleet (one process each; process 0 serves the front door over a "
        "FleetCoordinator); exported as UNIONML_TPU_NUM_PROCESSES")
    add("--coordinator", default=None, metavar="HOST:PORT",
        help="the fleet's rendezvous address; exported as UNIONML_TPU_COORDINATOR")
    add("--process-id", type=int, default=None,
        help="this host's id in [0, --num-hosts); exported as UNIONML_TPU_PROCESS_ID")
    add("--fault-plan", default=None, metavar="PLAN",
        help="a deterministic fault plan (a JSON path, or the JSON inline); exported as UNIONML_TPU_FAULT_PLAN")
    add("--probe-interval", type=float, default=None,
        help="seconds between the coordinator's reconciliation ticks; exported as UNIONML_TPU_PROBE_INTERVAL_S")
    add("--probation-probes", type=int, default=None,
        help="probe successes a returning host needs before it goes live; exported as "
        "UNIONML_TPU_PROBATION_PROBES")
    add("--lease-ttl", type=float, default=None,
        help="the coordinator lease's TTL in seconds; exported as UNIONML_TPU_LEASE_TTL_S")
    refused = p.add_argument_group("not ported yet (refused at boot; ROADMAP.md, Queue A: the rest)")
    refused.add_argument("--remote", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG, description="unionml-tpu's PyTorch port: serve machine learning "
                                     "microservices on an NVIDIA GPU.")
    parser.add_argument("--version", action="version", version=f"%(prog)s {_version()}")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND", required=True)
    p = sub.add_parser("init", help="initialize a new project from a template")
    p.add_argument("app_name")
    p.add_argument("--template", "-t", default="basic", help="template to scaffold the app from (see `templates`)")
    sub.add_parser("templates", help="list available project templates")
    _serve_parser(sub)
    for name in _REFUSED_COMMANDS:
        p = sub.add_parser(name, help="not ported yet (ROADMAP.md, Queue A: the rest)")
        p.add_argument("rest", nargs=argparse.REMAINDER)
    return parser


def app(argv: Optional[Sequence[str]] = None) -> None:
    """Run one command. Always raises ``SystemExit``: 0 on success, 1 on a
    failed check (``Error: <message>`` on stderr), 2 on a usage error."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    try:
        if args.command == "init":
            init(args.app_name, args.template)
        elif args.command == "templates":
            templates()
        elif args.command == "serve":
            serve(args, argv)
        else:
            raise _not_ported(f"the {args.command!r} command", _THE_REST)
    except UsageError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1)
    raise SystemExit(0)


def main() -> None:  # console-script entry point
    app()


if __name__ == "__main__":
    main()
