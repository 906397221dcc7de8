"""Multi-host fleet serving: a coordinator over per-host worker engines,
counterpart of ``unionml_tpu/serving/cluster.py``.

**What a host is here.** In JAX one process drives all of a host's devices,
and a TP replica is a submesh inside that process. torch has no
single-process SPMD over several devices: one process is one rank, and a TP
engine over a mesh is a group of ranks whose first rank owns the scheduler
and records a ``StepPlan`` that the other ranks replay
(:mod:`unionml_tpu_torch.serving.mesh`). So a port fleet **host** is one
replica's group of ranks: its leader runs the engine's scheduler and the
:class:`WorkerAgent`, its followers run only the follower loop. Over a hybrid
mesh (:meth:`~unionml_tpu_torch.parallel.mesh.MeshSpec.build_hybrid`: the
batch axes span the hosts, the model axes stay inside one) each rank builds
only the replica whose submesh holds it (``ReplicaSet.build`` is process
aware, as in JAX's multi-host sense), and a host's id is its submesh's index
in the slice; a host of one rank (no mesh) takes its process id.

- **workers** own their local engines and expose them through a loopback
  control server (:class:`WorkerAgent`, on each host's leader);
- **the coordinator** (:class:`FleetCoordinator`) owns routing, admission and
  scale decisions: it mirrors the engine surface (``submit`` / ``warmup`` /
  ``stats`` / ``health`` / ``scale_to`` / ``close``), so the serving app,
  ``/metrics``, ``/healthz`` and ``/debug/fleet`` compose with a multi-host
  fleet as they do with a :class:`ReplicaSet`;
- **the control plane** is plain HTTP (newline-delimited JSON token streams,
  binary ``npz`` handoff payloads), out of band from ``torch.distributed``:
  no collective spans hosts after bootstrap, so a worker crash breaks one
  TCP connection (the coordinator marks the host and routes around it)
  instead of a collective; each host's step plans ride a gloo group of its
  own ranks (``Mesh.plan_group``), which a dead host breaks for itself alone;
- **the bootstrap** (:mod:`unionml_tpu_torch.distributed`) gives workers
  their rank, over gloo whatever the device (it moves host objects only, and
  two ranks on one card cannot form an NCCL world): process 0's fleet config
  is broadcast so every host builds knob-identical engines
  (:func:`~unionml_tpu_torch.distributed.agree`), and control ports are
  exchanged with :func:`~unionml_tpu_torch.distributed.allgather_ints`. A
  replacement host forms a world of its own ranks: it never rejoins the
  first one.

Routing is the :class:`~unionml_tpu_torch.serving.replicas.ReplicaScheduler`
at host granularity: per submission the coordinator probes every live host
for its token-weighted load, SLO state and its actual cached-prefix length
for this prompt (the fleet-global radix tier), so a multi-turn conversation
lands on the host that already holds its KV. Hosts may carry roles
(``prefill``/``decode``/``mixed``, the ``UNIONML_TPU_HOST_ROLES`` export): a
long prompt prefills on a prefill host and its finished KV pages cross the
wire to a decode host, token-identical to one mixed fleet serving it. A TP
host's pages hold every KV head: the exporting engine gathers its ranks'
heads and the importing one scatters them (``ContinuousBatcher._op_export``,
``_op_import_kv``). On the wire, pages whose dtype numpy lacks (bfloat16)
cross as their raw 16 bits with the dtype in the metadata; an f32 or int8
payload is the JAX package's wire format, both ways.

Collectives (``agree``/``barrier``/``allgather_ints``) run only during
worker bootstrap and never while holding a lock: one stalled host must
degrade to a dead host, not a fleet-wide deadlock.

Fault tolerance is a lifecycle, not a boolean: a transport failure moves a
host ``live → suspect`` (routed around but re-probed), consecutive probe
failures move it to ``dead``, a fresh rendezvous announce or a successful
re-probe moves it to ``probation``, and probation probes + warmup move it
back to ``live``. Idempotent control RPCs (ping/probe/stats/health) retry
with bounded decorrelated jitter before suspecting anyone; streams that die
with zero tokens emitted are retried once on a sibling host, streams that
already emitted terminate with a clean 503-shaped :class:`StreamInterrupted`,
never a silent hang. The coordinator persists a fenced (epoch-stamped)
checkpoint and a heartbeat lease in the rendezvous dir; on lease expiry the
lowest-id live worker promotes itself (:func:`maybe_promote`), and a zombie
coordinator's writes are rejected. Every failure mode is reproducible under a
seeded :class:`~unionml_tpu_torch.serving.faults.FaultPlan`.
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
import random
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import (
    fleet_dead_after_probes,
    fleet_dir as default_fleet_dir,
    fleet_host_roles,
    fleet_lease_ttl_s,
    fleet_probation_probes,
    fleet_probe_interval_s,
    serve_prefill_threshold,
)
from unionml_tpu_torch.serving.faults import ArmedFaultPlan, FaultPlan
from unionml_tpu_torch.serving.metrics import LatencyWindow
from unionml_tpu_torch.serving.overload import (
    DeadlineExceeded,
    QueueFullError,
    TenantThrottled,
    expired,
    remaining_s,
)
from unionml_tpu_torch.serving.replicas import ReplicaScheduler

__all__ = [
    "FleetCoordinator",
    "HostDied",
    "LocalHost",
    "RemoteHost",
    "StreamInterrupted",
    "WorkerAgent",
    "connect_fleet",
    "deserialize_handoff",
    "maybe_promote",
    "read_checkpoint",
    "read_lease",
    "run_worker",
    "serialize_handoff",
    "write_checkpoint",
    "write_lease",
]

#: control-plane RPC timeout for NON-streaming calls (probe/stats/scale);
#: loopback and intra-fleet DCN both answer in milliseconds, so a second of
#: silence means the worker is gone, not slow
CONTROL_TIMEOUT_S = 30.0

#: per-read ceiling on a token stream: long enough for any cold compile a
#: first token can hide behind, short enough that a genuinely wedged worker
#: is eventually declared dead instead of pinning the relay forever
STREAM_READ_TIMEOUT_S = 600.0

#: errors that mean "the worker is unreachable" — the caller suspects the
#: host and routes around it (the reconciliation loop owns re-probing)
_DEAD_ERRORS = (ConnectionError, OSError, TimeoutError)

#: host lifecycle states (docs/serving.md "Fault tolerance"): only a live
#: host takes traffic; suspect/dead are routed around and re-probed; a
#: probation host is being readmitted but not yet trusted
HOST_LIVE = "live"
HOST_SUSPECT = "suspect"
HOST_DEAD = "dead"
HOST_PROBATION = "probation"

#: bounded decorrelated-jitter retry envelope for IDEMPOTENT control RPCs
#: (ping/probe/stats/health): one slow scrape must cost a retry, not a host
RETRY_ATTEMPTS = 2
RETRY_BASE_S = 0.05
RETRY_CAP_S = 0.5

#: rendezvous-dir control files: the fenced coordinator checkpoint and the
#: heartbeat lease (both written under atomic rename)
CHECKPOINT_FILE = "coordinator.json"
LEASE_FILE = "coordinator.lease"


class HostDied(RuntimeError):
    """A remote host failed mid-stream (transport death or injected fault).
    Raised by :class:`_RemoteStream`; the coordinator's stream guard turns it
    into a sibling retry (zero tokens emitted) or a clean
    :class:`StreamInterrupted` (tokens already emitted)."""


class StreamInterrupted(RuntimeError):
    """A stream that had already emitted tokens lost its host: the clean
    503-shaped error record — the consumer learns the stream is over *now*,
    instead of hanging on a dead socket. ``emitted`` carries how many tokens
    arrived before the cut."""

    status = 503

    def __init__(self, detail: str, *, emitted: int = 0):
        super().__init__(detail)
        self.detail = detail
        self.emitted = int(emitted)


# ------------------------------------------------------------ checkpoint & lease


def _read_json_file(path: Path) -> "Optional[Dict[str, Any]]":
    try:
        payload = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


def read_checkpoint(fleet_dir: "str | Path") -> "Optional[Dict[str, Any]]":
    """The coordinator's persisted checkpoint (fleet spec, roster, monotonic
    epoch), or None when the rendezvous dir holds none / a torn write."""
    return _read_json_file(Path(fleet_dir).expanduser() / CHECKPOINT_FILE)


def write_checkpoint(
    fleet_dir: "str | Path",
    *,
    epoch: int,
    num_hosts: int,
    roster: "List[Dict[str, Any]]",
    failovers: int = 0,
    announce_floor: int = 0,
) -> bool:
    """Persist the coordinator checkpoint under atomic rename, FENCED on the
    epoch: when the directory already holds a higher epoch a newer
    coordinator exists and this writer is the zombie — the write is refused
    (returns False) instead of clobbering the living fleet's metadata."""
    root = Path(fleet_dir).expanduser()
    root.mkdir(parents=True, exist_ok=True)
    current = read_checkpoint(root)
    if current is not None and int(current.get("epoch", 0)) > int(epoch):
        return False
    payload = {
        "version": 1,
        "epoch": int(epoch),
        "num_hosts": int(num_hosts),
        "roster": roster,
        "failovers": int(failovers),
        #: the announce-epoch floor THIS fleet generation accepted: a
        #: same-generation successor (maybe_promote) must keep accepting the
        #: generation's original announces, while a fresh connect in the same
        #: dir raises the floor to this checkpoint's epoch
        "announce_floor": int(announce_floor),
        "written_at": time.time(),  # wall clock: read by OTHER processes
    }
    tmp = root / (CHECKPOINT_FILE + ".tmp")
    tmp.write_text(json.dumps(payload, sort_keys=True))
    os.replace(tmp, root / CHECKPOINT_FILE)
    return True


def read_lease(fleet_dir: "str | Path") -> "Optional[Dict[str, Any]]":
    return _read_json_file(Path(fleet_dir).expanduser() / LEASE_FILE)


def write_lease(
    fleet_dir: "str | Path", *, epoch: int, owner: int, ttl_s: float
) -> bool:
    """Heartbeat the coordinator lease (atomic rename, epoch-fenced like
    :func:`write_checkpoint`): workers watch its expiry to detect a dead
    coordinator, and a zombie's heartbeat is refused the moment a
    higher-epoch successor exists."""
    root = Path(fleet_dir).expanduser()
    root.mkdir(parents=True, exist_ok=True)
    current = read_lease(root)
    if current is not None and int(current.get("epoch", 0)) > int(epoch):
        return False
    payload = {
        "epoch": int(epoch),
        "owner": int(owner),
        "ttl_s": float(ttl_s),
        "expires_at": time.time() + float(ttl_s),  # wall clock: crosses processes
    }
    tmp = root / (LEASE_FILE + ".tmp")
    tmp.write_text(json.dumps(payload, sort_keys=True))
    os.replace(tmp, root / LEASE_FILE)
    return True


def lease_expired(lease: "Optional[Dict[str, Any]]", *, grace_s: float = 0.0) -> bool:
    """Whether a lease is missing or past its expiry (wall clock — the one
    cross-process time base; a fresh write always postdates a dead one)."""
    if lease is None:
        return True
    try:
        return time.time() > float(lease.get("expires_at", 0.0)) + float(grace_s)
    except (TypeError, ValueError):
        return True


# ---------------------------------------------------------------------- handoff wire


#: tensor dtypes numpy cannot hold, carried as their raw bits on the wire
_RAW_DTYPES = {torch.bfloat16: ("bfloat16", np.uint16)}


def _wire_array(buf: Any, name: str, raw: Dict[str, str]) -> np.ndarray:
    """One payload leaf as a numpy array for the ``npz``: a tensor is copied
    to the host whole (one copy a layer's leaf); a dtype numpy lacks goes as
    its raw bits, its name recorded in ``raw``."""
    if not isinstance(buf, torch.Tensor):
        return np.asarray(buf)
    buf = buf.detach().cpu()
    if buf.dtype in _RAW_DTYPES:
        label, bits = _RAW_DTYPES[buf.dtype]
        raw[name] = label
        return buf.contiguous().view(torch.int16).numpy().view(bits)
    return buf.numpy()


def serialize_handoff(payload: Dict[str, Any]) -> bytes:
    """Encode a handoff payload (``_export_admission``'s dict) for the wire:
    KV pages/rows as an uncompressed ``npz``, the scalar metadata as JSON
    riding inside it. The ``trace`` never crosses (request timelines are
    per-process); the absolute-monotonic ``deadline``/``created_at`` are
    rebased to RELATIVE seconds so the importing host's clock domain applies
    them correctly. bfloat16 leaves cross as raw 16 bits (``raw_dtypes`` in
    the metadata names them); any other payload reads as the JAX package's."""
    meta = {
        "prompt": [int(t) for t in payload["prompt"]],
        "first": int(payload["first"]),
        "lengths": int(payload["lengths"]),
        "max_new": int(payload["max_new"]),
        "produced": int(payload["produced"]),
        "echo": [int(t) for t in payload.get("echo", [])],
        "grammar": int(payload.get("grammar", 0)),
        "priority": int(payload.get("priority", 1)),
        "tenant": payload.get("tenant"),
        "deadline_remaining_s": remaining_s(payload.get("deadline")),
        "age_s": time.monotonic() - payload.get("created_at", time.monotonic()),
        "block_size": payload.get("block_size"),
    }
    arrays: Dict[str, np.ndarray] = {}
    raw: Dict[str, str] = {}
    layers = payload["pages"] if payload.get("pages") is not None else payload["row"]
    meta["kind"] = "pages" if payload.get("pages") is not None else "row"
    for i, layer in enumerate(layers):
        for name, buf in layer.items():
            arrays[f"p{i}.{name}"] = _wire_array(buf, f"p{i}.{name}", raw)
    meta["layers"] = len(layers)
    if raw:
        meta["raw_dtypes"] = raw
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    out = io.BytesIO()
    np.savez(out, **arrays)
    return out.getvalue()


def _leaf(array: np.ndarray, label: Optional[str]) -> torch.Tensor:
    tensor = torch.from_numpy(np.array(array))
    if label is None:
        return tensor
    dtype = next(d for d, (name, _) in _RAW_DTYPES.items() if name == label)
    return tensor.view(torch.int16).view(dtype)


def deserialize_handoff(data: bytes) -> Dict[str, Any]:
    """Decode :func:`serialize_handoff`'s bytes (or the JAX package's) back
    into the payload dict :meth:`ContinuousBatcher.import_handoff` consumes:
    pages as host tensors, which the importing engine places on its own
    device (and, over a mesh, cuts to its ranks' heads)."""
    with np.load(io.BytesIO(data)) as bundle:
        meta = json.loads(bytes(bundle["__meta__"]).decode())
        raw = meta.pop("raw_dtypes", {})
        layers = [
            {
                key.split(".", 1)[1]: _leaf(bundle[key], raw.get(key))
                for key in bundle.files
                if key.startswith(f"p{i}.")
            }
            for i in range(meta["layers"])
        ]
    remaining = meta.pop("deadline_remaining_s")
    age = meta.pop("age_s")
    kind = meta.pop("kind")
    meta.pop("layers")
    payload: Dict[str, Any] = dict(meta)
    payload["pages" if kind == "pages" else "row"] = tuple(layers)
    payload["deadline"] = None if remaining is None else time.monotonic() + remaining
    payload["created_at"] = time.monotonic() - max(age, 0.0)
    payload["trace"] = None
    return payload


# --------------------------------------------------------------------- worker agent


class _ControlHandler(BaseHTTPRequestHandler):
    """Route table of one worker's control server. HTTP/1.0 close-delimited
    responses keep the streaming path trivial (the coordinator reads lines
    until EOF); every request is its own connection — loopback/DCN accepts
    are microseconds against a decode chunk."""

    agent: "WorkerAgent"  # set by WorkerAgent on the subclass

    def log_message(self, fmt: str, *args: Any) -> None:  # route to our logger
        logger.debug(f"cluster control: {fmt % args}")

    def _json(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _drop_connection(self) -> None:
        """Simulate a dead worker for an injected fault: sever the TCP
        connection without any response bytes — the coordinator sees exactly
        what a SIGKILLed process produces."""
        self.close_connection = True
        try:
            self.connection.close()
        except OSError:  # pragma: no cover - defensive
            pass

    def _fault_gate(self) -> bool:
        """Consult the worker-side fault plan before dispatching; True when
        the request was injected away (connection already dropped)."""
        faults = self.agent.faults
        if faults is None:
            return False
        try:
            faults.check_rpc(self.agent.process_id, self.path)
        except ConnectionError:
            self._drop_connection()
            return True
        return False

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        agent = self.agent
        if self._fault_gate():
            return
        try:
            if self.path == "/ctrl/ping":
                self._json(200, {"ok": True, "process_id": agent.process_id, "role": agent.role})
            elif self.path == "/ctrl/stats":
                self._json(200, {"stats": _jsonable(agent.engine.stats())})
            elif self.path == "/ctrl/health":
                self._json(200, _jsonable(agent.engine.health()))
            else:
                self._json(404, {"detail": f"no control route for {self.path}"})
        except Exception as exc:  # pragma: no cover - defensive
            logger.exception("control GET failed")
            self._json(500, {"detail": f"{type(exc).__name__}: {exc}"})

    def do_POST(self) -> None:  # noqa: N802 - http.server contract
        agent = self.agent
        if self._fault_gate():
            return
        try:
            if self.path == "/ctrl/submit":
                self._submit(json.loads(self._body() or b"{}"))
            elif self.path == "/ctrl/import":
                self._import(self._body())
            elif self.path == "/ctrl/probe":
                request = json.loads(self._body() or b"{}")
                self._json(200, agent.probe(request.get("prompt")))
            elif self.path == "/ctrl/scale":
                request = json.loads(self._body() or b"{}")
                count = agent.engine.scale_to(
                    int(request["replicas"]), role=request.get("role")
                )
                self._json(200, {"replicas": count})
            elif self.path == "/ctrl/warmup":
                agent.engine.warmup()
                self._json(200, {"ok": True})
            elif self.path == "/ctrl/drain":
                agent.engine.close(wait=True)
                self._json(200, {"ok": True})
            elif self.path == "/ctrl/shutdown":
                self._json(200, {"ok": True})
                agent.request_shutdown()
            else:
                self._json(404, {"detail": f"no control route for {self.path}"})
        except (QueueFullError, DeadlineExceeded) as exc:
            self._shed(exc)
        except Exception as exc:
            logger.exception("control POST failed")
            try:
                self._json(500, {"detail": f"{type(exc).__name__}: {exc}"})
            except _DEAD_ERRORS:
                pass

    # ------------------------------------------------------------ streaming routes

    def _shed(self, exc: BaseException) -> None:
        """Map the engine's shed exceptions onto the wire so the coordinator
        re-raises the SAME types (429 queue/tenant, 503 deadline) — the
        fleet-wide overload posture survives the process boundary."""
        if isinstance(exc, TenantThrottled):
            self._json(429, {
                "detail": exc.detail, "kind": "tenant_limit",
                "retry_after": exc.retry_after_s, "tenant": exc.tenant,
            })
        elif isinstance(exc, QueueFullError):
            self._json(429, {
                "detail": exc.detail, "kind": "queue_full", "retry_after": exc.retry_after_s,
            })
        else:
            self._json(503, {"detail": str(exc) or "deadline exceeded", "kind": "deadline"})

    def _stream(self, stream: Any, *, export: bool) -> None:
        """Relay an engine token stream as ndjson lines, flushed per chunk so
        the coordinator's client sees each token as it is produced. A broken
        pipe (coordinator/client went away) closes the engine stream so the
        producer never decodes to a dead connection. An EXPORT stream's
        handoff payload rides as a final base64 ``npz`` line."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        faults = self.agent.faults
        cut_after = (
            faults.stream_cut_after(self.agent.process_id) if faults is not None else None
        )
        sent = 0
        try:
            for chunk in stream:
                if cut_after is not None and sent >= cut_after:
                    # injected stream_cut: sever mid-stream with no end marker
                    # — the coordinator sees a truncated stream, exactly as if
                    # the worker died between flushes
                    _close_quietly(stream)
                    self._drop_connection()
                    return
                tokens = [int(t) for t in np.asarray(chunk).ravel()]
                self.wfile.write(json.dumps({"t": tokens}).encode() + b"\n")
                self.wfile.flush()
                sent += 1
            if export and getattr(stream, "handoff", None) is not None:
                blob = base64.b64encode(serialize_handoff(stream.handoff)).decode()
                self.wfile.write(json.dumps({"handoff": blob}).encode() + b"\n")
            self.wfile.write(b'{"end": true}\n')
            self.wfile.flush()
        except _DEAD_ERRORS:
            _close_quietly(stream)
        except Exception as exc:
            _close_quietly(stream)
            try:
                self.wfile.write(
                    json.dumps({"error": f"{type(exc).__name__}: {exc}"}).encode() + b"\n"
                )
            except _DEAD_ERRORS:
                pass

    def _submit(self, request: Dict[str, Any]) -> None:
        agent = self.agent
        deadline = request.get("deadline_remaining_s")
        kwargs: Dict[str, Any] = {
            "max_new_tokens": request.get("max_new_tokens"),
            "constraint": request.get("constraint"),
            "deadline": None if deadline is None else time.monotonic() + float(deadline),
            "tenant": request.get("tenant"),
            "priority": request.get("priority"),
        }
        export = bool(request.get("export"))
        if export:
            kwargs["export_handoff"] = True
        stream = agent.engine.submit([int(t) for t in request["prompt"]], **kwargs)
        self._stream(stream, export=export)

    def _import(self, body: bytes) -> None:
        stream = self.agent.engine.import_handoff(deserialize_handoff(body))
        self._stream(stream, export=False)


def _close_quietly(stream: Any) -> None:
    closer = getattr(stream, "close", None)
    if callable(closer):
        try:
            closer()
        except Exception:  # pragma: no cover - defensive
            pass


def _jsonable(obj: Any) -> Any:
    """Strip a stats/health dict down to JSON-encodable leaves (numpy scalars
    become Python numbers; anything else stringifies)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _current_trace() -> Any:
    """The active request trace, if tracing is on (lazy import: cluster must
    stay importable without the observability stack initialized)."""
    from unionml_tpu_torch.observability.trace import current_trace

    return current_trace()


def _host_state(host: Any) -> str:
    """A handle's lifecycle state, with the boolean-only (duck-typed) handle
    fallback — uniform rows for /healthz, /debug/fleet, and /metrics."""
    state = getattr(host, "state", None)
    if isinstance(state, str):
        return state
    return HOST_LIVE if getattr(host, "alive", True) else HOST_DEAD


def _host_transition_s(host: Any) -> float:
    fn = getattr(host, "last_transition_s", None)
    return round(float(fn()), 3) if callable(fn) else 0.0


def _fleet_probe(engine: Any, prompt: Optional[Sequence[int]]) -> Dict[str, Any]:
    """One host's routing signals in a single fetch: token-weighted load,
    the radix probe for this prompt (the fleet-global prefix tier), the SLO
    breach flag, and the live replica count."""
    cached = 0
    if prompt is not None:
        probe = getattr(engine, "cached_prefix_tokens", None)
        if callable(probe):
            cached = int(probe([int(t) for t in prompt]))
    health_fn = getattr(engine, "health", None)
    breaching = False
    if callable(health_fn):
        breaching = health_fn().get("state") == "breach"
    replicas = getattr(engine, "replicas", 1)
    return {
        "load": float(engine.load()),
        "cached": cached,
        "breaching": bool(breaching),
        "replicas": int(replicas) if isinstance(replicas, (int, np.integer)) else 1,
    }


class WorkerAgent:
    """One worker process's control server around its local engine.

    Binds a loopback (or fleet-network) :class:`ThreadingHTTPServer` on an
    OS-assigned port, serves the control routes (`/ctrl/submit`,
    ``/ctrl/import``, ``/ctrl/probe``, ``/ctrl/stats``, ``/ctrl/health``,
    ``/ctrl/scale``, ``/ctrl/warmup``, ``/ctrl/drain``, ``/ctrl/shutdown``)
    on daemon threads, and announces itself into the fleet rendezvous
    directory so the coordinator can connect."""

    def __init__(
        self,
        engine: Any,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        process_id: Optional[int] = None,
        role: str = "mixed",
        fault_plan: "FaultPlan | ArmedFaultPlan | None" = None,
    ):
        from unionml_tpu_torch import distributed

        self.engine = engine
        self.role = role
        self.process_id = distributed.process_index() if process_id is None else int(process_id)
        handler = type("_BoundControlHandler", (_ControlHandler,), {"agent": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None
        #: set by /ctrl/shutdown (and close()) — run_worker's exit signal
        self.shutdown_event = threading.Event()
        #: this worker's rendezvous file, tracked so graceful shutdown can
        #: remove it (a stale announce would point a restarted fleet in the
        #: same --fleet-dir at a dead address)
        self._announce_path: Optional[Path] = None
        if fault_plan is None:
            fault_plan = FaultPlan.from_env()
        #: worker-side fault injector (serving/faults.py); None = no plan
        self.faults: Optional[ArmedFaultPlan] = (
            fault_plan.arm() if isinstance(fault_plan, FaultPlan) else fault_plan
        )

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def probe(self, prompt: Optional[Sequence[int]]) -> Dict[str, Any]:
        return _fleet_probe(self.engine, prompt)

    def start(self) -> "WorkerAgent":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
                daemon=True, name=f"unionml-tpu-worker-{self.process_id}",
            )
            self._thread.start()
            logger.info(f"worker {self.process_id} control server on {self.address} (role={self.role})")
        return self

    def announce(self, fleet_dir: "str | Path") -> Path:
        """Write this worker's rendezvous file (atomic: the coordinator must
        never read a half-written announcement). The announce is EPOCH-STAMPED
        with the fleet checkpoint's current epoch (0 before any coordinator
        wrote one): the reconciliation loop and ``connect_fleet`` reject
        announces from a previous fleet generation, so a stale file can never
        point a fresh fleet at a dead address."""
        root = Path(fleet_dir).expanduser()
        root.mkdir(parents=True, exist_ok=True)
        checkpoint = read_checkpoint(root)
        path = root / f"host-{self.process_id}.json"
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps({
            "process_id": self.process_id,
            "host": self.host,
            "port": self.port,
            "pid": os.getpid(),
            "role": self.role,
            "epoch": int(checkpoint.get("epoch", 0)) if checkpoint else 0,
        }))
        os.replace(tmp, path)
        self._announce_path = path
        return path

    def request_shutdown(self) -> None:
        self.shutdown_event.set()

    def close(self, *, close_engine: bool = True) -> None:
        self.shutdown_event.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._announce_path is not None:
            # rendezvous hygiene: a gracefully-stopped worker withdraws its
            # announce so a restarted fleet in the same dir never pings it
            try:
                self._announce_path.unlink()
            except OSError:  # pragma: no cover - already gone / dir removed
                pass
            self._announce_path = None
        if close_engine:
            self.engine.close(wait=True)


# ---------------------------------------------------------------------- host handles


class LocalHost:
    """The coordinator's handle on an engine living in ITS OWN process (host 0
    usually serves too) — direct calls, no HTTP hop."""

    def __init__(self, engine: Any, *, host_id: int = 0, role: str = "mixed"):
        self.engine = engine
        self.host_id = int(host_id)
        self.role = role
        self.alive = True
        self.address = "local"
        #: an in-process engine has no transport to fail: its lifecycle is
        #: degenerate (live while ``alive``); counters exist so the fleet
        #: aggregation reads every host uniformly
        self.suspects = 0
        self.rejoins = 0
        self.rpc_retries = 0
        self.epoch = 0

    @property
    def state(self) -> str:
        return HOST_LIVE if self.alive else HOST_DEAD

    def last_transition_s(self) -> float:
        return 0.0

    @property
    def gen(self) -> Any:
        """The underlying Generator (engine or first replica) — the
        ``/v1/*`` routes resolve generation config through ``batchers[0]``,
        and on a multi-host fleet ``batchers`` are HOST handles; without this
        delegation every OpenAI completion against a coordinator-fronted
        fleet answered 500."""
        gen = getattr(self.engine, "gen", None)
        if gen is None:
            batchers = getattr(self.engine, "batchers", None)
            if batchers:
                gen = getattr(batchers[0], "gen", None)
        return gen

    def probe(self, prompt: Optional[Sequence[int]]) -> Dict[str, Any]:
        return _fleet_probe(self.engine, prompt)

    def submit(self, prompt: Sequence[int], *, export: bool = False, **kwargs: Any) -> Any:
        if export:
            kwargs["export_handoff"] = True
        return self.engine.submit(prompt, **kwargs)

    def import_handoff(self, payload: Any) -> Any:
        if isinstance(payload, (bytes, bytearray)):
            payload = deserialize_handoff(bytes(payload))
        return self.engine.import_handoff(payload)

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def health(self) -> Dict[str, Any]:
        fn = getattr(self.engine, "health", None)
        if callable(fn):
            payload = dict(fn())  # copy: the engine may serve a TTL-cached dict
        else:
            payload = {"score": 1.0, "state": "ok", "state_code": 0, "enabled": False}
        payload["host_state"] = self.state
        payload["last_transition_s"] = 0.0
        return payload

    def occupancy(self) -> "Tuple[int, int]":
        fn = getattr(self.engine, "occupancy", None)
        if callable(fn):
            return fn()
        resident = sum(b.occupancy()[0] for b in getattr(self.engine, "batchers", ()))
        waiting = sum(b.occupancy()[1] for b in getattr(self.engine, "batchers", ()))
        return resident, waiting

    def warmup(self) -> None:
        self.engine.warmup()

    def scale_to(self, n: int, *, role: Optional[str] = None) -> int:
        return self.engine.scale_to(n, role=role)

    def replicas(self) -> int:
        return int(getattr(self.engine, "replicas", 1) or 1)

    def close(self, *, shutdown_worker: bool = False) -> None:
        self.engine.close(wait=True)


class _RemoteStream:
    """Iterator over a worker's ndjson token stream. ``close()`` drops the
    TCP connection, which the worker maps to closing the engine stream — the
    relay's client-disconnect contract crosses the process boundary. An
    EXPORT stream's serialized handoff lands on ``.handoff`` after the last
    token."""

    def __init__(
        self,
        conn: HTTPConnection,
        response: Any,
        host: "RemoteHost",
        *,
        cut_after: Optional[int] = None,
    ):
        self._conn = conn
        self._response = response
        self._host = host
        self._closed = False
        self._yielded = 0
        #: coordinator-side injected stream_cut: sever after this many chunks
        self._cut_after = cut_after
        self.handoff: Optional[bytes] = None

    def __iter__(self) -> "Iterator[np.ndarray]":
        return self

    def __next__(self) -> np.ndarray:
        while True:
            if self._cut_after is not None and self._yielded >= self._cut_after:
                self.close()
                self._host.mark_suspect(ConnectionError("fault-injected stream_cut"))
                raise HostDied(
                    f"worker {self._host.host_id} stream cut after {self._yielded} chunks "
                    "(fault-injected)"
                )
            try:
                line = self._response.readline()
            except _DEAD_ERRORS as exc:
                self._host.mark_suspect(exc)
                self.close()
                raise HostDied(f"worker {self._host.host_id} died mid-stream: {exc}") from exc
            if not line:
                # connection closed without an end marker: the worker died
                self.close()
                if not self._closed_cleanly:
                    self._host.mark_suspect(ConnectionError("stream truncated"))
                    raise HostDied(f"worker {self._host.host_id} truncated the stream")
                raise StopIteration
            record = json.loads(line)
            if "t" in record:
                self._yielded += 1
                return np.asarray(record["t"], np.int32)
            if "handoff" in record:
                self.handoff = base64.b64decode(record["handoff"])
                continue
            if record.get("end"):
                self._closed_cleanly = True
                self.close()
                raise StopIteration
            if "error" in record:
                self.close()
                raise RuntimeError(f"worker {self._host.host_id} stream failed: {record['error']}")

    _closed_cleanly = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._conn.close()
            except Exception:  # pragma: no cover - defensive
                pass


class RemoteHost:
    """The coordinator's handle on a worker process, over the HTTP control
    plane — with a lifecycle, not a boolean: ``live → suspect`` on a
    transport failure (routed around, re-probed by the reconciliation loop),
    ``suspect → dead`` after consecutive probe failures, ``→ probation`` on a
    successful re-probe or a fresh epoch-stamped announce, and
    ``probation → live`` after the configured probe streak plus a warmup.
    Idempotent control RPCs (ping/probe/stats/health) retry with bounded
    decorrelated jitter before suspecting the host; non-idempotent calls
    (submit/import/scale) never retry in-band — a wedged worker retried into
    is a wedged fleet."""

    def __init__(
        self,
        address: str,
        *,
        host_id: int,
        role: str = "mixed",
        epoch: int = 0,
        faults: "Optional[ArmedFaultPlan]" = None,
    ):
        self.address = address
        self.host_id = int(host_id)
        self.role = role
        host, _, port = address.partition(":")
        self._host, self._port = host, int(port)
        #: announce epoch this handle was bound from (stale-announce fencing)
        self.epoch = int(epoch)
        #: coordinator-side fault injector (serving/faults.py); None = no plan
        self.faults = faults
        #: lifecycle telemetry (summed into stats()["fleet"])
        self.suspects = 0
        self.rejoins = 0
        self.rpc_retries = 0
        self._slock = threading.Lock()
        self._state = HOST_LIVE
        self._state_since = time.monotonic()
        self._consecutive_failures = 0
        self._probation_successes = 0
        self._down_since: Optional[float] = None
        self._retry_rng = random.Random(host_id)
        #: (address, epoch, pid) of the announce this handle was bound from —
        #: the reconciler's dedup key for rebinding returning workers
        self._bound_announce: "Optional[Tuple[str, int, Any]]" = None

    # ------------------------------------------------------------- lifecycle

    @property
    def alive(self) -> bool:
        """Only a LIVE host takes traffic; suspect/dead/probation are all
        routed around (the scheduler's view is binary, the reconciler's is
        not)."""
        return self._state == HOST_LIVE

    @property
    def state(self) -> str:
        return self._state

    def last_transition_s(self) -> float:
        return max(time.monotonic() - self._state_since, 0.0)

    def _transition_locked(self, state: str) -> bool:
        # caller holds self._slock (the *_locked convention)
        if state == self._state:
            return False
        self._state = state
        self._state_since = time.monotonic()
        return True

    def mark_suspect(self, exc: BaseException) -> bool:
        """A transport failure: live → suspect (dead stays dead — only the
        reconciler readmits). Returns True on an actual live→suspect edge."""
        with self._slock:
            if self._state == HOST_DEAD:
                return False
            was_live = self._state == HOST_LIVE
            changed = self._transition_locked(HOST_SUSPECT)
            if changed and was_live:
                self.suspects += 1
                if self._down_since is None:
                    self._down_since = time.monotonic()
            self._probation_successes = 0
        if changed and was_live:
            logger.warning(
                f"fleet host {self.host_id} ({self.address}) suspect: {exc} "
                "(routed around; reconciliation will re-probe)"
            )
        return changed and was_live

    def mark_dead(self, exc: "Optional[BaseException]" = None) -> None:
        """The terminal demotion (N consecutive probe failures, or an
        explicit operator action); only a fresh announce or a successful
        re-probe brings the host back through probation."""
        with self._slock:
            if self._state == HOST_LIVE and self._down_since is None:
                self._down_since = time.monotonic()
                self.suspects += 1
            changed = self._transition_locked(HOST_DEAD)
        if changed:
            logger.warning(
                f"fleet host {self.host_id} ({self.address}) marked dead"
                + (f": {exc}" if exc is not None else "")
            )

    def note_probe_success(self, probation_probes: int) -> bool:
        """A reconciliation probe answered: suspect/dead → probation, and
        each further success extends the streak. True when the streak has
        reached ``probation_probes`` (the host is ready to go live)."""
        with self._slock:
            if self._state in (HOST_SUSPECT, HOST_DEAD):
                self._transition_locked(HOST_PROBATION)
                self._probation_successes = 1
            elif self._state == HOST_PROBATION:
                self._probation_successes += 1
            self._consecutive_failures = 0
            return (
                self._state == HOST_PROBATION
                and self._probation_successes >= int(probation_probes)
            )

    def note_probe_failure(self, dead_after: int) -> None:
        """A reconciliation probe failed: probation collapses back to
        suspect, and ``dead_after`` consecutive failures demote to dead."""
        with self._slock:
            self._consecutive_failures += 1
            if self._state == HOST_PROBATION:
                self._transition_locked(HOST_SUSPECT)
                self._probation_successes = 0
            demote = (
                self._state == HOST_SUSPECT
                and self._consecutive_failures >= int(dead_after)
            )
        if demote:
            self.mark_dead(ConnectionError(f"{dead_after} consecutive probe failures"))

    def go_live(self) -> "Tuple[bool, Optional[float]]":
        """Probation passed (probes + warmup): take traffic again. Returns
        ``(transitioned, down_since)`` so the coordinator can observe the
        outage-to-recovery latency."""
        with self._slock:
            changed = self._transition_locked(HOST_LIVE)
            down = self._down_since
            self._down_since = None
            self._consecutive_failures = 0
            self._probation_successes = 0
            if changed:
                self.rejoins += 1
        if changed:
            logger.info(f"fleet host {self.host_id} ({self.address}) rejoined (live)")
        return changed, down

    def rebind(self, address: str, *, epoch: int, role: "Optional[str]" = None) -> None:
        """Bind this handle to a returning worker's fresh announce (possibly
        a new address — a restarted or replacement process) and enter
        probation; traffic waits for the probe streak + warmup."""
        with self._slock:
            self.address = address
            host, _, port = address.partition(":")
            self._host, self._port = host, int(port)
            self.epoch = int(epoch)
            if role is not None:
                self.role = role
            self._transition_locked(HOST_PROBATION)
            self._probation_successes = 0
            self._consecutive_failures = 0
            if self._down_since is None:
                self._down_since = time.monotonic()
        logger.info(
            f"fleet host {self.host_id} re-announced at {address} (epoch {epoch}); probation"
        )

    # ------------------------------------------------------------- transport

    def _connect(self, timeout: Optional[float]) -> HTTPConnection:
        return HTTPConnection(self._host, self._port, timeout=timeout)

    def _call(self, method: str, path: str, body: Optional[bytes] = None,
              *, timeout: float = CONTROL_TIMEOUT_S, mark: bool = True) -> Dict[str, Any]:
        """One non-streaming control RPC; a transport error suspects the host
        (``mark=False`` lets the retry wrapper defer the verdict) and
        re-raises. NEVER call while holding a lock: a stalled
        worker must cost this call, not the whole coordinator."""
        if self.faults is not None:
            self.faults.check_rpc(self.host_id, path)
        conn = self._connect(timeout)
        try:
            conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
            response = conn.getresponse()
            payload = json.loads(response.read() or b"{}")
            if response.status >= 400:
                _raise_shed(response.status, payload)
            return payload
        except _DEAD_ERRORS as exc:
            if mark:
                self.mark_suspect(exc)
            raise
        finally:
            conn.close()

    def _call_retry(self, method: str, path: str, body: Optional[bytes] = None,
                    *, timeout: float = CONTROL_TIMEOUT_S,
                    attempts: int = RETRY_ATTEMPTS) -> Dict[str, Any]:
        """Bounded decorrelated-jitter retry for IDEMPOTENT control RPCs
        (ping/probe/stats/health): a transient
        drop or slow scrape costs a retry, not a host; only the exhausted
        envelope suspects. Non-idempotent calls must use :meth:`_call`."""
        sleep_s = RETRY_BASE_S
        last: Optional[BaseException] = None
        for attempt in range(max(int(attempts), 1)):
            try:
                return self._call(method, path, body, timeout=timeout, mark=False)
            except (QueueFullError, DeadlineExceeded):
                raise  # a shed is an ANSWER, not a transport failure
            except _DEAD_ERRORS as exc:
                last = exc
                if attempt + 1 >= max(int(attempts), 1):
                    break
                with self._slock:
                    self.rpc_retries += 1
                sleep_s = min(RETRY_CAP_S, self._retry_rng.uniform(RETRY_BASE_S, sleep_s * 3))
                time.sleep(sleep_s)
        assert last is not None
        self.mark_suspect(last)
        raise last

    def _stream_call(self, path: str, body: bytes, content_type: str) -> _RemoteStream:
        if self.faults is not None:
            self.faults.check_rpc(self.host_id, path)
            cut_after = self.faults.stream_cut_after(self.host_id)
        else:
            cut_after = None
        conn = self._connect(CONTROL_TIMEOUT_S)
        try:
            try:
                # connect under the control timeout, then RELAX the socket for
                # the stream's lifetime BEFORE the request: a cold first token
                # can sit behind a multi-minute kernel build, and for
                # close-delimited responses http.client drops conn.sock at
                # getresponse() — there is no socket left to retune afterwards
                # (a 30 s-stalled stream used to mis-classify the worker as
                # dead here)
                conn.connect()
                if conn.sock is not None:
                    conn.sock.settimeout(STREAM_READ_TIMEOUT_S)
                conn.request("POST", path, body=body, headers={"Content-Type": content_type})
                response = conn.getresponse()
            except _DEAD_ERRORS as exc:
                self.mark_suspect(exc)
                raise
            if response.status >= 400:
                # a garbage error body (truncated read, non-JSON payload)
                # raises out of here too — the outer close still runs
                payload = json.loads(response.read() or b"{}")
                _raise_shed(response.status, payload)
        except BaseException:
            # every failure path releases the socket: errors not in
            # _DEAD_ERRORS (interrupts, JSON decode failures on the shed
            # payload) used to leak the connection
            conn.close()
            raise
        return _RemoteStream(conn, response, self, cut_after=cut_after)

    def ping(self, timeout: float = CONTROL_TIMEOUT_S) -> Dict[str, Any]:
        return self._call_retry("GET", "/ctrl/ping", timeout=timeout)

    def probe(self, prompt: Optional[Sequence[int]]) -> Dict[str, Any]:
        body = json.dumps({"prompt": [int(t) for t in prompt] if prompt is not None else None})
        return self._call_retry("POST", "/ctrl/probe", body.encode())

    def submit(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: Optional[int] = None,
        constraint: Optional[int] = None,
        deadline: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        export: bool = False,
    ) -> _RemoteStream:
        body = json.dumps({
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": max_new_tokens,
            "constraint": constraint,
            "deadline_remaining_s": remaining_s(deadline),
            "tenant": tenant,
            "priority": priority,
            "export": export,
        }).encode()
        return self._stream_call("/ctrl/submit", body, "application/json")

    def import_handoff(self, payload: Any) -> _RemoteStream:
        if not isinstance(payload, (bytes, bytearray)):
            payload = serialize_handoff(payload)
        return self._stream_call("/ctrl/import", bytes(payload), "application/octet-stream")

    def stats(self) -> Dict[str, Any]:
        return self._call_retry("GET", "/ctrl/stats")["stats"]

    def health(self) -> Dict[str, Any]:
        if not self.alive:
            return {
                "score": 0.0, "state": "breach", "state_code": 2, "enabled": True,
                "dead": True, "host_state": self._state,
                "last_transition_s": round(self.last_transition_s(), 3),
            }
        try:
            payload = self._call_retry("GET", "/ctrl/health")
        except _DEAD_ERRORS:
            return {
                "score": 0.0, "state": "breach", "state_code": 2, "enabled": True,
                "dead": True, "host_state": self._state,
                "last_transition_s": round(self.last_transition_s(), 3),
            }
        payload["host_state"] = self._state
        payload["last_transition_s"] = round(self.last_transition_s(), 3)
        return payload

    def occupancy(self) -> "Tuple[int, int]":
        stats = self.stats()
        return int(stats.get("resident") or 0), int(stats.get("waiting") or 0)

    def warmup(self) -> None:
        self._call("POST", "/ctrl/warmup", b"{}", timeout=600.0)

    def scale_to(self, n: int, *, role: Optional[str] = None) -> int:
        payload = self._call(
            "POST", "/ctrl/scale", json.dumps({"replicas": int(n), "role": role}).encode(),
            timeout=600.0,
        )
        return int(payload["replicas"])

    def replicas(self) -> int:
        try:
            return int(self.stats().get("replicas") or 1)
        except _DEAD_ERRORS:
            return 0

    def close(self, *, shutdown_worker: bool = False) -> None:
        if not self.alive:
            return
        try:
            self._call("POST", "/ctrl/drain", b"{}", timeout=600.0)
            if shutdown_worker:
                self._call("POST", "/ctrl/shutdown", b"{}")
        except _DEAD_ERRORS:
            pass


def _raise_shed(status: int, payload: Dict[str, Any]) -> None:
    """Re-raise a worker's shed response as the SAME exception type the local
    engine would have raised, Retry-After preserved."""
    kind = payload.get("kind")
    detail = payload.get("detail") or f"worker answered {status}"
    if kind == "tenant_limit":
        raise TenantThrottled(
            detail, retry_after_s=float(payload.get("retry_after") or 1.0),
            tenant=payload.get("tenant"),
        )
    if kind == "queue_full":
        raise QueueFullError(detail, retry_after_s=float(payload.get("retry_after") or 1.0))
    if kind == "deadline":
        raise DeadlineExceeded(detail)
    raise RuntimeError(f"control call failed ({status}): {detail}")


# --------------------------------------------------------------------- coordinator


class FleetCoordinator:
    """Host-0's routing/admission/scale brain over N host handles.

    Mirrors the engine surface (``submit`` / ``warmup`` / ``stats`` /
    ``health`` / ``load`` / ``scale_to`` / ``close``), so
    ``model.generation_batcher = coordinator`` gives the serving app a
    multi-host fleet with zero route changes — ``/metrics`` grows per-host
    sections, ``/healthz`` per-host scores, ``/debug/fleet`` the host census.

    Routing is the :class:`ReplicaScheduler` at host granularity: per
    submission every live host is probed (one concurrent control RPC each)
    for its token-weighted load, SLO breach flag, and its actual
    cached-prefix length for this prompt — the radix prefix tier made
    FLEET-GLOBAL, so turn 2 of a conversation lands on the host whose KV
    pool already holds turn 1. Dead hosts rank last and are skipped; a
    transport failure during routing marks the host dead and the walk
    continues on its siblings (degrade, don't shed).

    With host roles configured (``host_roles=`` or the
    ``UNIONML_TPU_HOST_ROLES`` export), prompts at least
    ``prefill_threshold`` tokens long prefill on a prefill-role host and
    their finished KV pages cross the control plane to a decode host
    (:func:`serialize_handoff`'s block-native wire format) — token-identical
    to a mixed fleet, with the transfer latency on ``stats()``."""

    def __init__(
        self,
        hosts: Sequence[Any],
        *,
        affinity_tokens: int = 0,
        affinity_margin: int = 2,
        prefill_threshold: Optional[int] = None,
        host_roles: Optional[Sequence[str]] = None,
        fleet_dir: "str | Path | None" = None,
        epoch: int = 0,
        probe_interval_s: Optional[float] = None,
        probation_probes: Optional[int] = None,
        dead_after: Optional[int] = None,
        lease_ttl_s: Optional[float] = None,
        fault_plan: "FaultPlan | ArmedFaultPlan | None" = None,
    ):
        if not hosts:
            raise ValueError("a fleet needs at least one host")
        self.hosts: "List[Any]" = list(hosts)
        if host_roles is not None:
            if len(host_roles) != len(self.hosts):
                raise ValueError(
                    f"host_roles covers {len(host_roles)} hosts but the fleet has {len(self.hosts)}"
                )
            for host, role in zip(self.hosts, host_roles):
                host.role = role
        else:
            env_roles = fleet_host_roles()
            if env_roles:
                expanded: "List[str]" = []
                for role in ("prefill", "decode", "mixed"):
                    expanded.extend([role] * env_roles.get(role, 0))
                if len(expanded) == len(self.hosts) and any(r == "prefill" for r in expanded) and not all(
                    r == "prefill" for r in expanded
                ):
                    for host, role in zip(self.hosts, expanded):
                        host.role = role
                else:
                    logger.warning(
                        f"ignoring UNIONML_TPU_HOST_ROLES={env_roles} over {len(self.hosts)} hosts; "
                        "falling back to a symmetric (all-mixed) host fleet"
                    )
        self._scheduler = ReplicaScheduler(
            len(self.hosts), affinity_tokens=affinity_tokens, affinity_margin=affinity_margin
        )
        if prefill_threshold is None:
            prefill_threshold = serve_prefill_threshold()
        self._prefill_threshold = int(prefill_threshold)
        self._lock = threading.Lock()
        #: fleet-level telemetry (the ReplicaSet counters, one level up)
        self.shed_deadline = 0
        self.shed_queue_full = 0
        self.host_failures = 0
        self.cross_host_handoffs = 0
        self._transfer_ms = LatencyWindow()
        #: fault-tolerance telemetry (stats()["fleet"])
        self.stream_retries = 0
        self.streams_interrupted = 0
        self.coordinator_failovers = 0
        self._recovery_ms = LatencyWindow()
        #: fencing epoch: every checkpoint/lease write carries it, and a
        #: higher epoch on disk means a successor exists — this coordinator
        #: is the zombie and its writes are refused
        self.epoch = int(epoch)
        self.fenced = False
        self.fleet_dir: "Optional[Path]" = (
            Path(fleet_dir).expanduser() if fleet_dir is not None else None
        )
        #: announce-epoch floor: rendezvous files stamped below it belong to
        #: a previous fleet generation and are ignored (hygiene satellite)
        self._announce_floor = 0
        self._probe_interval_s = (
            fleet_probe_interval_s() if probe_interval_s is None else float(probe_interval_s)
        )
        self._probation_probes = (
            fleet_probation_probes() if probation_probes is None else int(probation_probes)
        )
        self._dead_after = fleet_dead_after_probes() if dead_after is None else int(dead_after)
        self._lease_ttl_s = fleet_lease_ttl_s() if lease_ttl_s is None else float(lease_ttl_s)
        self._reconcile_stop = threading.Event()
        self._reconcile_thread: Optional[threading.Thread] = None
        self._faults: Optional[ArmedFaultPlan] = None
        if fault_plan is None:
            fault_plan = FaultPlan.from_env()
        if fault_plan is not None:
            self.arm_faults(fault_plan)

    # -------------------------------------------------------------- fault injection

    def arm_faults(self, plan: "FaultPlan | ArmedFaultPlan") -> ArmedFaultPlan:
        """Arm a deterministic fault plan (serving/faults.py) on this
        coordinator: virtual time starts NOW, and every RemoteHost handle
        consults the shared injector at its transport boundary."""
        armed = plan.arm() if isinstance(plan, FaultPlan) else plan
        self._faults = armed
        for host in self.hosts:
            if isinstance(host, RemoteHost):
                host.faults = armed
        logger.info(
            f"fault plan armed: {len(armed.plan.events)} events over "
            f"{armed.plan.horizon_s:.2f}s (seed {armed.plan.seed})"
        )
        return armed

    # ------------------------------------------------------------------ introspection

    @property
    def batchers(self) -> "Tuple[Any, ...]":
        """The host handles (the ``fleet_health`` duck-typing surface: each
        handle's ``health()`` is one 'replica' row at host granularity)."""
        return tuple(self.hosts)

    @property
    def replicas(self) -> int:
        """Live hosts (the coordinator's fleet-size headline; per-host engine
        replica counts ride ``stats()['hosts']``)."""
        return sum(1 for host in self.hosts if host.alive)

    @property
    def roles(self) -> "List[str]":
        return [host.role for host in self.hosts]

    def _live(self) -> "List[int]":
        return [i for i, host in enumerate(self.hosts) if host.alive]

    def _note_failure(self) -> None:
        with self._lock:
            self.host_failures += 1

    def _probe_all(
        self, indices: "List[int]", prompt: Optional[Sequence[int]]
    ) -> "Dict[int, Dict[str, Any]]":
        """Probe the named hosts concurrently (one control RPC each); a host
        that fails its probe is marked dead and omitted."""
        if len(indices) == 1:
            index = indices[0]
            try:
                return {index: self.hosts[index].probe(prompt)}
            except _DEAD_ERRORS:
                self._note_failure()
                return {}
        from concurrent.futures import ThreadPoolExecutor

        def one(index: int) -> "Tuple[int, Optional[Dict[str, Any]]]":
            try:
                return index, self.hosts[index].probe(prompt)
            except _DEAD_ERRORS:
                self._note_failure()
                return index, None

        with ThreadPoolExecutor(max_workers=len(indices)) as pool:
            results = list(pool.map(one, indices))
        return {index: probe for index, probe in results if probe is not None}

    # ------------------------------------------------------------------ submission

    def submit(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: Optional[int] = None,
        constraint: Optional[int] = None,
        deadline: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
    ) -> "Iterator[np.ndarray]":
        """Route a prompt to the best live host and return its token stream
        (the engine submit contract, one level up)."""
        if expired(deadline):
            with self._lock:
                self.shed_deadline += 1
            raise DeadlineExceeded("deadline expired before the prompt was routed to a host")
        live = self._live()
        if not live:
            raise RuntimeError(f"all {len(self.hosts)} fleet hosts are dead")
        probes = self._probe_all(live, prompt)
        if not probes:
            raise RuntimeError(f"all {len(self.hosts)} fleet hosts are dead")
        kwargs = dict(
            max_new_tokens=max_new_tokens, constraint=constraint, deadline=deadline,
            tenant=tenant, priority=priority,
        )
        if any(self.hosts[i].role == "prefill" for i in probes):
            stream = self._submit_disaggregated(probes, prompt, kwargs)
            if stream is not None:
                return stream
        return self._submit_routed(probes, prompt, kwargs)

    def _order(
        self, probes: "Dict[int, Dict[str, Any]]", prompt: Sequence[int],
        tenant: Optional[str] = None,
    ) -> "Tuple[List[int], Any]":
        """The scheduler's host order over the full (stable-index) host list;
        dead/unprobed hosts rank last via infinite load + avoid flags and are
        filtered from the returned walk. ``tenant`` arms HOST-level tenant
        session affinity: when no host's radix probe is warm for this prompt,
        the host that last served the tenant heads the walk (margin-gated) —
        its radix tier holds the tenant's recent sessions."""
        n = len(self.hosts)
        loads = [probes[i]["load"] if i in probes else math.inf for i in range(n)]
        cached = [probes[i]["cached"] if i in probes else 0 for i in range(n)]
        breaching = [probes[i]["breaching"] if i in probes else True for i in range(n)]
        deprioritized = [self.hosts[i].role == "prefill" for i in range(n)]
        order, affinity_head = self._scheduler.order(
            loads, prompt,
            cached if max(cached, default=0) > 0 else None,
            breaching,
            deprioritized if any(deprioritized) else None,
            tenant=tenant,
        )
        return [i for i in order if i in probes], affinity_head

    def _submit_routed(
        self,
        probes: "Dict[int, Dict[str, Any]]",
        prompt: Sequence[int],
        kwargs: Dict[str, Any],
    ) -> "Iterator[np.ndarray]":
        tenant = kwargs.get("tenant")
        if tenant is None:
            from unionml_tpu_torch.serving.tenancy import current_tenant

            tenant = current_tenant()
        order, affinity_head = self._order(probes, prompt, tenant)
        last_exc: Optional[BaseException] = None
        for index in order:
            try:
                stream = self.hosts[index].submit(prompt, **kwargs)
            except TenantThrottled:
                raise  # every host shares the tenant policy; the walk could only re-shed
            except QueueFullError as exc:
                last_exc = exc
                continue
            except _DEAD_ERRORS as exc:
                self._note_failure()
                last_exc = exc
                continue
            self._scheduler.note(
                index, prompt,
                affinity=affinity_head if index == order[0] else False,
                tenant=tenant,
            )
            return self._guard_stream(stream, index, prompt, kwargs)
        with self._lock:
            self.shed_queue_full += 1
        raise QueueFullError(
            f"all {len(order)} live hosts' queues are full"
        ) from last_exc

    def _guard_stream(
        self,
        stream: Any,
        index: int,
        prompt: Sequence[int],
        kwargs: Dict[str, Any],
    ) -> "Iterator[np.ndarray]":
        """The accepted-stream fault contract: a host that dies under a
        stream with ZERO tokens emitted costs one transparent retry on a
        sibling (the request never observably failed); a host that dies
        after tokens flowed terminates the stream with a clean 503-shaped
        :class:`StreamInterrupted` — the consumer learns NOW, instead of
        hanging on a dead socket or silently receiving a spliced stream with
        different sampling state."""
        emitted = 0
        retried = False
        recover_from: Optional[float] = None
        try:
            while True:
                try:
                    for chunk in stream:
                        if recover_from is not None:
                            self._recovery_ms.observe(time.monotonic() - recover_from)
                            recover_from = None
                        emitted += int(np.asarray(chunk).size)
                        yield chunk
                    return
                except (HostDied, *_DEAD_ERRORS) as exc:
                    self._note_failure()
                    failed_at = time.monotonic()
                    trace = _current_trace()
                    if trace is not None:
                        trace.event("engine.host_suspect", host=index, emitted=emitted)
                    if emitted > 0 or retried:
                        with self._lock:
                            self.streams_interrupted += 1
                        raise StreamInterrupted(
                            f"fleet host {index} failed after {emitted} emitted tokens: {exc}",
                            emitted=emitted,
                        ) from exc
                    retried = True
                    stream = self._retry_on_sibling(index, prompt, kwargs, exc)
                    recover_from = failed_at
                    index = getattr(stream, "_retry_host", index)
        finally:
            _close_quietly(stream)

    def _retry_on_sibling(
        self,
        failed_index: int,
        prompt: Sequence[int],
        kwargs: Dict[str, Any],
        cause: BaseException,
    ) -> Any:
        """Resubmit a zero-token stream on the best sibling host (once)."""
        live = [i for i in self._live() if i != failed_index]
        probes = self._probe_all(live, prompt) if live else {}
        if not probes:
            with self._lock:
                self.streams_interrupted += 1
            raise StreamInterrupted(
                f"fleet host {failed_index} died before the first token and no "
                "sibling is live",
                emitted=0,
            ) from cause
        order, _ = self._order(probes, prompt, kwargs.get("tenant"))
        last: Optional[BaseException] = None
        for sibling in order:
            try:
                stream = self.hosts[sibling].submit(prompt, **kwargs)
            except (QueueFullError, *_DEAD_ERRORS) as exc:
                last = exc
                continue
            with self._lock:
                self.stream_retries += 1
            trace = _current_trace()
            if trace is not None:
                trace.event("engine.stream_retry", host=sibling, failed_host=failed_index)
            self._scheduler.note(sibling, prompt, tenant=kwargs.get("tenant"))
            try:
                stream._retry_host = sibling
            except AttributeError:  # engine streams without a __dict__
                pass
            logger.info(
                f"stream retried on host {sibling} after host {failed_index} died "
                "with zero tokens emitted"
            )
            return stream
        with self._lock:
            self.streams_interrupted += 1
        raise StreamInterrupted(
            f"fleet host {failed_index} died before the first token and every "
            f"sibling refused the retry",
            emitted=0,
        ) from (last if last is not None else cause)

    # -------------------------------------------------------------- disaggregation

    def _submit_disaggregated(
        self,
        probes: "Dict[int, Dict[str, Any]]",
        prompt: Sequence[int],
        kwargs: Dict[str, Any],
    ) -> "Optional[Iterator[np.ndarray]]":
        """The cross-host prefill→decode path; None = not applicable (short
        prompt, no viable pair) — the caller falls back to the classic walk,
        so host disaggregation can only redirect work, never shed it."""
        prefills = [i for i in probes if self.hosts[i].role == "prefill"]
        targets = [i for i in probes if self.hosts[i].role == "decode"] or [
            i for i in probes if self.hosts[i].role == "mixed"
        ]
        if not prefills or not targets or len(prompt) < self._prefill_threshold:
            return None
        # warm multi-turn shortcut at host granularity: a decode host whose
        # radix tier already covers most of the prompt admits directly
        warm = max(targets, key=lambda i: (probes[i]["cached"], -probes[i]["load"]))
        cached = probes[warm]["cached"]
        if cached > 0 and len(prompt) - cached < max(self._prefill_threshold, (len(prompt) + 1) // 2):
            try:
                stream = self.hosts[warm].submit(prompt, **kwargs)
            except (QueueFullError, *_DEAD_ERRORS):
                pass
            else:
                self._scheduler.note(warm, prompt)
                return stream
        for p in sorted(prefills, key=lambda i: (probes[i]["load"], i)):
            try:
                pstream = self.hosts[p].submit(prompt, export=True, **kwargs)
            except (QueueFullError, *_DEAD_ERRORS) as exc:
                if isinstance(exc, _DEAD_ERRORS):
                    self._note_failure()
                continue
            self._scheduler.note(p, prompt)
            targets_ranked = sorted(targets, key=lambda i: (probes[i]["load"], i))
            return self._relay(pstream, targets_ranked)
        return None

    def _relay(self, pstream: Any, targets: "List[int]") -> "Iterator[np.ndarray]":
        """Stitch the prefill host's first-token stream and the decode host's
        resident stream into one consumer-facing iterator, shipping the
        block-native payload across the control plane in between."""
        active = pstream
        try:
            for item in pstream:
                yield item
            payload = getattr(pstream, "handoff", None)
            if payload is None:
                return  # finished outright at the prompt-sampled token
            started = time.monotonic()
            dstream = self._import_on(targets, payload)
            with self._lock:
                self.cross_host_handoffs += 1
            self._transfer_ms.observe(time.monotonic() - started)
            active = dstream
            for item in dstream:
                yield item
        finally:
            _close_quietly(active)

    def _import_on(self, targets: "List[int]", payload: Any) -> Any:
        last_exc: Optional[BaseException] = None
        for t in targets:
            try:
                return self.hosts[t].import_handoff(payload)
            except (QueueFullError, RuntimeError) as exc:
                last_exc = exc
                continue
            except _DEAD_ERRORS as exc:
                self._note_failure()
                last_exc = exc
                continue
        raise RuntimeError(
            f"no decode host of {len(targets)} could adopt the handed-off prefill"
        ) from last_exc

    # ------------------------------------------------------------- reconciliation

    def start_reconciler(self) -> None:
        """Start the background reconciliation loop: heartbeat the lease,
        watch the rendezvous dir for fresh (epoch-stamped) announces, re-probe
        suspect/dead hosts, and walk returning hosts through probation +
        warmup back to live. Idempotent; joined by :meth:`close`."""
        if self._reconcile_thread is not None:
            return
        self._reconcile_stop.clear()
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="unionml-tpu-fleet-reconcile"
        )
        self._reconcile_thread.start()

    def stop_reconciler(self) -> None:
        self._reconcile_stop.set()
        thread = self._reconcile_thread
        if thread is not None:
            thread.join(timeout=10.0)
            self._reconcile_thread = None

    def _reconcile_loop(self) -> None:
        while not self._reconcile_stop.wait(self._probe_interval_s):
            try:
                self.reconcile_once()
            except Exception:  # pragma: no cover - defensive
                logger.exception("fleet reconciliation tick failed")

    def reconcile_once(self) -> None:
        """One reconciliation tick (public so tests and single-shot callers
        can drive the state machine without the timer thread)."""
        self._heartbeat_lease()
        self._scan_announces()
        self._probe_unhealthy()

    def _heartbeat_lease(self) -> None:
        if self.fleet_dir is None:
            return
        ok = write_lease(
            self.fleet_dir, epoch=self.epoch, owner=0, ttl_s=self._lease_ttl_s
        )
        if not ok and not self.fenced:
            self.fenced = True
            logger.warning(
                f"coordinator epoch {self.epoch} is fenced: a successor holds a higher "
                "epoch; this coordinator's rendezvous writes are rejected"
            )

    def _scan_announces(self) -> None:
        """Bind returning workers: a rendezvous announce whose epoch clears
        the floor AND differs from what the handle is currently bound to is a
        restarted (or replacement) worker — rebind the handle into probation.
        Stale files from a previous fleet generation are ignored."""
        if self.fleet_dir is None or not self.fleet_dir.exists():
            return
        for path in sorted(self.fleet_dir.glob("host-*.json")):
            record = _read_json_file(path)
            if record is None:
                continue
            try:
                pid = int(record["process_id"])
                address = f"{record['host']}:{record['port']}"
                epoch = int(record.get("epoch", 0))
            except (KeyError, TypeError, ValueError):
                continue
            if epoch < self._announce_floor:
                continue  # a previous incarnation's leftovers
            host = next(
                (h for h in self.hosts if isinstance(h, RemoteHost) and h.host_id == pid),
                None,
            )
            if host is None or host.state == HOST_LIVE:
                continue
            candidate = (address, epoch, record.get("pid"))
            if host._bound_announce == candidate:
                continue  # the incarnation we already know (and failed) about
            host.rebind(address, epoch=epoch, role=record.get("role"))
            host._bound_announce = candidate

    def _probe_unhealthy(self) -> None:
        """Re-probe every non-live remote host: successes walk it through
        probation (then warmup, then live); failures demote suspect → dead
        after the configured streak. Never under a lock."""
        for host in self.hosts:
            if not isinstance(host, RemoteHost) or host.state == HOST_LIVE:
                continue
            try:
                host.ping(timeout=min(self._probe_interval_s * 4, CONTROL_TIMEOUT_S))
            except (_DEAD_ERRORS + (RuntimeError,)):
                host.note_probe_failure(self._dead_after)
                continue
            if not host.note_probe_success(self._probation_probes):
                continue
            try:
                # rejoin warmup: cheap when the worker preloads from the AOT
                # store; a failure here is just another failed probe
                host.warmup()
            except (_DEAD_ERRORS + (RuntimeError,)):
                host.note_probe_failure(self._dead_after)
                continue
            changed, down = host.go_live()
            if changed and down is not None:
                self._recovery_ms.observe(time.monotonic() - down)

    # ------------------------------------------------------------------ fleet ops

    def warmup(self) -> None:
        """Warm every live host concurrently (each host warms its own
        replicas in parallel below this)."""
        from concurrent.futures import ThreadPoolExecutor

        live = [self.hosts[i] for i in self._live()]
        with ThreadPoolExecutor(max_workers=max(len(live), 1)) as pool:
            list(pool.map(lambda host: host.warmup(), live))

    def load(self) -> float:
        total = 0.0
        for index in self._live():
            try:
                total += float(self.hosts[index].probe(None)["load"])
            except _DEAD_ERRORS:
                self._note_failure()
        return total

    def cached_prefix_tokens(self, prompt: Sequence[int]) -> int:
        """Fleet-global radix probe (a coordinator can itself be a host of a
        higher-level fleet)."""
        best = 0
        for index in self._live():
            try:
                best = max(best, int(self.hosts[index].probe(prompt)["cached"]))
            except _DEAD_ERRORS:
                self._note_failure()
        return best

    def occupancy(self) -> "Tuple[int, int]":
        resident = waiting = 0
        for index in self._live():
            try:
                r, w = self.hosts[index].occupancy()
            except _DEAD_ERRORS:
                self._note_failure()
                continue
            resident += r
            waiting += w
        return resident, waiting

    def scale_to(self, n: int, *, role: Optional[str] = None, timeout: float = 120.0) -> int:
        """Resize the FLEET to ``n`` total replicas, spread evenly over live
        hosts (stable order, remainder to the lowest host ids). Each host's
        own ``scale_to`` does the zero-loss work — warm-before-join on the
        way up, quiesce-drain-close on the way down."""
        live = self._live()
        if not live:
            raise RuntimeError("no live hosts to scale")
        if n < len(live):
            raise ValueError(
                f"a {len(live)}-host fleet cannot scale below one replica per host ({len(live)})"
            )
        base, rem = divmod(int(n), len(live))
        total = 0
        for position, index in enumerate(live):
            target = base + (1 if position < rem else 0)
            try:
                total += self.hosts[index].scale_to(target, role=role)
            except _DEAD_ERRORS:
                self._note_failure()
        return total

    def health(self) -> Dict[str, Any]:
        """Fleet health at host granularity — same shape as
        :func:`~unionml_tpu.observability.health.fleet_health` (which this
        delegates to through the ``batchers`` duck-typing), so ``/healthz``
        renders a multi-host fleet with per-host rows unchanged."""
        from unionml_tpu_torch.observability.health import fleet_health

        return fleet_health(self)

    def replica_loads(self) -> "List[Dict[str, Any]]":
        """Per-host occupancy rows for live gauges (`/debug/fleet`)."""
        out = []
        for index, host in enumerate(self.hosts):
            row: Dict[str, Any] = {
                "host": index, "role": host.role, "alive": host.alive,
                "address": host.address, "state": _host_state(host),
                "last_transition_s": _host_transition_s(host),
            }
            if host.alive:
                try:
                    resident, waiting = host.occupancy()
                    row.update({"resident": resident, "waiting": waiting})
                except _DEAD_ERRORS:
                    self._note_failure()
            out.append(row)
        return out

    def host_census(self) -> "List[Dict[str, Any]]":
        """The ``/debug/fleet`` host table: who is where, alive, what role,
        how many replicas."""
        return [
            {
                "host": index,
                "process_id": getattr(host, "host_id", index),
                "address": host.address,
                "role": host.role,
                "alive": host.alive,
                "state": _host_state(host),
                "last_transition_s": _host_transition_s(host),
                "replicas": host.replicas() if host.alive else 0,
            }
            for index, host in enumerate(self.hosts)
        ]

    def stats(self) -> Dict[str, Any]:
        """Fleet snapshot for ``/metrics``: per-host sections plus the
        cross-host aggregates and the coordinator's own routing/failure
        telemetry."""
        per_host: "List[Dict[str, Any]]" = []
        for index, host in enumerate(self.hosts):
            entry: Dict[str, Any] = {
                "host": index,
                "process_id": getattr(host, "host_id", index),
                "address": host.address,
                "role": host.role,
                "alive": host.alive,
                "state": _host_state(host),
                "last_transition_s": _host_transition_s(host),
            }
            if host.alive:
                try:
                    entry["stats"] = host.stats()
                except _DEAD_ERRORS:
                    self._note_failure()
                    entry["alive"] = False
                    entry["state"] = _host_state(host)
            per_host.append(entry)

        def total(key: str) -> int:
            return sum(
                int((entry.get("stats") or {}).get(key) or 0) for entry in per_host
            )

        states: Dict[str, int] = {
            HOST_LIVE: 0, HOST_SUSPECT: 0, HOST_DEAD: 0, HOST_PROBATION: 0
        }
        for entry in per_host:
            states[entry["state"]] = states.get(entry["state"], 0) + 1
        with self._lock:
            shed_deadline, shed_queue_full = self.shed_deadline, self.shed_queue_full
            host_failures = self.host_failures
            cross_host = self.cross_host_handoffs
            stream_retries = self.stream_retries
            streams_interrupted = self.streams_interrupted
            failovers = self.coordinator_failovers
        fleet: Dict[str, Any] = {
            "epoch": int(self.epoch),
            "fenced": int(self.fenced),
            "host_suspects": sum(int(getattr(h, "suspects", 0)) for h in self.hosts),
            "host_rejoins": sum(int(getattr(h, "rejoins", 0)) for h in self.hosts),
            "rpc_retries": sum(int(getattr(h, "rpc_retries", 0)) for h in self.hosts),
            "coordinator_failovers": failovers,
            "stream_retries": stream_retries,
            "streams_interrupted": streams_interrupted,
            "recovery_ms": self._recovery_ms.snapshot(),
            "states": states,
        }
        if self._faults is not None:
            fleet["faults_injected"] = self._faults.stats()
        return {
            "hosts": per_host,
            "live_hosts": sum(1 for entry in per_host if entry["alive"]),
            "replicas": total("replicas"),
            "scheduler": self._scheduler.stats(),
            "host_failures": host_failures,
            "handoffs_cross_host": cross_host,
            "handoff_transfer_ms": self._transfer_ms.snapshot(),
            "fleet": fleet,
            "slots": total("slots"),
            "resident": total("resident"),
            "waiting": total("waiting"),
            "decode_dispatches": total("decode_dispatches"),
            "decoded_rows": total("decoded_rows"),
            "shed_queue_full": shed_queue_full + total("shed_queue_full"),
            "shed_deadline": shed_deadline + total("shed_deadline"),
        }

    def close(self, wait: bool = True, timeout: float = 120.0,
              *, shutdown_workers: bool = False) -> None:
        """Drain every live host (``shutdown_workers=True`` also stops the
        worker processes' control loops — the CLI-owned fleet's exit path;
        test-owned workers are reaped by their spawner). The reconciliation
        thread is stopped and joined first."""
        self.stop_reconciler()
        for index in self._live():
            try:
                self.hosts[index].close(shutdown_worker=shutdown_workers)
            except _DEAD_ERRORS:
                self._note_failure()


# -------------------------------------------------------------------- fleet bootstrap


def connect_fleet(
    fleet_dir: "str | Path | None" = None,
    *,
    num_hosts: int,
    timeout_s: float = 120.0,
    local_engine: Any = None,
    local_process_id: int = 0,
    epoch: Optional[int] = None,
    announce_floor: Optional[int] = None,
    allow_missing: bool = False,
    start_reconciler: bool = True,
    **coordinator_kwargs: Any,
) -> FleetCoordinator:
    """Build a :class:`FleetCoordinator` from the rendezvous directory the
    workers announce into: poll until ``num_hosts`` announcements appear (a
    worker that never announces fails the connect loudly at ``timeout_s``),
    ping each worker, and return the coordinator with hosts in process-id
    order. ``local_engine`` substitutes a direct in-process handle for
    ``local_process_id`` (host 0 usually serves too — its submissions
    shouldn't pay an HTTP hop).

    Failover semantics: the new coordinator's fencing ``epoch`` is the
    persisted checkpoint's epoch plus one (or the explicit ``epoch``), a
    fenced checkpoint + heartbeat lease are written before returning, and
    announces stamped with an epoch BELOW the previous checkpoint's are
    ignored as a previous fleet generation's leftovers. ``allow_missing``
    (the promotion path) builds dead placeholder handles for hosts that
    never announced or failed their connect ping — the reconciliation loop
    (started unless ``start_reconciler=False``) readmits them if they
    return."""
    root = Path(fleet_dir if fleet_dir is not None else default_fleet_dir()).expanduser()
    previous = read_checkpoint(root)
    prev_epoch = int(previous.get("epoch", 0)) if previous else 0
    # a FRESH connect starts a new generation: only announces stamped from
    # the previous checkpoint onward count. A same-generation successor
    # (maybe_promote) passes the generation's original floor instead.
    floor = prev_epoch if announce_floor is None else int(announce_floor)
    my_epoch = (prev_epoch + 1) if epoch is None else int(epoch)
    deadline = time.monotonic() + timeout_s
    announcements: "Dict[int, Dict[str, Any]]" = {}
    while True:
        if root.exists():
            for path in sorted(root.glob("host-*.json")):
                try:
                    record = json.loads(path.read_text())
                except (OSError, ValueError):
                    continue  # half-written or vanished; next poll sees it
                if int(record.get("epoch", 0)) < floor:
                    continue  # stale: a previous fleet generation's announce
                announcements[int(record["process_id"])] = record
        needed = set(range(num_hosts))
        if local_engine is not None:
            needed.discard(local_process_id)
        if needed <= set(announcements):
            break
        if time.monotonic() >= deadline:
            if allow_missing and (announcements or local_engine is not None):
                break
            raise TimeoutError(
                f"fleet rendezvous timed out: {sorted(announcements)} of {num_hosts} "
                f"hosts announced in {root}"
            )
        time.sleep(0.05)
    hosts: "List[Any]" = []
    for process_id in range(num_hosts):
        if local_engine is not None and process_id == local_process_id:
            hosts.append(LocalHost(local_engine, host_id=process_id))
            continue
        record = announcements.get(process_id)
        if record is None:
            # allow_missing promotion path: a placeholder the reconciler can
            # readmit when (if) the host announces again
            host = RemoteHost("0.0.0.0:0", host_id=process_id)
            host.mark_dead(ConnectionError("never announced for this epoch"))
            hosts.append(host)
            continue
        host = RemoteHost(
            f"{record['host']}:{record['port']}",
            host_id=process_id,
            role=record.get("role", "mixed"),
            epoch=int(record.get("epoch", 0)),
        )
        host._bound_announce = (
            host.address, host.epoch, record.get("pid")
        )
        try:
            host.ping()  # fail the connect loudly rather than at first routing
        except _DEAD_ERRORS:
            if not allow_missing:
                raise
            host.mark_dead(ConnectionError("connect ping failed"))
        hosts.append(host)
    coordinator = FleetCoordinator(
        hosts, fleet_dir=root, epoch=my_epoch, **coordinator_kwargs
    )
    coordinator._announce_floor = floor
    roster = [
        {
            "host": index,
            "process_id": getattr(host, "host_id", index),
            "address": host.address,
            "role": host.role,
            "alive": host.alive,
        }
        for index, host in enumerate(hosts)
    ]
    failovers = int(previous.get("failovers", 0)) if previous else 0
    if not write_checkpoint(
        root, epoch=my_epoch, num_hosts=num_hosts, roster=roster,
        failovers=failovers, announce_floor=floor,
    ) or not write_lease(
        root, epoch=my_epoch, owner=local_process_id, ttl_s=coordinator._lease_ttl_s
    ):
        coordinator.fenced = True
        logger.warning(
            f"connect_fleet epoch {my_epoch} lost the fencing race: a higher-epoch "
            "coordinator already owns this rendezvous dir"
        )
    coordinator.coordinator_failovers = failovers
    if start_reconciler:
        coordinator.start_reconciler()
    return coordinator


def maybe_promote(
    fleet_dir: "str | Path | None" = None,
    *,
    local_engine: Any,
    local_process_id: int,
    num_hosts: Optional[int] = None,
    lease_grace_s: float = 0.0,
    timeout_s: float = 10.0,
    **coordinator_kwargs: Any,
) -> "Optional[FleetCoordinator]":
    """Coordinator failover: promote THIS worker if (and only if) the
    coordinator lease has expired and no lower-id live worker outranks it.

    Returns ``None`` while the lease is fresh or a better candidate exists;
    otherwise connects a new :class:`FleetCoordinator` over the surviving
    announces with the checkpoint epoch BUMPED — the fencing edge: the old
    coordinator's subsequent checkpoint/lease writes are rejected, and
    accepted-but-unfinished streams on surviving hosts are untouched (this is
    pure control-plane succession; no engine state moves)."""
    root = Path(fleet_dir if fleet_dir is not None else default_fleet_dir()).expanduser()
    lease = read_lease(root)
    if not lease_expired(lease, grace_s=lease_grace_s):
        return None
    checkpoint = read_checkpoint(root)
    if num_hosts is None:
        if checkpoint is None:
            return None  # nothing to succeed: no fleet ever checkpointed here
        num_hosts = int(checkpoint.get("num_hosts", 0))
    prev_epoch = int(checkpoint.get("epoch", 0)) if checkpoint else 0
    # the succession stays WITHIN the dead coordinator's fleet generation:
    # the generation's original announces (stamped at its formation floor)
    # remain valid for the successor
    floor = int(checkpoint.get("announce_floor", 0)) if checkpoint else 0
    # lowest-id-live-wins: a smaller-id worker with a current-generation
    # announce that still answers its ping has precedence — stand down for it
    for path in sorted(root.glob("host-*.json")):
        record = _read_json_file(path)
        if record is None:
            continue
        pid = int(record.get("process_id", -1))
        if not (0 <= pid < local_process_id) or int(record.get("epoch", 0)) < floor:
            continue
        probe = RemoteHost(f"{record['host']}:{record['port']}", host_id=pid)
        try:
            probe.ping(timeout=2.0)
        except _DEAD_ERRORS:
            continue
        return None
    coordinator = connect_fleet(
        root,
        num_hosts=int(num_hosts),
        timeout_s=timeout_s,
        local_engine=local_engine,
        local_process_id=int(local_process_id),
        epoch=prev_epoch + 1,
        announce_floor=floor,
        allow_missing=True,
        **coordinator_kwargs,
    )
    coordinator.coordinator_failovers += 1
    write_checkpoint(
        root,
        epoch=coordinator.epoch,
        num_hosts=int(num_hosts),
        roster=[
            {
                "host": index,
                "process_id": getattr(host, "host_id", index),
                "address": host.address,
                "role": host.role,
                "alive": host.alive,
            }
            for index, host in enumerate(coordinator.hosts)
        ],
        failovers=coordinator.coordinator_failovers,
        announce_floor=floor,
    )
    logger.warning(
        f"worker {local_process_id} promoted to fleet coordinator "
        f"(epoch {coordinator.epoch}, failover #{coordinator.coordinator_failovers})"
    )
    return coordinator


def _host_role(engine: Any) -> "Tuple[int, bool]":
    """``(host id, leads)`` of this rank's engine: over a mesh of several
    ranks the host is the replica's submesh (its index in the slice) and
    its first rank leads; a host of one rank is its process."""
    from unionml_tpu_torch import distributed

    batchers = list(getattr(engine, "batchers", None) or [engine])
    mesh = getattr(getattr(batchers[0], "gen", None), "mesh", None)
    if mesh is None or mesh.devices == 1:
        return distributed.process_index(), True
    return int(getattr(mesh, "slice_index", 0)), not batchers[0]._follower


def _follow_until_closed(engine: Any) -> None:
    """A follower rank's life after bootstrap: its engine threads replay the
    leader's plans until the leader's engine closes (or the leader's host
    dies and the plan group breaks), then the engine is closed here."""
    for batcher in list(getattr(engine, "batchers", None) or [engine]):
        thread = getattr(batcher, "_thread", None)
        while thread is not None and thread.is_alive():
            thread.join(timeout=1.0)
    engine.close(wait=True)


def run_worker(spec: Dict[str, Any]) -> None:
    """A worker process's whole life (the ``python -m
    unionml_tpu_torch.serving.cluster`` entrypoint body):

    1. join the process group the env names, over gloo
       (:func:`unionml_tpu_torch.distributed.maybe_initialize`; alone, a
       world of this process);
    2. AGREE on the fleet config: process 0's ``builder``/``kwargs`` are
       broadcast and every rank builds from the agreed copy;
    3. build the local engine (the builder returns a ContinuousBatcher or
       ReplicaSet; over a hybrid mesh each rank builds its own replica) and
       fence at a barrier so no host announces before the slowest finishes;
    4. exchange control ports, start the :class:`WorkerAgent` on each host's
       leader (as the spec's ``host_id`` where it names one: a replacement
       host's world numbers its own ranks), announce into the fleet dir, and
       serve until
       ``/ctrl/shutdown`` (or SIGTERM) arrives; a follower rank replays its
       leader's plans until the leader closes the engine.
    """
    from unionml_tpu_torch import distributed
    from unionml_tpu_torch.resolver import locate

    distributed.maybe_initialize("gloo")
    agreed = distributed.agree(
        {"builder": spec["builder"], "kwargs": spec.get("kwargs") or {}}
    )
    if agreed["builder"] != spec["builder"]:
        logger.warning(
            f"fleet config disagreement: host 0 builds {agreed['builder']!r}, this spec "
            f"names {spec['builder']!r}; building host 0's (the agreement wins)"
        )
    builder = locate(agreed["builder"])
    engine = builder(**agreed["kwargs"])
    distributed.barrier("unionml-tpu-fleet-build")
    host_id, leads = _host_role(engine)
    # a replacement host forms a world of its own ranks: the spec names the host it replaces
    host_id = int(spec.get("host_id", host_id))
    agent = None
    if leads:
        agent = WorkerAgent(
            engine,
            host=spec.get("control_host", "127.0.0.1"),
            role=spec.get("role", "mixed"),
            process_id=host_id,
        )
        agent.start()
    ports = distributed.allgather_ints(agent.port if agent is not None else 0)
    logger.info(f"fleet control ports by process: {ports}")
    if agent is None:
        _follow_until_closed(engine)
        return
    fleet_dir = spec.get("fleet_dir") or default_fleet_dir()
    agent.announce(fleet_dir)
    #: with watch_lease set, this worker is a failover STANDBY: when the
    #: coordinator's heartbeat lease expires, the lowest-id live worker
    #: promotes itself (fencing the old epoch) so the fleet's control
    #: metadata (checkpoint, lease, rendezvous hygiene) survives
    watch_lease = bool(spec.get("watch_lease"))
    promoted: "Optional[FleetCoordinator]" = None
    next_lease_check = time.monotonic() + fleet_lease_ttl_s()
    try:
        while not agent.shutdown_event.wait(0.2):
            if watch_lease and promoted is None and time.monotonic() >= next_lease_check:
                next_lease_check = time.monotonic() + fleet_lease_ttl_s()
                try:
                    promoted = maybe_promote(
                        fleet_dir,
                        local_engine=engine,
                        local_process_id=agent.process_id,
                    )
                except Exception:  # pragma: no cover - defensive
                    logger.exception("coordinator promotion attempt failed")
    finally:
        if promoted is not None:
            promoted.stop_reconciler()
        agent.close(close_engine=True)


def enable_serve_cluster(serving: Any, *, host: str = "127.0.0.1", port: int = 8000) -> None:
    """Run a :class:`~unionml_tpu_torch.serving.app.ServingApp` as one member
    of a multi-host fleet (the ``serve --num-hosts/--coordinator/--process-id``
    path; each process is a host of one rank). Process 0 is the front door:
    its ``model.generation_batcher`` is wrapped in a :class:`FleetCoordinator`
    (itself as the local host, every peer as a remote one) and the public
    HTTP server runs as usual, so ``/predict-stream``, ``/v1/*``,
    ``/metrics``, ``/healthz``, ``/debug/fleet`` and ``/debug/scale`` all
    operate on the whole fleet. Processes > 0 run only the control server:
    their engines take work from the coordinator, not from clients. The
    bootstrap runs over gloo (several processes may share one card)."""
    from unionml_tpu_torch import distributed

    distributed.maybe_initialize("gloo")
    me, num = distributed.process_index(), distributed.process_count()
    serving.startup()
    engine = getattr(serving.model, "generation_batcher", None)
    if engine is None:
        raise RuntimeError(
            "cluster serving needs a generation engine: set model.generation_batcher "
            "(e.g. the text-generation template's ContinuousBatcher/ReplicaSet) "
            "before serve starts"
        )
    fleet = default_fleet_dir()
    if me != 0:
        agent = WorkerAgent(engine, process_id=me)
        agent.start()
        ports = distributed.allgather_ints(agent.port)
        logger.info(f"fleet control ports by process: {ports}")
        agent.announce(fleet)
        try:
            while not agent.shutdown_event.wait(0.2):
                pass
        finally:
            agent.close(close_engine=True)
        return
    # process 0: rendezvous with every worker, then serve the front door
    distributed.allgather_ints(0)  # pair the workers' port exchange
    coordinator = connect_fleet(
        fleet, num_hosts=num, local_engine=engine, local_process_id=0
    )
    serving.model.generation_batcher = coordinator
    serving.run(host=host, port=port)


def main(argv: "Optional[List[str]]" = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m unionml_tpu_torch.serving.cluster",
        description="run one multi-host serving fleet worker from a spec file",
    )
    parser.add_argument("spec", help="path to the worker spec JSON (builder, kwargs, fleet_dir, role)")
    args = parser.parse_args(argv)
    run_worker(json.loads(Path(args.spec).read_text()))


if __name__ == "__main__":
    main()
