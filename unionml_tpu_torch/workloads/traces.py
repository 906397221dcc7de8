"""Traffic traces: the versioned ndjson request record, its reader and writer,
and the live-capture tap, copied from ``unionml_tpu/workloads/traces.py``.

A **trace** is a recorded request mix — arrival offsets, tenants,
priorities, routes, prompts, budgets, deadlines — one JSON object a line
(ndjson). Line 1 is the header ``{"trace_version": 1, "kind":
"unionml-tpu-traffic-trace", "meta": {...}}``; every later line is one
:class:`TraceRequest`. Serialization is canonical (sorted keys, compact
separators, offsets rounded to microseconds), so a file written here is byte
for byte what the JAX package writes for the same requests, and reads back
in either package's replayer (:func:`dumps_trace`/:func:`write_trace`,
:func:`loads_trace`/:func:`read_trace`).

:class:`TraceRecorder` is the capture side: the serving app installs one
process-wide from ``UNIONML_TPU_RECORD_TRAFFIC``, and the request-parsing
layers (``/v1/*`` in serving/openai_api.py, ``/predict-stream`` in
serving/app.py) tap it with the parsed request AFTER validation.
``hash_prompts=True`` records a SHA-256 digest and the token length instead
of the prompt ids; the replayer (workloads/replayer.py) then regenerates
deterministic same-length prompts from the digest.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from unionml_tpu_torch._logging import logger

__all__ = [
    "TRACE_KIND",
    "TRACE_VERSION",
    "TraceRecorder",
    "TraceRequest",
    "active_traffic_recorder",
    "dumps_trace",
    "hash_prompt",
    "loads_trace",
    "read_trace",
    "set_active_traffic_recorder",
    "write_trace",
]

TRACE_VERSION = 1
TRACE_KIND = "unionml-tpu-traffic-trace"

#: routes a trace line may carry — the serving surfaces the replayer can drive
ROUTES = ("/v1/completions", "/v1/chat/completions", "/predict-stream")


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request of a traffic trace.

    ``t`` is the arrival offset in seconds from trace start. ``prompt`` holds
    token ids; a hashed capture drops it and keeps ``prompt_len`` +
    ``prompt_sha256`` instead (the replayer synthesizes a deterministic
    same-length prompt from the digest). ``session``/``turn`` link multi-turn
    conversations: for ``turn > 0`` the ``prompt`` is only the NEW turn's
    tokens — the replayer prepends the session's accumulated history (prior
    prompts + completions). ``body`` carries a
    raw JSON body for ``/predict-stream`` replays of recorded non-token
    traffic."""

    t: float
    route: str = "/v1/completions"
    prompt: Optional[Tuple[int, ...]] = None
    prompt_len: Optional[int] = None
    prompt_sha256: Optional[str] = None
    max_tokens: int = 16
    stream: bool = True
    tenant: Optional[str] = None
    priority: Optional[str] = None
    deadline_ms: Optional[float] = None
    session: Optional[str] = None
    turn: Optional[int] = None
    body: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if self.t < 0:
            raise ValueError("arrival offset t must be >= 0")
        if self.route not in ROUTES:
            raise ValueError(f"unknown trace route {self.route!r}; expected one of {ROUTES}")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.prompt is None and self.prompt_len is None and self.body is None:
            raise ValueError("a trace request needs a prompt, a prompt_len (hashed), or a raw body")
        if self.turn is not None and self.session is None:
            raise ValueError("a turn index needs a session id")

    def effective_prompt_len(self) -> int:
        """Token length of this request's own prompt contribution."""
        if self.prompt is not None:
            return len(self.prompt)
        return int(self.prompt_len or 0)

    def to_line(self) -> "Dict[str, Any]":
        """The canonical wire dict — ``None`` fields omitted, offsets rounded,
        key order left to the canonical dumper (sorted)."""
        out: "Dict[str, Any]" = {
            "t": round(float(self.t), 6),
            "route": self.route,
            "max_tokens": int(self.max_tokens),
            "stream": bool(self.stream),
        }
        if self.prompt is not None:
            out["prompt"] = [int(tok) for tok in self.prompt]
        if self.prompt_len is not None:
            out["prompt_len"] = int(self.prompt_len)
        if self.prompt_sha256 is not None:
            out["prompt_sha256"] = self.prompt_sha256
        for name in ("tenant", "priority", "session"):
            value = getattr(self, name)
            if value is not None:
                out[name] = str(value)
        if self.deadline_ms is not None:
            out["deadline_ms"] = round(float(self.deadline_ms), 3)
        if self.turn is not None:
            out["turn"] = int(self.turn)
        if self.body is not None:
            out["body"] = self.body
        return out

    @classmethod
    def from_line(cls, line: "Dict[str, Any]") -> "TraceRequest":
        prompt = line.get("prompt")
        return cls(
            t=float(line["t"]),
            route=str(line.get("route", "/v1/completions")),
            prompt=tuple(int(tok) for tok in prompt) if prompt is not None else None,
            prompt_len=line.get("prompt_len"),
            prompt_sha256=line.get("prompt_sha256"),
            max_tokens=int(line.get("max_tokens", 16)),
            stream=bool(line.get("stream", True)),
            tenant=line.get("tenant"),
            priority=line.get("priority"),
            deadline_ms=line.get("deadline_ms"),
            session=line.get("session"),
            turn=line.get("turn"),
            body=line.get("body"),
        )


def _canonical(obj: "Dict[str, Any]") -> str:
    """Canonical JSON: sorted keys, compact separators — the byte-identity
    contract (same spec + seed => identical trace bytes) rests on this."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _header(meta: "Optional[Dict[str, Any]]") -> "Dict[str, Any]":
    return {"trace_version": TRACE_VERSION, "kind": TRACE_KIND, "meta": meta or {}}


def dumps_trace(requests: "Iterable[TraceRequest]", meta: "Optional[Dict[str, Any]]" = None) -> str:
    """Render a whole trace as canonical ndjson text (header + one line per
    request, arrival order). The file format :func:`write_trace` persists."""
    ordered = sorted(requests, key=lambda r: (r.t, r.session or "", r.turn or 0))
    lines = [_canonical(_header(meta))]
    lines.extend(_canonical(request.to_line()) for request in ordered)
    return "\n".join(lines) + "\n"


def write_trace(
    path: str, requests: "Iterable[TraceRequest]", meta: "Optional[Dict[str, Any]]" = None
) -> str:
    """Write a trace file (atomic tmp+rename — a torn trace is worse than no
    trace); returns the path."""
    text = dumps_trace(requests, meta)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as handle:
        handle.write(text)
    os.replace(tmp, path)
    return path


def loads_trace(text: str) -> "Tuple[Dict[str, Any], List[TraceRequest]]":
    """Parse trace text: ``(meta, requests)``. Rejects missing/foreign headers
    and unknown versions — a replay against a misread trace would judge the
    server on traffic it was never sent."""
    lines = [line for line in text.splitlines() if line.strip()]
    if not lines:
        raise ValueError("empty trace: expected an ndjson header line")
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError as exc:
        raise ValueError(f"trace header is not valid JSON: {exc}")
    if not isinstance(header, dict) or header.get("kind") != TRACE_KIND:
        raise ValueError(
            f"not a {TRACE_KIND} file (header {str(lines[0])[:80]!r}); "
            "traces start with a kind/version header line"
        )
    version = header.get("trace_version")
    if version != TRACE_VERSION:
        raise ValueError(
            f"unsupported trace_version {version!r}; this reader understands version "
            f"{TRACE_VERSION} — re-synthesize the trace or upgrade the package"
        )
    requests = [TraceRequest.from_line(json.loads(line)) for line in lines[1:]]
    return header.get("meta") or {}, requests


def read_trace(path: str) -> "Tuple[Dict[str, Any], List[TraceRequest]]":
    with open(path) as handle:
        return loads_trace(handle.read())


def hash_prompt(prompt: "Iterable[int]") -> str:
    """The privacy digest a hashed capture records instead of token ids."""
    digest = hashlib.sha256()
    digest.update(" ".join(str(int(tok)) for tok in prompt).encode())
    return digest.hexdigest()


class TraceRecorder:
    """Capture live traffic into a replayable trace file.

    One recorder per serving process (``serve --record-traffic DIR`` installs
    it process-wide, the flight-recorder pattern); the request-parsing layers
    call :meth:`record` with the PARSED request — arrival offsets come from
    the recorder's own monotonic clock, so the captured inter-arrival law is
    the one the server actually experienced. Thread-safe; every line is
    flushed as written, so a crash loses at most the in-progress line. With
    ``hash_prompts`` the token ids never reach disk — only their SHA-256 and
    length."""

    def __init__(
        self,
        directory: str,
        *,
        hash_prompts: bool = False,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.directory = str(directory)
        self.hash_prompts = bool(hash_prompts)
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._handle: Optional[Any] = None
        self._path: Optional[str] = None
        self.recorded = 0
        self.dropped = 0
        os.makedirs(self.directory, exist_ok=True)

    @property
    def path(self) -> Optional[str]:
        """The trace file this recorder writes (None until the first record)."""
        with self._lock:
            return self._path

    def _open_locked(self) -> None:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self._path = os.path.join(self.directory, f"traffic-{stamp}-{os.getpid()}.ndjson")
        self._handle = open(self._path, "w")
        self._handle.write(
            _canonical(
                _header({"captured": True, "hashed_prompts": self.hash_prompts})
            )
            + "\n"
        )
        self._t0 = self._clock()

    def record(
        self,
        route: str,
        *,
        prompt: "Optional[Iterable[int]]" = None,
        max_tokens: int = 16,
        stream: bool = True,
        tenant: Optional[str] = None,
        priority: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        session: Optional[str] = None,
        turn: Optional[int] = None,
        body: "Optional[Dict[str, Any]]" = None,
    ) -> None:
        """Append one request. Never raises into the serving path: a capture
        failure (full disk, closed recorder) is counted and logged once, and
        the request it was observing is served normally."""
        try:
            ids = tuple(int(tok) for tok in prompt) if prompt is not None else None
            request = TraceRequest(
                t=0.0,  # placeholder; the real offset is stamped under the lock
                route=route,
                prompt=None if (ids is not None and self.hash_prompts) else ids,
                prompt_len=len(ids) if (ids is not None and self.hash_prompts) else None,
                prompt_sha256=hash_prompt(ids) if (ids is not None and self.hash_prompts) else None,
                max_tokens=max_tokens,
                stream=stream,
                tenant=tenant,
                priority=priority,
                deadline_ms=deadline_ms,
                session=session,
                turn=turn,
                body=body,
            )
            with self._lock:
                if self._handle is None:
                    self._open_locked()
                line = request.to_line()
                line["t"] = round(max(self._clock() - self._t0, 0.0), 6)
                self._handle.write(_canonical(line) + "\n")
                self._handle.flush()
                self.recorded += 1
        except Exception as exc:
            with self._lock:
                self.dropped += 1
                first = self.dropped == 1
            if first:
                logger.warning(f"traffic recorder dropped a request ({exc}); capture continues")

    def stats(self) -> "Dict[str, int]":
        """Bounded capture counters for ``/metrics`` (ints only, never None)."""
        with self._lock:
            return {"recorded": self.recorded, "dropped": self.dropped}

    def close(self) -> Optional[str]:
        """Flush and close the capture file; returns its path (None if nothing
        was ever recorded). Idempotent."""
        with self._lock:
            if self._handle is not None:
                try:
                    self._handle.close()
                finally:
                    self._handle = None
            return self._path


#: the process-wide recorder (the observability.recorder active pattern):
#: installed by the serving app from the serve --record-traffic export, tapped
#: by the request-parsing layers without construction wiring. None = off.
_active: "Optional[TraceRecorder]" = None
_active_lock = threading.Lock()


def set_active_traffic_recorder(recorder: "Optional[TraceRecorder]") -> None:
    global _active
    with _active_lock:
        _active = recorder


def active_traffic_recorder() -> "Optional[TraceRecorder]":
    with _active_lock:
        return _active
