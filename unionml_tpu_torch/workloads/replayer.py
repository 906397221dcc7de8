"""The traffic replayer: arrival-time-faithful playback through the real HTTP stack.

A copy of ``unionml_tpu/workloads/replayer.py`` over the port's
:class:`~unionml_tpu_torch.serving.ServingApp`: the same records, report and
verdicts, so a replay of either package reads the same.

A benchmark that drives the ENGINE API from a hand-rolled closed loop is
realistic about device work, silent about everything the front
door does (header parsing, tenancy resolution, deadline propagation, sheds,
SSE framing, per-route metrics). The replayer closes that gap: it takes a
trace (recorded or synthesized, workloads/traces.py) and plays it **open
loop** — each request is launched at its recorded arrival offset whether or
not earlier ones finished, which is how real traffic behaves and exactly what
closed loops cannot express — against either

- a **self-hosted** :class:`~unionml_tpu_torch.serving.ServingApp` (in-process
  dispatch through ``server.dispatch_with_headers``, the same surface every
  serving test drives: the full HTTP handler stack minus the socket), or
- a live ``--target http://host:port`` server over real sockets.

Fidelity is measured, not assumed: every request records its **schedule lag**
(actual launch minus planned arrival — for session-linked turns, planned is
``max(arrival, previous turn's completion)``, since a conversation cannot
send turn 3 before turn 2 answered), and the report's ``schedule.adherence``
is the fraction launched within ``grace_s``. A replay that fell behind its
own trace is judging the client harness, not the server — a benchmark
should gate on adherence ≥ 0.95 before believing anything else.

Collected per request: TTFT (submit → first content chunk), TBT (inter-chunk
gaps), end-to-end latency, HTTP status, shed class (429/503 + Retry-After).
Aggregated per tenant and overall, then judged: with per-tenant targets the
report carries a verdict block (workloads/verdicts.py) — observed vs target,
burn rates, pass/warn/breach — so a replay run is a judgment, not just
numbers. Multi-turn sessions accumulate history (prompt + parsed completion
ids) and re-send it on the next turn, which is what makes ``chat_multiturn``
exercise the radix cache's decode-side insertion like real chat traffic.

Library surface: :func:`replay` (sync, owns its event loop) and
:func:`replay_async`; CLI surface: ``python -m unionml_tpu_torch.cli replay``
(cli.py).
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.workloads.traces import TraceRequest
from unionml_tpu_torch.workloads.verdicts import availability, overall_state, tenant_verdicts

__all__ = ["replay", "replay_async"]

#: tenant key for requests that carried no tenant identity
ANONYMOUS = "anonymous"

#: vocab for prompts regenerated from hashed captures (shape-preserving, not
#: content-preserving — documented in docs/workloads.md)
_HASHED_VOCAB = 90


def _percentile(ordered: "List[float]", q: float) -> float:
    rank = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
    return ordered[rank]


def _window(samples: "List[float]") -> "Dict[str, Any]":
    """A latency summary in ms ({"n": 0} when empty — never a None gauge)."""
    if not samples:
        return {"n": 0}
    ordered = sorted(s * 1e3 for s in samples)
    return {
        "n": len(ordered),
        "mean_ms": round(sum(ordered) / len(ordered), 3),
        "p50_ms": round(_percentile(ordered, 0.50), 3),
        "p95_ms": round(_percentile(ordered, 0.95), 3),
        "p99_ms": round(_percentile(ordered, 0.99), 3),
        "max_ms": round(ordered[-1], 3),
    }


def _materialize_prompt(request: TraceRequest) -> "List[int]":
    """The request's own prompt tokens: literal ids, or a deterministic
    same-length regeneration from a hashed capture's digest."""
    if request.prompt is not None:
        return [int(tok) for tok in request.prompt]
    length = int(request.prompt_len or 1)
    seed = int((request.prompt_sha256 or "0")[:8] or "0", 16)
    rng = random.Random(seed)
    return [1 + rng.randrange(_HASHED_VOCAB - 1) for _ in range(max(length, 1))]


def _parse_token_text(text: str) -> "Optional[List[int]]":
    """Completion text back to token ids when the server used the documented
    no-tokenizer fallback (space-joined ids); None for real text."""
    ids = []
    for piece in text.split():
        if not (piece.isdigit() or (piece.startswith("-") and piece[1:].isdigit())):
            return None
        ids.append(int(piece))
    return ids


class _Record:
    """One replayed request's outcome (plain attrs; rendered into the report)."""

    __slots__ = (
        "tenant", "status", "shed", "error", "lag_s", "start_s", "ttft_s",
        "tbt_s", "e2e_s", "tokens", "retry_after",
    )

    def __init__(self, tenant: Optional[str]):
        self.tenant = tenant or ANONYMOUS
        self.status: Optional[int] = None
        self.shed = False
        self.error = False
        self.lag_s = 0.0
        #: actual launch offset from replay t0 (the availability section's
        #: time base — fault plans are keyed on the same virtual clock)
        self.start_s = 0.0
        self.ttft_s: Optional[float] = None
        self.tbt_s: "List[float]" = []
        self.e2e_s: Optional[float] = None
        self.tokens = 0
        self.retry_after: Optional[float] = None


async def _drive_self_hosted(
    app: Any, request: TraceRequest, prompt: "List[int]", record: _Record
) -> "List[int]":
    """One request through the in-process HTTP stack; returns the completion
    token ids (empty when unparseable) for session-history accumulation."""
    headers: "Dict[str, str]" = {}
    if request.tenant:
        headers["x-tenant-id"] = request.tenant
    if request.priority:
        headers["x-priority"] = request.priority
    if request.deadline_ms is not None:
        headers["x-request-deadline-ms"] = str(request.deadline_ms)
    if request.route == "/predict-stream":
        body = json.dumps(request.body or {"features": prompt}).encode()
    else:
        payload: "Dict[str, Any]" = {"max_tokens": request.max_tokens, "stream": request.stream}
        if request.route == "/v1/chat/completions":
            payload["messages"] = [{"role": "user", "content": " ".join(str(t) for t in prompt)}]
        else:
            payload["prompt"] = prompt
        body = json.dumps(payload).encode()
    start = time.monotonic()
    status, payload_out, _ct, extra = await app.server.dispatch_with_headers(
        "POST", request.route, body, headers
    )
    record.status = int(status)
    if status in (429, 503):
        record.shed = True
        try:
            record.retry_after = float(extra.get("Retry-After", "") or 0.0)
        except ValueError:
            record.retry_after = None
        record.e2e_s = time.monotonic() - start
        return []
    if status != 200:
        record.error = True
        record.e2e_s = time.monotonic() - start
        return []
    completion: "List[int]" = []
    if hasattr(payload_out, "__aiter__"):
        last = start
        usage_tokens: Optional[int] = None
        try:
            async for chunk in payload_out:
                now = time.monotonic()
                data = chunk if isinstance(chunk, bytes) else str(chunk).encode()
                text, usage = _sse_content(data, chat=request.route.endswith("chat/completions"))
                if usage is not None:
                    usage_tokens = usage
                if text is None and request.route == "/predict-stream":
                    text = data.decode(errors="replace")
                if not text:
                    continue  # SSE role opener / [DONE] / empty delta
                if record.ttft_s is None:
                    record.ttft_s = now - start
                else:
                    record.tbt_s.append(now - last)
                last = now
                ids = _parse_token_text(text)
                if ids is not None:
                    completion.extend(ids)
                    record.tokens += len(ids)
                else:
                    record.tokens += 1  # real text: count chunks, not tokens
        finally:
            closer = getattr(payload_out, "aclose", None)
            if closer is not None:
                try:
                    await closer()
                except Exception:  # pragma: no cover - defensive
                    pass
        if usage_tokens is not None:
            record.tokens = usage_tokens
    else:
        # non-streaming completion: one JSON payload, TTFT == e2e
        record.ttft_s = time.monotonic() - start
        usage = payload_out.get("usage") if isinstance(payload_out, dict) else None
        if isinstance(usage, dict):
            record.tokens = int(usage.get("completion_tokens", 0))
        choice = (payload_out.get("choices") or [{}])[0] if isinstance(payload_out, dict) else {}
        text = choice.get("text") or (choice.get("message") or {}).get("content") or ""
        ids = _parse_token_text(text) if text else None
        if ids is not None:
            completion.extend(ids)
    record.e2e_s = time.monotonic() - start
    return completion


def _sse_content(data: bytes, *, chat: bool) -> "Tuple[Optional[str], Optional[int]]":
    """(content text, usage completion_tokens) from one SSE chunk; (None,
    None) for non-SSE payloads, openers, and [DONE]."""
    if not data.startswith(b"data: "):
        return None, None
    body = data[6:].strip()
    if body == b"[DONE]":
        return None, None
    try:
        event = json.loads(body)
    except ValueError:
        return None, None
    usage = event.get("usage")
    tokens = int(usage["completion_tokens"]) if isinstance(usage, dict) else None
    choice = (event.get("choices") or [{}])[0]
    if chat:
        return (choice.get("delta") or {}).get("content"), tokens
    return choice.get("text"), tokens


def _drive_target_sync(
    target: str, request: TraceRequest, prompt: "List[int]", record: _Record
) -> "List[int]":
    """One request over a real socket (the ``--target URL`` mode); runs in a
    worker thread — timings use the same monotonic clock."""
    import http.client
    import urllib.parse

    parsed = urllib.parse.urlsplit(target)
    headers = {"Content-Type": "application/json"}
    if request.tenant:
        headers["X-Tenant-Id"] = request.tenant
    if request.priority:
        headers["X-Priority"] = request.priority
    if request.deadline_ms is not None:
        headers["X-Request-Deadline-Ms"] = str(request.deadline_ms)
    if request.route == "/predict-stream":
        body = json.dumps(request.body or {"features": prompt}).encode()
    else:
        payload: "Dict[str, Any]" = {"max_tokens": request.max_tokens, "stream": request.stream}
        if request.route == "/v1/chat/completions":
            payload["messages"] = [{"role": "user", "content": " ".join(str(t) for t in prompt)}]
        else:
            payload["prompt"] = prompt
        body = json.dumps(payload).encode()
    completion: "List[int]" = []
    start = time.monotonic()
    # connect only once the request is fully built: everything from here to
    # the `finally` that closes it is exception-safe
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port or 80, timeout=120.0)
    try:
        conn.request("POST", request.route, body, headers)
        resp = conn.getresponse()
        record.status = resp.status
        if resp.status in (429, 503):
            record.shed = True
            retry = resp.getheader("Retry-After")
            record.retry_after = float(retry) if retry else None
            resp.read()
            return completion
        if resp.status != 200:
            record.error = True
            resp.read()
            return completion
        last = start
        usage_tokens: Optional[int] = None
        buffer = b""
        while True:
            piece = resp.read1(65536) if hasattr(resp, "read1") else resp.read(65536)
            if not piece:
                break
            now = time.monotonic()
            buffer += piece
            while b"\n" in buffer:
                line, buffer = buffer.split(b"\n", 1)
                text, usage = _sse_content(line + b"\n", chat=request.route.endswith("chat/completions"))
                if usage is not None:
                    usage_tokens = usage
                if text is None and request.route == "/predict-stream" and line.strip():
                    text = line.decode(errors="replace")
                if not text:
                    continue
                if record.ttft_s is None:
                    record.ttft_s = now - start
                else:
                    record.tbt_s.append(now - last)
                last = now
                ids = _parse_token_text(text)
                if ids is not None:
                    completion.extend(ids)
                    record.tokens += len(ids)
                else:
                    record.tokens += 1
        if usage_tokens is not None:
            record.tokens = usage_tokens
    except OSError as exc:
        record.error = True
        logger.warning(f"replay request failed against {target}: {exc}")
    finally:
        record.e2e_s = time.monotonic() - start
        try:
            conn.close()
        except Exception:  # pragma: no cover - defensive
            pass
    return completion


class _Session:
    """One conversation's replay state: accumulated history and the gate the
    next turn waits behind (turn n+1 cannot launch before turn n answered)."""

    __slots__ = ("history", "done_at", "gate")

    def __init__(self) -> None:
        self.history: "List[int]" = []
        self.done_at = 0.0
        self.gate = asyncio.Lock()


async def replay_async(
    requests: "Sequence[TraceRequest]",
    *,
    app: Any = None,
    target: Optional[str] = None,
    concurrency: int = 32,
    rate_scale: float = 1.0,
    grace_s: float = 0.25,
    targets: "Optional[Dict[str, Dict[str, float]]]" = None,
    meta: "Optional[Dict[str, Any]]" = None,
    fault_times_s: "Optional[Sequence[float]]" = None,
) -> "Dict[str, Any]":
    """Replay ``requests`` open-loop and return the report dict. Exactly one
    of ``app`` (a started ServingApp — in-process HTTP dispatch) or ``target``
    (a base URL) must be given. ``rate_scale`` compresses (>1) or stretches
    (<1) the arrival schedule; ``concurrency`` bounds in-flight requests (a
    safety valve — hitting it shows up as schedule lag, not silence);
    ``targets`` adds the per-tenant verdict block. ``fault_times_s`` (a
    chaos run's fault onsets, on the replay's own virtual clock — arm the
    FaultPlan when the replay starts) adds the ``availability`` section:
    success ratio, clean-error ratio, and per-fault
    recovery-to-first-routed-token (workloads/verdicts.py)."""
    if (app is None) == (target is None):
        raise ValueError("pass exactly one of app= (self-hosted) or target= (URL)")
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    if rate_scale <= 0:
        raise ValueError("rate_scale must be > 0")
    loop = asyncio.get_running_loop()
    executor = None
    if target is not None:
        from concurrent.futures import ThreadPoolExecutor

        # a dedicated pool sized to the concurrency cap: the default executor
        # is shared with the server's own stream-advancing work in self-host
        # setups, and a starved pool would read as schedule slip
        executor = ThreadPoolExecutor(max_workers=concurrency)
    semaphore = asyncio.Semaphore(concurrency)
    sessions: "Dict[str, _Session]" = {}
    for request in requests:
        if request.session is not None:
            sessions.setdefault(request.session, _Session())
    records: "List[_Record]" = []
    t0 = time.monotonic()

    async def one(request: TraceRequest) -> None:
        planned = request.t / rate_scale
        delay = planned - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        record = _Record(request.tenant)
        session = sessions.get(request.session) if request.session is not None else None
        records.append(record)
        if session is not None:
            # the session gate serializes turns; planned time for adherence is
            # the LATER of the arrival offset and the prior turn's completion
            await session.gate.acquire()
        try:
            effective_planned = planned
            if session is not None:
                effective_planned = max(planned, session.done_at)
            async with semaphore:
                record.start_s = time.monotonic() - t0
                record.lag_s = max(record.start_s - effective_planned, 0.0)
                prompt = _materialize_prompt(request)
                if session is not None and request.turn:
                    prompt = list(session.history) + prompt
                if app is not None:
                    completion = await _drive_self_hosted(app, request, prompt, record)
                else:
                    completion = await loop.run_in_executor(
                        executor, _drive_target_sync, target, request, prompt, record
                    )
                if session is not None:
                    if record.status == 200:
                        session.history = prompt + completion
                    session.done_at = time.monotonic() - t0
        finally:
            if session is not None:
                session.gate.release()

    try:
        await asyncio.gather(*(one(request) for request in requests))
    finally:
        if executor is not None:
            executor.shutdown(wait=False)
    wall = time.monotonic() - t0
    return _report(
        records, wall, grace_s=grace_s, rate_scale=rate_scale, targets=targets,
        meta=meta, fault_times_s=fault_times_s,
    )


def _report(
    records: "List[_Record]",
    wall_s: float,
    *,
    grace_s: float,
    rate_scale: float,
    targets: "Optional[Dict[str, Dict[str, float]]]",
    meta: "Optional[Dict[str, Any]]",
    fault_times_s: "Optional[Sequence[float]]" = None,
) -> "Dict[str, Any]":
    per_tenant: "Dict[str, Dict[str, Any]]" = {}
    by_tenant: "Dict[str, List[_Record]]" = {}
    for record in records:
        by_tenant.setdefault(record.tenant, []).append(record)
    for tenant, rows in sorted(by_tenant.items()):
        sheds = sum(1 for r in rows if r.shed)
        per_tenant[tenant] = {
            "requests": len(rows),
            "ok": sum(1 for r in rows if r.status == 200),
            "shed": sheds,
            "errors": sum(1 for r in rows if r.error),
            "shed_ratio": round(sheds / len(rows), 4) if rows else 0.0,
            "tokens": sum(r.tokens for r in rows),
            "ttft_ms": _window([r.ttft_s for r in rows if r.ttft_s is not None]),
            "tbt_ms": _window([gap for r in rows for gap in r.tbt_s]),
            "e2e_ms": _window([r.e2e_s for r in rows if r.e2e_s is not None]),
        }
    lags = sorted(r.lag_s for r in records)
    adherent = sum(1 for lag in lags if lag <= grace_s)
    total_tokens = sum(r.tokens for r in records)
    report: "Dict[str, Any]" = {
        "requests": len(records),
        "ok": sum(1 for r in records if r.status == 200),
        "shed": sum(1 for r in records if r.shed),
        "errors": sum(1 for r in records if r.error),
        "duration_s": round(wall_s, 3),
        "tokens": total_tokens,
        "tokens_per_s": round(total_tokens / wall_s, 2) if wall_s > 0 else 0.0,
        "schedule": {
            "adherence": round(adherent / len(records), 4) if records else 1.0,
            "grace_s": grace_s,
            "rate_scale": rate_scale,
            "lag_p50_ms": round(_percentile(lags, 0.50) * 1e3, 3) if lags else 0.0,
            "lag_p95_ms": round(_percentile(lags, 0.95) * 1e3, 3) if lags else 0.0,
            "lag_max_ms": round(lags[-1] * 1e3, 3) if lags else 0.0,
        },
        "per_tenant": per_tenant,
    }
    if meta:
        report["trace"] = dict(meta)
    if targets:
        verdicts = tenant_verdicts(per_tenant, targets)
        report["verdicts"] = verdicts
        report["verdict_state"] = overall_state(verdicts)
    if fault_times_s is not None:
        report["availability"] = availability(
            (
                {
                    "tenant": r.tenant,
                    "status": r.status,
                    "start_s": r.start_s,
                    "ttft_s": r.ttft_s,
                }
                for r in records
            ),
            fault_times_s=fault_times_s,
        )
    return report


def replay(
    requests: "Sequence[TraceRequest]",
    *,
    app: Any = None,
    target: Optional[str] = None,
    concurrency: int = 32,
    rate_scale: float = 1.0,
    grace_s: float = 0.25,
    targets: "Optional[Dict[str, Dict[str, float]]]" = None,
    meta: "Optional[Dict[str, Any]]" = None,
    fault_times_s: "Optional[Sequence[float]]" = None,
) -> "Dict[str, Any]":
    """The sync entry point (owns its event loop): see :func:`replay_async`."""
    return asyncio.run(replay_async(
        requests, app=app, target=target, concurrency=concurrency,
        rate_scale=rate_scale, grace_s=grace_s, targets=targets, meta=meta,
        fault_times_s=fault_times_s,
    ))
