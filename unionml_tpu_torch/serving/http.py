"""Minimal asyncio HTTP/1.1 server for model serving, a copy of
``unionml_tpu/serving/http.py``.

Replaces the reference's FastAPI/uvicorn dependency (unionml/fastapi.py) with a
self-contained server: request-line + header parsing, Content-Length bodies, JSON
responses, HTTP/1.1 keep-alive (persistent connections with an idle timeout — a
benchmark client reusing one connection pays the TCP/loopback handshake once, not
per request), and the overload posture the reference left to uvicorn/Flyte:
in-flight admission control (429 + Retry-After past the cap), per-request
deadlines (``X-Request-Deadline-Ms``, 503 on expiry, handler cancelled), and
SIGTERM graceful drain (readiness off, in-flight streams finish, then exit) —
see docs/serving.md "Serving under load". Deliberately small — the serving
surface is five routes — and dependency-free so the serving container stays
lean.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import signal
import time
import urllib.parse
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import SERVE_DRAIN_TIMEOUT_S, SERVE_MAX_DEADLINE_MS, SERVE_RETRY_AFTER_S
from unionml_tpu_torch.observability.trace import (
    REQUEST_ID_HEADER,
    bind as _bind_request,
    new_request_id,
    sanitize_request_id,
    unbind as _unbind_request,
)
from unionml_tpu_torch.serving.overload import (
    DeadlineExceeded,
    QueueFullError,
    TenantThrottled,
    remaining_s,
    request_deadline,
)
from unionml_tpu_torch.serving.tenancy import (
    AUTHORIZATION_HEADER,
    PRIORITY_HEADER,
    TENANT_HEADER,
    active_registry,
    bind_tenant as _bind_tenant,
    parse_priority,
    priority_name,
    resolve_tenant,
    unbind_tenant as _unbind_tenant,
)

Handler = Callable[[bytes], Awaitable[Tuple[int, Any, str]]]

_STATUS_PHRASES = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    409: "Conflict",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}

#: query parameters of the request currently being handled, bound by
#: ``_dispatch_full`` — handlers read them via :func:`current_query` instead of
#: a signature change on the Handler protocol (``/metrics?format=prometheus``,
#: ``/debug/requests?route=...``)
request_query: "contextvars.ContextVar[Dict[str, str]]" = contextvars.ContextVar(
    "request_query", default={}
)


def current_query() -> "Dict[str, str]":
    """The active request's parsed query-string parameters."""
    return request_query.get()

MAX_BODY_BYTES = 64 * 1024 * 1024
KEEPALIVE_IDLE_S = 75.0

#: the client's deadline header: milliseconds this request is still worth
#: serving. Clipped to ``max_deadline_ms``; absent -> ``default_deadline_ms``.
DEADLINE_HEADER = "x-request-deadline-ms"


class HTTPServer:
    """Route table + asyncio socket loop, with admission control and deadlines.

    Overload posture (all opt-in at this layer; :class:`ServingApp` turns them
    on with the ``defaults.py`` values): ``max_inflight`` bounds concurrently
    executing handlers — excess requests shed immediately with ``429`` +
    ``Retry-After`` instead of queueing; ``default_deadline_ms`` bounds every
    handler (a request past its deadline is cancelled and answered ``503``);
    ``begin_drain()``/``shutdown()`` implement graceful drain — readiness flips
    (non-exempt routes get ``503``), in-flight work finishes under
    ``drain_timeout_s``, then ``serve()`` returns. ``serve()`` installs a
    SIGTERM handler wired to ``shutdown()`` so rolling restarts drain live
    decodes instead of dropping them.
    """

    def __init__(self) -> None:
        self._routes: Dict[Tuple[str, str], Handler] = {}
        #: prefix routes (``/debug/requests/<id>``): handler receives the path
        #: suffix as a second argument; exact routes always win
        self._prefix_routes: Dict[Tuple[str, str], Callable[[bytes, str], Awaitable[Any]]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        #: optional sink with a ``record(route, status, latency_s)`` method
        #: (:class:`unionml_tpu_torch.serving.metrics.ServingMetrics`)
        self.metrics: Any = None
        #: optional :class:`~unionml_tpu_torch.observability.trace.Tracer`: when set
        #: and enabled, every request gets a RequestTrace timeline registered
        #: in the app's flight recorder. Request IDS flow regardless — inbound
        #: ``X-Request-Id`` honored, generated otherwise, echoed on every
        #: response including errors and sheds.
        self.tracer: Any = None
        #: one structured line per completed request (request id attached via
        #: the contextvar, so JSON-format logs correlate with traces); off by
        #: default — the bare server stays silent on the request path
        self.access_log: bool = False
        # ---- overload knobs (None = unbounded, the bare-server default;
        # ServingApp applies the production defaults from defaults.py)
        self.max_inflight: Optional[int] = None
        self.default_deadline_ms: Optional[float] = None
        self.max_deadline_ms: Optional[float] = SERVE_MAX_DEADLINE_MS
        self.retry_after_s: float = SERVE_RETRY_AFTER_S
        self.drain_timeout_s: float = SERVE_DRAIN_TIMEOUT_S
        #: called once by ``shutdown()`` after in-flight work drains — the app
        #: hook that closes its batching engines
        self.on_drained: Optional[Callable[[], None]] = None
        # ---- overload state
        self.draining = False
        self._inflight = 0
        self._streams = 0
        #: routes that keep answering while draining (health must report
        #: ready=false, metrics must stay scrapable through the drain, and the
        #: flight recorder and fleet-health views are most useful exactly
        #: while a drain is stuck)
        self._drain_exempt = {
            ("GET", "/health"), ("GET", "/healthz"), ("GET", "/metrics"),
            ("GET", "/debug/requests"), ("GET", "/debug/fleet"),
        }
        self._stop_serving: Optional[asyncio.Event] = None

    @property
    def inflight(self) -> int:
        """Concurrently executing handlers + live streaming responses."""
        return self._inflight + self._streams

    def route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method.upper(), path)] = handler

    def route_prefix(
        self, method: str, prefix: str, handler: "Callable[[bytes, str], Awaitable[Any]]"
    ) -> None:
        """Register a prefix route: requests whose path extends ``prefix`` call
        ``handler(body, suffix)``. Exact routes win over prefixes, and the
        metrics label is the prefix + ``*`` (bounded cardinality — arbitrary
        suffixes must not mint metric routes)."""
        self._prefix_routes[(method.upper(), prefix)] = handler

    def _resolve(self, method: str, path: str) -> "Tuple[Optional[Handler], Optional[str]]":
        """``(handler, metrics_route)`` for a request path: exact match first,
        then the longest matching prefix route (its suffix is bound into the
        returned handler)."""
        handler = self._routes.get((method, path))
        if handler is not None:
            return handler, f"{method} {path}"
        best: Optional[Tuple[str, Callable[[bytes, str], Awaitable[Any]]]] = None
        for (pmethod, prefix), phandler in self._prefix_routes.items():
            if pmethod == method and path.startswith(prefix) and len(path) > len(prefix):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, phandler)
        if best is None:
            return None, None
        prefix, phandler = best
        suffix = path[len(prefix):]

        async def bound(body: bytes) -> Any:
            return await phandler(body, suffix)

        return bound, f"{method} {prefix}*"

    async def _read_request(
        self, reader: asyncio.StreamReader, request_line: Optional[bytes] = None
    ) -> Optional[Tuple[str, str, bytes, bool, bool, Dict[str, str]]]:
        if request_line is None:
            request_line = await reader.readline()
        if not request_line:
            return None
        try:
            method, target, version = request_line.decode("latin1").split(" ", 2)
        except ValueError:
            raise ValueError("malformed request line")
        # the query string rides along; _dispatch_full splits and parses it so
        # the in-process test client (`dispatch("GET", "/metrics?format=...")`)
        # behaves exactly like the wire
        path = target

        content_length = 0
        # HTTP/1.1 defaults to persistent connections; 1.0 must opt in
        http10 = "1.0" in version
        keep_alive = not http10
        wants_close = False
        headers: Dict[str, str] = {}
        while True:
            header_line = await reader.readline()
            if header_line in (b"\r\n", b"\n", b""):
                break
            name, _, value = header_line.decode("latin1").partition(":")
            name = name.strip().lower()
            headers[name] = value.strip()
            if name == "content-length":
                try:
                    content_length = int(value.strip())
                except ValueError:
                    raise ValueError("malformed Content-Length")
                if content_length < 0:
                    # readexactly(-n) would raise its own confusing ValueError;
                    # reject the protocol violation with a clean 400 instead
                    raise ValueError("negative Content-Length")
            elif name == "connection":
                # the value is a comma-separated token list ("close, TE"); an
                # explicit close wins over everything, including later headers
                tokens = {t.strip().lower() for t in value.split(",")}
                if "close" in tokens:
                    keep_alive = False
                    wants_close = True
                elif "keep-alive" in tokens and not wants_close:
                    keep_alive = True
        if content_length > MAX_BODY_BYTES:
            raise ValueError("request body too large")
        body = await reader.readexactly(content_length) if content_length else b""
        return method.upper(), path, body, keep_alive, http10, headers

    @staticmethod
    def _extra_header_lines(extra_headers: Optional[Dict[str, str]]) -> str:
        if not extra_headers:
            return ""
        return "".join(f"{name}: {value}\r\n" for name, value in extra_headers.items())

    @classmethod
    def _encode_stream_head(
        cls, status: int, content_type: str, *, keep_alive: bool, http10: bool,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> bytes:
        """Response head for a streaming body. HTTP/1.0 peers cannot parse chunked
        framing, so they get an unframed close-delimited body instead."""
        connection = "keep-alive" if (keep_alive and not http10) else "close"
        framing = "" if http10 else "Transfer-Encoding: chunked\r\n"
        return (
            f"HTTP/1.1 {status} {_STATUS_PHRASES.get(status, 'Unknown')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"{framing}"
            f"{cls._extra_header_lines(extra_headers)}"
            f"Connection: {connection}\r\n\r\n"
        ).encode("latin1")

    @staticmethod
    async def _write_stream(
        writer: asyncio.StreamWriter, payload: Any, *, http10: bool,
        deadline: Optional[float] = None,
    ) -> None:
        """Emit an async-iterator payload, draining per chunk so each arrives as
        soon as it is produced: chunked transfer encoding for HTTP/1.1, raw bytes
        delimited by connection close for HTTP/1.0. A ``deadline`` (absolute
        monotonic, set only for explicit client deadlines) truncates the stream
        at the next chunk boundary — the caller's abort path then acloses the
        payload, which releases the producer (e.g. a continuous-batching slot)."""
        async for chunk in payload:
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded("stream deadline exceeded")
            data = chunk if isinstance(chunk, bytes) else str(chunk).encode()
            if not data:
                continue  # a zero-length HTTP chunk would terminate the stream early
            if http10:
                writer.write(data)
            else:
                writer.write(f"{len(data):x}\r\n".encode("latin1") + data + b"\r\n")
            await writer.drain()
        if not http10:
            writer.write(b"0\r\n\r\n")
            await writer.drain()

    @classmethod
    def _encode_response(
        cls, status: int, payload: Any, content_type: str = "application/json", *,
        keep_alive: bool = False, extra_headers: Optional[Dict[str, str]] = None,
    ) -> bytes:
        if content_type == "application/json":
            body = json.dumps(payload, default=str).encode()
        elif isinstance(payload, bytes):
            body = payload
        else:
            body = str(payload).encode()
        connection = "keep-alive" if keep_alive else "close"
        head = (
            f"HTTP/1.1 {status} {_STATUS_PHRASES.get(status, 'Unknown')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{cls._extra_header_lines(extra_headers)}"
            f"Connection: {connection}\r\n\r\n"
        )
        return head.encode("latin1") + body

    def _deadline_for(self, headers: Dict[str, str]) -> Tuple[Optional[float], bool]:
        """Absolute monotonic deadline for a request: the client's
        ``X-Request-Deadline-Ms`` (clipped to ``max_deadline_ms``), else the
        server default. Returns ``(deadline, explicit)`` — only an explicit
        client deadline also bounds a streaming response body."""
        raw = headers.get(DEADLINE_HEADER)
        explicit = raw is not None
        if explicit:
            try:
                ms = float(raw)
            except ValueError:
                raise HTTPError(400, f"malformed {DEADLINE_HEADER} header: {raw!r}")
        else:
            ms = self.default_deadline_ms
        if ms is not None and self.max_deadline_ms is not None:
            ms = min(ms, self.max_deadline_ms)
        if ms is None:
            return None, False
        return time.monotonic() + ms / 1000.0, explicit

    def _inc(self, counter: str) -> None:
        if self.metrics is not None and hasattr(self.metrics, "inc"):
            self.metrics.inc(counter)

    def _shed_headers(self) -> Dict[str, str]:
        return {"Retry-After": str(self.retry_after_s)}

    async def dispatch(self, method: str, path: str, body: bytes, headers: Optional[Dict[str, str]] = None) -> Tuple[int, Any, str]:
        """Route a request; usable directly by tests (in-process 'test client').
        ``path`` may carry a query string (``/metrics?format=prometheus``)."""
        status, payload, content_type, _, _ = await self._dispatch_full(method, path, body, headers)
        return status, payload, content_type

    async def dispatch_with_headers(
        self, method: str, path: str, body: bytes = b"", headers: Optional[Dict[str, str]] = None
    ) -> Tuple[int, Any, str, Dict[str, str]]:
        """:meth:`dispatch` plus the response's extra headers — the serverless
        adapter uses this so ``X-Request-Id``/``Retry-After`` survive the
        event bridge."""
        status, payload, content_type, extra, _ = await self._dispatch_full(method, path, body, headers)
        return status, payload, content_type, extra

    async def _dispatch_full(
        self, method: str, path: str, body: bytes, headers: Optional[Dict[str, str]] = None
    ) -> Tuple[int, Any, str, Dict[str, str], Optional[float]]:
        """Full dispatch: request-id binding, admission control, deadline
        propagation, then the handler. Returns ``(status, payload,
        content_type, extra_headers, stream_deadline)`` — the last element is
        the absolute deadline to apply to a streaming body (set only when the
        client sent one explicitly)."""
        start = time.perf_counter()
        headers = headers or {}
        path, _, raw_query = path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query)) if raw_query else {}
        # request-id contract (docs/observability.md): honor an inbound
        # X-Request-Id (sanitized — a raw echo of client bytes would be a
        # header-injection vector), generate otherwise, echo on EVERY response
        # — errors and sheds included
        rid = sanitize_request_id(headers.get(REQUEST_ID_HEADER)) or new_request_id()
        # multi-tenant QoS (serving/tenancy.py): tenant identity + priority
        # tier ride contextvars like the request id. Requests with none of the
        # three headers skip all of it — the zero-cost-off contract.
        tenant: Optional[str] = None
        priority: Optional[int] = None
        priority_error: Optional[str] = None
        if (
            TENANT_HEADER in headers
            or AUTHORIZATION_HEADER in headers
            or PRIORITY_HEADER in headers
        ):
            tenant = resolve_tenant(headers, active_registry())
            raw_priority = headers.get(PRIORITY_HEADER)
            if raw_priority is not None:
                try:
                    priority = parse_priority(raw_priority)
                except ValueError as exc:
                    priority_error = str(exc)
        tracer = self.tracer
        trace = tracer.start(method, path, rid) if tracer is not None else None
        if trace is not None:
            if tenant is not None:
                trace.tenant = tenant
            if priority is not None:
                trace.priority = priority_name(priority)
        bind_tokens = _bind_request(rid, trace)
        tenant_tokens = _bind_tenant(tenant, priority)
        query_token = request_query.set(query)
        extra: Dict[str, str] = {"X-Request-Id": rid}
        stream_deadline: Optional[float] = None
        if trace is not None:
            trace.event("http.accept", body_bytes=len(body))
        try:
            handler, metrics_route = self._resolve(method, path)
            if metrics_route is None:
                metrics_route = f"{method} {path}"
            if handler is None:
                if any(p == path for (_, p) in self._routes):
                    # bound the label set: arbitrary method tokens must not mint routes
                    if method not in ("GET", "POST", "PUT", "DELETE", "HEAD", "OPTIONS", "PATCH"):
                        metrics_route = "<unmatched>"
                    result = 405, {"detail": f"method {method} not allowed for {path}"}, "application/json"
                else:
                    # unmatched paths share one metrics label — per-path labels would let
                    # a scanner grow the route table (and snapshot) without bound
                    metrics_route = "<unmatched>"
                    result = 404, {"detail": f"no route for {path}"}, "application/json"
            elif priority_error is not None:
                # an explicit bad X-Priority is a usage error, not something
                # to silently serve at the wrong tier
                result = 400, {"detail": priority_error}, "application/json"
            elif self.draining and (method, path) not in self._drain_exempt:
                # readiness is off: the load balancer should already be routing
                # around us, so anything still arriving gets a fast 503 + hint
                self._inc("shed_draining")
                extra.update(self._shed_headers())
                if trace is not None:
                    trace.event("http.shed", reason="draining")
                result = 503, {"detail": "server is draining"}, "application/json"
            elif self.max_inflight is not None and self.inflight >= self.max_inflight:
                # admission control: shed NOW with 429 instead of queueing — a
                # bounded queue keeps admitted-request latency bounded, and
                # Retry-After tells well-behaved clients when to come back
                self._inc("shed_inflight")
                extra.update(self._shed_headers())
                if trace is not None:
                    trace.event("http.shed", reason="inflight_cap")
                result = (
                    429,
                    {"detail": f"server at capacity ({self.max_inflight} requests in flight)"},
                    "application/json",
                )
            else:
                try:
                    deadline, explicit = self._deadline_for(headers)
                except HTTPError as exc:
                    result = exc.status, {"detail": exc.detail}, "application/json"
                else:
                    if explicit and deadline is not None:
                        stream_deadline = deadline
                    token = request_deadline.set(deadline)
                    self._inflight += 1
                    try:
                        timeout = remaining_s(deadline)
                        if timeout is not None and timeout <= 0:
                            # born expired (e.g. X-Request-Deadline-Ms: 0 or negative):
                            # shed before the handler runs at all
                            raise DeadlineExceeded("deadline expired before dispatch")
                        result = await asyncio.wait_for(handler(body), timeout)
                    except HTTPError as exc:
                        extra.update(exc.headers)
                        result = exc.status, {"detail": exc.detail}, "application/json"
                    except QueueFullError as exc:
                        # an admission queue deeper in the stack (micro-batcher or
                        # continuous engine) is full — same shed contract as ours.
                        # A TENANT-bucket shed is stamped distinctly and its
                        # Retry-After is the bucket's actual refill time, not
                        # the server's fixed hint (docs/serving.md
                        # "Multi-tenant QoS")
                        if isinstance(exc, TenantThrottled):
                            self._inc("shed_tenant_limit")
                            shed_reason = "tenant_limit"
                        else:
                            self._inc("shed_queue_full")
                            shed_reason = "queue_full"
                        extra.update({"Retry-After": str(exc.retry_after_s)})
                        if trace is not None:
                            trace.event("http.shed", reason=shed_reason)
                        result = 429, {"detail": exc.detail}, "application/json"
                    except (asyncio.TimeoutError, DeadlineExceeded) as exc:
                        # the deadline fired: wait_for has cancelled the handler (its
                        # pending batcher future is dropped and the queued work shed at
                        # the next dispatch), so resources are reclaimed, not leaked
                        self._inc("deadline_timeouts")
                        extra.update(self._shed_headers())
                        if trace is not None:
                            trace.event("http.shed", reason="deadline")
                        detail = str(exc) or "request deadline exceeded"
                        result = 503, {"detail": detail}, "application/json"
                    except Exception as exc:  # pragma: no cover - defensive
                        logger.exception("handler error")
                        result = 500, {"detail": f"{type(exc).__name__}: {exc}"}, "application/json"
                    finally:
                        self._inflight -= 1
                        request_deadline.reset(token)
            status, payload = result[0], result[1]
            if trace is not None:
                if hasattr(payload, "__aiter__"):
                    # the handler returned a stream: the trace must outlive this
                    # method — the wrapper records per-chunk events and finishes
                    # the timeline when the stream ends (or aborts)
                    result = (status, self._traced_stream(payload, trace, status), result[2])
                else:
                    detail = payload.get("detail") if isinstance(payload, dict) and status >= 400 else None
                    tracer.finish(trace, status, detail)
            if self.metrics is not None:
                self.metrics.record(metrics_route, status, time.perf_counter() - start)
            if self.access_log:
                logger.info(
                    f"{method} {path} {status} "
                    f"{round((time.perf_counter() - start) * 1e3, 2)}ms rid={rid}"
                )
            return (*result, extra, stream_deadline)
        finally:
            request_query.reset(query_token)
            _unbind_tenant(tenant_tokens)
            _unbind_request(bind_tokens)

    def _traced_stream(self, payload: Any, trace: Any, status: int):
        """Wrap a streaming body so its trace finishes when the STREAM does
        (the handler returned long before the last chunk): one event per HTTP
        chunk, terminal status on exhaustion/abort, and the wrapped payload's
        ``aclose`` still runs — the producer-release contract is preserved."""
        tracer = self.tracer

        async def wrapped():
            try:
                async for chunk in payload:
                    trace.event(
                        "http.stream_chunk",
                        bytes=len(chunk) if isinstance(chunk, (bytes, str)) else 0,
                    )
                    yield chunk
            except BaseException as exc:
                tracer.finish(trace, status, f"stream aborted: {type(exc).__name__}")
                raise
            else:
                tracer.finish(trace, status)
            finally:
                # `async for` does not aclose an early-exited iterator; the
                # server acloses THIS wrapper, so forward the release
                closer = getattr(payload, "aclose", None)
                if closer is not None:
                    try:
                        await closer()
                    except Exception:  # pragma: no cover - defensive
                        pass

        return wrapped()

    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    # idle timeout applies only to waiting for the NEXT request line;
                    # an in-flight slow body read is never cancelled mid-request
                    request_line = await asyncio.wait_for(reader.readline(), KEEPALIVE_IDLE_S)
                except asyncio.TimeoutError:
                    break  # idle keep-alive connection: close quietly
                if not request_line:
                    break
                request = await self._read_request(reader, request_line)
                if request is None:
                    break
                method, path, body, keep_alive, http10, req_headers = request
                status, payload, content_type, extra, stream_deadline = await self._dispatch_full(
                    method, path, body, req_headers
                )
                if self.draining:
                    # a drain must converge: no new requests down this connection
                    keep_alive = False
                if hasattr(payload, "__aiter__"):
                    # streaming handler: one HTTP chunk per item (1.0 peers get an
                    # unframed close-delimited body)
                    keep_alive = keep_alive and not http10
                    writer.write(self._encode_stream_head(
                        status, content_type, keep_alive=keep_alive, http10=http10, extra_headers=extra
                    ))
                    self._streams += 1
                    try:
                        await self._write_stream(writer, payload, http10=http10, deadline=stream_deadline)
                    except DeadlineExceeded:
                        # explicit client deadline hit mid-stream: truncate at
                        # this chunk boundary; the finally below acloses the
                        # payload, which releases the producer's engine slot
                        self._inc("stream_deadline_truncations")
                        logger.warning(f"stream truncated at client deadline: {method} {path}")
                        break
                    except Exception as exc:
                        # predictor failure mid-stream, or the client went away
                        # (ConnectionResetError from drain): the response is already
                        # underway, so truncate the stream and drop the connection
                        logger.warning(f"stream aborted: {type(exc).__name__}: {exc}")
                        break
                    finally:
                        self._streams -= 1
                        closer = getattr(payload, "aclose", None)
                        if closer is not None:
                            try:
                                await closer()  # release the producer promptly
                            except Exception:
                                pass
                else:
                    writer.write(self._encode_response(
                        status, payload, content_type, keep_alive=keep_alive, extra_headers=extra
                    ))
                    await writer.drain()
                if not keep_alive:
                    break
        except (ValueError, asyncio.IncompleteReadError) as exc:
            try:
                writer.write(self._encode_response(400, {"detail": str(exc)}))
                await writer.drain()
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # ------------------------------------------------------------------ drain

    def begin_drain(self) -> None:
        """Flip readiness off and stop accepting new work: ``GET /health``
        reports ``ready: false`` (503), every non-exempt route sheds with 503 +
        ``Retry-After``, and the listening socket closes so a load balancer's
        next connection attempt fails over to a healthy replica. In-flight
        requests and streams keep running — :meth:`shutdown` waits for them."""
        if not self.draining:
            self.draining = True
            logger.info("drain started: readiness off, shedding new requests")
        if self._server is not None:
            self._server.close()

    async def shutdown(self, drain_timeout_s: Optional[float] = None) -> None:
        """Graceful drain: stop admitting, wait for in-flight requests and live
        streams to finish (bounded by ``drain_timeout_s``), then stop
        ``serve()``. Wired to SIGTERM by :meth:`serve`, so a rolling restart on
        a serving host finishes live decodes instead of dropping them."""
        self.begin_drain()
        timeout = self.drain_timeout_s if drain_timeout_s is None else drain_timeout_s
        deadline = time.monotonic() + timeout
        while (self._inflight > 0 or self._streams > 0) and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        if self._inflight > 0 or self._streams > 0:
            logger.warning(
                f"drain timeout after {timeout:.1f}s with {self._inflight} requests and "
                f"{self._streams} streams still in flight; exiting anyway"
            )
        else:
            logger.info("drain complete: all in-flight work finished")
        if self.on_drained is not None:
            try:
                self.on_drained()  # the app closes its batching engines
            except Exception:  # pragma: no cover - defensive
                logger.exception("on_drained hook failed")
        if self._stop_serving is not None:
            self._stop_serving.set()

    async def serve(self, host: str = "127.0.0.1", port: int = 8000, *, reuse_port: bool = False) -> None:
        # reuse_port lets N worker processes share one listening port (the kernel
        # load-balances accepts) — the `serve --workers N` multi-process mode
        self._server = await asyncio.start_server(self._on_connection, host, port, reuse_port=reuse_port or None)
        self._stop_serving = asyncio.Event()
        loop = asyncio.get_running_loop()
        sigterm_installed = False
        try:
            loop.add_signal_handler(
                signal.SIGTERM, lambda: asyncio.ensure_future(self.shutdown())
            )
            sigterm_installed = True
        except (NotImplementedError, RuntimeError, ValueError):
            # non-main thread, or a platform without signal-handler support:
            # drain stays reachable programmatically via shutdown()
            pass
        logger.info(f"serving on http://{host}:{port}")
        try:
            async with self._server:
                serve_task = asyncio.create_task(self._server.serve_forever())
                stop_task = asyncio.create_task(self._stop_serving.wait())
                try:
                    done, _ = await asyncio.wait(
                        {serve_task, stop_task}, return_when=asyncio.FIRST_COMPLETED
                    )
                    if stop_task not in done and self.draining:
                        # begin_drain() closed the listener, which cancels
                        # serve_forever — but in-flight work is still draining;
                        # shutdown() sets the stop event once it finishes
                        await stop_task
                    # surface an unexpected accept-loop crash (a drain-stopped
                    # serve_forever is cancelled, not failed)
                    if serve_task in done and not serve_task.cancelled() and serve_task.exception():
                        raise serve_task.exception()
                finally:
                    for task in (serve_task, stop_task):
                        task.cancel()
                    await asyncio.gather(serve_task, stop_task, return_exceptions=True)
        finally:
            if sigterm_installed:
                loop.remove_signal_handler(signal.SIGTERM)

    def run(self, host: str = "127.0.0.1", port: int = 8000, *, reuse_port: bool = False) -> None:
        try:
            asyncio.run(self.serve(host, port, reuse_port=reuse_port))
        except KeyboardInterrupt:  # pragma: no cover
            logger.info("server stopped")


class HTTPError(Exception):
    """Raise inside a handler to produce a non-200 JSON response.

    ``headers`` ride onto the response head — the 429/503 shed paths use it for
    ``Retry-After``."""

    def __init__(self, status: int, detail: str, headers: Optional[Dict[str, str]] = None):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.headers: Dict[str, str] = headers or {}
