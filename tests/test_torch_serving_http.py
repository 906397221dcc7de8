"""The port's ``HTTPServer`` against the JAX package's over a loopback socket.

Both servers get the same routes and limits and serve on ephemeral ports,
each on its own event-loop thread; the same raw HTTP/1.1 requests go to
each, and the raw response bytes must be equal (no response carries a
latency field). Covered: keep-alive (two requests on one connection), the
in-flight cap (429 with ``Retry-After``), the deadline header (503), the
request-id echo and a malformed one, tenant and priority headers (bound to
the handler's context, a bad priority answered 400), chunked streams, 404
and 405.
"""

import asyncio
import json
import socket
import threading
import time

import pytest
import torch

import unionml_tpu.serving.http as jax_http
import unionml_tpu.serving.tenancy as jax_tenancy
import unionml_tpu_torch.serving.http as torch_http
import unionml_tpu_torch.serving.tenancy as torch_tenancy

torch.set_num_threads(2)

PACKAGES = {"jax": (jax_http, jax_tenancy), "torch": (torch_http, torch_tenancy)}


def _build(http, tenancy):
    server = http.HTTPServer()
    server.max_inflight = 1
    server.default_deadline_ms = 5_000.0
    slow_started = threading.Event()

    async def ok(body):
        return 200, {"ok": True, "echo": json.loads(body or b"{}")}, "application/json"

    async def context(body):
        return 200, {"tenant": tenancy.current_tenant(), "priority": tenancy.current_priority()}, "application/json"

    async def slow(body):
        slow_started.set()
        await asyncio.sleep(0.6)
        return 200, {"slow": True}, "application/json"

    async def stream(body):
        async def chunks():
            for i in range(3):
                yield (json.dumps({"i": i}) + "\n").encode()

        return 200, chunks(), "application/x-ndjson"

    server.route("GET", "/ok", ok)
    server.route("POST", "/ok", ok)
    server.route("POST", "/context", context)
    server.route("POST", "/slow", slow)
    server.route("GET", "/stream", stream)
    return server, slow_started


@pytest.fixture(scope="module")
def servers():
    """Both packages' servers on ephemeral loopback ports, with a tenancy
    registry installed in each package."""
    running = {}
    for name, (http, tenancy) in PACKAGES.items():
        tenancy.set_active_registry(tenancy.TenantRegistry({"acme": tenancy.TenantSpec(priority="high")}))
        server, slow_started = _build(http, tenancy)
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_until_complete, args=(server.serve("127.0.0.1", 0),), daemon=True)
        thread.start()
        for _ in range(500):
            if server._server is not None and server._server.sockets:
                break
            time.sleep(0.01)
        running[name] = (server, loop, thread, server._server.sockets[0].getsockname()[1], slow_started)
    yield running
    for name, (server, loop, thread, _, _) in running.items():
        asyncio.run_coroutine_threadsafe(server.shutdown(drain_timeout_s=5), loop).result(timeout=30)
        thread.join(timeout=30)
        PACKAGES[name][1].set_active_registry(None)


def _request(method, path, body=b"", headers=(), keep_alive=False):
    lines = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1", f"Content-Length: {len(body)}",
             f"Connection: {'keep-alive' if keep_alive else 'close'}", *headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def _read_response(sock):
    """One full response (Content-Length or chunked body) off ``sock``."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(65536)
        if not chunk:
            return data
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    fields = dict(line.split(": ", 1) for line in head.decode("latin1").split("\r\n")[1:])
    if "Content-Length" in fields:
        need = int(fields["Content-Length"])
        while len(rest) < need:
            rest += sock.recv(65536)
        return head + b"\r\n\r\n" + rest[:need]
    while not rest.endswith(b"0\r\n\r\n"):  # chunked
        chunk = sock.recv(65536)
        if not chunk:
            break
        rest += chunk
    return head + b"\r\n\r\n" + rest


def _exchange(port, *requests):
    """Send ``requests`` in turn on ONE connection; return each response's bytes."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        out = []
        for raw in requests:
            sock.sendall(raw)
            out.append(_read_response(sock))
        return out


def _both(servers, *requests):
    got = {name: _exchange(port, *requests) for name, (_, _, _, port, _) in servers.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_keep_alive_serves_two_requests_on_one_connection(servers):
    first, second = _both(
        servers,
        _request("POST", "/ok", b'{"a": 1}', ("X-Request-Id: ka-1",), keep_alive=True),
        _request("GET", "/ok", headers=("X-Request-Id: ka-2",)),
    )
    assert b"Connection: keep-alive" in first and b"X-Request-Id: ka-1" in first
    assert b"Connection: close" in second and second.endswith(b'{"ok": true, "echo": {}}')


@pytest.mark.parametrize(
    "request_id", ["rid-1", "bad\r\nInjected: 1", None], ids=["echoed", "sanitized", "generated"]
)
def test_request_id_echo(servers, request_id):
    headers = () if request_id is None else (f"X-Request-Id: {request_id}",)
    if request_id is None:  # a generated id differs by construction: compare all but its value
        got = {}
        for name, (_, _, _, port, _) in servers.items():
            [raw] = _exchange(port, _request("GET", "/ok"))
            head, _, body = raw.partition(b"\r\n\r\n")
            lines = [line for line in head.split(b"\r\n") if not line.startswith(b"X-Request-Id: ")]
            rid = next(line for line in head.split(b"\r\n") if line.startswith(b"X-Request-Id: "))
            assert len(rid) > len(b"X-Request-Id: ")
            got[name] = (lines, body)
        assert got["torch"] == got["jax"]
        return
    [raw] = _both(servers, _request("GET", "/ok", headers=headers))
    assert b"\r\nInjected: 1\r\n" not in raw


@pytest.mark.parametrize(
    "headers",
    [("X-Tenant-Id: acme",), ("X-Tenant-Id: acme", "X-Priority: batch"), ("X-Priority: high",),
     ("X-Priority: turbo",), ("Authorization: Bearer sk-secret-key",), ()],
    ids=["tenant", "tenant-priority", "priority", "bad-priority", "api-key", "anonymous"],
)
def test_tenant_headers_bind_the_handler_context(servers, headers):
    [raw] = _both(servers, _request("POST", "/context", b"{}", ("X-Request-Id: t-1", *headers)))
    status = int(raw.split(b" ", 2)[1])
    assert status == (400 if "X-Priority: turbo" in headers else 200)
    assert b"sk-secret-key" not in raw


def test_inflight_cap_sheds_429_with_retry_after(servers):
    results = {}
    for name, (_, _, _, port, slow_started) in servers.items():
        slow_started.clear()
        holder = {}
        thread = threading.Thread(target=lambda: holder.update(
            raw=_exchange(port, _request("POST", "/slow", b"{}", ("X-Request-Id: s-1",)))[0]))
        thread.start()
        assert slow_started.wait(10)
        [shed] = _exchange(port, _request("GET", "/ok", headers=("X-Request-Id: s-2",)))
        thread.join(timeout=30)
        results[name] = (holder["raw"], shed)
    assert results["torch"] == results["jax"]
    slow, shed = results["torch"]
    assert slow.startswith(b"HTTP/1.1 200") and shed.startswith(b"HTTP/1.1 429 Too Many Requests")
    assert b"Retry-After: 1" in shed


def test_deadline_header_answers_503(servers):
    [raw] = _both(servers, _request("POST", "/slow", b"{}", ("X-Request-Id: d-1", "X-Request-Deadline-Ms: 50")))
    assert raw.startswith(b"HTTP/1.1 503 Service Unavailable") and b"Retry-After: 1" in raw


@pytest.mark.parametrize(
    "raw",
    [_request("GET", "/stream", headers=("X-Request-Id: st-1",)), _request("GET", "/nope", headers=("X-Request-Id: n",)),
     _request("DELETE", "/ok", headers=("X-Request-Id: m",)),
     _request("POST", "/ok", b"{", ("X-Request-Id: j",)),
     _request("POST", "/slow", b"{}", ("X-Request-Id: md", "X-Request-Deadline-Ms: soon"))],
    ids=["chunked-stream", "404", "405", "handler-json", "malformed-deadline"],
)
def test_other_responses_are_byte_equal(servers, raw):
    _both(servers, raw)
