"""Overload-protection primitives shared across the serving stack, a copy of
``unionml_tpu/serving/overload.py``.

The north star is "heavy traffic from millions of users" — which means the
interesting regime is the one where demand exceeds capacity. Left alone, every
queue in the stack (the micro-batcher's asyncio.Queue, the continuous engine's
``_pending`` list, the socket backlog) grows without bound under overload and
every request eventually times out client-side after consuming server work —
congestion collapse. The fix ("The Tail at Scale", Dean & Barroso 2013) is to
bound admission and shed the excess *immediately*:

- :class:`QueueFullError` — an admission queue is at capacity; the HTTP layer
  maps it to ``429 Too Many Requests`` + ``Retry-After`` so well-behaved
  clients back off instead of retrying into the same wall.
- :class:`DeadlineExceeded` — the request's deadline passed while it was still
  queued (or mid-flight); mapped to ``503 Service Unavailable``. Work a client
  has already given up on must never reach the device.

Deadlines are absolute ``time.monotonic()`` instants. They enter at the HTTP
layer (``X-Request-Deadline-Ms`` header, clipped to the server's maximum, else
the server default) and propagate down through a :data:`request_deadline`
contextvar so handlers — and through them the micro-batcher and the continuous
engine — can shed expired work at every queue boundary without any signature
churn on the handler protocol.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional


class QueueFullError(Exception):
    """An admission queue is at capacity — shed now with 429 + ``Retry-After``."""

    def __init__(self, detail: str, retry_after_s: float = 1.0):
        super().__init__(detail)
        self.detail = detail
        self.retry_after_s = retry_after_s


class TenantThrottled(QueueFullError):
    """A per-tenant token bucket (serving/tenancy.py) is empty — shed with 429.

    A :class:`QueueFullError` subclass so every existing 429 path (HTTP
    mapping, ``Retry-After`` from ``retry_after_s``) applies unchanged, but
    distinguishable: the HTTP layer stamps ``shed_tenant_limit`` (not
    ``shed_queue_full``) on the metrics and the trace, and ``retry_after_s``
    is computed from the limiting bucket's ACTUAL refill time rather than the
    server's fixed hint — a well-behaved client backs off exactly as long as
    the limit requires, no longer. The replica scheduler re-raises it
    immediately instead of walking the fleet: every replica shares the same
    registry, so the walk could only re-shed."""

    def __init__(self, detail: str, retry_after_s: float = 1.0, tenant: Optional[str] = None):
        super().__init__(detail, retry_after_s=retry_after_s)
        self.tenant = tenant


class DeadlineExceeded(Exception):
    """The request's deadline passed before (or while) its work ran — shed with 503."""


#: absolute ``time.monotonic()`` deadline of the request currently being handled
#: (``None`` = no deadline). Set by ``HTTPServer`` around each handler call.
request_deadline: "contextvars.ContextVar[Optional[float]]" = contextvars.ContextVar(
    "request_deadline", default=None
)


def current_deadline() -> Optional[float]:
    """The active request's absolute deadline, if any (monotonic seconds)."""
    return request_deadline.get()


def remaining_s(deadline: Optional[float]) -> Optional[float]:
    """Seconds until ``deadline`` (may be negative); ``None`` when unbounded."""
    return None if deadline is None else deadline - time.monotonic()


def expired(deadline: Optional[float]) -> bool:
    return deadline is not None and time.monotonic() >= deadline
