"""Overload-protection primitives, counterparts of the part of
``unionml_tpu/serving/overload.py`` the continuous engine needs.

- :class:`QueueFullError`: an admission queue is at capacity; shed now
  (HTTP 429 + ``Retry-After`` at the serving surface).
- :class:`DeadlineExceeded`: the request's deadline passed before (or while)
  its work ran (HTTP 503).

Deadlines are absolute ``time.monotonic()`` instants.
"""

from __future__ import annotations

import time
from typing import Optional


class QueueFullError(Exception):
    """An admission queue is at capacity — shed now with 429 + ``Retry-After``."""

    def __init__(self, detail: str, retry_after_s: float = 1.0):
        super().__init__(detail)
        self.detail = detail
        self.retry_after_s = retry_after_s


class DeadlineExceeded(Exception):
    """The request's deadline passed before (or while) its work ran — shed with 503."""


def expired(deadline: Optional[float]) -> bool:
    return deadline is not None and time.monotonic() >= deadline
