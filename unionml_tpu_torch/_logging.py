"""Package logger ``unionml_tpu_torch``, a copy of ``unionml_tpu/_logging.py``.

- ``UNIONML_TPU_LOGLEVEL`` is validated: a garbage value warns and falls back
  to INFO instead of raising at import time.
- ``UNIONML_TPU_LOG_FORMAT=json`` (or :func:`set_log_format`) switches every
  line to one JSON object carrying the active request id from
  :mod:`unionml_tpu_torch.observability.trace`, so access-log lines correlate
  with ``/debug/requests`` timelines by ``request_id``.

One difference: the logger propagates, so records also reach the root
logger's handlers (pytest's ``caplog`` among them); the JAX package's does
not. With no root handler configured, a record is printed once.
"""

import json
import logging
import os

_VALID_LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL", "NOTSET", "WARN", "FATAL")

_TEXT_FORMAT = "[unionml-tpu-torch] %(asctime)s %(levelname)s %(message)s"


class JsonFormatter(logging.Formatter):
    """One JSON object per line: timestamp, level, logger, message and — when
    a request is being handled — its ``request_id``."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exc_info"] = self.formatException(record.exc_info)
        try:
            # lazy: keeps bare-logger users free of the serving stack
            from unionml_tpu_torch.observability.trace import current_request_id

            request_id = current_request_id()
            if request_id is not None:
                out["request_id"] = request_id
        except Exception:  # pragma: no cover - never fail a log line
            pass
        return json.dumps(out, default=str)


def _resolve_level() -> "tuple[str, str | None]":
    """``(level, warning)`` from the env: an unknown name degrades to INFO
    with a warning emitted after the handler is attached."""
    raw = os.environ.get("UNIONML_TPU_LOGLEVEL", "INFO").strip().upper()
    if raw in _VALID_LEVELS:
        return raw, None
    return "INFO", f"ignoring invalid UNIONML_TPU_LOGLEVEL={raw!r}; falling back to INFO"


def set_log_format(fmt: str) -> None:
    """Switch the package handler's formatter: ``"json"`` for one JSON object
    a line, anything else for the text prefix."""
    formatter: logging.Formatter = (
        JsonFormatter() if str(fmt).strip().lower() == "json" else logging.Formatter(_TEXT_FORMAT)
    )
    for handler in logger.handlers:
        handler.setFormatter(formatter)


logger = logging.getLogger("unionml_tpu_torch")
_level, _level_warning = _resolve_level()
logger.setLevel(_level)
if not logger.handlers:  # re-imports (importlib.reload) must not stack handlers
    logger.addHandler(logging.StreamHandler())
set_log_format(os.environ.get("UNIONML_TPU_LOG_FORMAT", "text"))
if _level_warning:
    logger.warning(_level_warning)
