"""Serve-time knobs read from the environment.

The subset of ``unionml_tpu/defaults.py`` that the port's ``Generator``
reads: the serve CLI exports ``UNIONML_TPU_QUANTIZE`` and
``UNIONML_TPU_KV_CACHE_DTYPE`` before the app module imports, and every
``Generator`` the app builds resolves an unset ``quantize=`` and
``config.kv_cache_dtype`` from them. A copy, not an import: the port never
imports the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

#: "int8" = weight-only int8 for serving Generators (ops/quant.py:
#: per-channel symmetric); "none"/unset = full precision. Garbage values warn
#: and fall back (never crash serve at app-import time); explicit API calls
#: still raise the Generator's own "unsupported quantize mode" ValueError.
SERVE_QUANTIZE_ENV_VAR = "UNIONML_TPU_QUANTIZE"

#: "int8" = int8 KV cache (per-(position, head) symmetric scales, dense rows
#: and paged pools both); "none"/unset = the compute dtype. Same
#: warn-and-fall-back contract.
SERVE_KV_CACHE_DTYPE_ENV_VAR = "UNIONML_TPU_KV_CACHE_DTYPE"


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
