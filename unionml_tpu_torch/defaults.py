"""Serve-time knobs read from the environment.

The subset of ``unionml_tpu/defaults.py`` that the port's ``Generator`` and
``ContinuousBatcher`` read. The serve CLI exports these before the app module
imports: every ``Generator`` the app builds resolves an unset ``quantize=``
and ``config.kv_cache_dtype`` from ``UNIONML_TPU_QUANTIZE`` and
``UNIONML_TPU_KV_CACHE_DTYPE``, and every engine resolves an unset
``admit_chunk``, ``prefill_budget``, ``max_admissions`` and ``prefix_cache``
from the four admission knobs below. A copy, not an import: the port never
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

#: admission prefill slice width in tokens; 0 = unset (fall back to
#: ``GenerationConfig.prefill_chunk``, else monolithic admission).
SERVE_ADMIT_CHUNK_ENV_VAR = "UNIONML_TPU_ADMIT_CHUNK"

#: prefill tokens the engine may run per iteration between decode dispatches;
#: 0 = unset (one admission chunk per iteration).
SERVE_PREFILL_BUDGET_ENV_VAR = "UNIONML_TPU_PREFILL_BUDGET"

#: concurrent partially-prefilled admissions; 0 = unset (one at a time).
SERVE_MAX_ADMISSIONS_ENV_VAR = "UNIONML_TPU_MAX_ADMISSIONS"

#: 1 = enable the radix prefix cache on paged continuous engines; 0/unset = off.
SERVE_PREFIX_CACHE_ENV_VAR = "UNIONML_TPU_PREFIX_CACHE"


def env_int(name: str, default: int, *, minimum: Optional[int] = None) -> int:
    """Parse an integer env var, tolerating garbage: unset/empty -> ``default``,
    a non-integer value warns and falls back to ``default`` instead of raising
    at whatever moment the knob happens to be read. ``minimum`` clamps the
    parsed value (with a warning)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        value = int(raw.strip())
    except ValueError:
        logger.warning(f"ignoring non-integer {name}={raw!r}; falling back to {default}")
        return default
    if minimum is not None and value < minimum:
        logger.warning(f"clamping {name}={value} to the minimum {minimum}")
        return minimum
    return value


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


def serve_admit_chunk() -> int:
    """Serve-time admission prefill chunk width; 0 = unset. Read at engine
    construction, after the CLI's export."""
    return env_int(SERVE_ADMIT_CHUNK_ENV_VAR, 0, minimum=0)


def serve_prefill_budget() -> int:
    """Serve-time per-iteration prefill-token budget; 0 = unset (one chunk)."""
    return env_int(SERVE_PREFILL_BUDGET_ENV_VAR, 0, minimum=0)


def serve_max_admissions() -> int:
    """Serve-time cap on concurrent partially-prefilled admissions; 0 = unset."""
    return env_int(SERVE_MAX_ADMISSIONS_ENV_VAR, 0, minimum=0)


def serve_prefix_cache() -> bool:
    """Whether the serve-time radix prefix cache is on
    (``UNIONML_TPU_PREFIX_CACHE=1``), read at engine construction."""
    return env_int(SERVE_PREFIX_CACHE_ENV_VAR, 0, minimum=0) > 0
