"""Default execution settings and serve-time knobs read from the environment.

The subset of ``unionml_tpu/defaults.py`` that the port reads:

- ``Resources``, ``DEFAULT_RESOURCES`` and ``MODEL_PATH_ENV_VAR`` for the app
  protocol (``stage.py``, ``model.py``);
- the serve CLI's exports, read when an object is built, after the CLI has
  set them: every ``Generator`` resolves an unset ``quantize=`` and
  ``config.kv_cache_dtype`` from ``UNIONML_TPU_QUANTIZE`` and
  ``UNIONML_TPU_KV_CACHE_DTYPE``; every engine resolves an unset
  ``admit_chunk``, ``prefill_budget``, ``max_admissions`` and
  ``prefix_cache`` from the four admission knobs, and reads the replica
  exports ``UNIONML_TPU_DP_REPLICAS`` and ``UNIONML_TPU_REPLICA_ROLES``.

A copy, not an import: the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Resources:
    """Resource request attached to a :class:`unionml_tpu_torch.stage.Stage`.

    The JAX package's fields, kept for the stage interface: ``accelerator``
    names an accelerator topology and ``chips`` how many; ``None`` means
    host-only execution, the default for data-plumbing stages. Nothing in
    the port schedules on them yet (the remote backend is ROADMAP.md, Queue A).
    """

    cpu: str = "1"
    mem: str = "1Gi"
    accelerator: Optional[str] = None
    chips: int = 0


DEFAULT_RESOURCES = Resources()

#: Environment variable used by ``load_from_env`` (and the serve CLI), the
#: name the JAX package and UnionML use.
MODEL_PATH_ENV_VAR = "UNIONML_MODEL_PATH"

#: the serve CLI's ``--dp-replicas`` export: a count above 1 asks for that
#: many engine replicas
SERVE_DP_REPLICAS_ENV_VAR = "UNIONML_TPU_DP_REPLICAS"

#: the serve CLI's ``--replica-roles`` export, e.g. ``prefill=1,decode=3``
#: (roles: prefill / decode / mixed; the counts sum to the fleet size)
SERVE_REPLICA_ROLES_ENV_VAR = "UNIONML_TPU_REPLICA_ROLES"

#: roles a replica may carry; "mixed" prefills and decodes in one engine
REPLICA_ROLES = ("prefill", "decode", "mixed")

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


def serve_dp_replicas() -> int:
    """The serve-time data-parallel replica override; 0 = unset. Read at
    engine construction; garbage (``UNIONML_TPU_DP_REPLICAS=abc``) warns and
    falls back to 0."""
    return env_int(SERVE_DP_REPLICAS_ENV_VAR, 0, minimum=0)


def parse_replica_roles(raw: str) -> Dict[str, int]:
    """Parse a ``prefill=1,decode=3`` role spec into ``{role: count}``.
    Raises ``ValueError`` naming the offending entry; the env reader below
    degrades instead."""
    out: Dict[str, int] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        role, sep, count = entry.partition("=")
        role = role.strip().lower()
        if not sep or role not in REPLICA_ROLES:
            raise ValueError(
                f"bad replica-role entry {entry!r}; expected role=count with role in "
                f"{REPLICA_ROLES} (e.g. 'prefill=1,decode=3')"
            )
        try:
            n = int(count.strip())
        except ValueError:
            raise ValueError(f"bad replica-role count in {entry!r}; expected an integer")
        if n < 0:
            raise ValueError(f"replica-role count must be >= 0 in {entry!r}")
        out[role] = out.get(role, 0) + n
    return {role: n for role, n in out.items() if n > 0}


def serve_replica_roles() -> Dict[str, int]:
    """The serve-time ``--replica-roles`` export parsed to ``{role: count}``;
    ``{}`` = unset. Garbage warns and falls back to ``{}``."""
    raw = os.environ.get(SERVE_REPLICA_ROLES_ENV_VAR)
    if raw is None or not raw.strip():
        return {}
    try:
        return parse_replica_roles(raw)
    except ValueError as exc:
        logger.warning(
            f"ignoring {SERVE_REPLICA_ROLES_ENV_VAR}={raw!r} ({exc}); "
            "falling back to a symmetric (all-mixed) fleet"
        )
        return {}
