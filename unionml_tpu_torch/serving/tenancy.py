"""Multi-tenant QoS: tenant identity, per-tenant token buckets, fair shares.

A copy of ``unionml_tpu/serving/tenancy.py`` (the port never imports the JAX
package). Without it every request is anonymous and equal: overload shedding
(serving/overload.py) is global, and one hostile client bursting requests
FIFO-starves everyone behind it. This module is the tenancy layer the rest of
the serving stack keys on:

- **identity**: :func:`resolve_tenant` extracts a tenant id from the request
  headers — ``X-Tenant-Id`` wins; else an ``Authorization: Bearer`` key maps
  through the registry's ``api_keys`` table, or (unmapped) derives a stable
  non-reversible id from the key's digest, so the OpenAI SDK's ``api_key`` IS
  the tenant identity without the secret ever reaching traces or metrics. The
  id and the ``X-Priority`` tier ride contextvars down the stack exactly like
  the request id (observability/trace.py);
- **rate limits**: :class:`TenantRegistry` holds per-tenant token buckets —
  requests/s and generated-tokens/s, lazily refilled — in a BOUNDED map with
  idle eviction (the registry dogfoods tpu-lint TPU009: a tenant-keyed dict
  must have an eviction path). A bucket miss sheds with
  :class:`~unionml_tpu_torch.serving.overload.TenantThrottled` (HTTP 429) whose
  ``Retry-After`` is computed from that bucket's actual refill time;
- **fair shares**: per-tenant ``weight`` drives the continuous engine's
  deficit-round-robin admission (serving/continuous.py) so a burst from one
  tenant no longer starves the rest, and ``priority`` sets a request's default
  tier (``high``/``normal``/``batch``) — a high-priority admission may preempt
  a lowest-priority resident through the engine's existing paged
  preempt/exact-width-resume machinery (the preempted stream resumes
  token-identically, never truncates).

Zero-cost off contract: with no registry installed and no tenancy headers,
every request runs with ``current_tenant()`` and ``current_priority()`` both
``None``, the engine's admission stays plain FIFO, and no stats section or
trace attribute changes — byte-for-byte today's serving stack (the same
contract every serve-time knob in this repo holds to).

Anonymous traffic (no tenant headers) is never bucket-limited — it rides the
global overload posture (serving/overload.py) — but it does participate in the fair-share
round as one pseudo-tenant, so identified tenants cannot starve it either.
"""

from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from unionml_tpu_torch._logging import logger

__all__ = [
    "PRIORITIES",
    "PRIORITY_BATCH",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "TenantRegistry",
    "TenantSpec",
    "active_registry",
    "bind_tenant",
    "current_priority",
    "current_tenant",
    "priority_name",
    "resolve_tenant",
    "sanitize_tenant_id",
    "set_active_registry",
    "unbind_tenant",
]

#: the wire headers (lower-cased, the serving stack's header-dict convention)
TENANT_HEADER = "x-tenant-id"
PRIORITY_HEADER = "x-priority"
AUTHORIZATION_HEADER = "authorization"

#: priority tiers, ordered: LOWER value = served (and preempts) first
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_BATCH = 2
PRIORITIES: "Dict[str, int]" = {
    "high": PRIORITY_HIGH,
    "normal": PRIORITY_NORMAL,
    "batch": PRIORITY_BATCH,
}
_PRIORITY_NAMES = {v: k for k, v in PRIORITIES.items()}

#: tenant ids echo into traces, metrics names, and debug payloads — same
#: sanitization posture as request ids (trace.py)
_MAX_TENANT_LEN = 64

_tenant_var: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "unionml_tpu_tenant", default=None
)
_priority_var: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "unionml_tpu_priority", default=None
)


def current_tenant() -> Optional[str]:
    """The tenant id of the request currently being handled (contextvar)."""
    return _tenant_var.get()


def current_priority() -> Optional[int]:
    """The priority tier of the active request (``None`` = unset/normal)."""
    return _priority_var.get()


def bind_tenant(tenant: Optional[str], priority: Optional[int]) -> "Tuple[Any, Any]":
    """Set the tenant/priority contextvars; returns reset tokens for
    :func:`unbind_tenant`. Called by the HTTP layer around each handler."""
    return _tenant_var.set(tenant), _priority_var.set(priority)


def unbind_tenant(tokens: "Tuple[Any, Any]") -> None:
    _tenant_var.reset(tokens[0])
    _priority_var.reset(tokens[1])


def priority_name(priority: Optional[int]) -> str:
    return _PRIORITY_NAMES.get(
        PRIORITY_NORMAL if priority is None else priority, "normal"
    )


def parse_priority(raw: str) -> int:
    """An ``X-Priority`` header value -> tier; raises ``ValueError`` on
    garbage (an explicit bad header is a usage error, not something to guess)."""
    tier = PRIORITIES.get(raw.strip().lower())
    if tier is None:
        raise ValueError(
            f"unknown priority {raw!r}; expected one of {sorted(PRIORITIES)}"
        )
    return tier


def sanitize_tenant_id(raw: Optional[str]) -> Optional[str]:
    """An inbound tenant id made safe to echo into headers/metrics/traces:
    same character policy as request ids, bounded length."""
    from unionml_tpu_torch.observability.trace import sanitize_request_id

    kept = sanitize_request_id(raw)
    return kept[:_MAX_TENANT_LEN] if kept else None


def resolve_tenant(
    headers: "Dict[str, str]", registry: "Optional[TenantRegistry]" = None
) -> Optional[str]:
    """Tenant identity from request headers. ``X-Tenant-Id`` (sanitized) wins;
    else an ``Authorization: Bearer <key>`` maps through the registry's
    ``api_keys`` table when one is configured, falling back to a stable
    digest-derived id (``key-<12 hex>``) so distinct API keys become distinct
    tenants WITHOUT the secret itself ever reaching traces or metrics.
    ``None`` = anonymous."""
    explicit = sanitize_tenant_id(headers.get(TENANT_HEADER))
    if explicit:
        return explicit
    auth = headers.get(AUTHORIZATION_HEADER)
    if not auth:
        return None
    scheme, _, credential = auth.strip().partition(" ")
    credential = credential.strip()
    if scheme.lower() != "bearer" or not credential:
        return None
    if registry is not None:
        mapped = registry.tenant_for_key(credential)
        if mapped is not None:
            return mapped
    digest = hashlib.sha256(credential.encode("utf-8", "replace")).hexdigest()[:12]
    return f"key-{digest}"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS contract.

    ``weight`` is the fair share driving deficit-round-robin admission (0 =
    best-effort: served only when no weighted tenant is waiting in the same
    tier). ``req_per_s``/``tokens_per_s`` are bucket refill rates (0 =
    unlimited); ``burst_s`` sizes each bucket's capacity as ``rate * burst_s``
    (never below one request / one token, so a conforming tenant is never shed
    from a cold start). ``priority`` is the DEFAULT tier for the tenant's
    requests — an explicit ``X-Priority`` header always wins.

    ``slo_ttft_p95_ms``/``slo_tbt_p99_ms``/``slo_shed_ratio`` are optional
    PER-TENANT SLO targets (docs/observability.md "SLOs and fleet health"):
    when any is set, every continuous engine keys a per-tenant burn-rate
    tracker for this tenant (bounded LRU — the TPU009 discipline), its
    verdicts ride ``stats()["tenant_slo"]`` → ``/metrics`` and ``/healthz``,
    and the traffic replayer judges the tenant against the same numbers.
    ``None``/0 = no per-tenant target (the tenant rides the engine-level SLO
    alone — byte-for-byte today's behavior)."""

    weight: float = 1.0
    req_per_s: float = 0.0
    tokens_per_s: float = 0.0
    burst_s: float = 2.0
    priority: str = "normal"
    slo_ttft_p95_ms: Optional[float] = None
    slo_tbt_p99_ms: Optional[float] = None
    slo_shed_ratio: Optional[float] = None

    def __post_init__(self) -> None:
        if self.weight < 0:
            raise ValueError("tenant weight must be >= 0")
        if self.req_per_s < 0 or self.tokens_per_s < 0:
            raise ValueError("tenant rates must be >= 0 (0 = unlimited)")
        if self.burst_s <= 0:
            raise ValueError("burst_s must be > 0")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {self.priority!r}; expected one of {sorted(PRIORITIES)}"
            )
        for name in ("slo_ttft_p95_ms", "slo_tbt_p99_ms", "slo_shed_ratio"):
            value = getattr(self, name)
            if value is not None and value < 0:
                raise ValueError(f"tenant {name} must be >= 0 (None/0 = disarmed)")

    def slo_config(self) -> "Optional[Any]":
        """This tenant's targets as an
        :class:`~unionml_tpu_torch.observability.slo.SLOConfig` (windows/min-samples
        from the serve-wide ``UNIONML_TPU_SLO_*`` exports, so per-tenant and
        engine-level evaluation share one burn-rate clock); ``None`` when no
        per-tenant objective is armed — no tracker is ever created for such a
        tenant, which is what keeps target-less registries byte-for-byte
        off."""
        if not any((self.slo_ttft_p95_ms, self.slo_tbt_p99_ms, self.slo_shed_ratio)):
            return None
        from unionml_tpu_torch.observability.slo import SLOConfig

        base = SLOConfig.from_env()
        return SLOConfig(
            ttft_p95_ms=self.slo_ttft_p95_ms or None,
            tbt_p99_ms=self.slo_tbt_p99_ms or None,
            shed_ratio=self.slo_shed_ratio or None,
            fast_window_s=base.fast_window_s,
            slow_window_s=base.slow_window_s,
            min_samples=base.min_samples,
        )


class _TenantState:
    """One tenant's live buckets + counters (registry lock guards access)."""

    __slots__ = (
        "spec", "req_tokens", "gen_tokens", "last_refill", "last_seen",
        "admitted", "shed", "generated_tokens", "refunded",
    )

    def __init__(self, spec: TenantSpec, now: float):
        self.spec = spec
        self.req_tokens = max(spec.req_per_s * spec.burst_s, 1.0)
        self.gen_tokens = max(spec.tokens_per_s * spec.burst_s, 1.0)
        self.last_refill = now
        self.last_seen = now
        self.admitted = 0
        self.shed = 0
        self.generated_tokens = 0
        self.refunded = 0

    def refill(self, now: float) -> None:
        elapsed = max(now - self.last_refill, 0.0)
        self.last_refill = now
        if self.spec.req_per_s > 0:
            cap = max(self.spec.req_per_s * self.spec.burst_s, 1.0)
            self.req_tokens = min(cap, self.req_tokens + elapsed * self.spec.req_per_s)
        if self.spec.tokens_per_s > 0:
            cap = max(self.spec.tokens_per_s * self.spec.burst_s, 1.0)
            self.gen_tokens = min(cap, self.gen_tokens + elapsed * self.spec.tokens_per_s)


class TenantRegistry:
    """Per-tenant QoS state: specs, token buckets, counters — bounded.

    ``tenants`` maps names to :class:`TenantSpec`; any OTHER identified tenant
    gets ``default_spec`` (the ``serve --default-tenant-rate`` contract).
    ``api_keys`` maps ``Authorization: Bearer`` credentials to tenant names.
    The live state map is bounded at ``max_tenants`` with least-recently-SEEN
    eviction (plus ``idle_evict_s`` aging on every admission), so unbounded
    tenant-id cardinality — a scanner minting fresh ids per request — cannot
    grow host memory: exactly the bug class tpu-lint TPU009 exists for, and
    this map is its dogfood. Thread-safe; ``clock`` injectable for tests."""

    def __init__(
        self,
        tenants: "Optional[Dict[str, TenantSpec]]" = None,
        *,
        default_spec: Optional[TenantSpec] = None,
        api_keys: "Optional[Dict[str, str]]" = None,
        max_tenants: int = 256,
        idle_evict_s: float = 3600.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        if idle_evict_s <= 0:
            raise ValueError("idle_evict_s must be > 0")
        self.specs: "Dict[str, TenantSpec]" = dict(tenants or {})
        self.default_spec = default_spec if default_spec is not None else TenantSpec()
        self._api_keys: "Dict[str, str]" = dict(api_keys or {})
        self.max_tenants = max_tenants
        self.idle_evict_s = idle_evict_s
        self._clock = clock
        self._lock = threading.Lock()
        #: tenant -> live state, least-recently-seen first (move_to_end on
        #: every touch; eviction pops from the front)
        self._states: "OrderedDict[str, _TenantState]" = OrderedDict()
        self.evicted = 0

    # ------------------------------------------------------------------ config

    @classmethod
    def from_file(
        cls, path: str, *, default_rate: float = 0.0, **kwargs: Any
    ) -> "TenantRegistry":
        """Build from a ``tenants.json``::

            {
              "default": {"req_per_s": 10, "weight": 1},
              "tenants": {
                "acme":    {"weight": 2, "req_per_s": 50, "tokens_per_s": 2000},
                "batchco": {"weight": 0, "req_per_s": 5, "priority": "batch"}
              },
              "api_keys": {"sk-acme-123": "acme"}
            }

        ``default_rate`` (the ``--default-tenant-rate`` flag) fills the
        default spec's ``req_per_s`` when the file declares no ``default``."""
        with open(path) as handle:
            raw = json.load(handle)
        if not isinstance(raw, dict):
            raise ValueError(f"tenant config {path} must be a JSON object")
        tenants = {
            str(name): TenantSpec(**spec)
            for name, spec in (raw.get("tenants") or {}).items()
        }
        default_raw = raw.get("default")
        if default_raw is not None:
            default_spec = TenantSpec(**default_raw)
        else:
            default_spec = TenantSpec(req_per_s=float(default_rate))
        api_keys = {str(k): str(v) for k, v in (raw.get("api_keys") or {}).items()}
        return cls(tenants, default_spec=default_spec, api_keys=api_keys, **kwargs)

    @classmethod
    def from_env(cls) -> "Optional[TenantRegistry]":
        """The serve-time registry from the early-export env contract
        (``UNIONML_TPU_TENANT_CONFIG`` / ``_DEFAULT_TENANT_RATE``); ``None``
        when neither is set — tenancy off. A bad config file warns and falls
        back to rate-only (an inherited fleet-wide export must not crash
        serve at app-import time, the established degrade posture)."""
        from unionml_tpu_torch.defaults import serve_default_tenant_rate, serve_tenant_config

        path = serve_tenant_config()
        rate = serve_default_tenant_rate()
        if path is None and rate <= 0:
            return None
        if path is not None:
            try:
                return cls.from_file(path, default_rate=rate)
            except (OSError, ValueError, TypeError) as exc:
                logger.warning(
                    f"ignoring tenant config {path!r} ({exc}); falling back to "
                    f"--default-tenant-rate={rate} only"
                )
        return cls(default_spec=TenantSpec(req_per_s=rate))

    def tenant_for_key(self, credential: str) -> Optional[str]:
        return self._api_keys.get(credential)

    def spec(self, tenant: Optional[str]) -> TenantSpec:
        if tenant is None:
            return self.default_spec
        return self.specs.get(tenant, self.default_spec)

    def weight(self, tenant: Optional[str]) -> float:
        """The fair-share weight the engine's deficit-round-robin uses;
        anonymous traffic rounds at weight 1 (it cannot be starved either)."""
        if not tenant:
            return 1.0
        return self.spec(tenant).weight

    def default_priority(self, tenant: Optional[str]) -> int:
        return PRIORITIES[self.spec(tenant).priority]

    # ------------------------------------------------------------------ buckets

    def _state_locked(self, tenant: str, now: float) -> _TenantState:
        state = self._states.get(tenant)
        if state is None:
            state = _TenantState(self.spec(tenant), now)
            self._states[tenant] = state
            self._evict_locked(now)
        else:
            state.last_seen = now
        self._states.move_to_end(tenant)
        return state

    def _evict_locked(self, now: float) -> None:
        """Bound the state map: drop idle tenants past ``idle_evict_s``, then
        least-recently-seen entries beyond ``max_tenants`` (their counters
        restart if they return — bounded memory beats perfect lifetime
        totals)."""
        while self._states:
            tenant, state = next(iter(self._states.items()))
            if now - state.last_seen > self.idle_evict_s:
                self._states.pop(tenant)
                self.evicted += 1
                continue
            break
        while len(self._states) > self.max_tenants:
            self._states.popitem(last=False)
            self.evicted += 1

    def try_admit(self, tenant: Optional[str], now: Optional[float] = None) -> Optional[float]:
        """Charge one request against ``tenant``'s buckets. ``None`` = admitted
        (the request bucket was debited); else the seconds until a retry could
        succeed — computed from the LIMITING bucket's actual refill rate, the
        value the 429's ``Retry-After`` carries. Anonymous requests are never
        limited. A failed admission leaves the buckets untouched (so a
        replica-walk retry is not double-charged) and bumps the tenant's shed
        counter."""
        if tenant is None:
            return None
        if now is None:
            now = self._clock()
        with self._lock:
            state = self._state_locked(tenant, now)
            state.refill(now)
            spec = state.spec
            if spec.req_per_s > 0 and state.req_tokens < 1.0:
                state.shed += 1
                return max((1.0 - state.req_tokens) / spec.req_per_s, 0.001)
            if spec.tokens_per_s > 0 and state.gen_tokens < 1.0:
                # generated-token debt: emissions post-charge this bucket, so
                # a long stream can overdraw — new admissions wait out the debt
                state.shed += 1
                return max((1.0 - state.gen_tokens) / spec.tokens_per_s, 0.001)
            if spec.req_per_s > 0:
                state.req_tokens -= 1.0
            state.admitted += 1
            return None

    def refund(self, tenant: Optional[str], now: Optional[float] = None) -> None:
        """Undo one :meth:`try_admit` charge: credit the request token back.

        For requests that were charged but never served — an exception between
        the successful admission and the stream actually entering the batch.
        Without the refund such failures silently erode the tenant's effective
        rate below its configured floor ("never double-charge, never charge on
        shed" — and never charge for work that was not done).  The credit is
        capped at the bucket's burst capacity, so a stray double refund cannot
        mint extra burst; a tenant evicted between charge and refund is a
        no-op (its bucket state is gone, and a fresh state starts full)."""
        if tenant is None:
            return
        if now is None:
            now = self._clock()
        with self._lock:
            state = self._states.get(tenant)
            if state is None:
                return
            state.last_seen = now
            if state.spec.req_per_s > 0:
                cap = max(state.spec.req_per_s * state.spec.burst_s, 1.0)
                state.req_tokens = min(cap, state.req_tokens + 1.0)
            state.refunded += 1

    def charge_tokens(self, tenant: Optional[str], n: int, now: Optional[float] = None) -> None:
        """Debit ``n`` generated tokens (called at engine emission sites).
        The bucket may go negative — debt that :meth:`try_admit` makes new
        admissions wait out — which is what makes a tokens/s limit meaningful
        for streams whose length is unknown at admission."""
        if tenant is None or n <= 0:
            return
        if now is None:
            now = self._clock()
        with self._lock:
            state = self._state_locked(tenant, now)
            state.generated_tokens += int(n)
            if state.spec.tokens_per_s > 0:
                state.refill(now)
                state.gen_tokens -= float(n)

    # ------------------------------------------------------------------ telemetry

    def stats(self) -> "Dict[str, Any]":
        """Bounded per-tenant counters for ``/metrics`` (the map itself is
        bounded at ``max_tenants``, so the label cardinality the Prometheus
        exposition mints is too)."""
        with self._lock:
            tenants = {
                tenant: {
                    "admitted": state.admitted,
                    "shed": state.shed,
                    "generated_tokens": state.generated_tokens,
                    "refunded": state.refunded,
                    "weight": state.spec.weight,
                }
                for tenant, state in self._states.items()
            }
            return {
                "count": len(tenants),
                "evicted": self.evicted,
                "max_tenants": self.max_tenants,
                "per_tenant": tenants,
            }


#: the process-wide registry, installed by the serving app (the same pattern
#: as observability.recorder's active recorder): engines built by app code
#: consult it at submit time without construction wiring. None = tenancy off.
_active: "Optional[TenantRegistry]" = None
_active_lock = threading.Lock()


def set_active_registry(registry: "Optional[TenantRegistry]") -> None:
    global _active
    with _active_lock:
        _active = registry


def active_registry() -> "Optional[TenantRegistry]":
    with _active_lock:
        return _active
