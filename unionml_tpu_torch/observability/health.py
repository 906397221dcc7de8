"""Per-engine and fleet-wide health: SLO state x saturation as one score.

A copy of ``unionml_tpu/observability/health.py``: the port never imports the
JAX package.

The signal the replica scheduler, ``GET /healthz``, ``GET /debug/fleet`` and
(through the roadmap's item 2) an autoscaler act on. Two inputs per engine:

- **SLO state** (observability/slo.py): is the engine meeting its declared
  latency/shed targets over the burn-rate windows;
- **saturation**: how much headroom is left — resident-slot occupancy, the
  waiting queue's fill, KV-pool block usage, and the prefill backlog
  normalized by the admission chunk (each already a gauge the engine keeps).

The score is ``state_factor * (1 - 0.5 * saturation)`` in ``[0, 1]``: an ok
engine ranges 1.0 (idle) down to 0.5 (fully saturated but still meeting its
SLOs — loaded is not unhealthy), a warn engine starts from 0.6, a breaching
engine from 0.2 — so any breaching replica scores strictly below any
non-breaching one, which is exactly the ordering the scheduler's
route-around-breach policy needs. Fleet health reports the mean score (the
autoscaling signal), the worst score, and the worst state (the paging
signal): a 4-replica fleet with one breach is ``state="breach"`` even though
its mean still looks comfortable.

Everything here is duck-typed over the engine surface (``occupancy()``,
``queued_prefill_tokens()``, ``timeseries``, ``slo``) so a
:class:`~unionml_tpu_torch.serving.continuous.ContinuousBatcher`, a
:class:`~unionml_tpu_torch.serving.replicas.ReplicaSet`, or a test double all work;
every leaf in every payload is numeric or a state string (strings are skipped
by the Prometheus exposition — ``state_code``/``score`` are the series), and
``None`` never appears.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from unionml_tpu_torch.observability.slo import STATE_CODES, worst_state

__all__ = ["STATE_FACTORS", "engine_health", "fleet_health", "fleet_debug", "merge_tenant_slo"]

#: SLO state -> score ceiling: breach < warn < ok with no overlap once the
#: saturation discount (at most 0.5x) is applied
STATE_FACTORS = {"ok": 1.0, "warn": 0.6, "breach": 0.2}

#: the health dict of an engine with telemetry disabled (slo=False): always
#: routable, never breaching — the pre-health-engine behavior
DISABLED: Dict[str, Any] = {
    "score": 1.0,
    "state": "ok",
    "state_code": 0,
    "enabled": False,
}


def _fraction(num: float, den: float) -> float:
    """num/den clipped into [0, 1]; 0.0 for a degenerate denominator."""
    if den <= 0:
        return 0.0
    return min(max(num / den, 0.0), 1.0)


def engine_health(engine: Any) -> Dict[str, Any]:
    """One engine's health: SLO evaluation + saturation gauges + fast-window
    rates, combined into the score. Called by
    ``ContinuousBatcher.health()`` (which caches it briefly — this walks a few
    locks and sorts the windowed reservoirs, so the per-submit routing path
    reads the cache, not this)."""
    timeseries = getattr(engine, "timeseries", None)
    tracker = getattr(engine, "slo", None)
    if timeseries is None or tracker is None:
        return dict(DISABLED)
    resident, waiting = engine.occupancy()
    slots = int(getattr(engine, "slots", 0) or 0)
    max_waiting = int(getattr(engine, "max_waiting", 0) or 0)
    backlog = int(engine.queued_prefill_tokens())
    saturation = {
        "slots": round(_fraction(resident, slots), 3),
        "waiting": round(_fraction(waiting, max_waiting), 3),
        # backlog in units of (admission chunks x slots): a full iteration of
        # queued prefill for every slot counts as saturated
        "prefill_backlog": round(
            _fraction(backlog, float(getattr(engine, "_load_norm", 0.0) or 1.0) * max(slots, 1)),
            3,
        ),
    }
    pool_blocks = getattr(engine, "pool_blocks", None)
    free_blocks = getattr(engine, "_free_blocks", None)
    if pool_blocks and free_blocks is not None:
        saturation["kv_blocks"] = round(
            _fraction(pool_blocks - len(free_blocks), pool_blocks), 3
        )
    worst_saturation = max(saturation.values())
    saturation["max"] = worst_saturation
    slo = (
        tracker.evaluate(timeseries)
        if tracker.armed
        else {"state": "ok", "state_code": 0, "breached_requests": tracker.breached_requests,
              "objectives": {}}
    )
    state = slo["state"]
    score = STATE_FACTORS.get(state, 0.0) * (1.0 - 0.5 * worst_saturation)
    return {
        "score": round(score, 3),
        "state": state,
        "state_code": STATE_CODES.get(state, 0),
        "enabled": True,
        "saturation": saturation,
        "slo": slo,
        "rates": engine.rates(),
    }


def _engines(batcher: Any) -> "List[Any]":
    """The per-replica engines behind a batcher-shaped object (a ReplicaSet's
    ``batchers`` tuple), or the object itself as a one-engine fleet."""
    replicas = getattr(batcher, "batchers", None)
    return list(replicas) if replicas is not None else [batcher]


def _replica_health(engine: Any, index: int) -> Dict[str, Any]:
    health_fn = getattr(engine, "health", None)
    health = health_fn() if callable(health_fn) else dict(DISABLED)
    entry = {"replica": index, **health}
    role = getattr(engine, "role", None)
    if role is not None:
        # disaggregated fleets: the replica's role rides every health entry
        # (a string — the Prometheus exposition skips it by design; the
        # numeric series stay score/state_code)
        entry["role"] = role
    return entry


def merge_tenant_slo(engines: "List[Any]") -> Dict[str, Any]:
    """Fleet-wide per-tenant SLO view: each tenant's WORST replica entry (a
    tenant breaching anywhere is breaching — the same worst-wins posture as
    the fleet state). ``{}`` when no engine tracks tenant targets, so the
    section stays absent on tenancy-off fleets (the byte-for-byte contract).
    Every entry is an engine's own evaluate() dict — numeric/state leaves
    only, never ``None``."""
    merged: Dict[str, Any] = {}
    for engine in engines:
        fn = getattr(engine, "tenant_slo", None)
        if not callable(fn):
            continue
        for tenant, entry in fn().items():
            current = merged.get(tenant)
            if current is None or int(entry.get("state_code", 0)) > int(current.get("state_code", 0)):
                merged[tenant] = entry
    return merged


def fleet_health(batcher: Optional[Any]) -> Dict[str, Any]:
    """The ``GET /healthz`` payload body: fleet score/state plus each
    replica's health (score, SLO states, saturation, windowed rates) and,
    when any tenant carries per-tenant targets, the fleet-wide ``tenant_slo``
    section (worst replica wins per tenant). A ``None`` batcher (an app with
    no generation engine) is a healthy empty fleet — the probe still
    answers, with the HTTP layer's own readiness."""
    if batcher is None:
        return {"score": 1.0, "worst_score": 1.0, "state": "ok", "state_code": 0, "replicas": []}
    engines = _engines(batcher)
    entries = [_replica_health(engine, i) for i, engine in enumerate(engines)]
    scores = [entry["score"] for entry in entries]
    state = worst_state(entry["state"] for entry in entries)
    out = {
        "score": round(sum(scores) / len(scores), 3),
        "worst_score": min(scores),
        "state": state,
        "state_code": STATE_CODES[state],
        "replicas": entries,
    }
    tenant_slo = merge_tenant_slo(engines)
    if tenant_slo:
        out["tenant_slo"] = tenant_slo
    return out


def fleet_debug(batcher: Optional[Any]) -> Dict[str, Any]:
    """The ``GET /debug/fleet`` payload: :func:`fleet_health` plus the routing
    view — per-replica live loads and the scheduler's telemetry — so one fetch
    answers "who is unhealthy AND where is traffic actually going"."""
    out: Dict[str, Any] = {"health": fleet_health(batcher)}
    if batcher is None:
        out["replicas"] = 0
        return out
    out["replicas"] = len(_engines(batcher))
    census_hosts = getattr(batcher, "host_census", None)
    if callable(census_hosts):
        # multi-host fleets (serving/cluster.py): the host table — who is
        # where, alive, what role, how many replicas — plus the coordinator's
        # failure/handoff counters, in the same debug fetch
        out["hosts"] = census_hosts()
        out["host_failures"] = int(getattr(batcher, "host_failures", 0))
        out["handoffs_cross_host"] = int(getattr(batcher, "cross_host_handoffs", 0))
    loads_fn = getattr(batcher, "replica_loads", None)
    if callable(loads_fn):
        out["replica_loads"] = loads_fn()
    scheduler = getattr(batcher, "_scheduler", None)
    if scheduler is not None and callable(getattr(scheduler, "stats", None)):
        out["scheduler"] = scheduler.stats()
    breach_avoided = getattr(batcher, "breach_avoided", None)
    if breach_avoided is not None:
        out["breach_avoided"] = int(breach_avoided)
    roles = getattr(batcher, "roles", None)
    if isinstance(roles, list) and any(role != "mixed" for role in roles):
        # disaggregated fleets: the role census and handoff telemetry in the
        # same debug fetch — "who is prefill, who is decode, and how much
        # work crossed between them" (cheap attribute reads, not a full
        # stats() walk)
        out["roles"] = list(roles)
        out["handoffs"] = {
            "routed": int(getattr(batcher, "handoff_routes", 0)),
            "shortcuts": int(getattr(batcher, "handoff_shortcuts", 0)),
            "exported": sum(
                int(getattr(engine, "handoffs_exported", 0)) for engine in _engines(batcher)
            ),
            "imported": sum(
                int(getattr(engine, "handoffs_imported", 0)) for engine in _engines(batcher)
            ),
        }
    census_fn = getattr(batcher, "tenant_census", None)
    if callable(census_fn):
        census = census_fn()
        if census:
            # multi-tenant QoS: per-tenant in-flight counts, bounded top-K by
            # live streams (resident + waiting) so unbounded tenant-id
            # cardinality can never grow the debug payload — omitted entirely
            # with no identified-tenant traffic, the QoS-off contract
            top_k = 16
            ranked = sorted(
                census.items(),
                key=lambda item: (-(item[1].get("resident", 0) + item[1].get("waiting", 0)), item[0]),
            )
            out["tenants"] = {tenant: counts for tenant, counts in ranked[:top_k]}
            if len(ranked) > top_k:
                out["tenants_omitted"] = len(ranked) - top_k
    scaled = int(getattr(batcher, "scaled_up", 0)) + int(getattr(batcher, "scaled_down", 0))
    if scaled:
        out["resize"] = {
            "scaled_up": int(getattr(batcher, "scaled_up", 0)),
            "scaled_down": int(getattr(batcher, "scaled_down", 0)),
        }
    return out
