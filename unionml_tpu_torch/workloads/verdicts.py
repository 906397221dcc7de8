"""Replay verdicts: per-tenant observed-vs-target judgment for a finite run.

A copy of ``unionml_tpu/workloads/verdicts.py`` over the port's
``observability/slo.py``.

The live SLO engine (observability/slo.py) evaluates *windows* with
multi-window burn rates, because a server's life has no end. A replay does end
— so its judgment is simpler and stricter: for every tenant with declared
targets, compare the whole run's observed TTFT p95 / TBT p99 / shed ratio
against the target, report the **burn rate** (observed/target, the same
convention the live tracker uses), and classify:

- ``pass``   — burn <= 1.0 (at or under target);
- ``warn``   — 1.0 < burn <= ``warn_factor`` (default 1.2: over target, but
  within the slack a noisy CPU-substrate run is allowed);
- ``breach`` — burn > ``warn_factor``.

A tenant whose objective saw fewer than ``min_samples`` observations cannot
breach on it (the live tracker's idle-is-healthy gate, applied to a run) —
the objective reports ``"samples"`` short and passes. Every leaf is numeric
or a state string, never ``None`` (the /metrics exposition contract, kept
here so a verdict block can ride straight into BENCH_ALL.json or a scrape).

This is what turns a replay from *numbers* into a *judgment*: the
``traffic_replay`` bench lane gates on "every well-behaved tenant passes
while the hostile tenant sheds", and any future perf PR that regresses a
tenant's latency flips that tenant's verdict — visibly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence

from unionml_tpu_torch.observability.slo import STATE_CODES, worst_state

__all__ = ["OBJECTIVES", "availability", "overall_state", "tenant_verdicts"]

#: objective name -> (per-tenant metric section, metric key within it);
#: shed_ratio reads the flat per-tenant counter instead of a latency window
OBJECTIVES = ("ttft_p95_ms", "tbt_p99_ms", "shed_ratio")

#: verdict states reuse the live SLO machine's vocabulary, with "pass"
#: standing in for "ok" (a finished run is judged, not monitored)
_STATE_BY_CODE = {0: "pass", 1: "warn", 2: "breach"}


def _observe(metrics: "Dict[str, Any]", objective: str) -> "tuple[float, int]":
    """(observed value, samples) for one objective from a replay's per-tenant
    metrics block (workloads/replayer.py shape)."""
    if objective == "ttft_p95_ms":
        window = metrics.get("ttft_ms") or {}
        return float(window.get("p95_ms", 0.0)), int(window.get("n", 0))
    if objective == "tbt_p99_ms":
        window = metrics.get("tbt_ms") or {}
        return float(window.get("p99_ms", 0.0)), int(window.get("n", 0))
    return float(metrics.get("shed_ratio", 0.0)), int(metrics.get("requests", 0))


def tenant_verdicts(
    per_tenant: "Dict[str, Dict[str, Any]]",
    targets: "Dict[str, Dict[str, float]]",
    *,
    warn_factor: float = 1.2,
    min_samples: int = 1,
) -> "Dict[str, Dict[str, Any]]":
    """Judge every targeted tenant: ``{tenant: {state, state_code,
    objectives: {name: {target, observed, burn_rate, samples, state, ...}}}}``.

    Tenants in ``targets`` but absent from the run are judged ``breach`` with
    zero samples on a synthetic ``missing`` objective — a replay that never
    exercised a tenant it promised to judge must not silently pass it."""
    if warn_factor < 1.0:
        raise ValueError("warn_factor must be >= 1.0 (pass ends at burn 1.0)")
    if min_samples < 1:
        raise ValueError("min_samples must be >= 1")
    out: "Dict[str, Dict[str, Any]]" = {}
    for tenant, tenant_targets in sorted(targets.items()):
        metrics = per_tenant.get(tenant)
        if metrics is None:
            out[tenant] = {
                "state": "breach",
                "state_code": STATE_CODES["breach"],
                "objectives": {
                    "missing": {"samples": 0, "state": "breach", "state_code": 2}
                },
            }
            continue
        objectives: "Dict[str, Any]" = {}
        for name in OBJECTIVES:
            target = tenant_targets.get(name)
            if not target:
                continue
            observed, samples = _observe(metrics, name)
            burn = observed / float(target)
            if samples < min_samples:
                state = "pass"  # too little evidence to convict (idle-is-healthy)
            elif burn <= 1.0:
                state = "pass"
            elif burn <= warn_factor:
                state = "warn"
            else:
                state = "breach"
            objectives[name] = {
                "target": float(target),
                "observed": round(observed, 4),
                "burn_rate": round(burn, 3),
                "samples": samples,
                "state": state,
                "state_code": STATE_CODES["breach" if state == "breach" else ("warn" if state == "warn" else "ok")],
            }
        worst = worst_state(
            "breach" if entry["state"] == "breach" else ("warn" if entry["state"] == "warn" else "ok")
            for entry in objectives.values()
        )
        out[tenant] = {
            "state": _STATE_BY_CODE[STATE_CODES[worst]],
            "state_code": STATE_CODES[worst],
            "objectives": objectives,
        }
    return out


def overall_state(verdicts: "Dict[str, Dict[str, Any]]") -> str:
    """The run's headline judgment: the worst tenant state (``pass`` for an
    empty verdict block — no targets declared means nothing to fail)."""
    worst = max((entry["state_code"] for entry in verdicts.values()), default=0)
    return _STATE_BY_CODE[int(worst)]


def availability(
    samples: "Iterable[Dict[str, Any]]",
    *,
    fault_times_s: "Sequence[float]" = (),
    target: float = 0.99,
) -> "Dict[str, Any]":
    """The chaos-replay judgment: did the fleet degrade *gracefully*?

    ``samples`` is one dict per replayed request (the replayer's shape):
    ``tenant``, ``status`` (HTTP status, or ``None`` for a transport-level
    failure — the unclean kind), ``start_s`` (launch offset from replay t0)
    and ``ttft_s`` (``None`` when no token arrived). Three judgments:

    - **success ratio** — fraction of requests answered 200, overall and per
      tenant (the per-tenant view is what the ``fleet_chaos`` lane gates at
      ``target`` for well-behaved tenants: a kill-and-rejoin plan may cost a
      beat of latency, not answers);
    - **clean-error ratio** — of the requests that did NOT succeed, the
      fraction that failed *cleanly* (a real HTTP error record — the
      coordinator's 503-shaped :class:`StreamInterrupted` posture) rather
      than a hang or transport drop (1.0 when nothing failed);
    - **recovery** — for each fault onset in ``fault_times_s``, the virtual
      milliseconds until the first request LAUNCHED after the fault got its
      first routed token (``recovered: 0`` and no ``recovery_ms`` key when
      nothing after that fault ever streamed — absent, never ``None``).

    Every leaf is numeric or bool-as-int — the /metrics exposition contract,
    so an availability block rides straight into BENCH_ALL.json."""
    rows = list(samples)
    per_tenant: "Dict[str, Dict[str, Any]]" = {}
    ok = hangs = clean = 0
    for row in rows:
        tenant = str(row.get("tenant") or "anonymous")
        entry = per_tenant.setdefault(tenant, {"requests": 0, "ok": 0})
        entry["requests"] += 1
        if row.get("status") == 200:
            ok += 1
            entry["ok"] += 1
        elif row.get("status") is None:
            hangs += 1
        else:
            clean += 1
    for entry in per_tenant.values():
        entry["success_ratio"] = (
            round(entry["ok"] / entry["requests"], 4) if entry["requests"] else 1.0
        )
        entry["meets_target"] = int(entry["success_ratio"] >= target)
    recovery: "list[Dict[str, Any]]" = []
    for fault_t in sorted(float(t) for t in fault_times_s):
        first: "Optional[float]" = None
        for row in rows:
            start = row.get("start_s")
            ttft = row.get("ttft_s")
            if start is None or ttft is None or float(start) < fault_t:
                continue
            arrived = float(start) + float(ttft)
            if first is None or arrived < first:
                first = arrived
        entry = {"fault_t_s": round(fault_t, 3), "recovered": int(first is not None)}
        if first is not None:
            entry["recovery_ms"] = round(max(first - fault_t, 0.0) * 1e3, 3)
        recovery.append(entry)
    failed = len(rows) - ok
    out: "Dict[str, Any]" = {
        "requests": len(rows),
        "ok": ok,
        "success_ratio": round(ok / len(rows), 4) if rows else 1.0,
        "clean_errors": clean,
        "hangs": hangs,
        "clean_error_ratio": round(clean / failed, 4) if failed else 1.0,
        "target": float(target),
        "per_tenant": per_tenant,
    }
    if recovery:
        out["recovery"] = recovery
        recovered = [e["recovery_ms"] for e in recovery if "recovery_ms" in e]
        if recovered:
            out["recovery_ms_max"] = max(recovered)
    return out
