"""Scenario library: parameterized, seeded generators of traffic traces.

A copy of ``unionml_tpu/workloads/scenarios.py``: the same registry, the
same draws in the same order from one ``random.Random(seed)``, so
:func:`synthesize_text` gives the JAX package's bytes for every scenario.

Recorded traffic is the gold standard, but a reproduction also needs
*synthetic-yet-realistic* mixes it can regenerate anywhere — so each scenario
here is a pure function of ``(spec params, seed)`` producing a list of
:class:`~unionml_tpu_torch.workloads.traces.TraceRequest`. Determinism is the
contract: every draw goes through one ``random.Random(seed)``, serialization
is canonical, and the same spec + seed yields **byte-identical** trace files
— which is what lets two replays months apart run literally the same
traffic.

The shipped mixes each stress a different subsystem the serving stack has
grown:

- ``chat_multiturn`` — session-linked turns that re-send conversation history
  (the replayer accumulates prompt + completion per session), exercising the
  radix prefix cache's decode-side insertion and, in a fleet, warm-turn
  session-affinity routing;
- ``rag_long_prompt`` — few requests, heavy prompts, small budgets: prefill-
  dominated traffic that exercises chunked prefill and the prefill→decode
  disaggregated handoff;
- ``burst_tenants`` — one hostile tenant lands a 10× backlog at t≈0 over
  well-behaved closed-cadence tenants: the DRR fairness + per-tenant bucket
  shed path, with per-tenant SLO verdicts splitting the two populations;
- ``deadline_heavy`` — tight ``X-Request-Deadline-Ms`` values, some
  infeasible by construction: the deadline shed paths (submit, waiting,
  mid-prefill) under realistic arrival pressure.

``synthesize(name, seed, **overrides)`` builds a scenario's requests;
``scenario_targets(name)`` returns its per-tenant SLO targets (the verdict
inputs); ``SCENARIOS`` is the registry the CLI's ``replay`` reads.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

from unionml_tpu_torch.workloads.traces import TraceRequest, dumps_trace

__all__ = ["SCENARIOS", "scenario_meta", "scenario_targets", "synthesize", "synthesize_text"]


def _prompt(rng: "random.Random", length: int, vocab: int) -> "tuple":
    return tuple(rng.randrange(1, max(vocab, 2)) for _ in range(max(length, 1)))


def _chat_multiturn(rng: "random.Random", params: "Dict[str, Any]") -> "List[TraceRequest]":
    """Session-linked chat: each session opens with a prompt and continues
    with short new-turn suffixes; turn n's full prompt is the session history
    (the replayer's accumulation), so warm turns should radix-hit the whole
    prior exchange."""
    sessions = int(params["sessions"])
    turns = int(params["turns"])
    vocab = int(params["vocab"])
    duration = float(params["duration_s"])
    tenants = list(params["tenants"])
    out: "List[TraceRequest]" = []
    for s in range(sessions):
        tenant = tenants[s % len(tenants)]
        start = rng.uniform(0.0, duration * 0.4)
        gap = rng.uniform(*params["turn_gap_s"])
        for turn in range(turns):
            length = rng.randint(*params["turn_tokens"])
            out.append(TraceRequest(
                t=start + turn * gap,
                route="/v1/completions",
                prompt=_prompt(rng, length, vocab),
                max_tokens=int(params["max_tokens"]),
                tenant=tenant,
                session=f"chat-{s}",
                turn=turn,
            ))
    return out


def _rag_long_prompt(rng: "random.Random", params: "Dict[str, Any]") -> "List[TraceRequest]":
    """Prefill-heavy retrieval traffic: long stuffed-context prompts, small
    generation budgets, Poisson-ish arrivals."""
    vocab = int(params["vocab"])
    out: "List[TraceRequest]" = []
    t = 0.0
    for _ in range(int(params["requests"])):
        t += rng.expovariate(1.0 / float(params["mean_gap_s"]))
        out.append(TraceRequest(
            t=t,
            route="/v1/completions",
            prompt=_prompt(rng, rng.randint(*params["prompt_tokens"]), vocab),
            max_tokens=int(params["max_tokens"]),
            tenant=str(params["tenant"]),
        ))
    return out


def _burst_tenants(rng: "random.Random", params: "Dict[str, Any]") -> "List[TraceRequest]":
    """One hostile tenant fires its whole backlog in the first instants; the
    well-behaved tenants keep a steady cadence behind it. QoS (DRR + buckets)
    is what keeps the two populations' verdicts apart."""
    vocab = int(params["vocab"])
    duration = float(params["duration_s"])
    out: "List[TraceRequest]" = []
    for i in range(int(params["hostile_requests"])):
        out.append(TraceRequest(
            t=rng.uniform(0.0, 0.05),
            route="/v1/completions",
            prompt=_prompt(rng, rng.randint(*params["prompt_tokens"]), vocab),
            max_tokens=int(params["max_tokens"]),
            tenant=str(params["hostile_tenant"]),
        ))
    per_tenant = int(params["well_behaved_requests"])
    for w in range(int(params["well_behaved_tenants"])):
        tenant = f"{params['well_behaved_prefix']}{w}"
        phase = rng.uniform(0.0, duration / max(per_tenant, 1))
        for i in range(per_tenant):
            out.append(TraceRequest(
                t=phase + i * (duration / max(per_tenant, 1)),
                route="/v1/completions",
                prompt=_prompt(rng, rng.randint(*params["prompt_tokens"]), vocab),
                max_tokens=int(params["max_tokens"]),
                tenant=tenant,
            ))
    return out


def _chaos_fleet(rng: "random.Random", params: "Dict[str, Any]") -> "List[TraceRequest]":
    """Steady, well-behaved cadences from two tenants across the whole
    window — deliberately unremarkable traffic, because the drama comes from
    OUTSIDE the trace: the mix is replayed while a seeded FaultPlan
    (serving/faults.py, e.g. ``default_chaos_plan``) kills and restores a
    fleet host. The availability verdict (success ratio, clean-error ratio,
    recovery-to-first-routed-token) is what judges the fleet's lifecycle
    machinery; requests spanning the kill window are the ones that must
    route around, retry zero-token streams, and never hang."""
    vocab = int(params["vocab"])
    duration = float(params["duration_s"])
    per_tenant = int(params["requests_per_tenant"])
    out: "List[TraceRequest]" = []
    for w, tenant in enumerate(params["tenants"]):
        phase = rng.uniform(0.0, duration / max(per_tenant, 1) / 2)
        for i in range(per_tenant):
            out.append(TraceRequest(
                t=phase + i * (duration / max(per_tenant, 1)),
                route="/v1/completions",
                prompt=_prompt(rng, rng.randint(*params["prompt_tokens"]), vocab),
                max_tokens=int(params["max_tokens"]),
                tenant=str(tenant),
            ))
    return out


def _deadline_heavy(rng: "random.Random", params: "Dict[str, Any]") -> "List[TraceRequest]":
    """Tight per-request deadlines, a fraction infeasible by construction —
    the shed paths (before enqueue, while waiting, mid-prefill) must answer
    503 fast instead of burning prefill on work the client abandoned."""
    vocab = int(params["vocab"])
    out: "List[TraceRequest]" = []
    t = 0.0
    for i in range(int(params["requests"])):
        t += rng.expovariate(1.0 / float(params["mean_gap_s"]))
        tight = rng.random() < float(params["infeasible_fraction"])
        lo, hi = params["tight_deadline_ms"] if tight else params["deadline_ms"]
        out.append(TraceRequest(
            t=t,
            route="/v1/completions",
            prompt=_prompt(rng, rng.randint(*params["prompt_tokens"]), vocab),
            max_tokens=int(params["max_tokens"]),
            tenant=str(params["tenant"]),
            deadline_ms=round(rng.uniform(lo, hi), 3),
        ))
    return out


#: scenario registry: builder + default params + per-tenant SLO targets (the
#: verdict inputs — generous latency ceilings sized for CPU-substrate runs;
#: the hostile burst tenant deliberately carries NO targets: its judgment is
#: "did it shed", asserted by the bench lane from the per-tenant metrics)
SCENARIOS: "Dict[str, Dict[str, Any]]" = {
    "chat_multiturn": {
        "builder": _chat_multiturn,
        "params": {
            "sessions": 6, "turns": 3, "vocab": 90, "duration_s": 2.0,
            "tenants": ("chat-a", "chat-b"), "turn_gap_s": (0.25, 0.6),
            "turn_tokens": (3, 6), "max_tokens": 5,
        },
        "targets": {
            "chat-a": {"ttft_p95_ms": 5000.0, "shed_ratio": 0.01},
            "chat-b": {"ttft_p95_ms": 5000.0, "shed_ratio": 0.01},
        },
    },
    "rag_long_prompt": {
        "builder": _rag_long_prompt,
        "params": {
            "requests": 8, "vocab": 90, "mean_gap_s": 0.25,
            "prompt_tokens": (48, 96), "max_tokens": 3, "tenant": "rag",
        },
        "targets": {"rag": {"ttft_p95_ms": 8000.0, "shed_ratio": 0.01}},
    },
    "burst_tenants": {
        "builder": _burst_tenants,
        "params": {
            "vocab": 90, "duration_s": 2.0, "hostile_requests": 30,
            "hostile_tenant": "hostile", "well_behaved_tenants": 3,
            "well_behaved_requests": 4, "well_behaved_prefix": "wb-",
            "prompt_tokens": (4, 7), "max_tokens": 5,
        },
        "targets": {
            "wb-0": {"tbt_p99_ms": 5000.0, "shed_ratio": 0.01},
            "wb-1": {"tbt_p99_ms": 5000.0, "shed_ratio": 0.01},
            "wb-2": {"tbt_p99_ms": 5000.0, "shed_ratio": 0.01},
        },
    },
    "chaos_fleet": {
        "builder": _chaos_fleet,
        "params": {
            "vocab": 90, "duration_s": 3.0, "requests_per_tenant": 12,
            "tenants": ("chaos-a", "chaos-b"), "prompt_tokens": (4, 8),
            "max_tokens": 5,
        },
        # the latency targets are generous (a kill-and-rejoin may cost a
        # beat); the availability gate — success ratio >= 0.99 per tenant —
        # rides the replay's availability section, not these verdicts
        "targets": {
            "chaos-a": {"ttft_p95_ms": 10000.0, "shed_ratio": 0.01},
            "chaos-b": {"ttft_p95_ms": 10000.0, "shed_ratio": 0.01},
        },
    },
    "deadline_heavy": {
        "builder": _deadline_heavy,
        "params": {
            "requests": 16, "vocab": 90, "mean_gap_s": 0.08,
            "prompt_tokens": (4, 8), "max_tokens": 4, "tenant": "deadline",
            "infeasible_fraction": 0.25, "tight_deadline_ms": (0.0, 0.5),
            "deadline_ms": (5000.0, 20000.0),
        },
        # the scenario EXPECTS sheds (the infeasible fraction): the shed-ratio
        # target tolerates them; the latency target covers the feasible rest
        "targets": {"deadline": {"ttft_p95_ms": 8000.0, "shed_ratio": 0.5}},
    },
}


def synthesize(name: str, seed: int, **overrides: Any) -> "List[TraceRequest]":
    """Expand a scenario spec into trace requests — deterministic: every draw
    rides one ``random.Random(seed)``, so the same (name, seed, overrides)
    yields identical requests (and, through the canonical dumper,
    byte-identical trace files). ``overrides`` replace default params by name;
    an unknown scenario or param raises rather than silently generating the
    wrong workload."""
    spec = SCENARIOS.get(name)
    if spec is None:
        raise ValueError(f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}")
    params = dict(spec["params"])
    unknown = set(overrides) - set(params)
    if unknown:
        raise ValueError(f"unknown {name} params {sorted(unknown)}; expected {sorted(params)}")
    params.update(overrides)
    rng = random.Random(int(seed))
    requests: "List[TraceRequest]" = spec["builder"](rng, params)
    return sorted(requests, key=lambda r: (r.t, r.session or "", r.turn or 0))


def scenario_meta(name: str, seed: int) -> "Dict[str, Any]":
    """The header meta a synthesized trace carries (scenario + seed make the
    file self-describing — a replay report can say what it replayed)."""
    return {"scenario": name, "seed": int(seed)}


def synthesize_text(name: str, seed: int, **overrides: Any) -> str:
    """A scenario rendered straight to canonical trace text — the byte-identity
    surface the determinism tests and the bench lane pin."""
    return dumps_trace(synthesize(name, seed, **overrides), scenario_meta(name, seed))


def scenario_targets(name: str) -> "Dict[str, Dict[str, float]]":
    """Per-tenant SLO targets for a scenario's verdict block (a copy — callers
    may tighten/loosen without mutating the registry)."""
    spec = SCENARIOS.get(name)
    if spec is None:
        raise ValueError(f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}")
    return {tenant: dict(targets) for tenant, targets in spec["targets"].items()}
