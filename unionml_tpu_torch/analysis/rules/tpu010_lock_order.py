"""TPU010 — lock-order cycle across methods and modules (potential deadlock).

The serving stack holds six-plus locks across three thread kinds (HTTP
handler threads, the engine decode loop, the autoscaler), and the deadlock
shape is never visible in one file: thread 1 takes ``ReplicaSet._scale_lock``
then reaches into an engine method that takes the engine's ``_lock``; thread
2 holds the engine ``_lock`` in the decode loop and calls back into a fleet
method that wants ``_scale_lock``. Each call site is locally reasonable; the
cycle only exists in the whole-program lock-acquisition graph — which is
exactly what Infer/RacerD-style interprocedural analysis builds, and what
this rule builds from the project index.

Construction: every function's recorded acquisitions carry the lock set held
at that point (``with self.<lock>:`` nesting, plus the ``*_locked``
convention — a ``*_locked`` method's body is charged with its class's lock).
An edge ``L -> M`` means some thread can acquire ``M`` while holding ``L``,
either by textual nesting or by calling (transitively, through the resolved
cross-module call graph) a function that acquires ``M``. Any cycle in that
directed graph is a potential deadlock; the finding reports BOTH acquisition
paths so the fix (a global lock order, or dropping one lock before taking
the other) is mechanical.

Out of scope, deliberately: re-acquiring the SAME lock (``L -> L``) — RLocks
are reentrant, Conditions are usually waited on, and call-graph
over-approximation would make self-edges mostly noise. Lock identity is by
declaring class (``module.Class.attr``) or module-global name — the standard
abstraction: two instances of one class rank identically in the lock order.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from unionml_tpu_torch.analysis.engine import Finding, Rule


class LockOrderCycle(Rule):
    id = "TPU010"
    title = "lock-order cycle across the project's lock-acquisition graph"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        return []  # whole-program only: a single tree cannot hold a cross-module cycle

    def check_project(self, index) -> "List[Finding]":
        # edge (L, M) -> (witness text, anchor path, anchor line); first
        # witness in deterministic order wins
        edges: "Dict[Tuple[str, str], Tuple[str, str, int]]" = {}
        functions = sorted(index.iter_functions(), key=lambda f: (f.path, f.line, f.qualname))
        for facts in functions:
            summary = index.modules.get(facts.module)
            if summary is None:
                continue
            # textual nesting: `with A: ... with B:` inside one function
            for token, line, held in facts.acquisitions:
                inner = index.lock_node(token, summary, facts)
                if inner is None:
                    continue
                for held_token in held:
                    outer = index.lock_node(held_token, summary, facts)
                    if outer is None or outer == inner:
                        continue
                    witness = (
                        f"{facts.fq} acquires {inner} at {facts.path}:{line} "
                        f"while holding {outer}"
                    )
                    edges.setdefault((outer, inner), (witness, facts.path, line))
            # call-driven: holding L, call something that (transitively) takes M
            for call in facts.calls:
                if not call.held:
                    continue
                callee = index.resolve_call(call.raw, summary, facts)
                if callee is None or callee.fq == facts.fq:
                    continue
                for inner, (chain, acq_line) in sorted(index.transitive_acquisitions(callee).items()):
                    for held_token in call.held:
                        outer = index.lock_node(held_token, summary, facts)
                        if outer is None or outer == inner:
                            continue
                        via = " -> ".join(chain)
                        witness = (
                            f"{facts.fq} holds {outer} and calls {call.raw}() at "
                            f"{facts.path}:{call.line}; the chain {via} acquires {inner} "
                            f"({callee.path}:{acq_line})"
                        )
                        edges.setdefault((outer, inner), (witness, facts.path, call.line))
        return self._report_cycles(edges)

    # --------------------------------------------------------------- cycles

    def _report_cycles(
        self, edges: "Dict[Tuple[str, str], Tuple[str, str, int]]"
    ) -> "List[Finding]":
        graph: "Dict[str, List[str]]" = {}
        for outer, inner in edges:
            graph.setdefault(outer, []).append(inner)
            graph.setdefault(inner, [])
        for targets in graph.values():
            targets.sort()
        findings: "List[Finding]" = []
        reported: "set" = set()
        for start in sorted(graph):
            cycle = self._shortest_cycle(graph, start)
            if cycle is None:
                continue
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            pairs = [(cycle[i], cycle[(i + 1) % len(cycle)]) for i in range(len(cycle))]
            witnesses = [edges[pair][0] for pair in pairs]
            _, anchor_path, anchor_line = edges[pairs[0]]
            locks = " -> ".join(cycle + [cycle[0]])
            findings.append(
                Finding(
                    rule=self.id,
                    path=anchor_path,
                    line=anchor_line,
                    col=0,
                    message=f"lock-order cycle {locks}: "
                    + "; ".join(f"[path {i + 1}] {w}" for i, w in enumerate(witnesses))
                    + " — two threads taking these paths concurrently deadlock; impose one "
                    "global acquisition order or release the outer lock before the call",
                )
            )
        return findings

    @staticmethod
    def _shortest_cycle(graph: "Dict[str, List[str]]", start: str) -> "List[str] | None":
        """Shortest directed cycle through ``start`` (BFS back to start)."""
        queue: "List[List[str]]" = [[start]]
        seen = {start}
        while queue:
            path = queue.pop(0)
            for nxt in graph.get(path[-1], ()):
                if nxt == start:
                    return path
                if nxt not in seen:
                    seen.add(nxt)
                    queue.append(path + [nxt])
        return None
