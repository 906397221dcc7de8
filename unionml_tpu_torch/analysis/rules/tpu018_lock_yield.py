"""TPU018 — a generator yields while holding a lock.

A ``yield`` hands control to the consumer, and the consumer decides when —
or whether — the generator resumes.  If the generator is inside ``with
self._lock:`` at that point, the lock stays held across the suspension: a
slow HTTP client draining a token stream serializes every other thread that
needs the lock, and a consumer that abandons the iterator without closing it
holds the lock until GC finalizes the frame.  That is the stream-iterator
deadlock shape: TPU003 sees the mutation is locked (fine), TPU013 sees no
collective under the lock (fine), and neither can express "the lock's
critical section contains a suspension point".

Lock identity reuses the index's discovery: class lock attributes (through
the MRO), module-level locks, and locals assigned from ``LOCK_FACTORIES``.
Held-ness is the :class:`~unionml_tpu_torch.analysis.rules._flow.LockFlow` dataflow
— ``with`` acquires at entry and releases at the CFG's ``with_exit`` node on
every path, explicit ``.acquire()``/``.release()`` pairs gen/kill — so a
yield *between* ``release`` and re-``acquire`` is correctly clean.  The fix
is always the same: snapshot under the lock, yield outside it.
"""

from __future__ import annotations

import ast
from typing import List, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.dataflow import solve_forward
from unionml_tpu_torch.analysis.rules._flow import LockFlow, function_hints


class LockHeldAcrossYield(Rule):
    id = "TPU018"
    title = "generator yields while holding a lock"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        return []  # flow analysis runs in the project pass (CFGs are cached there)

    def check_project(self, index) -> "List[Finding]":
        from unionml_tpu_torch.analysis.project import function_cfg

        findings: "List[Finding]" = []
        for summary in sorted(index.modules.values(), key=lambda s: s.path):
            for facts in sorted(
                summary.functions.values(), key=lambda f: (f.line, f.qualname)
            ):
                hints = function_hints(summary, facts)
                if not (hints.has_yield and hints.has_lock):
                    continue
                lock_attrs: "Set[str]" = set()
                if facts.cls is not None:
                    cls = summary.classes.get(facts.cls)
                    if cls is not None:
                        for candidate in index.class_mro(cls):
                            lock_attrs |= candidate.lock_attrs
                problem = LockFlow(lock_attrs, summary.module_locks, facts.local_types)
                cfg = function_cfg(summary, facts)
                sol = solve_forward(cfg, problem)
                for node in cfg.statement_nodes():
                    if not node.is_yield or not sol.reachable(node.nid):
                        continue
                    for token, line in sorted(sol.in_facts(node.nid)):
                        findings.append(
                            Finding(
                                rule=self.id,
                                path=facts.path,
                                line=node.line,
                                col=0,
                                message=(
                                    f"yield while holding lock '{token}' (acquired line "
                                    f"{line}): the consumer controls when this generator "
                                    f"resumes, so the lock is held for an unbounded time "
                                    f"— snapshot under the lock and yield outside it"
                                ),
                            )
                        )
        return findings
