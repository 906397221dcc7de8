"""TPU019 — release skipped on a non-exception early exit.

The CFG twin of TPU016: same acquire/release protocol table, same dataflow
facts, but the sink is an explicit ``return`` instead of the RAISE exit.  The
shape it catches is a guard clause added after the acquire::

    conn = HTTPConnection(host)
    if self._draining:
        return None          # <- conn leaks on this path
    ...
    conn.close()

The rule only fires when the function *does* release the protocol somewhere
— a function whose whole job is to acquire and hand the resource off
(``return conn``, ``self._conn = conn``) transfers ownership, which the
escape semantics already recognize; and a function with no release at all is
TPU016's business on its exception paths, not a half-finished release
discipline.  Requiring an in-function release keeps this rule's findings
"you released on the other paths, you forgot this one" — always actionable.
"""

from __future__ import annotations

import ast
from typing import List, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import dotted, iter_scope
from unionml_tpu_torch.analysis.rules._flow import (
    CLOSE_PROTOS,
    PROTOCOLS,
    ResourceFlow,
    _loaded_names,
    derived_acquirers,
    function_hints,
    solve_resources,
)
from unionml_tpu_torch.analysis.rules.tpu016_resource_leak import _make_resolver, _relevant


def released_protos(func: ast.AST) -> "Set[str]":
    """Protocols this function explicitly releases somewhere in its body."""
    out: "Set[str]" = set()
    for node in iter_scope(func):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        method = node.func.attr
        if method == "close":
            out |= CLOSE_PROTOS
        elif method == "release":
            out.add("radix-pin")
        elif method in ("extend", "append") and "free_blocks" in (
            dotted(node.func.value) or ""
        ):
            out.add("kv-blocks")
    return out


class UnreleasedOnEarlyReturn(Rule):
    id = "TPU019"
    title = "early return skips a release other paths perform"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        return []  # flow analysis runs in the project pass (CFGs are cached there)

    def check_project(self, index) -> "List[Finding]":
        from unionml_tpu_torch.analysis.project import function_cfg

        derived = derived_acquirers(index)
        derived_names = {fq.rsplit(".", 1)[-1] for fq in derived}
        findings: "List[Finding]" = []
        for summary in sorted(index.modules.values(), key=lambda s: s.path):
            for facts in sorted(
                summary.functions.values(), key=lambda f: (f.line, f.qualname)
            ):
                hints = function_hints(summary, facts)
                if not _relevant(hints, derived_names):
                    continue
                released = released_protos(facts.node)
                if not released:
                    continue
                resolve = _make_resolver(index, summary, facts, derived, derived_names)
                cfg = function_cfg(summary, facts)
                sol = solve_resources(cfg, ResourceFlow(resolve))
                # a fact live AT a `return` can still die on the way out — a
                # `finally` between the return and the function exit releases
                # on every path — so only facts that also survive to EXIT leak
                escaped = sol.at_exit
                for node in cfg.statement_nodes():
                    if not isinstance(node.stmt, ast.Return) or not sol.reachable(node.nid):
                        continue
                    returned = (
                        _loaded_names(node.stmt.value) if node.stmt.value is not None else set()
                    )
                    for var, proto_name, line in sorted(sol.in_facts(node.nid)):
                        if (var, proto_name, line) not in escaped:
                            continue
                        if proto_name not in released or var in returned:
                            continue
                        proto = PROTOCOLS[proto_name]
                        findings.append(
                            Finding(
                                rule=self.id,
                                path=facts.path,
                                line=node.line,
                                col=0,
                                message=(
                                    f"returning here leaves '{var}' ({proto.noun}, acquired "
                                    f"line {line}) unreleased, while other paths in this "
                                    f"function release it — release before this return, or "
                                    f"restructure so the release is unconditional "
                                    f"(try/finally or with)"
                                ),
                            )
                        )
        return findings
