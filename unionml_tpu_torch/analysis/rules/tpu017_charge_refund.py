"""TPU017 — tenant token-bucket charge whose exception path skips the refund.

PR 10's admission contract is "never double-charge, never charge on shed":
``TenantRegistry.try_admit`` debits the tenant's request bucket exactly when
it returns ``None`` (admitted); a non-``None`` return is a retry-after with
the buckets untouched.  Everything that happens between a successful charge
and the request actually entering the batch — grammar compilation, queue
mutation, thread spawn — can raise; if the exception propagates without a
refund, the tenant paid for a request that was never served.  Under
sustained load that is a slow quota leak: a tenant's effective rate sinks
below its configured floor and no counter explains why.

The dataflow: an assignment ``r = <registry>.try_admit(...)`` (or
``.charge(...)``) generates a charge fact.  The fact is *path-sensitive*:
``try_admit`` charged only when its result is ``None``, so on the branch
where ``r is not None`` the assume-transfer kills the fact — which is what
keeps the canonical ``if r is not None: raise TenantThrottled(...)`` shed
path clean.  A ``.refund(...)`` call kills the fact.  Any charge fact
reaching the RAISE exit is a finding.

``charge_tokens`` (generated-token debt, settled post-hoc by design) is
deliberately NOT a charge here: it records actual consumption after the
fact, and refunding it would un-count work that was really done.

``test_*`` functions are exempt: the refund contract binds production
callers that sit between a charge and the batch, not tests asserting on
bucket math — a failing ``assert`` after ``try_admit`` tears the whole
registry down, so there is no tenant left to over-bill.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.dataflow import Problem
from unionml_tpu_torch.analysis.rules._common import call_target
from unionml_tpu_torch.analysis.rules._flow import function_hints

#: method names that debit a tenant bucket up front (refundable on failure)
CHARGE_METHODS = frozenset({"try_admit", "charge"})

#: charge fact: (result variable or "", charge line)
Fact = Tuple[str, int]


def _charge_call(node: ast.AST):
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in CHARGE_METHODS
    ):
        return node
    return None


class ChargeFlow(Problem):
    def gen_kill(self, node):
        gen: "Set[Fact]" = set()
        kill: "Set[str]" = set()
        stmt = node.stmt
        if node.kind != "stmt" or stmt is None:
            return gen, kill
        var = ""
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
        ):
            var = stmt.targets[0].id
        for expr in node.exprs:
            for sub in ast.walk(expr):
                if _charge_call(sub) is not None:
                    gen.add((var, node.line))
                elif isinstance(sub, ast.Call):
                    # refund-by-name: `registry.refund(t)` or a wrapper like
                    # `_refund_admission(registry, t)` — guarded-refund
                    # helpers keep the None-registry correlation out of the
                    # dataflow's sight, so the name is the contract
                    target = call_target(sub) or ""
                    if "refund" in target.rsplit(".", 1)[-1]:
                        kill.add("*")
        return gen, kill

    def apply_kill(self, facts, kill):
        return set() if "*" in kill else facts

    def assume(self, node, branch, facts):
        """Kill the charge fact on branches where the charge did not happen:
        ``try_admit`` returned non-None (a retry-after) exactly when it did
        NOT debit the bucket."""
        stmt = node.stmt
        test = getattr(stmt, "test", None) if isinstance(stmt, (ast.If, ast.While)) else None
        if test is None:
            return facts
        not_charged_var = None  # var proven non-None on this branch
        if (
            isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and len(test.ops) == 1
            and len(test.comparators) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            if isinstance(test.ops[0], ast.IsNot) and branch == "true":
                not_charged_var = test.left.id
            elif isinstance(test.ops[0], ast.Is) and branch == "false":
                not_charged_var = test.left.id
        elif isinstance(test, ast.Name) and branch == "true":
            # `if retry_after:` — truthy retry-after means not charged
            not_charged_var = test.id
        if not_charged_var is None:
            return facts
        return {f for f in facts if f[0] != not_charged_var}


class ChargeWithoutRefund(Rule):
    id = "TPU017"
    title = "tenant charge reaches an exception exit without a refund"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        return []  # flow analysis runs in the project pass (CFGs are cached there)

    def check_project(self, index) -> "List[Finding]":
        from unionml_tpu_torch.analysis.project import function_cfg
        from unionml_tpu_torch.analysis.dataflow import solve_forward

        findings: "List[Finding]" = []
        for summary in sorted(index.modules.values(), key=lambda s: s.path):
            for facts in sorted(
                summary.functions.values(), key=lambda f: (f.line, f.qualname)
            ):
                if not function_hints(summary, facts).has_charge:
                    continue
                if facts.qualname.rsplit(".", 1)[-1].startswith("test_"):
                    continue  # see module docstring: the contract binds production callers
                cfg = function_cfg(summary, facts)
                sol = solve_forward(cfg, ChargeFlow())
                for var, line in sorted(sol.at_raise):
                    label = f"'{var}'" if var else "the charge"
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=facts.path,
                            line=line,
                            col=0,
                            message=(
                                f"tenant bucket charged here ({label}) and an exception "
                                f"path exits without a refund — the tenant pays for a "
                                f"request that was never served; refund in an `except` "
                                f"and re-raise"
                            ),
                        )
                    )
        return findings
