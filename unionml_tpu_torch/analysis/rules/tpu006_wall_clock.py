"""TPU006 — wall-clock ``time.time()`` used for duration or deadline arithmetic.

``time.time()`` steps under NTP corrections (and leaps at manual clock sets):
a duration measured as ``time.time() - t0`` can come out negative or minutes
long, and a deadline built as ``time.time() + timeout`` can fire early or
never — in serving/engine code that means bogus latency percentiles, spurious
deadline sheds, and drains that exit too soon. Elapsed time and deadlines must
use ``time.monotonic()`` (or ``time.perf_counter()`` for fine measurement),
which is what every other timing site in the serving stack already does.

Detection: within one scope, two *wall-clock-derived* values (a direct
``time.time()`` call, or a name assigned from an expression containing one)
meeting in a subtraction or an ordering comparison. Pairing is the point —
a lone ``time.time()`` recorded as a timestamp (job heartbeat files,
``deployed_at`` fields) is legitimate wall-clock use, and subtracting a
wall-clock value read from ANOTHER process (``time.time() - float(file)``) is
the one case monotonic cannot serve, so neither is flagged.
"""

from __future__ import annotations

import ast
from typing import List, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import assign_target_names, call_target, iter_scope

_WALL_CLOCK = {"time.time", "time"}  # `time.time()` / `from time import time; time()`

_ORDERING = (ast.Lt, ast.LtE, ast.Gt, ast.GtE)


def _is_wall_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and call_target(node) in _WALL_CLOCK and not node.args


def _contains_wall_call(expr: ast.AST) -> bool:
    return any(_is_wall_call(node) for node in ast.walk(expr))


class WallClockDuration(Rule):
    id = "TPU006"
    title = "time.time() paired into duration/deadline arithmetic (use time.monotonic())"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        scopes: "List[ast.AST]" = [tree]
        scopes += [
            n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            findings.extend(self._check_scope(scope, path))
        return findings

    def _check_scope(self, scope: ast.AST, path: str) -> "List[Finding]":
        # names assigned from an expression containing time.time() anywhere in
        # this scope are wall-clock tainted (covers `t0 = time.time()` and the
        # deadline form `deadline = time.time() + timeout`)
        tainted: "Set[str]" = set()
        for node in iter_scope(scope):
            if isinstance(node, ast.Assign) and _contains_wall_call(node.value):
                for target in node.targets:
                    tainted.update(assign_target_names(target))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
                if _contains_wall_call(node.value):
                    tainted.update(assign_target_names(node.target))

        def derived(expr: ast.AST) -> bool:
            if _is_wall_call(expr):
                return True
            return isinstance(expr, ast.Name) and expr.id in tainted

        findings: "List[Finding]" = []
        for node in iter_scope(scope):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                if derived(node.left) and derived(node.right):
                    findings.append(
                        self.finding(
                            path, node,
                            "duration measured by subtracting wall-clock time.time() values "
                            "— the result steps under NTP corrections; use time.monotonic()",
                        )
                    )
            elif isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                if (
                    any(isinstance(op, _ORDERING) for op in node.ops)
                    and sum(1 for operand in operands if derived(operand)) >= 2
                ):
                    findings.append(
                        self.finding(
                            path, node,
                            "deadline arithmetic on wall-clock time.time() values — the "
                            "comparison fires early/late under NTP corrections; build "
                            "deadlines from time.monotonic()",
                        )
                    )
        return findings
