"""TPU005 — bare numeric parse of an environment variable.

``int(os.environ.get("VAR", "0"))`` has a default for the UNSET case but none
for the garbage case: ``VAR=abc`` raises ``ValueError`` at whatever moment the
code happens to read it — for serve-path knobs that is import/export time in
``cli.py serve``, taking the whole service down over a typo'd deployment env.
The hardened pattern wraps the conversion in ``try/except ValueError`` with a
warn-and-fall-back (see :func:`unionml_tpu_torch.defaults.env_int`), which this rule
recognizes as clean.

Detection: ``int(...)``/``float(...)`` whose argument reads
``os.environ[...]``/``os.environ.get(...)``/``os.getenv(...)`` — directly or
through a local name assigned from such a read in the same scope — outside any
``try`` whose handlers catch ``ValueError``/``TypeError``/``Exception``.
"""

from __future__ import annotations

import ast
from typing import List, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import assign_target_names, call_target, dotted, iter_scope

_CATCHING = {"ValueError", "TypeError", "Exception", "BaseException", None}


def _reads_env(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and call_target(node) in ("os.environ.get", "os.getenv", "environ.get", "getenv"):
            return True
        if isinstance(node, ast.Subscript) and dotted(node.value) in ("os.environ", "environ"):
            return True
    return False


def _handler_names(handler: ast.ExceptHandler) -> "Set":
    if handler.type is None:
        return {None}
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    return {dotted(t).split(".")[-1] if dotted(t) else "" for t in types}


class BareEnvNumericParse(Rule):
    id = "TPU005"
    title = "environment variable parsed to a number without a garbage fallback"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        scopes: "List[ast.AST]" = [tree]
        scopes += [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            findings.extend(self._check_scope(scope, path))
        return findings

    def _check_scope(self, scope: ast.AST, path: str) -> "List[Finding]":
        # names assigned from an env read anywhere in this scope are tainted
        tainted: "Set[str]" = set()
        for node in iter_scope(scope):
            if isinstance(node, ast.Assign) and _reads_env(node.value):
                for target in node.targets:
                    tainted.update(assign_target_names(target))
        findings: "List[Finding]" = []
        self._visit(scope, path, tainted, protected=False, findings=findings)
        return findings

    def _visit(self, node: ast.AST, path: str, tainted: "Set[str]", protected: bool, findings: "List[Finding]") -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                continue  # nested scopes get their own _check_scope pass
            if isinstance(child, ast.Try):
                catches = set()
                for handler in child.handlers:
                    catches.update(_handler_names(handler))
                guarded = protected or bool(catches & _CATCHING)
                for stmt in child.body:
                    self._visit(stmt, path, tainted, guarded, findings)
                for rest in (child.handlers, child.orelse, child.finalbody):
                    for stmt in rest:
                        self._visit(stmt, path, tainted, protected, findings)
                continue
            if isinstance(child, ast.Call) and not protected:
                target = call_target(child)
                if target in ("int", "float") and len(child.args) == 1:
                    arg = child.args[0]
                    is_env = _reads_env(arg) or (
                        isinstance(arg, ast.Name) and arg.id in tainted
                    )
                    if is_env:
                        findings.append(
                            self.finding(
                                path, child,
                                f"{target}() on an environment variable without a garbage "
                                "fallback — VAR=abc raises ValueError at read time; wrap in "
                                "try/except with a warn-and-default (defaults.env_int/env_float)",
                            )
                        )
            self._visit(child, path, tainted, protected, findings)
        return None
