"""TPU002 — use of a buffer after passing it at a donated position.

``jax.jit(fn, donate_argnums=...)`` hands the argument's device buffer to XLA
for in-place reuse: after the call the Python object still exists but its
buffer is deleted, and touching it raises (or, through stale references on
some backends, silently reads garbage). The correct idiom rebinds the name
from the call's result — ``state = step(state, batch)`` — which this rule
recognizes as safe. Only literal ``donate_argnums`` are analyzed: a variable
value (e.g. gated on ``debug_disable_donation``) cannot be resolved
statically and is never guessed.

Scope: same-file dataflow, plus an index-backed cross-module pass
(:meth:`UseAfterDonate.check_project`): a donor defined in one module
(``@partial(jax.jit, donate_argnums=...)`` or a module-level
``step = jax.jit(fn, donate_argnums=...)`` binding) and imported into
another is invisible to the per-file pass — the project index's donor table
makes the importing module's call sites subject to the same later-load
analysis. Donating callables are collected from local
``f = jax.jit(g, donate_argnums=...)`` bindings, class-wide
``self._f = jax.jit(...)`` attributes, ``@partial(jax.jit, donate_argnums=...)``
decorators, and immediate ``jax.jit(g, ...)(args)`` invocations.

Path sensitivity: donations are solved as a reaching-definitions problem over
the function's CFG (:mod:`unionml_tpu_torch.analysis.cfg`) rather than by source
line order.  A load in the *other* branch of the donating ``if`` is clean; a
load lexically above the donation but reachable again through a loop back
edge is flagged; a rebind on one path does not launder the other path.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import (
    assign_target_names,
    call_target,
    dotted,
    is_jit_decorator,
    iter_scope,
    jit_wrap_call,
    literal_argnums,
)


def _donated_positions(call: ast.Call) -> "Optional[Tuple[int, ...]]":
    for keyword in call.keywords:
        if keyword.arg == "donate_argnums":
            return literal_argnums(keyword.value)
    return None


def _make_donation_flow():
    """Reaching-donations dataflow: fact ``(name, donate_line)``, generated at
    the donating call's statement, killed by any Store/Del of the name (the
    rebind idiom).  Built lazily so the per-file fast path doesn't import the
    dataflow machinery until a donation is actually seen."""
    from unionml_tpu_torch.analysis.dataflow import Problem

    class _DonationFlow(Problem):
        def __init__(self, gens):
            self._gens = gens

        def gen_kill(self, node):
            gen = self._gens.get(node.nid, set())
            kill = set()
            for expr in node.exprs:
                if expr is None:
                    continue
                for sub in ast.walk(expr):
                    if isinstance(sub, ast.Name) and isinstance(
                        sub.ctx, (ast.Store, ast.Del)
                    ):
                        kill.add(sub.id)
            return gen, kill

        def apply_kill(self, facts, kill):
            return {f for f in facts if f[0] not in kill}

    return _DonationFlow


class UseAfterDonate(Rule):
    id = "TPU002"
    title = "buffer used after being passed at a donated position"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        attr_donors = self._class_attribute_donors(tree)
        module_donors = self._decorated_donors(tree)
        # module level counts as a scope too (module-scope jit wrap + call)
        scopes: "List[ast.AST]" = [tree]
        scopes += [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            findings.extend(self._check_scope(scope, path, attr_donors, module_donors))
        return findings

    def check_project(self, index) -> "List[Finding]":
        """Cross-module donors: a module that imports a donating callable gets
        the same later-load analysis, with the import alias as the donor name."""
        findings: "List[Finding]" = []
        for summary in index.modules.values():
            imported: "Dict[str, Tuple[int, ...]]" = {}
            for alias, fq in summary.imports.items():
                mod, _, sym = fq.rpartition(".")
                donor_module = index.modules.get(mod)
                if donor_module is not None and sym in donor_module.donors:
                    imported[alias] = donor_module.donors[sym]
            if not imported:
                continue
            tree = summary.tree
            scopes: "List[ast.AST]" = [tree]
            scopes += [
                n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            for scope in scopes:
                findings.extend(self._check_scope(scope, summary.path, {}, imported))
        return findings

    # ------------------------------------------------------------ donor discovery

    @staticmethod
    def _class_attribute_donors(tree: ast.Module) -> "Dict[str, Tuple[int, ...]]":
        """``self._f = jax.jit(..., donate_argnums=<literal>)`` anywhere in a
        class -> ``{"self._f": positions}`` (methods of the same class call
        through the attribute)."""
        donors: "Dict[str, Tuple[int, ...]]" = {}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            target = dotted(node.targets[0])
            wrap = jit_wrap_call(node.value)
            if target is None or wrap is None or not target.startswith(("self.", "cls.")):
                continue
            positions = _donated_positions(wrap)
            if positions:
                donors["self." + target.split(".", 1)[1]] = positions
        return donors

    @staticmethod
    def _decorated_donors(tree: ast.Module) -> "Dict[str, Tuple[int, ...]]":
        """``@partial(jax.jit, donate_argnums=<literal>)`` functions, callable
        by bare name within the module."""
        donors: "Dict[str, Tuple[int, ...]]" = {}
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and is_jit_decorator(dec):
                    positions = _donated_positions(dec)
                    if positions:
                        donors[node.name] = positions
        return donors

    # ------------------------------------------------------------ per-scope check

    def _check_scope(
        self,
        scope: ast.AST,
        path: str,
        attr_donors: "Dict[str, Tuple[int, ...]]",
        module_donors: "Dict[str, Tuple[int, ...]]",
    ) -> "List[Finding]":
        donors = dict(module_donors)
        donors.update(attr_donors)
        statements = list(iter_scope(scope))
        # pass 1: local `f = jax.jit(g, donate_argnums=...)` bindings
        for node in statements:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = dotted(node.targets[0])
                wrap = jit_wrap_call(node.value)
                if target and wrap:
                    positions = _donated_positions(wrap)
                    if positions:
                        donors[target] = positions

        # pass 2: call sites -> donated argument names, keyed by the Call node
        # so the CFG pass below can attach each donation to its statement
        donated_by_call: "Dict[int, List[str]]" = {}
        for call in statements:
            if not isinstance(call, ast.Call):
                continue
            positions = self._call_donated_positions(call, donors)
            if positions is None:
                continue
            if any(isinstance(arg, ast.Starred) for arg in call.args):
                continue  # positions unknowable through *args
            rebound = self._rebound_names(statements, call)
            for pos in positions:
                if pos >= len(call.args):
                    continue
                arg = call.args[pos]
                if isinstance(arg, ast.Name) and arg.id not in rebound:
                    donated_by_call.setdefault(id(call), []).append(arg.id)
        if not donated_by_call:
            return []

        # pass 3 (path-sensitive): solve reaching-donations over the CFG and
        # flag only loads a donation actually reaches with no intervening
        # rebind.  A load in the *other* branch of the donating `if` is clean;
        # a load lexically before the donation but reached again through a
        # loop back edge is not.
        from unionml_tpu_torch.analysis.cfg import build_cfg
        from unionml_tpu_torch.analysis.dataflow import solve_forward

        cfg = build_cfg(scope)
        gens: "Dict[int, Set[Tuple[str, int]]]" = {}
        for node in cfg.statement_nodes():
            for expr in node.exprs:
                if expr is None:
                    continue
                for sub in ast.walk(expr):
                    for name in donated_by_call.get(id(sub), ()):
                        gens.setdefault(node.nid, set()).add((name, sub.lineno))
        sol = solve_forward(cfg, _make_donation_flow()(gens))

        findings: "List[Finding]" = []
        flagged: "Set[Tuple[str, int]]" = set()
        for node in cfg.statement_nodes():
            live = sol.in_facts(node.nid)
            if not live:
                continue
            live_names = {name: donated_at for name, donated_at in sorted(live)}
            for expr in node.exprs:
                if expr is None:
                    continue
                for sub in ast.walk(expr):
                    if (
                        isinstance(sub, ast.Name)
                        and isinstance(sub.ctx, ast.Load)
                        and sub.id in live_names
                        and (sub.id, sub.lineno) not in flagged
                    ):
                        flagged.add((sub.id, sub.lineno))
                        donated_at = live_names[sub.id]
                        findings.append(
                            self.finding(
                                path, sub,
                                f"'{sub.id}' was donated to a jit-compiled call on line {donated_at} "
                                "(donate_argnums) — its buffer is deleted after the call; rebind the "
                                "name from the call's result instead",
                            )
                        )
        return findings

    @staticmethod
    def _call_donated_positions(call: ast.Call, donors: "Dict[str, Tuple[int, ...]]"):
        target = call_target(call)
        if target is not None:
            if target.startswith(("self.", "cls.")):
                target = "self." + target.split(".", 1)[1]
            if target in donors:
                return donors[target]
        # immediate invocation: jax.jit(g, donate_argnums=...)(args)
        wrap = jit_wrap_call(call.func)
        if wrap is not None:
            return _donated_positions(wrap)
        return None

    @staticmethod
    def _rebound_names(statements, call: ast.Call) -> "Set[str]":
        """Names the call's own result assignment rebinds (``a, b = f(a, x)``
        consumes and replaces ``a`` — the donation-safe idiom)."""
        for node in statements:
            if isinstance(node, ast.Assign) and node.value is call:
                out: "Set[str]" = set()
                for target in node.targets:
                    out.update(assign_target_names(target))
                return out
            if isinstance(node, ast.AugAssign) and node.value is call:
                name = dotted(node.target)
                return {name} if name else set()
        return set()
