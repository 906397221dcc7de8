"""TPU011 — Python-varying value passed into a static position of a jit call.

``jax.jit(fn, static_argnums=...)``/``static_argnames=...`` bakes the marked
argument into the compiled program: every DISTINCT value is a full trace +
XLA compile. That is the design (the value becomes a constant the compiler
can fold), and it is fine for genuinely enumerable values — a bool flag, a
bucketed length, a config enum. It becomes a production incident when the
call site feeds a value that varies per request or per loop iteration: a
loop index, ``len(prompt)``, a wall-clock or RNG draw, an f-string. Each
request then pays the full compile (87.6 s for BERT in this repo's bench) and
the AOT compile cache ROADMAP item 1 exists to build is defeated by an
unbounded key space — a *recompile storm*.

The per-file view cannot see this: the ``jax.jit`` wrap and the hot call site
are routinely in different modules. This rule uses the project index's jit
bindings (decorated functions, ``self._f = jax.jit(...)`` attributes,
module-level wraps — with their literal ``static_argnums``/``static_argnames``)
and checks every cross-module call site. An argument in a static position
flags when it is provably per-call-varying:

- a loop variable of an enclosing ``for`` (each iteration = one compile);
- ``len(...)`` of a function parameter (per-request length — bucket it);
- a ``time.*``/``random.*``/``uuid.*`` draw (unbounded key space);
- an f-string (unbounded string space).

Anything not provably varying — literals, config attributes, module
constants, plain parameters forwarded through — is left alone: a forwarded
parameter MAY vary, but flagging every forward would bury the storms under
noise, and the caller of that caller is checked at its own call sites.

The port's reading: a *capture storm*. ``AOTFunction(fn, ...,
static_argnames=...)`` (the index's bindings of kind ``"aot"``) keys a
captured program on its static arguments and on the VALUE of every Python
scalar it is given (a CUDA graph bakes scalars in), so each distinct value
captures one more graph, and past its ``_MAX_PROGRAMS = 64`` the storm
evicts live programs. At a call site of such a binding, an argument in a
static position flags for every reason above; an argument in any other
position flags when it is a scalar by construction that varies per call:
``len(...)`` of a parameter, a ``time.*``/``random.*``/``uuid.*`` draw, or
an f-string (a loop variable there may be a tensor, and is left alone).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import assign_target_names, call_target

_VARYING_CALL_PREFIXES = ("time.", "random.", "uuid.")
_VARYING_CALLS = {"time", "monotonic", "perf_counter"}  # from-imported spellings


class RecompileHazard(Rule):
    id = "TPU011"
    title = "Python-varying value in a static position of a jit-compiled call"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        return []  # the wrap and the call site are rarely in one file; index-only

    def check_project(self, index) -> "List[Finding]":
        findings: "List[Finding]" = []
        bindings = self._collect_bindings(index)
        if not bindings:
            return findings
        for facts in sorted(index.iter_functions(), key=lambda f: (f.path, f.line, f.qualname)):
            summary = index.modules.get(facts.module)
            if summary is None:
                continue
            for call, loop_vars in self._calls_with_loop_context(facts.node):
                raw = call_target(call)
                if raw is None:
                    continue
                binding = self._match(raw, facts, summary, index, bindings)
                if binding is None:
                    continue
                findings.extend(
                    self._check_call(call, loop_vars, facts, binding, index, summary)
                )
        return findings

    # ------------------------------------------------------------- bindings

    @staticmethod
    def _collect_bindings(index) -> "Dict[Tuple[str, Optional[str], str], object]":
        """(module, class-or-None, binding spelling) -> JitBinding, for every
        binding that has static positions, and every AOT binding (its
        scalars are keyed by value wherever they sit)."""
        out: "Dict[Tuple[str, Optional[str], str], object]" = {}
        for summary in index.modules.values():
            for binding in summary.jit_bindings:
                if binding.kind == "aot" or binding.static_argnums or binding.static_argnames:
                    out.setdefault((summary.module, binding.cls, binding.binding), binding)
        return out

    @staticmethod
    def _match(raw, facts, summary, index, bindings):
        if raw.startswith(("self.", "cls.")):
            raw = "self." + raw.split(".", 1)[1]
            return bindings.get((facts.module, facts.cls, raw))
        # same module, module-level binding
        hit = bindings.get((facts.module, None, raw))
        if hit is not None:
            return hit
        # imported: alias -> fully-qualified module.symbol
        fq = index._resolve_alias(raw, summary)
        if fq is None:
            return None
        mod, _, sym = fq.rpartition(".")
        return bindings.get((mod, None, sym))

    # ------------------------------------------------------------ call walk

    @staticmethod
    def _calls_with_loop_context(func_node: ast.AST) -> "List[Tuple[ast.Call, Set[str]]]":
        """Every call in the function's own scope, with the set of enclosing
        for-loop target names active at that point."""
        out: "List[Tuple[ast.Call, Set[str]]]" = []

        def walk(node: ast.AST, loop_vars: "Set[str]") -> None:
            for child in ast.iter_child_nodes(node):
                visit(child, loop_vars)

        # dispatch per node, entered for walked children AND For-body
        # statements — a for-loop directly inside another for-loop must
        # re-enter the For branch so its own target variable accumulates
        def visit(node: ast.AST, loop_vars: "Set[str]") -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, (ast.For, ast.AsyncFor)):
                visit(node.iter, loop_vars)  # the iter expr runs outside the loop body
                inner = loop_vars | set(assign_target_names(node.target))
                for stmt in node.body + node.orelse:
                    visit(stmt, inner)
                return
            record(node, loop_vars)
            walk(node, loop_vars)

        def record(node: ast.AST, loop_vars: "Set[str]") -> None:
            if isinstance(node, ast.Call):
                out.append((node, set(loop_vars)))

        walk(func_node, set())
        return out

    # ----------------------------------------------------------- the check

    def _check_call(self, call, loop_vars, facts, binding, index, summary) -> "List[Finding]":
        findings: "List[Finding]" = []
        static_exprs: "List[Tuple[str, ast.AST]]" = []
        for pos in binding.static_argnums:
            if pos < len(call.args):
                static_exprs.append((f"static position {pos}", call.args[pos]))
        target_params = self._target_params(binding, index, summary)
        aot = binding.kind == "aot"
        # after a *args, positions no longer name parameters
        positional = not (aot and any(isinstance(arg, ast.Starred) for arg in call.args))
        for name in binding.static_argnames:
            for kw in call.keywords:
                if kw.arg == name:
                    static_exprs.append((f"static argument '{name}'", kw.value))
            if positional and target_params is not None and name in target_params:
                pos = target_params.index(name)
                if target_params[:1] in (["self"], ["cls"]):
                    pos -= 1
                if 0 <= pos < len(call.args):
                    static_exprs.append((f"static argument '{name}'", call.args[pos]))
        if aot:
            return self._check_aot_call(call, loop_vars, facts, binding, static_exprs)
        for label, expr in static_exprs:
            reason = self._varying_reason(expr, loop_vars, facts.params)
            if reason is None:
                continue
            findings.append(
                self.finding(
                    facts.path,
                    expr,
                    f"{reason} flows into {label} of jit-compiled "
                    f"'{binding.target_raw or binding.binding}' (jit-bound at line {binding.line}) — every distinct "
                    "value triggers a full trace+compile and defeats the AOT compile cache; "
                    "bucket the value (pad to a fixed set) or make the argument traced",
                )
            )
        return findings

    def _check_aot_call(self, call, loop_vars, facts, binding, static_exprs) -> "List[Finding]":
        """A call of an AOT binding: every reason in a static position, the
        scalar-by-construction reasons in any other."""
        static_ids = {id(expr) for _, expr in static_exprs}
        exprs = [(label, expr, loop_vars) for label, expr in static_exprs]
        for pos, arg in enumerate(call.args):
            if id(arg) not in static_ids:
                exprs.append((f"argument {pos}", arg, set()))
        for kw in call.keywords:
            if kw.arg is not None and id(kw.value) not in static_ids:
                exprs.append((f"argument '{kw.arg}'", kw.value, set()))
        findings: "List[Finding]" = []
        for label, expr, loops in exprs:
            reason = self._varying_reason(expr, loops, facts.params)
            if reason is None:
                continue
            findings.append(
                self.finding(
                    facts.path,
                    expr,
                    f"{reason} flows into {label} of captured program "
                    f"'{binding.target_raw or binding.binding}' (AOT-bound at line {binding.line}) — a captured "
                    "program is keyed on the value of every Python scalar, so each distinct value captures "
                    "another CUDA graph, and past 64 programs the storm evicts live ones; bucket the value "
                    "(pad to a fixed set) or pass it as a tensor",
                )
            )
        return findings

    @staticmethod
    def _target_params(binding, index, summary) -> "Optional[List[str]]":
        if not binding.target_raw:
            return None
        caller = None
        if binding.cls is not None:
            # resolve self._impl relative to the owning class
            cls = summary.classes.get(binding.cls)
            if cls is not None and binding.target_raw.startswith(("self.", "cls.")):
                bare = binding.target_raw.split(".", 1)[1]
                facts = summary.functions.get(f"{binding.cls}.{bare}")
                return list(facts.params) if facts is not None else None
        facts = index.resolve_call(binding.target_raw, summary, caller)
        return list(facts.params) if facts is not None else None

    @staticmethod
    def _varying_reason(expr: ast.AST, loop_vars: "Set[str]", params) -> "Optional[str]":
        if isinstance(expr, ast.Name) and expr.id in loop_vars:
            return f"loop variable '{expr.id}' (one compile per iteration)"
        if isinstance(expr, ast.JoinedStr):
            return "an f-string (unbounded static key space)"
        if isinstance(expr, ast.Call):
            target = call_target(expr)
            if target == "len" and expr.args:
                arg = expr.args[0]
                base = arg
                while isinstance(base, (ast.Attribute, ast.Subscript)):
                    base = base.value
                if isinstance(base, ast.Name) and base.id in params:
                    return f"len() of parameter '{base.id}' (per-request length)"
            if target is not None and (
                target.startswith(_VARYING_CALL_PREFIXES) or target in _VARYING_CALLS
            ):
                return f"'{target}()' (a new value every call)"
        return None
