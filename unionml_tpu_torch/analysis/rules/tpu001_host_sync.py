"""TPU001 — host sync inside a jit-compiled function.

A jitted function runs as one async XLA dispatch; anything that pulls a traced
value back to the host (``.item()``, ``float()``/``int()`` on a tracer,
``np.asarray``, ``jax.device_get``, ``.block_until_ready()`` or its
module-level twin ``jax.block_until_ready(x)``) either fails at
trace time or — worse, via implicit conversion paths — silently fences the
device queue, turning an overlap-everything pipeline into a round-trip per
step. ``print`` runs at trace time only (usually a debugging leftover; use
``jax.debug.print``). The rule marks every function that is jit-compiled
(``@jax.jit``/``@partial(jax.jit, ...)`` decorators, or ``jax.jit(fn)``
wrapping of a module function, method, or nested function), follows the
intra-module call graph from those entry points, and flags host-sync
operations anywhere in the reachable set.

Whole-program upgrade: :meth:`HostSyncInJit.check_project` re-runs the same
scan over the PROJECT index's cross-module reachable set — a jitted entry in
``serving/continuous.py`` calling a helper imported from ``ops/`` now carries
the taint into that helper's module, where the per-file pass could never
follow. Intra-module duplicates are dropped by the engine's dedupe.

The port's reading. PyTorch's counterpart of a jitted function is a
*captured program*: a function wrapped by the port's ``AOTFunction(fn, ...)``
(``self._decode = AOTFunction(self._decode, "decode", ...)``, recorded as one
CUDA graph per signature), or the body of a ``with torch.cuda.graph(...):``
block. Inside one, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``torch.cuda.synchronize()`` and ``np.asarray``/``np.array`` on a tensor wait
for the device: on the card the capture then fails, and ``AOTFunction``
raises rather than run the program eagerly; on the CPU they fence. Entries
are followed through the same reachability, across modules through the
index, and scanned with these detectors. The JAX detectors run only from jit
entries, so JAX sources get the JAX findings.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import (
    aot_aliases,
    call_target,
    dotted,
    is_capture_context,
    is_jit_decorator,
    iter_scope,
    jit_wrap_call,
)

#: calls that are a host sync no matter what their argument is
_SYNC_CALLS = {
    "jax.device_get": "jax.device_get() pulls values to the host",
    # both spellings of the fence: x.block_until_ready() is _SYNC_METHODS
    "jax.block_until_ready": "jax.block_until_ready() fences the device queue",
    "np.asarray": "np.asarray() on a tracer forces a host transfer",
    "np.array": "np.array() on a tracer forces a host transfer",
    "numpy.asarray": "numpy.asarray() on a tracer forces a host transfer",
    "numpy.array": "numpy.array() on a tracer forces a host transfer",
}

#: zero-arg methods that sync when called on a device array
_SYNC_METHODS = {"item", "tolist", "block_until_ready"}

#: the same hazards inside a captured program (an AOTFunction's CUDA graph)
_CAPTURE_SYNC_CALLS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for the device",
    "np.asarray": "np.asarray() on a tensor copies it to the host",
    "np.array": "np.array() on a tensor copies it to the host",
    "numpy.asarray": "numpy.asarray() on a tensor copies it to the host",
    "numpy.array": "numpy.array() on a tensor copies it to the host",
}
_CAPTURE_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CAPTURED = (
    "inside a captured program (AOTFunction / torch.cuda.graph) forces a host sync: "
    "the CUDA graph capture fails on the card"
)

_FuncNode = ast.FunctionDef  # AsyncFunctionDef handled alongside


class HostSyncInJit(Rule):
    id = "TPU001"
    title = "host sync inside a jit-compiled function"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        functions, entries = self._collect(tree)
        reachable = self._reachable(functions, entries)
        findings: "List[Finding]" = []
        for func in reachable:
            findings.extend(self._scan(func, path))
        # jitted lambdas have no def to put in the graph: scan their body directly
        for node in ast.walk(tree):
            wrap = jit_wrap_call(node)
            if wrap is not None and wrap.args and isinstance(wrap.args[0], ast.Lambda):
                findings.extend(self._scan(wrap.args[0], path, params=self._params(wrap.args[0])))
        findings.extend(self._check_captured(tree, path, functions))
        return findings

    def check_project(self, index) -> "List[Finding]":
        """Index-backed reachability: BFS from every jit entry point across
        the resolved cross-module call graph, scanning each reached function
        with the same host-sync detectors as the per-file pass; then the same
        from every capture entry with the captured-program detectors."""
        findings: "List[Finding]" = []
        for facts in index.reachable_from(index.jit_entry_functions()):
            findings.extend(self._scan(facts.node, facts.path))
        for facts in index.reachable_from(index.capture_entry_functions()):
            findings.extend(self._scan_captured(facts.node.body, facts.path))
        return findings

    # ------------------------------------------------------ captured programs

    def _check_captured(self, tree: ast.Module, path: str, functions: "Dict[str, ast.AST]") -> "List[Finding]":
        """The per-file pass of the port's reading: ``AOTFunction(fn, ...)``
        wraps and ``with torch.cuda.graph(...):`` bodies, followed through the
        same-module call graph."""
        aliases = aot_aliases(tree)
        entries: "List[ast.AST]" = []
        findings: "List[Finding]" = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and aliases and call_target(node) in aliases and node.args:
                entry = self._lookup(functions, dotted(node.args[0]))
                if entry is not None:
                    entries.append(entry)
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                is_capture_context(item) for item in node.items
            ):
                findings.extend(self._scan_captured(node.body, path))
                for stmt in node.body:
                    for child in [stmt, *iter_scope(stmt)]:
                        if isinstance(child, ast.Call):
                            entry = self._lookup(functions, call_target(child))
                            if entry is not None:
                                entries.append(entry)
        for func in self._reachable(functions, entries):
            findings.extend(self._scan_captured(func.body, path))
        return findings

    @staticmethod
    def _lookup(functions: "Dict[str, ast.AST]", target: "Optional[str]") -> "Optional[ast.AST]":
        if target is None:
            return None
        if target.startswith(("self.", "cls.")):
            target = "self." + target.split(".", 1)[1]
        return functions.get(target)

    def _scan_captured(self, body: "List[ast.AST]", path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        for stmt in body:
            for node in [stmt, *iter_scope(stmt)]:
                if not isinstance(node, ast.Call):
                    continue
                target = call_target(node)
                if target in _CAPTURE_SYNC_CALLS:
                    findings.append(self.finding(path, node, f"{_CAPTURE_SYNC_CALLS[target]} {_CAPTURED}"))
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _CAPTURE_SYNC_METHODS
                    and not node.args
                    and not node.keywords
                ):
                    findings.append(self.finding(path, node, f".{node.func.attr}() {_CAPTURED}"))
        return findings

    # ------------------------------------------------------------- collection

    @staticmethod
    def _params(func) -> "Set[str]":
        args = func.args
        names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        return set(names)

    def _collect(self, tree: ast.Module):
        """All function defs keyed by the names a same-module call site would
        use (bare name for module/nested functions, ``self.name`` for methods),
        plus the jit entry-point set."""
        functions: "Dict[str, ast.AST]" = {}
        entries: "List[ast.AST]" = []

        def visit(node: ast.AST, in_class: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    functions[child.name] = child
                    if in_class:
                        functions[f"self.{child.name}"] = child
                    if any(is_jit_decorator(dec) for dec in child.decorator_list):
                        entries.append(child)
                    visit(child, in_class=False)
                elif isinstance(child, ast.ClassDef):
                    visit(child, in_class=True)
                else:
                    visit(child, in_class=in_class)

        visit(tree, in_class=False)

        # jax.jit(fn, ...) wrapping: the first positional argument names the
        # compiled function — module-level, local, or a self.method reference
        for node in ast.walk(tree):
            wrap = jit_wrap_call(node)
            if wrap is None or not wrap.args:
                continue
            target = dotted(wrap.args[0])
            if target is None:
                continue
            if target in functions:
                entries.append(functions[target])
            elif target.startswith(("self.", "cls.")):
                bare = target.split(".", 1)[1]
                if f"self.{bare}" in functions:
                    entries.append(functions[f"self.{bare}"])
        return functions, entries

    def _reachable(self, functions: "Dict[str, ast.AST]", entries: "List[ast.AST]"):
        """BFS over same-module call edges from the jit entry points."""
        queue = list(entries)
        seen: "List[ast.AST]" = []
        while queue:
            func = queue.pop()
            if any(func is s for s in seen):
                continue
            seen.append(func)
            for node in iter_scope(func):
                if not isinstance(node, ast.Call):
                    continue
                target = call_target(node)
                if target is None:
                    continue
                if target.startswith(("self.", "cls.")):
                    target = "self." + target.split(".", 1)[1]
                callee = functions.get(target)
                if callee is not None:
                    queue.append(callee)
        return seen

    # ------------------------------------------------------------- detection

    def _scan(self, func, path: str, params: "Optional[Set[str]]" = None) -> "List[Finding]":
        params = self._params(func) if params is None else params
        findings: "List[Finding]" = []
        body = func.body if isinstance(func.body, list) else [func.body]  # Lambda body is an expr
        for stmt in body:
            for node in [stmt, *iter_scope(stmt)]:
                if not isinstance(node, ast.Call):
                    continue
                target = call_target(node)
                if target == "print":
                    findings.append(
                        self.finding(
                            path, node,
                            "print() inside a jit-compiled function runs at trace time only "
                            "(use jax.debug.print for runtime values)",
                        )
                    )
                elif target in _SYNC_CALLS:
                    findings.append(
                        self.finding(path, node, f"{_SYNC_CALLS[target]} inside a jit-compiled function")
                    )
                elif target in ("float", "int") and len(node.args) == 1 and self._is_param_value(
                    node.args[0], params
                ):
                    findings.append(
                        self.finding(
                            path, node,
                            f"{target}() on a traced argument inside a jit-compiled function "
                            "forces a host sync (and fails under jit)",
                        )
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS
                    and not node.args
                ):
                    findings.append(
                        self.finding(
                            path, node,
                            f".{node.func.attr}() inside a jit-compiled function forces a host sync",
                        )
                    )
        return findings

    @staticmethod
    def _is_param_value(expr: ast.AST, params: "Set[str]") -> bool:
        """``int(x)`` / ``int(x[0])`` where ``x`` is a traced parameter. Shape
        and dtype accesses (``int(x.shape[0])``) are static under jit and stay
        allowed — only the bare value and element reads sync."""
        if isinstance(expr, ast.Name):
            return expr.id in params
        if isinstance(expr, ast.Subscript):
            return isinstance(expr.value, ast.Name) and expr.value.id in params
        return False
