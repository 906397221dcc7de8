"""Shared AST helpers for tpu-lint rules (stdlib ``ast`` only)."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

#: names that compile a function for device execution when used as a decorator
#: or called with the function as first argument
JIT_NAMES = {"jax.jit", "jit", "pjit", "jax.pjit", "jax.experimental.pjit.pjit"}

#: constructors whose result is a mutual-exclusion lock (shared by TPU003,
#: TPU007, TPU010, and the project index's per-class lock discovery)
LOCK_FACTORIES = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "Lock",
    "RLock",
    "Condition",
}

#: the port's counterpart of ``jax.jit``: ``AOTFunction(fn, ...)`` records
#: one CUDA graph per signature of ``fn`` (unionml_tpu_torch/serving/aot.py)
AOT_MODULE = "unionml_tpu_torch.serving.aot"
AOT_CLASS = "AOTFunction"

#: context managers whose body is recorded into a CUDA graph
CAPTURE_CONTEXTS = {"torch.cuda.graph"}

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as ``"a.b.c"`` (None for anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_target(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def iter_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node``'s OWN scope: descend the tree but do not enter nested
    function/class/lambda bodies — their statements belong to other scopes."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, _SCOPE_NODES):
            stack.extend(ast.iter_child_nodes(child))


def literal_argnums(node: Optional[ast.AST]) -> Optional[Tuple[int, ...]]:
    """``donate_argnums=0`` or ``=(0, 2)`` as a tuple of ints; None when the
    value is absent or not a literal (a variable donate_argnums — e.g. gated on
    ``debug_disable_donation`` — cannot be analyzed and must not be guessed)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, int) and not isinstance(node.value, bool):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[int] = []
        for element in node.elts:
            if not (
                isinstance(element, ast.Constant)
                and isinstance(element.value, int)
                and not isinstance(element.value, bool)
            ):
                return None
            out.append(element.value)
        return tuple(out)
    return None


def jit_wrap_call(node: ast.AST) -> Optional[ast.Call]:
    """The ``jax.jit(...)``/``pjit(...)`` call itself, if ``node`` is one."""
    if isinstance(node, ast.Call) and call_target(node) in JIT_NAMES:
        return node
    return None


def is_jit_decorator(dec: ast.AST) -> bool:
    """``@jax.jit``, ``@jit``, ``@pjit``, ``@jax.jit(...)``, or
    ``@(functools.)partial(jax.jit, ...)``."""
    if dotted(dec) in JIT_NAMES:
        return True
    if isinstance(dec, ast.Call):
        if call_target(dec) in JIT_NAMES:
            return True
        if call_target(dec) in ("partial", "functools.partial") and dec.args:
            return dotted(dec.args[0]) in JIT_NAMES
    return False


def assign_target_names(node: ast.AST) -> List[str]:
    """Flattened simple/dotted names bound by an assignment target."""
    out: List[str] = []
    if isinstance(node, (ast.Tuple, ast.List)):
        for element in node.elts:
            out.extend(assign_target_names(element))
    elif isinstance(node, ast.Starred):
        out.extend(assign_target_names(node.value))
    else:
        name = dotted(node)
        if name is not None:
            out.append(name)
    return out


def self_attribute(node: ast.AST) -> Optional[str]:
    """``self.x`` -> ``"x"`` (one level only; ``self.x.y`` resolves to ``"x"``)."""
    while isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id in ("self", "cls"):
            return node.attr
        node = node.value
    return None


def imported_names(tree: ast.Module, modules: "Set[str]", names: "Set[str]") -> "Set[str]":
    """The local names that ``from <module> import <name> [as <alias>]``
    binds anywhere in ``tree``, for a module of ``modules`` and a name of
    ``names`` (absolute imports, the port's only form)."""
    out: "Set[str]" = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module in modules:
            out.update(alias.asname or alias.name for alias in node.names if alias.name in names)
    return out


def aot_aliases(tree: ast.Module) -> "Set[str]":
    """The spellings that call the port's ``AOTFunction`` in this module.
    The JAX package's ``unionml_tpu.serving.aot.AOTFunction`` serializes
    jitted executables and captures nothing, so it never matches."""
    return imported_names(tree, {AOT_MODULE}, {AOT_CLASS})


def is_capture_context(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g, ...):`` — the block is one captured program."""
    expr = item.context_expr
    return isinstance(expr, ast.Call) and call_target(expr) in CAPTURE_CONTEXTS
