"""TPU003 — unlocked mutation of lock-guarded shared state.

The serving stack is threaded (submit from executor threads, a dedicated
engine thread, replica schedulers), and its classes follow one discipline: a
class that owns a ``threading.Lock``/``RLock``/``Condition`` guards its shared
attributes with ``with self._lock:`` blocks. The race this rule catches is the
half-guarded attribute: ``self._x`` is mutated or read under the lock in one
method and mutated WITHOUT it in another — two threads interleave, an
increment is lost or a list is resized mid-iteration, and it only reproduces
under production load.

Conventions honored (both are this codebase's existing idiom):

- ``__init__``/``__new__``/``__del__`` are exempt — construction happens
  before the object is shared;
- methods named ``*_locked`` are exempt — their docstring contract is
  "caller holds the lock" and the engine calls them from inside ``with``
  blocks (flagging them would punish the helper-extraction the discipline
  encourages).

Unlocked READS are deliberately not flagged: snapshot-style reads of counters
are a documented pattern here (and mostly benign); lost-update mutations are
the class of bug that corrupts state.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import LOCK_FACTORIES, call_target, self_attribute

_LOCK_FACTORIES = LOCK_FACTORIES

#: method calls that mutate their receiver in place
_MUTATING_METHODS = {
    "append", "appendleft", "extend", "insert", "remove", "pop", "popleft",
    "popitem", "clear", "update", "add", "discard", "setdefault", "sort", "reverse",
}

_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__post_init__"}


@dataclasses.dataclass
class _Access:
    attr: str
    mutation: bool
    under_lock: bool
    node: ast.AST
    method: str


class UnlockedSharedMutation(Rule):
    id = "TPU003"
    title = "lock-guarded attribute mutated outside the lock"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, path))
        return findings

    def _check_class(self, cls: ast.ClassDef, path: str) -> "List[Finding]":
        locks = self._lock_attributes(cls)
        if not locks:
            return []
        accesses: "List[_Access]" = []
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name in _EXEMPT_METHODS or method.name.endswith("_locked"):
                continue
            self._walk(method, method.name, locks, under_lock=False, accesses=accesses)
        guarded: "Set[str]" = {a.attr for a in accesses if a.under_lock}
        findings: "List[Finding]" = []
        for access in accesses:
            if access.mutation and not access.under_lock and access.attr in guarded:
                findings.append(
                    self.finding(
                        path, access.node,
                        f"'self.{access.attr}' is mutated in {access.method}() without holding "
                        f"the lock, but is accessed under 'with self.{sorted(locks)[0]}:' "
                        "elsewhere in the class — racy lost update",
                    )
                )
        return findings

    # ------------------------------------------------------------------ helpers

    @staticmethod
    def _lock_attributes(cls: ast.ClassDef) -> "Set[str]":
        """Attributes assigned a Lock/RLock/Condition anywhere in the class."""
        locks: "Set[str]" = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if call_target(node.value) in _LOCK_FACTORIES:
                    for target in node.targets:
                        attr = self_attribute(target)
                        if attr is not None and isinstance(target, ast.Attribute):
                            locks.add(attr)
        return locks

    def _walk(
        self,
        node: ast.AST,
        method: str,
        locks: "Set[str]",
        under_lock: bool,
        accesses: "List[_Access]",
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                continue  # nested scopes: a closure's lock discipline is its own
            if isinstance(child, ast.With):
                holds = under_lock or any(
                    self_attribute(item.context_expr) in locks for item in child.items
                )
                for item in child.items:
                    self._record_expr(item.context_expr, method, locks, under_lock, accesses)
                for stmt in child.body:
                    self._walk(stmt, method, locks, holds, accesses)
                continue
            if isinstance(child, (ast.Assign, ast.AnnAssign)):
                targets = child.targets if isinstance(child, ast.Assign) else [child.target]
                for target in targets:
                    self._record_target(target, method, locks, under_lock, accesses)
                if child.value is not None:
                    self._record_expr(child.value, method, locks, under_lock, accesses)
                continue
            if isinstance(child, ast.AugAssign):
                self._record_target(child.target, method, locks, under_lock, accesses, aug=True)
                self._record_expr(child.value, method, locks, under_lock, accesses)
                continue
            self._record_expr(child, method, locks, under_lock, accesses, walk_children=False)
            self._walk(child, method, locks, under_lock, accesses)

    def _record_target(
        self,
        target: ast.AST,
        method: str,
        locks: "Set[str]",
        under_lock: bool,
        accesses: "List[_Access]",
        aug: bool = False,
    ) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for element in target.elts:
                self._record_target(element, method, locks, under_lock, accesses, aug=aug)
            return
        if isinstance(target, ast.Starred):
            self._record_target(target.value, method, locks, under_lock, accesses, aug=aug)
            return
        # self.x = ..., self.x[k] = ..., self.x.y = ... all mutate self.x
        attr = self_attribute(target)
        if attr is not None and attr not in locks:
            accesses.append(_Access(attr, True, under_lock, target, method))

    def _record_expr(
        self,
        node: ast.AST,
        method: str,
        locks: "Set[str]",
        under_lock: bool,
        accesses: "List[_Access]",
        walk_children: bool = True,
    ) -> None:
        """Record reads of self attributes and in-place-mutating method calls."""
        nodes = ast.walk(node) if walk_children else [node]
        for child in nodes:
            if isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute):
                if child.func.attr in _MUTATING_METHODS:
                    attr = self_attribute(child.func.value)
                    if attr is not None and attr not in locks:
                        accesses.append(_Access(attr, True, under_lock, child, method))
            elif isinstance(child, ast.Attribute) and isinstance(child.ctx, ast.Load):
                attr = self_attribute(child)
                if attr is not None and attr not in locks:
                    accesses.append(_Access(attr, False, under_lock, child, method))
