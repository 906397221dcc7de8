"""TPU007 — ``*_locked`` helper called without holding the lock.

TPU003 polices direct attribute mutation, but it deliberately EXEMPTS methods
named ``*_locked``: their docstring contract is "caller holds the lock", and
the engine extracts its refcount/free-list bookkeeping — block allocator
returns, radix-cache pin/release/insert/eviction, slot finish/preempt — into
exactly such helpers. That trust has a caller-side hole: a ``*_locked``
helper invoked OUTSIDE a ``with self._lock:`` block mutates the same guarded
state TPU003 protects, with none of its scrutiny. The radix prefix cache
(serving/prefix_cache.py) widened this surface — the tree and the
``_free_blocks`` allocator are mutated exclusively through ``*_locked``
helpers, so one unlocked call site is a lost-update/corruption race on the
KV block pool.

This rule closes the hole: within a class that owns a
``threading.Lock``/``RLock``/``Condition`` attribute, every
``self._foo_locked(...)`` / ``cls._foo_locked(...)`` call must appear either
inside a ``with self.<lock>:`` block or inside another ``*_locked`` method
(the contract propagates to its caller).

Conventions honored (the codebase's existing idiom, mirroring TPU003):

- ``__init__``/``__new__``/``__del__``/``__post_init__`` are exempt —
  construction happens before the object is shared;
- calls on OTHER objects (``self.engine._foo_locked()``) are out of scope:
  the lock those helpers assume is the other object's, which a class-local
  analysis cannot see;
- classes without a lock attribute are out of scope — ``*_locked`` there is
  just a naming choice.
"""

from __future__ import annotations

import ast
from typing import List, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import LOCK_FACTORIES, call_target, self_attribute

_LOCK_FACTORIES = LOCK_FACTORIES

_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__post_init__"}


class UnlockedLockedHelperCall(Rule):
    id = "TPU007"
    title = "*_locked helper called without holding the lock"

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
        findings: "List[Finding]" = []
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name in _EXEMPT_METHODS or method.name.endswith("_locked"):
                continue
            self._walk(method, method.name, locks, under_lock=False, findings=findings, path=path)
        return findings

    @staticmethod
    def _lock_attributes(cls: ast.ClassDef) -> "Set[str]":
        """Attributes assigned a Lock/RLock/Condition anywhere in the class
        (the same detection TPU003 uses)."""
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
        findings: "List[Finding]",
        path: str,
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                continue  # nested scopes: a closure's lock discipline is its own
            if isinstance(child, ast.With):
                holds = under_lock or any(
                    self_attribute(item.context_expr) in locks for item in child.items
                )
                for stmt in child.body:
                    self._walk(stmt, method, locks, holds, findings, path)
                continue
            self._record(child, method, locks, under_lock, findings, path)
            self._walk(child, method, locks, under_lock, findings, path)

    def _record(
        self,
        node: ast.AST,
        method: str,
        locks: "Set[str]",
        under_lock: bool,
        findings: "List[Finding]",
        path: str,
    ) -> None:
        if under_lock or not isinstance(node, ast.Call):
            return
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr.endswith("_locked")):
            return
        # self/cls receivers only: another object's *_locked helper assumes
        # ITS owner's lock, which this class-local analysis cannot track
        if not (isinstance(func.value, ast.Name) and func.value.id in ("self", "cls")):
            return
        findings.append(
            self.finding(
                path, node,
                f"'self.{func.attr}()' is called in {method}() without holding "
                f"'self.{sorted(locks)[0]}' — its name promises the caller holds the "
                "lock (TPU003 exempts it on that basis), so this call races every "
                "guarded mutation inside it",
            )
        )
