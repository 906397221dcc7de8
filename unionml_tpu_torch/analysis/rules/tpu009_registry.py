"""TPU009 — unbounded per-key registry: request-derived keys, no eviction.

A serving process lives for weeks; its host memory must be bounded by
CONSTRUCTION, not by hoping traffic is polite. The recurring bug shape: a
class keeps a ``dict`` keyed by a value the REQUEST chose — a tenant id, a
request id, a session/prefix key — and inserts on every request but never
evicts. A scanner (or one hostile tenant minting fresh ids) then grows the
map without bound: the multi-tenant registry, the flight recorder's in-flight
table, and the scheduler's affinity map are all exactly one missing eviction
away from this. The fixed forms in-tree: a bounded LRU (``popitem`` past a
capacity), idle-age eviction (``pop`` on a sweep), per-request removal
(``pop``/``del`` on completion), or rebuilding the map filtered (the resize
idiom).

The rule: inside ANY class, a subscript assignment (or ``setdefault``) on a
``self.<attr>`` whose KEY expression names a request-derived value — an
identifier whose last component contains ``tenant``, ``request_id``, ``rid``,
``session_id``, ``api_key``, or is exactly ``key``/``request`` — is flagged
unless the class shows an eviction path for that attribute somewhere:

- ``self.<attr>.pop(...)`` / ``.popitem(...)`` / ``.clear()``,
- ``del self.<attr>[...]``,
- a ``len(self.<attr>)`` comparison (the bound-check-then-evict idiom),
- re-assigning ``self.<attr>`` outside ``__init__`` (the filtered-rebuild
  idiom, e.g. the scheduler's resize).

Out of scope (conservative posture): module-level dicts (no lifecycle object
to bound), keys that are server-chosen (slot indices, route names), and
containers inserted into via methods (``.append`` lists are TPU008's thread
territory; bounded deques carry their own maxlen).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule

#: substrings of an identifier's LAST component that mark it request-derived
_KEY_MARKERS = ("tenant", "request_id", "rid", "session_id", "api_key")
#: exact identifiers that are request-derived on their own
_KEY_EXACT = {"key", "request"}
#: methods whose call on the attr counts as an eviction path
_EVICT_METHODS = {"pop", "popitem", "clear"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"`` (None otherwise)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _key_identifier(expr: ast.AST) -> Optional[str]:
    """The identifier a subscript KEY ultimately names: a bare name, the last
    attribute component (``session.tenant`` -> ``tenant``), or a call's
    receiver is NOT followed (``id(state)`` is server-derived)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _request_derived(expr: ast.AST) -> bool:
    name = _key_identifier(expr)
    if name is None:
        return False
    lowered = name.lower()
    if lowered in _KEY_EXACT:
        return True
    return any(marker in lowered for marker in _KEY_MARKERS)


class UnboundedPerKeyRegistry(Rule):
    id = "TPU009"
    title = "request-keyed dict in a class with no eviction/bound path"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, path))
        return findings

    def _check_class(self, cls: ast.ClassDef, path: str) -> "List[Finding]":
        inserts: "Dict[str, ast.AST]" = {}  # attr -> first insert site
        evictable = self._evictable_attrs(cls)
        for node in ast.walk(cls):
            attr = self._insert_attr(node)
            if attr is not None:
                inserts.setdefault(attr, node)
        return [
            self.finding(
                path, node,
                f"self.{attr} is inserted into with a request-derived key but the "
                "class has no eviction path for it (no pop/popitem/clear/del, no "
                "len() bound check, no filtered rebuild) — a hostile client minting "
                "fresh ids grows it without bound; add a capacity/idle eviction "
                "(see serving/tenancy.py's TenantRegistry)",
            )
            for attr, node in inserts.items()
            if attr not in evictable
        ]

    @staticmethod
    def _insert_attr(node: ast.AST) -> Optional[str]:
        """The ``self.<attr>`` a request-keyed insert targets, if ``node`` is
        one: ``self.X[key] = v`` or ``self.X.setdefault(key, v)``."""
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Subscript):
                    attr = _self_attr(target.value)
                    if attr is not None and _request_derived(target.slice):
                        return attr
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "setdefault"
            and node.args
        ):
            attr = _self_attr(node.func.value)
            if attr is not None and _request_derived(node.args[0]):
                return attr
        return None

    @staticmethod
    def _evictable_attrs(cls: ast.ClassDef) -> "Set[str]":
        """Attributes with ANY eviction/bound evidence in the class."""
        evictable: "Set[str]" = set()
        for node in ast.walk(cls):
            # self.X.pop(...) / .popitem() / .clear()
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _EVICT_METHODS
            ):
                attr = _self_attr(node.func.value)
                if attr is not None:
                    evictable.add(attr)
            # del self.X[...]
            if isinstance(node, ast.Delete):
                for target in node.targets:
                    if isinstance(target, ast.Subscript):
                        attr = _self_attr(target.value)
                        if attr is not None:
                            evictable.add(attr)
            # len(self.X) in a comparison: the bound-check-then-evict idiom
            if isinstance(node, ast.Compare):
                for expr in [node.left, *node.comparators]:
                    if (
                        isinstance(expr, ast.Call)
                        and isinstance(expr.func, ast.Name)
                        and expr.func.id == "len"
                        and expr.args
                    ):
                        attr = _self_attr(expr.args[0])
                        if attr is not None:
                            evictable.add(attr)
        # re-assignment outside __init__: the filtered-rebuild idiom
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__":
                continue
            for node in ast.walk(method):
                if isinstance(node, ast.Assign):
                    for target in node.targets:
                        attr = _self_attr(target)
                        if attr is not None:
                            evictable.add(attr)
        return evictable
