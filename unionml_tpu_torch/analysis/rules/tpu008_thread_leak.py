"""TPU008 — leaked engine thread: started in a closeable class, never joined.

The serving stack's lifecycle contract is that ``close()`` tears everything
down: the continuous engine joins its decode thread, the replica set joins its
autoscaler loop, the HTTP server drains its handlers. Elastic runtime resize
(disaggregated serving) multiplies the places a background thread gets
started — and a thread that outlives ``close()`` keeps dispatching against a
device pool (or a replica fleet) the owner believes is gone: the exact bug
class PR 3's sweep found live in the engine once already.

The rule: inside a class that defines ``close()``, every
``threading.Thread(...)`` must be *joinable from the object* —

- assigned to a ``self.<attr>`` on which ``.join(...)`` is called somewhere
  in the class (any method; the engine's lazily started ``_thread`` joined in
  ``close`` is the canonical idiom), or
- tracked into a ``self.<container>`` via ``.append(...)``/``.add(...)``
  (the fork-worker list pattern — the container's consumer joins), or
- a local that is ``.join()``-ed in the same method (scoped helper threads,
  like a warmup fan-out).

Flagged: a Thread assigned to an attribute no method ever joins, and a
fire-and-forget local/immediate ``threading.Thread(...).start()`` in a method
of a closeable class. ``daemon=True`` is NOT an exemption — the engine thread
is a daemon AND joined; daemonhood saves interpreter exit, not the live
``close()``-then-reuse sequence.

Out of scope (the usual conservative posture): classes without a ``close``
method (nothing promises teardown), module-level functions (no lifecycle
object to leak from), and threads created by other objects.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import call_target

_THREAD_FACTORIES = {"threading.Thread", "Thread"}
_TRACK_METHODS = {"append", "add", "appendleft"}
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _ordered_scope(node: ast.AST):
    """``iter_scope`` in SOURCE order: the create→track→join dataflow below is
    order-sensitive, and the shared stack-based walker visits siblings in
    reverse."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, _SCOPE_NODES):
            yield from _ordered_scope(child)


def _is_thread_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and call_target(node) in _THREAD_FACTORIES


def _self_attr_of(node: ast.AST) -> Optional[str]:
    """``self.X`` → ``"X"`` (None otherwise)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class LeakedEngineThread(Rule):
    id = "TPU008"
    title = "thread started in a closeable class but never joined/tracked"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, path))
        return findings

    def _check_class(self, cls: ast.ClassDef, path: str) -> "List[Finding]":
        methods = [
            node for node in cls.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        if not any(method.name == "close" for method in methods):
            return []
        joined_attrs = self._joined_attrs(cls)
        findings: "List[Finding]" = []
        #: self attributes assigned a Thread anywhere in the class, keyed on
        #: the FIRST assignment node (the report site)
        thread_attrs: "Dict[str, ast.AST]" = {}
        for method in methods:
            findings.extend(
                self._check_method(method, thread_attrs, joined_attrs, path)
            )
        for attr, node in thread_attrs.items():
            if attr not in joined_attrs:
                findings.append(self.finding(
                    path, node,
                    f"threading.Thread assigned to self.{attr} in a class with close() "
                    f"but no method ever calls self.{attr}.join(...) — the thread "
                    "outlives close(); join it there (a daemon flag only covers "
                    "interpreter exit, not teardown-then-reuse)",
                ))
        return findings

    @staticmethod
    def _joined_attrs(cls: ast.ClassDef) -> "Set[str]":
        """Attributes ``.join(...)``-ed anywhere in the class, including via a
        local alias (``thread = self._thread; ... thread.join()`` — the
        engine-loop idiom that keeps the join outside the lock)."""
        joined: "Set[str]" = set()
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            #: local name -> self attribute it aliases, within this method
            aliases: "Dict[str, str]" = {}
            for node in ast.walk(method):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target = node.targets[0]
                    attr = _self_attr_of(node.value)
                    if isinstance(target, ast.Name) and attr is not None:
                        aliases[target.id] = attr
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"
                ):
                    receiver = node.func.value
                    attr = _self_attr_of(receiver)
                    if attr is not None:
                        joined.add(attr)
                    elif isinstance(receiver, ast.Name) and receiver.id in aliases:
                        joined.add(aliases[receiver.id])
        return joined

    def _check_method(
        self,
        method: ast.AST,
        thread_attrs: "Dict[str, ast.AST]",
        joined_attrs: "Set[str]",
        path: str,
    ) -> "List[Finding]":
        findings: "List[Finding]" = []
        #: local names bound to a Thread in this method, with their creation
        #: node; names that get joined/tracked/stored are discharged
        locals_pending: "Dict[str, ast.AST]" = {}
        #: Thread(...) Call nodes consumed by an enclosing Assign handler —
        #: iter_scope revisits them as bare Calls, which must not re-report
        handled_calls: "Set[int]" = set()
        for node in _ordered_scope(method):
            if isinstance(node, ast.Assign) and _is_thread_call(node.value):
                handled_calls.add(id(node.value))
                handled = False
                for target in node.targets:
                    attr = _self_attr_of(target)
                    if attr is not None:
                        thread_attrs.setdefault(attr, node)
                        handled = True
                    elif isinstance(target, ast.Name):
                        locals_pending[target.id] = node
                        handled = True
                if not handled:
                    findings.append(self.finding(
                        path, node,
                        "threading.Thread stored where no join can reach it in a "
                        "class with close()",
                    ))
                continue
            if _is_thread_call(node) and id(node) not in handled_calls:
                findings.append(self.finding(
                    path, node,
                    "fire-and-forget threading.Thread in a class with close(): "
                    "nothing can ever join it — assign and join it in close(), "
                    "or track it in a joined container",
                ))
                continue
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                receiver = node.func.value
                if node.func.attr == "join" and isinstance(receiver, ast.Name):
                    locals_pending.pop(receiver.id, None)
                if node.func.attr in _TRACK_METHODS and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Name):
                        # tracked into a container (self.<threads>.append(t)):
                        # the container's consumer owns the join
                        locals_pending.pop(arg.id, None)
            if isinstance(node, ast.Assign):
                # re-binding a pending local to self.<attr> promotes it to the
                # attribute contract; any other re-binding keeps it pending
                value = node.value
                if isinstance(value, ast.Name) and value.id in locals_pending:
                    for target in node.targets:
                        attr = _self_attr_of(target)
                        if attr is not None:
                            thread_attrs.setdefault(attr, locals_pending.pop(value.id))
                            break
        for name, node in locals_pending.items():
            findings.append(self.finding(
                path, node,
                f"thread {name!r} started in a method of a class with close() is "
                "neither joined here, stored on self, nor tracked in a container — "
                "it outlives close()",
            ))
        return findings
