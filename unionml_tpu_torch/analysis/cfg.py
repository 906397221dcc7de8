"""Per-function control-flow graphs with exception edges.

tpu-lint's original rules are syntactic: they walk the AST and pattern-match
statements in source order.  That is blind to *paths* — an ``alloc`` whose
``free`` sits three statements later looks fine even if a call in between can
raise and skip the release forever.  This module builds a statement-level CFG
per function so the dataflow framework (:mod:`unionml_tpu_torch.analysis.dataflow`)
can reason about what happens on every path, including exceptional ones.

Design notes
------------

* **Granularity** — one :class:`CFGNode` per simple statement, plus one per
  compound-statement *header* (the ``if``/``while`` test, the ``for`` iterable,
  the ``with`` context expressions).  ``node.exprs`` holds only the
  expressions evaluated *at that node*, never the nested body.
* **Synthetic nodes** — every CFG has ``entry``, ``exit`` (normal function
  exit: explicit ``return`` or falling off the end) and ``raise_node`` (the
  function terminating with an uncaught exception).  ``with`` blocks get a
  ``with_exit`` node modelling ``__exit__`` — reached on normal completion,
  exceptions, and abrupt exits, which is exactly the guaranteed-release
  semantics.  ``try`` blocks with handlers get a ``dispatch`` node that fans
  out to each handler and, when no handler is a catch-all, onward to the
  enclosing handler/finally/RAISE.
* **Edge kinds** — ``next`` (sequential), ``true``/``false`` (branch taken /
  not taken; the test expression is available via ``node.stmt``), ``exc``
  (exception propagation) and ``back`` (loop back edge, also recorded in
  ``CFG.back_edges``).
* **``finally`` threading** — a ``finally`` body is duplicated per
  continuation kind that crosses it (normal fall-through, ``return``,
  ``break``, ``continue``, exception), the "splitting-style" modelling
  CPython's own compiler uses.  The merge-style alternative (one shared copy,
  fringe routed per kind) is cheaper but bleeds dataflow facts between
  continuations: a fact that is live only on the normal path would flow
  through the shared ``finally`` and out along the exception edge, producing
  phantom leak reports.  ``with`` gets the same treatment — one ``with_exit``
  node per continuation kind.
* **May-raise** — a node can raise iff it contains a :class:`ast.Call`, or is
  a ``raise``/``assert`` statement.  Attribute access, subscripts etc. are
  deliberately ignored: the rules built on this care about calls into the
  serving stack, and tighter may-raise sets keep the sweep signal clean.
* **Generators** — any node whose expressions contain ``yield``/``yield from``
  is marked ``is_yield``: a suspension point at which the consumer may never
  resume us, so anything held across it is held indefinitely.

Construction cost is tracked in a module-level accumulator so
``benchmarks/bench_lint.py`` can report ``cfg_build_ms`` without threading a
timer through every rule (:func:`consume_build_time_ms`).
"""

from __future__ import annotations

import ast
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CFG",
    "CFGNode",
    "build_cfg",
    "consume_build_time_ms",
    "NEXT",
    "TRUE",
    "FALSE",
    "EXC",
    "BACK",
]

NEXT = "next"
TRUE = "true"
FALSE = "false"
EXC = "exc"
BACK = "back"

#: Edge list type: ``(source node id, edge kind)`` pairs waiting for a target.
Edge = Tuple[int, str]

_build_time_ns = 0

#: calls modelled as never raising: monotonic clock reads have no failure
#: mode worth an exception edge, and they are pervasive in `finally` blocks
#: (timing instrumentation) where a spurious exc edge would make every
#: release look skippable
_NO_RAISE_CALLS = frozenset(
    {
        "time.monotonic",
        "time.monotonic_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "time.time",
    }
)


def consume_build_time_ms() -> float:
    """Return accumulated CFG construction time in ms and reset the counter."""
    global _build_time_ns
    ms = _build_time_ns / 1e6
    _build_time_ns = 0
    return ms


class CFGNode:
    """A single CFG node; ``kind`` is one of ``entry``/``exit``/``raise``/
    ``stmt``/``dispatch``/``handler``/``with_exit``."""

    __slots__ = ("nid", "kind", "stmt", "exprs", "succs", "preds", "line", "is_yield", "may_raise")

    def __init__(
        self,
        nid: int,
        kind: str,
        stmt: Optional[ast.AST] = None,
        exprs: Sequence[ast.AST] = (),
        line: int = 0,
    ) -> None:
        self.nid = nid
        self.kind = kind
        self.stmt = stmt
        self.exprs = [e for e in exprs if e is not None]
        self.succs: List[Edge] = []
        self.preds: List[Edge] = []
        self.line = line or getattr(stmt, "lineno", 0)
        self.is_yield = any(
            isinstance(sub, (ast.Yield, ast.YieldFrom))
            for e in self.exprs
            for sub in ast.walk(e)
        )
        self.may_raise = isinstance(stmt, (ast.Raise, ast.Assert)) or any(
            isinstance(sub, ast.Call) and _dotted(sub.func) not in _NO_RAISE_CALLS
            for e in self.exprs
            for sub in ast.walk(e)
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        label = type(self.stmt).__name__ if self.stmt is not None else ""
        return f"<CFGNode {self.nid} {self.kind} {label} L{self.line}>"


class CFG:
    """Control-flow graph for one function."""

    def __init__(self, func: ast.AST) -> None:
        self.func = func
        self.nodes: Dict[int, CFGNode] = {}
        self.entry = 0
        self.exit = 0
        self.raise_node = 0
        self.back_edges: List[Tuple[int, int]] = []

    def node(self, nid: int) -> CFGNode:
        return self.nodes[nid]

    def statement_nodes(self) -> List[CFGNode]:
        return [n for n in self.nodes.values() if n.kind not in ("entry", "exit", "raise")]


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


_CATCH_ALL = {"Exception", "BaseException"}


def _handler_is_catch_all(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    for t in types:
        name = _dotted(t).rsplit(".", 1)[-1]
        if name in _CATCH_ALL:
            return True
    return False


class _Frame:
    __slots__ = ("type", "dispatch", "breaks", "continues", "pending")

    def __init__(self, type_: str, dispatch: int = -1) -> None:
        self.type = type_
        self.dispatch = dispatch
        self.breaks: List[Edge] = []
        self.continues: List[Edge] = []
        # finally frames: continuation kind -> edges entering the finally
        self.pending: Dict[str, List[Edge]] = {}


class _Builder:
    def __init__(self, func: ast.AST) -> None:
        self.cfg = CFG(func)
        self._next_id = 0
        self.frames: List[_Frame] = []
        entry = self._new("entry", line=getattr(func, "lineno", 0))
        exit_n = self._new("exit")
        raise_n = self._new("raise")
        self.cfg.entry = entry.nid
        self.cfg.exit = exit_n.nid
        self.cfg.raise_node = raise_n.nid

    # ------------------------------------------------------------------ utils

    def _new(
        self,
        kind: str,
        stmt: Optional[ast.AST] = None,
        exprs: Sequence[ast.AST] = (),
        line: int = 0,
    ) -> CFGNode:
        node = CFGNode(self._next_id, kind, stmt, exprs, line)
        self._next_id += 1
        self.cfg.nodes[node.nid] = node
        return node

    def _connect(self, edges: Sequence[Edge], target: int) -> None:
        tgt = self.cfg.nodes[target]
        for src, kind in edges:
            self.cfg.nodes[src].succs.append((target, kind))
            tgt.preds.append((src, kind))
            if kind == BACK:
                self.cfg.back_edges.append((src, target))

    def _route(self, kind: str, edges: Sequence[Edge]) -> None:
        """Route abrupt-exit ``edges`` (kind ``return``/``break``/``continue``/
        ``raise``) through enclosing frames to their ultimate target."""
        if not edges:
            return
        for fr in reversed(self.frames):
            if fr.type == "finally":
                fr.pending.setdefault(kind, []).extend(edges)
                return
            if kind == "raise" and fr.type == "handler":
                self._connect(edges, fr.dispatch)
                return
            if kind in ("break", "continue") and fr.type == "loop":
                (fr.breaks if kind == "break" else fr.continues).extend(edges)
                return
        if kind == "raise":
            self._connect(edges, self.cfg.raise_node)
        else:
            self._connect(edges, self.cfg.exit)

    def _stmt_node(self, stmt: ast.stmt, exprs: Sequence[ast.AST], fringe: Sequence[Edge]) -> CFGNode:
        node = self._new("stmt", stmt, exprs)
        self._connect(fringe, node.nid)
        if node.may_raise:
            self._route("raise", [(node.nid, EXC)])
        return node

    # ------------------------------------------------------------ statements

    def build(self) -> CFG:
        body = getattr(self.cfg.func, "body", [])
        fringe = self._stmts(body, [(self.cfg.entry, NEXT)])
        self._connect(fringe, self.cfg.exit)
        return self.cfg

    def _stmts(self, stmts: Sequence[ast.stmt], fringe: Sequence[Edge]) -> List[Edge]:
        cur = list(fringe)
        for stmt in stmts:
            cur = self._stmt(stmt, cur)
        return cur

    def _stmt(self, stmt: ast.stmt, fringe: List[Edge]) -> List[Edge]:
        if isinstance(stmt, ast.If):
            return self._if(stmt, fringe)
        if isinstance(stmt, (ast.While,)):
            return self._while(stmt, fringe)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._for(stmt, fringe)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, fringe)
        if isinstance(stmt, ast.Try) or (
            hasattr(ast, "TryStar") and isinstance(stmt, ast.TryStar)
        ):
            return self._try(stmt, fringe)
        if isinstance(stmt, ast.Return):
            node = self._stmt_node(stmt, [stmt.value], fringe)
            self._route("return", [(node.nid, NEXT)])
            return []
        if isinstance(stmt, ast.Raise):
            node = self._new("stmt", stmt, [stmt.exc, stmt.cause])
            self._connect(fringe, node.nid)
            self._route("raise", [(node.nid, EXC)])
            return []
        if isinstance(stmt, ast.Break):
            node = self._new("stmt", stmt)
            self._connect(fringe, node.nid)
            self._route("break", [(node.nid, NEXT)])
            return []
        if isinstance(stmt, ast.Continue):
            node = self._new("stmt", stmt)
            self._connect(fringe, node.nid)
            self._route("continue", [(node.nid, NEXT)])
            return []
        if isinstance(stmt, ast.Assert):
            node = self._stmt_node(stmt, [stmt.test, stmt.msg], fringe)
            return [(node.nid, NEXT)]
        if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            return self._match(stmt, fringe)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            # Opaque: nested scopes get their own CFG; decorators may call.
            node = self._stmt_node(stmt, list(stmt.decorator_list), fringe)
            return [(node.nid, NEXT)]
        # Simple statements: Assign/AugAssign/AnnAssign/Expr/Delete/Import/...
        exprs = [v for v in ast.iter_child_nodes(stmt) if isinstance(v, ast.expr)]
        node = self._stmt_node(stmt, exprs, fringe)
        return [(node.nid, NEXT)]

    def _if(self, stmt: ast.If, fringe: List[Edge]) -> List[Edge]:
        node = self._stmt_node(stmt, [stmt.test], fringe)
        out = self._stmts(stmt.body, [(node.nid, TRUE)])
        if stmt.orelse:
            out = out + self._stmts(stmt.orelse, [(node.nid, FALSE)])
        else:
            out = out + [(node.nid, FALSE)]
        return out

    def _while(self, stmt: ast.While, fringe: List[Edge]) -> List[Edge]:
        node = self._stmt_node(stmt, [stmt.test], fringe)
        frame = _Frame("loop")
        self.frames.append(frame)
        body_fringe = self._stmts(stmt.body, [(node.nid, TRUE)])
        self.frames.pop()
        self._connect([(src, BACK) for src, _ in body_fringe], node.nid)
        self._connect([(src, BACK) for src, _ in frame.continues], node.nid)
        out: List[Edge] = list(frame.breaks)
        if stmt.orelse:
            out = out + self._stmts(stmt.orelse, [(node.nid, FALSE)])
        else:
            out = out + [(node.nid, FALSE)]
        return out

    def _for(self, stmt: ast.For, fringe: List[Edge]) -> List[Edge]:
        node = self._stmt_node(stmt, [stmt.iter, stmt.target], fringe)
        frame = _Frame("loop")
        self.frames.append(frame)
        body_fringe = self._stmts(stmt.body, [(node.nid, TRUE)])
        self.frames.pop()
        self._connect([(src, BACK) for src, _ in body_fringe], node.nid)
        self._connect([(src, BACK) for src, _ in frame.continues], node.nid)
        out: List[Edge] = list(frame.breaks)
        if stmt.orelse:
            out = out + self._stmts(stmt.orelse, [(node.nid, FALSE)])
        else:
            out = out + [(node.nid, FALSE)]
        return out

    def _with(self, stmt: ast.With, fringe: List[Edge]) -> List[Edge]:
        exprs: List[ast.AST] = []
        for item in stmt.items:
            exprs.append(item.context_expr)
            if item.optional_vars is not None:
                exprs.append(item.optional_vars)
        node = self._stmt_node(stmt, exprs, fringe)
        frame = _Frame("finally")
        self.frames.append(frame)
        body_fringe = self._stmts(stmt.body, [(node.nid, NEXT)])
        self.frames.pop()
        frame.pending.setdefault("normal", []).extend(body_fringe)
        out: List[Edge] = []
        for kind, edges in frame.pending.items():
            # one __exit__ node per continuation kind (splitting-style):
            # facts live only on the normal completion path must not bleed
            # onto the exception continuation through a shared exit node
            exit_node = self._new("with_exit", stmt, line=stmt.lineno)
            self._connect(edges, exit_node.nid)
            if kind == "normal":
                out = [(exit_node.nid, NEXT)]
            else:
                self._route(kind, [(exit_node.nid, EXC if kind == "raise" else NEXT)])
        return out

    def _try(self, stmt: ast.Try, fringe: List[Edge]) -> List[Edge]:
        fin_frame: Optional[_Frame] = None
        if stmt.finalbody:
            fin_frame = _Frame("finally")
            self.frames.append(fin_frame)
        dispatch: Optional[CFGNode] = None
        if stmt.handlers:
            dispatch = self._new("dispatch", stmt, line=stmt.lineno)
            self.frames.append(_Frame("handler", dispatch=dispatch.nid))
        body_fringe = self._stmts(stmt.body, fringe)
        if stmt.handlers:
            self.frames.pop()
        if stmt.orelse:
            body_fringe = self._stmts(stmt.orelse, body_fringe)
        after: List[Edge] = list(body_fringe)
        if dispatch is not None:
            catch_all = False
            for handler in stmt.handlers:
                hnode = self._new(
                    "handler", handler, [handler.type], line=handler.lineno
                )
                self._connect([(dispatch.nid, EXC)], hnode.nid)
                after.extend(self._stmts(handler.body, [(hnode.nid, NEXT)]))
                if _handler_is_catch_all(handler):
                    catch_all = True
            if not catch_all:
                self._route("raise", [(dispatch.nid, EXC)])
        if fin_frame is None:
            return after
        self.frames.pop()
        fin_frame.pending.setdefault("normal", []).extend(after)
        out: List[Edge] = []
        for kind, edges in fin_frame.pending.items():
            # splitting-style finally: one copy of the finalbody per
            # continuation kind, so facts from the normal path cannot bleed
            # onto the exception/return/break continuations (and vice versa)
            fin_fringe = self._stmts(stmt.finalbody, list(edges))
            if kind == "normal":
                out = list(fin_fringe)
            else:
                self._route(
                    kind,
                    [(src, EXC if kind == "raise" else k) for src, k in fin_fringe],
                )
        return out

    def _match(self, stmt: "ast.Match", fringe: List[Edge]) -> List[Edge]:
        node = self._stmt_node(stmt, [stmt.subject], fringe)
        out: List[Edge] = [(node.nid, FALSE)]
        for case in stmt.cases:
            out.extend(self._stmts(case.body, [(node.nid, TRUE)]))
        return out


def build_cfg(func: ast.AST) -> CFG:
    """Build the CFG for one ``FunctionDef``/``AsyncFunctionDef`` (or any node
    with a ``body`` of statements)."""
    global _build_time_ns
    start = time.perf_counter_ns()
    try:
        return _Builder(func).build()
    finally:
        _build_time_ns += time.perf_counter_ns() - start
