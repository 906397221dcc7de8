"""Shared machinery for the flow rules (TPU016-TPU019).

The four flow rules are all instances of one pattern: a gen/kill dataflow
problem over the per-function CFG (:mod:`unionml_tpu_torch.analysis.cfg`), where
facts are outstanding obligations — an unreleased resource, an unrefunded
tenant charge, a held lock — and the rule fires when a fact reaches a place
it must not (the RAISE exit, a ``return``, a ``yield``).

This module holds the protocol table (which calls acquire what, and what
releases it), the prescan that lets warm project passes skip the ~95% of
functions that mention no protocol at all, and the two dataflow problems
(:class:`ResourceFlow`, :class:`LockFlow`) the rules instantiate.

Ownership-transfer ("escape") semantics, validated against the real tree:

* ``return``/``yield`` reading the variable — the caller/consumer owns it now
  (``RemoteHost._connect`` returning its ``HTTPConnection``).
* storing it into an attribute or subscript — it outlives the function by
  design (``self._slot_blocks[slot] = alloc``, ``session.pins = pins``).
* passing it as a call argument — handing it to another owner
  (``subprocess.Popen(..., stdout=log_file)``, ``_RemoteStream(conn)``).
  Receiver position (``conn.request(...)``) is use, not escape.
* rebinding or ``del`` — the name no longer refers to the resource.

Escapes kill the fact: once ownership has moved, leaking is some other
scope's bug, and flagging it here would just teach people to suppress.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from unionml_tpu_torch.analysis.cfg import CFG, CFGNode
from unionml_tpu_torch.analysis.dataflow import Problem, solve_forward
from unionml_tpu_torch.analysis.rules._common import LOCK_FACTORIES, call_target, dotted, iter_scope

__all__ = [
    "PROTOCOLS",
    "Protocol",
    "ResourceFlow",
    "LockFlow",
    "acquire_proto_of_call",
    "derived_acquirers",
    "function_hints",
    "lock_token_of",
]


@dataclasses.dataclass(frozen=True)
class Protocol:
    name: str
    noun: str  #: human noun for messages
    fix: str  #: how to guarantee the release


PROTOCOLS: Dict[str, Protocol] = {
    "open-file": Protocol(
        "open-file", "file handle", "use `with open(...)` or close it in a try/finally"
    ),
    "socket": Protocol(
        "socket", "socket", "use `with socket.socket(...)` or close it in a try/finally"
    ),
    "http-conn": Protocol(
        "http-conn", "HTTP connection", "close it in a try/finally (or try/except + re-raise)"
    ),
    "kv-blocks": Protocol(
        "kv-blocks",
        "KV-cache block list",
        "return the blocks to the free list in a try/except before re-raising",
    ),
    "radix-pin": Protocol(
        "radix-pin",
        "pinned radix prefix blocks",
        "release the pins in a try/except before re-raising",
    ),
}

#: protocols whose release is ``<var>.close()``
CLOSE_PROTOS = frozenset({"open-file", "socket", "http-conn"})

#: resource fact: (variable, protocol name, acquisition line)
Fact = Tuple[str, str, int]


def acquire_proto_of_call(call: ast.Call) -> Optional[str]:
    """Protocol acquired by this call expression, if any (direct matchers)."""
    target = call_target(call)
    if target is None:
        return None
    last = target.rsplit(".", 1)[-1]
    if target == "open":
        return "open-file"
    if target == "socket.socket" or target.endswith(".socket.socket"):
        return "socket"
    if last in ("HTTPConnection", "HTTPSConnection"):
        return "http-conn"
    if (
        last == "pop"
        and isinstance(call.func, ast.Attribute)
        and "free_blocks" in (dotted(call.func.value) or "")
    ):
        return "kv-blocks"
    return None


def derived_acquirers(index) -> Dict[str, str]:
    """``FunctionFacts.fq -> protocol`` for one-hop acquire wrappers: functions
    whose body does ``return <direct acquire call>`` (``RemoteHost._connect``
    returning an ``HTTPConnection``).  A call to such a function acquires the
    same obligation as the call it wraps.

    Cached on the index — TPU016 and TPU019 both need the map, and the scan
    is gated on the prescan hints (a function with no direct acquire site
    cannot be returning one), so warm runs pay almost nothing."""
    cached = getattr(index, "_derived_acquirers", None)
    if cached is not None:
        return cached
    out: Dict[str, str] = {}
    for summary in index.modules.values():
        for facts in summary.functions.values():
            if not function_hints(summary, facts).protos:
                continue
            for node in iter_scope(facts.node):
                if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
                    proto = acquire_proto_of_call(node.value)
                    if proto is not None:
                        out[facts.fq] = proto
                        break
    index._derived_acquirers = out
    return out


# ------------------------------------------------------------------- prescan


@dataclasses.dataclass
class FlowHints:
    """What one function mentions, from a single cheap AST walk — memoized on
    the module summary so warm runs skip the walk *and* everything downstream."""

    protos: FrozenSet[str] = frozenset()  #: protocols with a direct acquire site
    calls: FrozenSet[str] = frozenset()  #: raw call targets (for derived acquirers)
    has_pin: bool = False
    has_charge: bool = False
    has_yield: bool = False
    has_lock: bool = False


def function_hints(summary, facts) -> FlowHints:
    key = (facts.qualname, facts.line)
    hints = summary.flow_hints.get(key)
    if hints is None:
        hints = _scan_hints(facts.node)
        summary.flow_hints[key] = hints
    return hints


def _scan_hints(func: ast.AST) -> FlowHints:
    protos: Set[str] = set()
    calls: Set[str] = set()
    has_pin = has_charge = has_yield = has_lock = False
    for node in iter_scope(func):
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            has_yield = True
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            has_lock = True  # candidate; LockFlow decides if it is really a lock
        elif isinstance(node, ast.Call):
            proto = acquire_proto_of_call(node)
            if proto is not None:
                protos.add(proto)
            target = call_target(node)
            if target is not None:
                calls.add(target)
                last = target.rsplit(".", 1)[-1]
                if last == "pin":
                    has_pin = True
                elif last in ("try_admit", "charge"):
                    has_charge = True
                elif last == "acquire":
                    has_lock = True
    return FlowHints(
        protos=frozenset(protos),
        calls=frozenset(calls),
        has_pin=has_pin,
        has_charge=has_charge,
        has_yield=has_yield,
        has_lock=has_lock,
    )


# ------------------------------------------------------- resource dataflow


def _loaded_names(node: ast.AST) -> Set[str]:
    return {
        sub.id
        for sub in ast.walk(node)
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
    }


def _stored_names(target: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(target):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, (ast.Store, ast.Del)):
            out.add(sub.id)
    return out


class ResourceFlow(Problem):
    """Outstanding acquire/release obligations (TPU016/TPU019).

    ``resolve`` maps an :class:`ast.Call` to the protocol it acquires through
    a one-hop wrapper (see :func:`derived_acquirers`); pass ``None`` when no
    index is available — direct matchers still apply.
    """

    def __init__(self, resolve=None) -> None:
        self._resolve = resolve
        self._memo: Dict[int, Tuple[Set[Fact], Set[Fact]]] = {}

    def _call_proto(self, call: ast.Call) -> Optional[str]:
        proto = acquire_proto_of_call(call)
        if proto is None and self._resolve is not None:
            proto = self._resolve(call)
        return proto

    def gen_kill(self, node: CFGNode):
        cached = self._memo.get(node.nid)
        if cached is not None:
            return cached
        gen: Set[Fact] = set()
        kill: Set[Fact] = set()
        kill_vars: Set[str] = set()  # (var, *) wildcards, expanded by the solver
        stmt = node.stmt
        if node.kind == "stmt" and stmt is not None:
            # -- acquires -------------------------------------------------
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                if (
                    len(targets) == 1
                    and isinstance(targets[0], ast.Name)
                    and stmt.value is not None
                ):
                    for call in ast.walk(stmt.value):
                        if isinstance(call, ast.Call):
                            proto = self._call_proto(call)
                            if proto is not None:
                                gen.add((targets[0].id, proto, node.line))
                                break
            for expr in node.exprs:
                for call in ast.walk(expr):
                    if not isinstance(call, ast.Call):
                        continue
                    func = call.func
                    method = func.attr if isinstance(func, ast.Attribute) else None
                    # arg-style acquire: <...radix...>.pin(name)
                    if (
                        method == "pin"
                        and "radix" in (dotted(func.value) or "")
                        and len(call.args) == 1
                        and isinstance(call.args[0], ast.Name)
                    ):
                        gen.add((call.args[0].id, "radix-pin", node.line))
                    # -- releases ------------------------------------------
                    if method == "close" and isinstance(func.value, ast.Name):
                        for proto in CLOSE_PROTOS:
                            kill.add((func.value.id, proto))
                    if (
                        method == "release"
                        and len(call.args) >= 1
                        and isinstance(call.args[0], ast.Name)
                    ):
                        kill.add((call.args[0].id, "radix-pin"))
                    if (
                        method in ("extend", "append")
                        and "free_blocks" in (dotted(func.value) or "")
                        and len(call.args) == 1
                        and isinstance(call.args[0], ast.Name)
                    ):
                        kill.add((call.args[0].id, "kv-blocks"))
                    # -- escape: passed as an argument (ownership transfer)
                    for arg in list(call.args) + [kw.value for kw in call.keywords]:
                        kill_vars |= _loaded_names(arg)
            # -- escape / rebind ------------------------------------------
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                for target in targets:
                    kill_vars |= _stored_names(target)  # rebind
                    if isinstance(target, (ast.Attribute, ast.Subscript)) and getattr(
                        stmt, "value", None
                    ) is not None:
                        kill_vars |= _loaded_names(stmt.value)  # outlives the function
            elif isinstance(stmt, ast.Delete):
                for target in stmt.targets:
                    kill_vars |= _stored_names(target)
            elif isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    kill_vars |= _loaded_names(stmt.value)  # caller owns it now
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                kill_vars |= _stored_names(stmt.target)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if item.optional_vars is not None:
                        kill_vars |= _stored_names(item.optional_vars)
            if node.is_yield:
                for expr in node.exprs:
                    for sub in ast.walk(expr):
                        if isinstance(sub, (ast.Yield, ast.YieldFrom)) and sub.value is not None:
                            kill_vars |= _loaded_names(sub.value)
        if kill_vars:
            for var in kill_vars:
                for proto in PROTOCOLS:
                    kill.add((var, proto))
        result = (gen, kill)
        self._memo[node.nid] = result
        return result

    def apply_kill(self, facts, kill):
        # kills are (var, proto); facts are (var, proto, line) — match prefix
        return {f for f in facts if (f[0], f[1]) not in kill}

    def assume(self, node, branch, facts):
        """Path sensitivity: on a branch where the variable is proven falsy
        (``if pins:`` not taken, ``if conn is None:`` taken) there is no
        resource behind the name — an empty pin list or a None handle carries
        no release obligation, so guarded-release idioms like
        ``if pins: release(pins)`` analyze clean on both branches."""
        stmt = node.stmt
        test = getattr(stmt, "test", None) if isinstance(stmt, (ast.If, ast.While)) else None
        if test is None:
            return facts
        falsy_var = None
        if isinstance(test, ast.Name):
            if branch == "false":
                falsy_var = test.id
        elif (
            isinstance(test, ast.UnaryOp)
            and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Name)
        ):
            if branch == "true":
                falsy_var = test.operand.id
        elif (
            isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and len(test.ops) == 1
            and len(test.comparators) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            if isinstance(test.ops[0], ast.Is) and branch == "true":
                falsy_var = test.left.id
            elif isinstance(test.ops[0], ast.IsNot) and branch == "false":
                falsy_var = test.left.id
        if falsy_var is None:
            return facts
        return {f for f in facts if f[0] != falsy_var}


def solve_resources(cfg: CFG, problem: ResourceFlow):
    return solve_forward(cfg, problem)


# ------------------------------------------------------------ lock dataflow


def lock_token_of(expr: ast.AST, lock_attrs: Set[str], module_locks: Set[str], local_types: Dict[str, str]) -> Optional[str]:
    """The lock identity of ``expr`` if it denotes a known lock, else None."""
    name = dotted(expr)
    if name is None:
        if isinstance(expr, ast.Call):
            target = call_target(expr)
            if target in LOCK_FACTORIES:
                return target  # `with threading.Lock():` — anonymous
        return None
    if name.startswith(("self.", "cls.")):
        attr = name.split(".", 1)[1]
        if "." not in attr and attr in lock_attrs:
            return name
        return None
    head = name.split(".", 1)[0]
    if name in module_locks or head in module_locks:
        return name
    if local_types.get(head) in LOCK_FACTORIES:
        return name
    return None


class LockFlow(Problem):
    """Which known locks are held (TPU018).  Facts are ``(token, line)``."""

    def __init__(self, lock_attrs: Set[str], module_locks: Set[str], local_types: Dict[str, str]) -> None:
        self._lock_attrs = lock_attrs
        self._module_locks = module_locks
        self._local_types = local_types

    def _token(self, expr: ast.AST) -> Optional[str]:
        return lock_token_of(expr, self._lock_attrs, self._module_locks, self._local_types)

    def _with_tokens(self, stmt: ast.AST) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        for item in stmt.items:
            token = self._token(item.context_expr)
            if token is not None:
                out.append((token, stmt.lineno))
        return out

    def gen_kill(self, node: CFGNode):
        gen: Set[Tuple[str, int]] = set()
        kill: Set[str] = set()  # lock tokens, matched against (token, line) facts
        stmt = node.stmt
        if node.kind == "stmt" and isinstance(stmt, (ast.With, ast.AsyncWith)):
            gen |= set(self._with_tokens(stmt))
        elif node.kind == "with_exit" and isinstance(stmt, (ast.With, ast.AsyncWith)):
            kill |= {token for token, _ in self._with_tokens(stmt)}
        elif node.kind == "stmt" and stmt is not None:
            for expr in node.exprs:
                for call in ast.walk(expr):
                    if not isinstance(call, ast.Call):
                        continue
                    func = call.func
                    if isinstance(func, ast.Attribute) and func.attr in ("acquire", "release"):
                        token = self._token(func.value)
                        if token is None:
                            continue
                        if func.attr == "acquire":
                            gen.add((token, node.line))
                        else:
                            kill.add(token)
        return gen, kill

    def apply_kill(self, facts, kill):
        return {f for f in facts if f[0] not in kill}
