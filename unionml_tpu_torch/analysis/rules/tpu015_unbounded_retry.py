"""TPU015 — network retry loop with neither an attempt bound nor a backoff.

The fleet's fault-tolerance layer (serving/cluster.py) made retrying control
RPCs a first-class idiom — and an unbounded one is the classic outage
amplifier: a loop that re-invokes a network call (``_call`` /
``_stream_call`` / ``ping`` / ``probe``, ``urlopen``, an ``http.client``
``getresponse``) as fast as exceptions arrive turns one dead worker into a
busy-spinning coordinator thread and a self-inflicted connect storm the
moment the worker returns. Every retry loop must carry at least one of the
two brakes the repo's own helper (``RemoteHost._call_retry``, the bounded
decorrelated-jitter envelope) carries both of: a **bounded attempt count**
or a **sleep/backoff between attempts**.

Detection (deliberately structural, not name-guessing):

- a ``while`` loop whose body (its own scope — nested function bodies run
  elsewhere) contains a flagged network call is a finding **unless** the
  loop is *bounded* — its test contains a comparison (``attempt < n``,
  ``time.monotonic() < deadline``), or the body carries a guarded exit
  (``if attempt >= n: break``/``raise``/``return``) whose test **dominates**
  the loop back edge (checked on the CFG: the bound must run on *every*
  iteration — one buried under a rare-path ``if`` bounds nothing) — or
  *paced* — an ``Event.wait``-style ``.wait(...)`` call in the test, or a
  ``time.sleep`` / ``asyncio.sleep`` / ``.wait(...)`` / ``*backoff*``-named
  call in the body;
- a ``for`` loop is inherently bounded by its iterable, EXCEPT over
  ``itertools.count()`` / ``cycle()`` (spelled dotted or bare), which get
  the same test.

Walking a finite host list re-invoking ``probe`` per host stays clean (one
attempt per host is not a retry), as does a poll loop that sleeps.
"""

from __future__ import annotations

import ast
from typing import List

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import call_target

#: method/function names whose invocation is a network round trip (the
#: control-plane RPC surface + the stdlib HTTP client verbs)
_NETWORK_NAMES = {"_call", "_stream_call", "ping", "probe", "urlopen", "getresponse"}

#: dotted prefixes that are always network receivers
_NETWORK_PREFIXES = ("http.client.", "urllib.request.")

#: calls that pace a loop (the "has a backoff" brake)
_PACING_NAMES = {"sleep"}  # time.sleep / asyncio.sleep / bare sleep

#: unbounded iterator constructors: a for-loop over one never ends
_UNBOUNDED_ITERS = {"count", "cycle", "itertools.count", "itertools.cycle"}


def _is_network_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    target = call_target(node)
    if target is not None:
        if any(target.startswith(prefix) for prefix in _NETWORK_PREFIXES):
            return True
        if target.rsplit(".", 1)[-1] in _NETWORK_NAMES:
            return True
    func = node.func
    return isinstance(func, ast.Attribute) and func.attr in _NETWORK_NAMES


def _is_pacing_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None
    )
    if name is None:
        return False
    return name in _PACING_NAMES or name == "wait" or "backoff" in name.lower()


def _own_scope_nodes(loop_body: "List[ast.stmt]") -> "List[ast.AST]":
    """Every node of the loop body's own scope (nested defs/lambdas/classes
    excluded — their bodies run at some other time, under some other pacing)."""
    out: "List[ast.AST]" = []
    stack: "List[ast.AST]" = list(loop_body)
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


class UnboundedNetworkRetry(Rule):
    id = "TPU015"
    title = "network retry loop with neither an attempt bound nor a backoff"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        for node in ast.walk(tree):
            if isinstance(node, ast.While):
                self._check_while(node, path, findings)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                self._check_for(node, path, findings)
        return findings

    def _check_while(self, loop: ast.While, path: str, findings: "List[Finding]") -> None:
        # a comparison in the test is a loop-variant bound (attempt counter,
        # deadline); an Event.wait-paced test throttles by construction
        bounded = any(isinstance(n, ast.Compare) for n in ast.walk(loop.test))
        paced = any(_is_pacing_call(n) for n in ast.walk(loop.test))
        if bounded or paced:
            return
        self._judge_body(loop, loop.body, path, findings)

    def _check_for(self, loop: "ast.For | ast.AsyncFor", path: str, findings: "List[Finding]") -> None:
        iterable = loop.iter
        if not isinstance(iterable, ast.Call):
            return
        target = call_target(iterable)
        if target not in _UNBOUNDED_ITERS:
            return  # a finite iterable bounds the loop
        self._judge_body(loop, loop.body, path, findings)

    def _judge_body(
        self, loop: ast.AST, body: "List[ast.stmt]", path: str, findings: "List[Finding]"
    ) -> None:
        nodes = _own_scope_nodes(body)
        network = next((n for n in nodes if _is_network_call(n)), None)
        if network is None:
            return
        if any(_is_pacing_call(n) for n in nodes):
            return
        if self._dominating_bound(loop):
            return
        label = call_target(network) or (
            network.func.attr if isinstance(network.func, ast.Attribute) else "network call"
        )
        findings.append(
            self.finding(
                path, network,
                f"'{label}' is re-invoked by an unbounded loop with no sleep/backoff — "
                "one dead peer becomes a busy-spin and a connect storm when it returns; "
                "bound the attempts (for attempt in range(n)) or pace the loop "
                "(decorrelated-jitter sleep, like RemoteHost._call_retry)",
            )
        )

    @staticmethod
    def _dominating_bound(loop: ast.AST) -> bool:
        """True when the loop body carries a guarded exit — an ``if`` whose
        test compares (``attempt >= max_attempts``) and whose taken branch
        leaves the loop (``break``/``raise``/``return``) — that **dominates**
        every back edge of the loop, i.e. the bound test actually runs on
        every iteration.  A bound check buried under a rare-path ``if`` (only
        tested when some flag flips) bounds nothing and does not count."""
        from unionml_tpu_torch.analysis.cfg import build_cfg
        from unionml_tpu_torch.analysis.dataflow import dominators

        holder = ast.Module(body=[loop], type_ignores=[])
        cfg = build_cfg(holder)
        header = next((n for n in cfg.statement_nodes() if n.stmt is loop), None)
        if header is None:
            return False
        backs = [src for src, dst in cfg.back_edges if dst == header.nid]
        if not backs:
            return False

        def _is_bound_node(n) -> bool:
            if n.stmt is None or n.stmt is loop or not isinstance(n.stmt, ast.If):
                return False
            if not any(isinstance(x, ast.Compare) for x in ast.walk(n.stmt.test)):
                return False
            return any(
                isinstance(x, (ast.Break, ast.Raise, ast.Return))
                for b in n.stmt.body
                for x in ast.walk(b)
            )

        bound_nids = {n.nid for n in cfg.statement_nodes() if _is_bound_node(n)}
        if not bound_nids:
            return False
        dom = dominators(cfg)
        return all(bound_nids & dom[src] for src in backs)
