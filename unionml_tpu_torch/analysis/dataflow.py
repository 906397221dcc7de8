"""Forward dataflow over :mod:`unionml_tpu_torch.analysis.cfg` graphs.

The framework is deliberately small: a gen/kill lattice over sets of hashable
facts, a worklist solver, and per-node IN maps.  Two join modes cover every
rule built so far:

* **may** (set union, the default) — "does *some* path carry this fact here?"
  Used by the resource-leak family (TPU016/TPU017/TPU019), lock-across-yield
  (TPU018) and the path-sensitive use-after-donate upgrade (TPU002).
* **must** (set intersection) — "does *every* path carry it?"  Used by
  :func:`dominators`, which TPU015 uses to accept a retry bound only when the
  bound test dominates the loop back edge.

Transfer functions are *edge-aware*.  A problem describes three things:

* :meth:`Problem.gen_kill` — the facts a node generates and kills when it
  completes **normally**.
* exception edges apply only the kills (``out = in - kill``): if the
  acquiring statement itself raised, the acquisition never happened, while a
  release that raises has still released.
* :meth:`Problem.assume` — an optional filter applied on ``true``/``false``
  branch edges, giving cheap path sensitivity (e.g. "on the branch where
  ``retry_after is not None`` the charge did not happen").

Facts are opaque hashable values; rules use tuples like
``(var, protocol, line)``.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, FrozenSet, Hashable, Optional, Set, Tuple

from unionml_tpu_torch.analysis.cfg import BACK, CFG, EXC, FALSE, TRUE, CFGNode

__all__ = ["Problem", "Solution", "solve_forward", "dominators"]

Fact = Hashable
Facts = FrozenSet[Fact]

EMPTY: Facts = frozenset()


class Problem:
    """Base class for forward gen/kill dataflow problems."""

    #: union join when True (may-analysis), intersection when False (must).
    may = True

    #: When False (default), exception edges apply only kills: if the node
    #: itself raised, its acquisitions never happened.  Problems tracking
    #: "was this node executed" (dominators) set True.
    gen_on_exc = False

    def entry_facts(self, cfg: CFG) -> Facts:
        return EMPTY

    def gen_kill(self, node: CFGNode) -> Tuple[Set[Fact], Set[Fact]]:
        """Facts generated / killed when ``node`` completes normally."""
        return set(), set()

    def apply_kill(self, facts: Set[Fact], kill: Set[Fact]) -> Set[Fact]:
        """How kills match facts.  Default: exact-element set difference.
        Problems whose facts carry provenance (e.g. the acquisition line)
        override this to match on a prefix."""
        return facts - kill

    def assume(self, node: CFGNode, branch: str, facts: Facts) -> Facts:
        """Refine ``facts`` along a ``true``/``false`` edge out of ``node``."""
        return facts

    # Iteration bound; CFGs are per-function so this is generous.
    max_iterations = 100000


class Solution:
    """Per-node IN sets plus the facts reaching the synthetic exits."""

    def __init__(self, cfg: CFG, ins: Dict[int, Optional[Facts]]) -> None:
        self.cfg = cfg
        self._ins = ins

    def in_facts(self, nid: int) -> Facts:
        facts = self._ins.get(nid)
        return EMPTY if facts is None else facts

    def reachable(self, nid: int) -> bool:
        return self._ins.get(nid) is not None

    @property
    def at_raise(self) -> Facts:
        return self.in_facts(self.cfg.raise_node)

    @property
    def at_exit(self) -> Facts:
        return self.in_facts(self.cfg.exit)


def _edge_out(problem: Problem, node: CFGNode, in_facts: Facts, kind: str) -> Facts:
    gen, kill = problem.gen_kill(node)
    base = problem.apply_kill(set(in_facts), kill) if kill else set(in_facts)
    if kind == EXC and not problem.gen_on_exc:
        out: Facts = frozenset(base)
    else:
        out = frozenset(base | gen)
        if kind in (TRUE, FALSE):
            out = frozenset(problem.assume(node, kind, out))
    return out


def solve_forward(cfg: CFG, problem: Problem) -> Solution:
    """Iterate the worklist to a fixed point; ``None`` IN means unreachable."""
    ins: Dict[int, Optional[Facts]] = {nid: None for nid in cfg.nodes}
    ins[cfg.entry] = frozenset(problem.entry_facts(cfg))
    work = deque([cfg.entry])
    queued = {cfg.entry}
    iterations = 0
    while work:
        iterations += 1
        if iterations > problem.max_iterations:  # pragma: no cover - safety net
            break
        nid = work.popleft()
        queued.discard(nid)
        node = cfg.nodes[nid]
        in_facts = ins[nid]
        if in_facts is None:
            continue
        for succ, kind in node.succs:
            out = _edge_out(problem, node, in_facts, kind)
            old = ins[succ]
            if old is None:
                new = out
            elif problem.may:
                new = old | out
            else:
                new = old & out
            if new != old:
                ins[succ] = new
                if succ not in queued:
                    queued.add(succ)
                    work.append(succ)
    return Solution(cfg, ins)


class _Dominators(Problem):
    may = False  # intersection: a node dominates iff it is on *every* path
    gen_on_exc = True  # a raising node was still executed on that path

    def entry_facts(self, cfg: CFG) -> Facts:
        return frozenset({cfg.entry})

    def gen_kill(self, node: CFGNode):  # type: ignore[override]
        return {node.nid}, set()


def dominators(cfg: CFG) -> Dict[int, FrozenSet[int]]:
    """Map node id -> set of dominator node ids (reflexive).

    Computed as a must-forward problem: IN[n] = ∩ over preds of (IN[p] ∪ {p}),
    so ``d in dominators(cfg)[n]`` iff every path from entry to ``n`` passes
    through ``d``.  Unreachable nodes map to the empty set.
    """
    sol = solve_forward(cfg, _Dominators())
    out: Dict[int, FrozenSet[int]] = {}
    for nid in cfg.nodes:
        if sol.reachable(nid):
            out[nid] = frozenset(sol.in_facts(nid) | {nid})
        else:
            out[nid] = frozenset()
    return out
