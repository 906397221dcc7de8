"""TPU013 — blocking cross-process collective called while holding a lock.

Multi-host fleets (serving/cluster.py, distributed.py) add a new
failure shape the single-process rules cannot see: a CROSS-PROCESS
rendezvous. ``multihost_utils.sync_global_devices`` / ``broadcast_one_to_all``
/ ``process_allgather``, the ``jax.distributed`` barrier/KV waits, and the
fleet's own control-plane RPC helpers all block THIS process until every
peer (or the addressed worker) arrives. Held under a lock from
``_common.LOCK_FACTORIES`` the blast radius changes category: a one-host
stall (a peer wedged in XLA, a worker mid-restart) turns into every thread
on THIS host queueing behind the lock — and if any peer needs that lock's
owner to make progress before reaching its own collective, the whole fleet
deadlocks. The coordinator's posture is route-around-the-dead-host; a
collective under a lock is the one place that posture cannot save.

Scope (the TPU007/TPU010 conventions): within a class that owns a
``threading.Lock``/``RLock``/``Condition`` attribute, any flagged call
lexically inside a ``with self.<lock>:`` block — or anywhere inside a
``*_locked`` method, whose name promises the caller already holds the lock —
is a finding. Flagged calls:

- anything under ``multihost_utils.`` / ``jax.experimental.multihost_utils.``
  or the bare re-exports (``sync_global_devices``, ``broadcast_one_to_all``,
  ``process_allgather``);
- anything under ``jax.distributed.`` (initialize/shutdown and the KV-store
  client waits);
- the repo's own cross-process helpers: ``distributed.barrier`` /
  ``distributed.agree`` / ``distributed.allgather_ints`` (dotted or bare),
  and the cluster control-plane RPCs (``_call`` / ``_stream_call`` on a
  host handle, ``ping`` / ``probe`` on a remote host) — one wedged worker
  must cost that call, not the lock.

``__init__``-family methods are exempt (construction precedes sharing), and
classes without a lock attribute are out of scope.

The port's reading adds PyTorch's rendezvous, read only where none of the
forms above matched (so JAX sources keep their labels):

- ``torch.distributed.<op>``/``dist.<op>`` for the ops that wait for a peer:
  ``all_reduce``, ``all_gather``, ``all_gather_object``, ``broadcast``,
  ``broadcast_object_list``, ``reduce_scatter``, ``all_to_all``,
  ``barrier``, ``monitored_barrier``, ``send``, ``recv``;
- the collectives of ``unionml_tpu_torch/parallel/collectives.py`` that run
  one in their forward (``allreduce_sum``, ``allreduce_mean``,
  ``all_gather``, ``gather_from``, ``reduce_scatter``, ``broadcast``,
  ``ring_permute``, ``all_to_all``), called by a name imported from that
  module or from ``unionml_tpu_torch.parallel``.
  ``sum_gradients`` and ``split_to`` are left out: their forward is local,
  and their collective runs in the backward.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import LOCK_FACTORIES, call_target, imported_names, self_attribute

_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__post_init__"}

#: dotted-name prefixes that are always cross-process rendezvous
_COLLECTIVE_PREFIXES = (
    "multihost_utils.",
    "jax.experimental.multihost_utils.",
    "jax.distributed.",
    "distributed.",  # the package's distributed.barrier/agree/allgather_ints
)

#: exact names (bare imports of the multihost re-exports, and the repo's own
#: cross-process helpers) that block on a peer
_COLLECTIVE_NAMES = {
    "sync_global_devices",
    "broadcast_one_to_all",
    "process_allgather",
    "barrier",
    "agree",
    "allgather_ints",
}

#: method names whose receiver is a control-plane host handle — a blocking
#: RPC to one worker process (serving/cluster.py's RemoteHost surface)
_CONTROL_RPC_METHODS = {"_call", "_stream_call", "ping", "probe"}

#: torch.distributed's ops that block until the peers arrive
_TORCH_PREFIXES = ("torch.distributed.", "dist.")
_TORCH_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_object", "broadcast", "broadcast_object_list",
    "reduce_scatter", "all_to_all", "barrier", "monitored_barrier", "send", "recv",
}

#: the port's named collectives that run one in their forward
_PORT_COLLECTIVES_MODULE = "unionml_tpu_torch.parallel.collectives"
_PORT_COLLECTIVES = {
    "allreduce_sum", "allreduce_mean", "all_gather", "gather_from", "reduce_scatter", "broadcast",
    "ring_permute", "all_to_all",
}


def _port_collective_names(tree: ast.Module) -> "Set[str]":
    """The port's collectives imported by name from their module or from
    the ``parallel`` package, which re-exports them."""
    modules = {_PORT_COLLECTIVES_MODULE, _PORT_COLLECTIVES_MODULE.rsplit(".", 1)[0]}
    return imported_names(tree, modules, _PORT_COLLECTIVES)


class BlockingCollectiveUnderLock(Rule):
    id = "TPU013"
    title = "blocking cross-process collective while holding a lock"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        port_names: "Optional[Set[str]]" = None
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                if port_names is None:
                    port_names = _port_collective_names(tree)
                findings.extend(self._check_class(node, path, port_names))
        return findings

    def _check_class(self, cls: ast.ClassDef, path: str, port_names: "Set[str]") -> "List[Finding]":
        locks = self._lock_attributes(cls)
        if not locks:
            return []
        findings: "List[Finding]" = []
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name in _EXEMPT_METHODS:
                continue
            # a *_locked method's contract is "caller holds the lock": its whole
            # body is an under-lock region
            under = method.name.endswith("_locked")
            self._walk(method, method.name, locks, under, findings, path, port_names)
        return findings

    @staticmethod
    def _lock_attributes(cls: ast.ClassDef) -> "Set[str]":
        locks: "Set[str]" = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if call_target(node.value) in LOCK_FACTORIES:
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
        port_names: "Set[str]",
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                continue  # nested scopes run later, possibly lock-free
            if isinstance(child, ast.With):
                holds = under_lock or any(
                    self_attribute(item.context_expr) in locks for item in child.items
                )
                for stmt in child.body:
                    self._walk(stmt, method, locks, holds, findings, path, port_names)
                continue
            self._record(child, method, locks, under_lock, findings, path, port_names)
            self._walk(child, method, locks, under_lock, findings, path, port_names)

    def _record(
        self,
        node: ast.AST,
        method: str,
        locks: "Set[str]",
        under_lock: bool,
        findings: "List[Finding]",
        path: str,
        port_names: "Set[str]",
    ) -> None:
        if not under_lock or not isinstance(node, ast.Call):
            return
        label = self._collective_label(node) or self._torch_label(node, port_names)
        if label is None:
            return
        findings.append(
            self.finding(
                path, node,
                f"'{label}' blocks on another PROCESS while {method}() holds "
                f"'self.{sorted(locks)[0]}' — a stalled peer turns this host's lock into "
                "a fleet-wide stall (and a deadlock if the peer needs this lock's owner "
                "to progress); move the collective/RPC outside the locked section",
            )
        )

    @staticmethod
    def _collective_label(node: ast.Call) -> "str | None":
        target = call_target(node)
        if target is not None:
            for prefix in _COLLECTIVE_PREFIXES:
                if target.startswith(prefix):
                    return target
            if target in _COLLECTIVE_NAMES:
                return target
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _COLLECTIVE_NAMES:
                return func.attr
            if func.attr in _CONTROL_RPC_METHODS and target is None:
                # a control RPC on a computed receiver (self.hosts[i].probe(...)):
                # the dotted form was already covered above
                return func.attr
            if func.attr in _CONTROL_RPC_METHODS and target is not None and "." in target:
                return target
        return None

    @staticmethod
    def _torch_label(node: ast.Call, port_names: "Set[str]") -> "str | None":
        target = call_target(node)
        if target is None:
            return None
        for prefix in _TORCH_PREFIXES:
            if target.startswith(prefix) and target[len(prefix):] in _TORCH_COLLECTIVES:
                return target
        if target in port_names:
            return target
        return None
