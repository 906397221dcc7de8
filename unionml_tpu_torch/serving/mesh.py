"""The continuous engine over a mesh: one controller, followers in lock step.

The JAX engine has a single controller: one Python process drives every
device and XLA inserts the collectives, so the engine does not know a mesh
exists. torch has no single-process SPMD over several devices: a mesh is one
process per rank, every rank running the same Python (see
:mod:`unionml_tpu_torch.parallel.mesh`). ``Generator`` calls are
deterministic given their arguments, so every rank simply makes the same
call. The engine is not: admission depends on when requests arrive, and
ranks that each scheduled for themselves would diverge, and deadlock in
the first collective they reached apart.

So rank 0 owns the scheduler: submits, admission, preemption, the block
allocator, the radix cache and every host decision are rank 0's alone.
Each device step of the engine is a named operation on the engine's device
state (``ContinuousBatcher._op_*``) whose arguments are host values: the
prompt columns and their positions, the admission's block-table row, the
slot, block ids appended at growth, slots masked at preemption or finish,
the gathered row of a radix hit (copy on write included), the number of
decode steps. Rank 0 records every operation it runs in a :class:`StepPlan`;
operations that run no collective (table updates, masks, the admission
scatter) wait in the plan, and the next one that does (a prefill chunk, a
first token, a decode dispatch) sends the whole plan in one broadcast before
it runs. Every other rank runs a follower loop
(``ContinuousBatcher._follow``) that receives each plan and runs exactly
those operations, in order, on its own shards: the same forwards, so the
same collectives, in the same order. ``submit`` on a follower raises;
``close()`` on rank 0 sends the plan that ends the followers, and a
follower's ``close()`` waits for it. While idle, rank 0 sends an empty plan
every :data:`HEARTBEAT_S` seconds, so no follower waits in a collective
long enough to reach the process group's timeout.

Sampling happens on rank 0 only: the head's vocab shards are gathered, so
every rank holds the whole logits; a sampled id is drawn by rank 0 and
broadcast (``Generator._draw``), and greedy ids are the argmax of logits
that are equal bit for bit on every rank. Ranks never draw from their own
generators.

Speculative decoding (``config.draft``) runs a dispatch's rounds as one
operation, ``spec_rounds``, whose argument is the host budget of each
slot: every rank rolls the draft's steps, the verify and the acceptance on
its own shards of both models. Acceptance compares tokens and
distributions that every rank holds whole (the draft's proposals and the
uniforms are drawn as above), so each round's stop condition reads the
same on every rank and the ranks leave the loop together. The draft's rows
are admitted by the same operations as the target's; the emitted tokens
and the acceptance counters are read on the leader.

The engine serves meshes with ``model``, ``sequence`` and ``expert`` axes.
A mesh with a ``data``, ``fsdp`` or ``dcn_data`` axis above 1 goes to the
replica layer, as in the JAX package (a batch-1 admission row cannot split
a batch axis): each replica's engine serves a submesh of one batch slice,
and its leader is the submesh's first rank. Over a submesh "rank 0" above
means that leader.
"""

from __future__ import annotations

import threading
from typing import Any, List, Tuple

import torch.distributed as dist

__all__ = ["HEARTBEAT_S", "StepPlan"]

#: seconds between the empty plans an idle controller sends
HEARTBEAT_S = 60.0


class StepPlan:
    """The leader's record of the engine's device operations since the last
    broadcast, and the followers' end of it. ``sent`` counts broadcasts.
    The leader is the mesh's first rank (rank 0 of a world mesh, a
    replica's first rank of a submesh)."""

    def __init__(self, mesh: Any):
        self.mesh = mesh
        self.leader = mesh.peer(mesh.axis_names, 0)
        # the mesh's own group (made with the mesh, by every rank of the
        # world): a follower's engine thread waits here while its main
        # thread stays free to run other collectives, and the other
        # replicas' ranks take no part. One engine serves a mesh at a time.
        self.group = mesh.plan_group
        self._pending: List[Tuple[str, Any, tuple]] = []
        self.sent = 0
        # the engine thread records every step; the idle heartbeat and a
        # caller driving one step by hand must not interleave with it
        self._lock = threading.Lock()

    def record(self, op: str, key: Any, args: tuple, collective: bool) -> None:
        """Add one operation; an operation that runs collectives sends the
        plan (this one last) before it runs."""
        with self._lock:
            self._pending.append((op, key, args))
            if collective:
                # the lock is held on purpose: it orders the plans the followers
                # run, and two threads' broadcasts on one group would deadlock
                dist.broadcast_object_list(  # tpu-lint: disable=TPU013 -- the lock orders plans
                    [self._pending], src=self.leader, group=self.group)
                self._pending = []
                self.sent += 1

    def receive(self) -> List[Tuple[str, Any, tuple]]:
        payload: List[Any] = [None]
        dist.broadcast_object_list(payload, src=self.leader, group=self.group)
        return payload[0]
