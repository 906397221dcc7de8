"""The multi-process bootstrap shared by the mesh path, counterpart of
``unionml_tpu/distributed.py``.

The JAX package joins a ``jax.distributed`` runtime; the port joins a
``torch.distributed`` process group. The same three knobs place a process
(``UNIONML_TPU_COORDINATOR`` names the rendezvous ``host:port``,
``UNIONML_TPU_NUM_PROCESSES``/``UNIONML_TPU_PROCESS_ID`` the world size and
rank, read through :mod:`unionml_tpu_torch.defaults`), and torchrun's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` do
too, so ``torchrun --nproc-per-node N script.py`` needs no other setting.
With neither set every helper is a single-process no-op, as in JAX.

On top sit the small agreement primitives: :func:`barrier`, :func:`agree`
(every process returns process 0's JSON-able value) and
:func:`allgather_ints`. All three are collectives: every process of the
runtime calls them, and none while holding a lock (one stalled process
would deadlock the rest).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from unionml_tpu_torch.defaults import (
    distributed_coordinator,
    distributed_num_processes,
    distributed_process_id,
    env_int,
)

__all__ = [
    "agree",
    "allgather_ints",
    "barrier",
    "is_initialized",
    "maybe_initialize",
    "process_count",
    "process_index",
]

logger = logging.getLogger(__name__)

#: a served mesh waits on its peers between requests: a collective of the
#: default process group may wait this long before it fails
_TIMEOUT = datetime.timedelta(hours=6)


def _torchrun_env() -> Optional[tuple]:
    """``(address, world, rank)`` from torchrun's exports, or None."""
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    world, rank = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    if not (addr and port and world and rank):
        return None
    try:
        return f"{addr}:{port}", int(world), int(rank)
    except ValueError:
        # a rank cannot fall back to a default: two ranks of one id would
        # wait in the rendezvous until its timeout
        raise ValueError(f"torchrun's WORLD_SIZE={world!r} and RANK={rank!r} must be integers") from None


def is_initialized() -> bool:
    """Whether a ``torch.distributed`` process group exists in this process."""
    return dist.is_available() and dist.is_initialized()


def maybe_initialize(backend: Optional[str] = None) -> bool:
    """Join the process group the environment names, if any.

    Returns True when this process is part of a process group (a second call,
    or a group the caller made itself, is a no-op), False when the env names
    none: the single-process mode every caller must tolerate. ``backend``
    defaults to NCCL where CUDA is available, else gloo. ``LOCAL_RANK``
    picks the process's card (modulo the card count: two ranks may share
    one card, over gloo)."""
    if is_initialized():
        return True
    coordinator = distributed_coordinator()
    if coordinator:
        address, world, rank = coordinator, distributed_num_processes(), distributed_process_id()
    else:
        found = _torchrun_env()
        if found is None:
            return False
        address, world, rank = found
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(env_int("LOCAL_RANK", rank, minimum=0) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank, timeout=_TIMEOUT)
    logger.info(f"joined torch.distributed process group: rank {rank}/{world} over {backend}")
    return True


def process_index() -> int:
    """This process's rank once a group exists, else the env reader's."""
    if is_initialized():
        return dist.get_rank()
    found = None if distributed_coordinator() else _torchrun_env()
    return found[2] if found else distributed_process_id()


def process_count() -> int:
    """Processes in the group (1 single-process)."""
    if is_initialized():
        return dist.get_world_size()
    found = None if distributed_coordinator() else _torchrun_env()
    return found[1] if found else distributed_num_processes()


def barrier(name: str) -> None:
    """Fence every process at a named point (a no-op single-process). A
    collective: never call it while holding a lock."""
    del name  # the JAX package names its sync points; a torch barrier has no name
    if is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def agree(obj: Any) -> Any:
    """Every process returns process 0's JSON-able ``obj`` (the fleet-config
    handshake). Single-process: ``obj`` unchanged. A collective."""
    if not is_initialized() or dist.get_world_size() == 1:
        return obj
    payload = [json.dumps(obj, sort_keys=True) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(payload, src=0)
    return json.loads(payload[0])


def allgather_ints(value: int) -> List[int]:
    """One small integer per process, in rank order. Single-process:
    ``[value]``. A collective."""
    if not is_initialized() or dist.get_world_size() == 1:
        return [int(value)]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, int(value))
    return [int(v) for v in out]
