"""Named device meshes over ``torch.distributed``, counterpart of
``unionml_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` that a single controller
drives. torch has no single-process SPMD over several devices: a mesh is
one process per rank, every rank running the same Python. So
:meth:`MeshSpec.build` joins (or starts) a process group and returns a
:class:`Mesh`: a grid of global ranks over the seven named axes, the
attributes of the JAX mesh the port reads (``shape``, ``axis_names``) and
this rank's coordinate, device and process groups.

Axis conventions are the JAX package's (all optional, size-1 axes free):
``data`` (rows of a batch), ``fsdp`` (parameter shards, all-gathered at
use), ``model`` (tensor parallelism), ``sequence`` (sequence-parallel
prefill and training), ``pipe`` (pipeline stages,
:mod:`unionml_tpu_torch.parallel.pipeline`; replicated where serving),
``expert`` (expert parallelism), ``dcn_data`` (the outer pure-data axis).

A mesh may also cover a *subset* of the world's ranks: the per-replica
submeshes of :func:`~unionml_tpu_torch.serving.replicas.slice_mesh`. Its
groups are made by every rank of the world, in the same order, members or
not (``dist.new_group`` is a collective of the world), so every rank slices
the same mesh at the same point. A rank outside a submesh holds it with
``local`` False and no coordinate. Among those groups is ``plan_group``, a
gloo group of all the mesh's ranks: the step plans of the one engine a
multi-rank mesh serves at a time (:mod:`unionml_tpu_torch.serving.mesh`)
and its KV handoffs ride it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from unionml_tpu_torch._device import DeviceLike, resolve_device

__all__ = ["AXIS_ORDER", "BATCH_AXES", "Mesh", "MeshSpec", "process_local_submeshes", "single_device_mesh"]

#: Canonical axis ordering, outermost first (the JAX package's).
AXIS_ORDER: Tuple[str, ...] = ("dcn_data", "data", "fsdp", "pipe", "sequence", "expert", "model")

#: Axes over which the batch dimension is sharded.
BATCH_AXES: Tuple[str, ...] = ("dcn_data", "data", "fsdp")

#: The axes a generator splits its rows over: the cache is ``P(data, None,
#: model, None)`` in the JAX package, so rows are split over ``data`` alone
#: and every other axis holds the same rows.
ROW_AXES: Tuple[str, ...] = ("data",)

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A built mesh (from :meth:`MeshSpec.build`, :meth:`MeshSpec.build_hybrid`
    or a slice of either): ``grid`` holds the global rank at each coordinate
    over :data:`AXIS_ORDER`; ``shape`` maps each axis name to its size and
    ``axis_names`` lists them, as on a JAX mesh; ``device`` is this rank's
    device; ``plan_group`` is a gloo group of all the mesh's ranks (None
    for a mesh of one rank). :meth:`group`, :meth:`index` and :meth:`size`
    name one axis or several (row-major in the order given, as a JAX
    ``PartitionSpec`` entry of several axes is)."""

    def __init__(self, grid: torch.Tensor, device: torch.device):
        self.grid = grid
        self.device = device
        self.axis_names: Tuple[str, ...] = AXIS_ORDER
        self.shape: Dict[str, int] = {name: int(s) for name, s in zip(AXIS_ORDER, grid.shape)}
        self.rank = dist.get_rank()
        self._ranks = grid.reshape(-1).tolist()
        #: whether this rank is one of the mesh's
        self.local = self.rank in self._ranks
        self.coordinate: Optional[Dict[str, int]] = self._coordinate_of(self.rank) if self.local else None
        self._groups: Dict[Tuple[str, ...], Any] = {}
        # every group a collective may name is made here, by every rank of
        # the world in the same order: made lazily, a group would need every
        # rank of the world to reach the same point
        for name in AXIS_ORDER:
            self._make_group((name,))
        non_row = tuple(a for a in AXIS_ORDER if a not in ROW_AXES)
        for axes in (ROW_AXES, non_row):
            self._make_group(axes)
        # host objects (step plans, handoff slices) move over gloo whatever
        # the world's backend
        self.plan_group: Any = dist.new_group(self._ranks, backend="gloo") if len(self._ranks) > 1 else None

    def _members(self, axes: Tuple[str, ...], coordinate: Dict[str, int]) -> list:
        """Global ranks of the group over ``axes`` through ``coordinate``,
        ordered by their index over ``axes``."""
        grid = self.grid
        index = tuple(slice(None) if name in axes else coordinate[name] for name in AXIS_ORDER)
        sub = grid[index]  # the kept dims stay in AXIS_ORDER
        order = [name for name in AXIS_ORDER if name in axes]
        sub = sub.permute(*[order.index(a) for a in axes]) if len(axes) > 1 else sub
        return sub.reshape(-1).tolist()

    def _make_group(self, axes: Tuple[str, ...]) -> None:
        if self.size(axes) <= 1 or axes in self._groups:
            return
        seen, mine = set(), None
        for r in self._ranks:  # every rank walks the same groups in the same order
            coordinate = self._coordinate_of(r)
            members = tuple(self._members(axes, coordinate))
            if members in seen:
                continue
            seen.add(members)
            group = dist.new_group(list(members))
            if self.rank in members:
                mine = group
        self._groups[axes] = mine

    def _coordinate_of(self, rank: int) -> Dict[str, int]:
        flat = self._ranks.index(rank)
        coords = {}
        for name in reversed(AXIS_ORDER):
            coords[name] = flat % self.shape[name]
            flat //= self.shape[name]
        return coords

    @property
    def devices(self) -> int:
        """Ranks in the mesh."""
        return len(self._ranks)

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's index over ``axes`` (row-major in the order given)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, axes: Axes) -> Any:
        """The process group of this rank's peers over ``axes`` (None where
        the axes have size 1: nothing to communicate)."""
        axes = _axes(axes)
        if self.size(axes) <= 1:
            return None
        if axes not in self._groups:
            raise ValueError(f"no process group over {axes}: the mesh makes groups over single axes, "
                             f"{ROW_AXES} and the axes beside them")
        return self._groups[axes]

    def peers(self, axes: Axes) -> list:
        """The global ranks of this rank's group over ``axes``, by index."""
        return self._members(_axes(axes), self.coordinate)

    def peer(self, axes: Axes, index: int) -> int:
        """The global rank at ``index`` over ``axes`` in this rank's group."""
        return self.peers(axes)[index]

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items() if v > 1) or "1 rank"
        where = f"rank {self.rank} on {self.device}" if self.local else f"ranks {self._ranks}"
        return f"Mesh({axes}; {where})"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh topology. ``-1`` on at most one axis means "all
    remaining ranks"."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    sequence: int = 1
    pipe: int = 1
    expert: int = 1
    dcn_data: int = 1

    def axis_sizes(self, n_devices: int) -> "dict[str, int]":
        sizes = {
            "dcn_data": self.dcn_data,
            "data": self.data,
            "fsdp": self.fsdp,
            "pipe": self.pipe,
            "sequence": self.sequence,
            "expert": self.expert,
            "model": self.model,
        }
        wildcards = [k for k, v in sizes.items() if v == -1]
        if len(wildcards) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wildcards}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wildcards:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh axes product {fixed} != device count {n_devices}")
        return sizes

    def build(self, *, device: DeviceLike = None) -> Mesh:
        """Build the mesh over every rank of the process group, ranks in
        row-major order over :data:`AXIS_ORDER`.

        ``device=None`` means the card (and raises where there is none);
        ``device="cpu"`` asks for the CPU, whose collectives go over gloo.
        Where no process group exists yet, the one
        :func:`~unionml_tpu_torch.distributed.maybe_initialize` finds in the
        environment is joined (NCCL on the card, gloo on the CPU), else a
        world of this one process is made. A collective: every rank builds
        the same mesh at the same point."""
        resolved = _joined_world(device)
        sizes = self.axis_sizes(dist.get_world_size())
        shape = tuple(sizes[name] for name in AXIS_ORDER)
        return Mesh(torch.arange(dist.get_world_size()).reshape(shape), _rank_device(resolved))

    def build_hybrid(self, dcn_axes: Optional[Sequence[str]] = None, *, device: DeviceLike = None) -> Mesh:
        """A hybrid mesh over the hosts of a multi-process world (JAX's
        ``create_hybrid_device_mesh`` shape): the ``dcn_axes`` span the
        hosts, in process-id order, and every other axis stays inside one
        host's ranks. A port host is one replica's group of ranks (see
        :mod:`unionml_tpu_torch.serving.cluster`), so ``dcn_axes=None``
        takes every batch axis of size > 1, outermost first: each host then
        holds one batch slice, the per-replica split
        :func:`~unionml_tpu_torch.serving.replicas.slice_mesh` cuts along
        (none: the world is one host).
        ``device`` and the process group are as in :meth:`build`. A
        collective."""
        resolved = _joined_world(device)
        sizes = self.axis_sizes(dist.get_world_size())
        if dcn_axes is None:
            dcn_axes = [name for name in AXIS_ORDER if name in BATCH_AXES and sizes[name] > 1]
        dcn_axes = tuple(dcn_axes)
        unknown = [name for name in dcn_axes if name not in AXIS_ORDER]
        if unknown:
            raise ValueError(f"unknown dcn axes {unknown}; expected a subset of {AXIS_ORDER}")
        return Mesh(hybrid_grid(sizes, dcn_axes), _rank_device(resolved))

    @property
    def num_devices_required(self) -> int:
        sizes = [self.data, self.fsdp, self.model, self.sequence, self.pipe, self.expert, self.dcn_data]
        if any(s == -1 for s in sizes):
            return -1
        return math.prod(sizes)


def serving_spec(mesh: Any) -> "MeshSpec":
    """Check the ``mesh`` of a serving config (``ServingConfig``, or any
    config a ``CompiledPredictor`` is given): a :class:`MeshSpec`. A
    ``pipe`` axis is taken as in the JAX package: serving rules leave it
    replicated."""
    if not isinstance(mesh, MeshSpec):
        raise TypeError(f"a serving config's mesh must be a MeshSpec, got {type(mesh).__name__}")
    return mesh


def hybrid_grid(sizes: Dict[str, int], dcn_axes: Sequence[str]) -> torch.Tensor:
    """The ranks of a hybrid mesh over :data:`AXIS_ORDER`: ranks in order
    over the DCN dims, then the ICI dims (a host's ranks are consecutive),
    each final dim the product of its DCN and ICI dims (one of them 1), as
    JAX's process-grouped fallback lays out devices."""
    ici = tuple(1 if name in dcn_axes else sizes[name] for name in AXIS_ORDER)
    dcn = tuple(sizes[name] if name in dcn_axes else 1 for name in AXIS_ORDER)
    n = len(AXIS_ORDER)
    grid = torch.arange(math.prod(sizes.values())).reshape(dcn + ici)
    perm = [axis for pair in zip(range(n), range(n, 2 * n)) for axis in pair]
    return grid.permute(perm).reshape(tuple(sizes[name] for name in AXIS_ORDER))


def _joined_world(device: DeviceLike) -> torch.device:
    """Resolve ``device`` and make sure a process group exists: the one
    :func:`~unionml_tpu_torch.distributed.maybe_initialize` finds in the
    environment (NCCL on the card, gloo on the CPU), else a world of this
    one process."""
    from unionml_tpu_torch.distributed import maybe_initialize

    resolved = resolve_device(device)
    backend = "gloo" if resolved.type == "cpu" else "nccl"
    if not maybe_initialize(backend):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return resolved


def _rank_device(resolved: torch.device) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if resolved.type == "cuda" else resolved


def process_local_submeshes(submeshes: Sequence[Mesh]) -> "List[Tuple[int, Mesh]]":
    """The :func:`~unionml_tpu_torch.serving.replicas.slice_mesh` submeshes
    this process drives, as ``(global_index, submesh)`` pairs: the JAX
    package keeps those whose devices are all this process's; a port process
    is one rank, so it keeps the one submesh that holds it (none where the
    slices leave it out). The global indices are the fleet's host ids."""
    return [(index, sub) for index, sub in enumerate(submeshes) if sub.local]


def single_device_mesh(device: DeviceLike = None) -> Mesh:
    """A one-rank mesh with the full axis set, so every sharded code path
    runs unchanged on one card (or on the CPU with ``device="cpu"``). The
    process must be alone in its world."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh needs a world of one process, not {dist.get_world_size()}")
    return MeshSpec(data=1).build(device=device)
