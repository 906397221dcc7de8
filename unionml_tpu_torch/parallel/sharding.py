"""Sharding rules and placement for parameter trees, counterpart of
``unionml_tpu/parallel/sharding.py``.

Two of the JAX package's three mechanisms carry over:

1. :class:`PartitionRules`: an ordered ``(path-regex, PartitionSpec)``
   table applied to parameter paths, first match wins. The port's parameter
   names follow the flax tree (``layer_0.attn.q_proj.kernel``, kernels
   stored ``[in, out]``), so a path joined with ``/`` is the JAX path and
   the JAX rule tables apply verbatim; no spec is transposed.
2. :func:`infer_fsdp_sharding`: each large leaf's largest divisible dim
   over the ``fsdp`` axis; small leaves replicate.

The third, flax's ``nn.Partitioned`` metadata boxes, has no torch
counterpart: a torch module carries no boxes, so :func:`unbox_partitioned`
is the identity, kept for the name.

Placement is explicit: each rank keeps only its shard of every leaf, cut
exactly as JAX's ``NamedSharding.devices_indices_map`` cuts it for the
same mesh coordinate (:func:`shard_slices`). The layers then compute on
those shards and run the collectives themselves (``models/layers.py``).
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from unionml_tpu_torch.parallel.mesh import BATCH_AXES, ROW_AXES

__all__ = [
    "NamedSharding",
    "P",
    "PartitionRules",
    "PartitionSpec",
    "REDUCE_AXES",
    "batch_axis_size",
    "batch_mean",
    "batch_sharding",
    "combine_fsdp_tp",
    "infer_fsdp_sharding",
    "named_sharding",
    "reduce_scope",
    "replicated",
    "row_axes",
    "row_scope",
    "shard_pytree",
    "shard_slices",
    "unbox_partitioned",
]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dim, each None (the dim
    is whole), an axis name, or a tuple of axis names (split over their
    product, row-major); dims past the spec's length are whole."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        # a one-axis tuple is that axis, as JAX normalizes it
        return super().__new__(cls, (e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_slices(shape: Sequence[int], spec: Sequence[Any], sizes: Mapping[str, int],
                 coordinate: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the shard that the rank at ``coordinate`` holds of an
    array of ``shape`` under ``spec`` on a mesh of axis ``sizes``: the
    slices ``devices_indices_map`` gives for the device at that coordinate.
    A dim split over several axes takes index ``i_a * size_b + i_b``. A dim
    that does not divide evenly raises."""
    out = []
    for dim, size in enumerate(shape):
        axes = _entry_axes(spec[dim]) if dim < len(spec) else ()
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coordinate[a]
        if n == 1:
            out.append(slice(None))
            continue
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split evenly over {axes} ({n} shards)")
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


class NamedSharding:
    """A spec on a mesh: :meth:`local` cuts this rank's shard of a full
    tensor."""

    def __init__(self, mesh: Any, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)

    @property
    def is_fully_replicated(self) -> bool:
        return all(self.mesh.shape[a] == 1 for entry in self.spec for a in _entry_axes(entry))

    def slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        return shard_slices(shape, self.spec, self.mesh.shape, self.mesh.coordinate)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``x``: a fresh contiguous copy (the full
        tensor may then be freed)."""
        if self.is_fully_replicated:
            return x
        return x[self.slices(x.shape)].clone(memory_format=torch.contiguous_format)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, NamedSharding) and other.mesh is self.mesh and other.spec == self.spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named_sharding(mesh: Any, *spec: Any) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def batch_sharding(mesh: Any) -> NamedSharding:
    """A batch's leading (sample) dim over every batch axis of size > 1,
    the rest whole."""
    present = tuple(a for a in BATCH_AXES if a in mesh.axis_names and mesh.shape[a] > 1)
    return NamedSharding(mesh, P(present if present else None))


def batch_axis_size(mesh: Any) -> int:
    """Shards of the batch dim under :func:`batch_sharding`."""
    size = 1
    for a in BATCH_AXES:
        if a in mesh.axis_names:
            size *= mesh.shape[a]
    return size


def replicated(mesh: Any) -> NamedSharding:
    return NamedSharding(mesh, P())


class PartitionRules:
    """Ordered ``(regex, PartitionSpec)`` table mapped over parameter paths
    (``/``-joined, the flax form)."""

    def __init__(self, rules: Sequence[Tuple[str, Any]]):
        self._rules = [(re.compile(pattern), spec) for pattern, spec in rules]

    def spec_for(self, path: str) -> Optional[PartitionSpec]:
        """First matching rule's spec, or None when no rule matches (None,
        not ``P()``: an explicit replication rule is honoured, not
        overridden by inferred FSDP)."""
        for pattern, spec in self._rules:
            if pattern.search(path):
                return spec
        return None

    def shardings(self, tree: Any, mesh: Any) -> Dict[str, NamedSharding]:
        """A sharding for every leaf path of ``tree`` (unmatched: replicated)."""
        return {path: NamedSharding(mesh, self.spec_for(path) or P()) for path, _ in _leaves(tree)}


def _leaves(tree: Any) -> Iterable[Tuple[str, Any]]:
    """``(path, leaf)`` over a module (parameters, and each int8 kernel slot
    as one leaf, shaped as its kernel) or a nested mapping, paths
    ``/``-joined."""
    if isinstance(tree, nn.Module):
        from unionml_tpu_torch.ops.quant import QuantizedKernel

        for name, mod in tree.named_modules():
            if isinstance(mod, QuantizedKernel):
                yield name.replace(".", "/"), mod
        for name, param in tree.named_parameters():
            yield name.replace(".", "/"), param
        return

    def walk(node: Mapping[str, Any], prefix: str) -> Iterable[Tuple[str, Any]]:
        for key, leaf in node.items():
            path = f"{prefix}{key}"
            if isinstance(leaf, Mapping):
                yield from walk(leaf, path + "/")
            else:
                yield path, leaf

    yield from walk(tree, "")


def _fsdp_spec(shape: Sequence[int], mesh: Any, axis: str, min_weight_size: int) -> PartitionSpec:
    axis_size = mesh.shape.get(axis, 1)
    numel = 1
    for d in shape:
        numel *= int(d)
    if axis_size <= 1 or not shape or numel < min_weight_size:
        return P()
    # the largest dim divisible by the axis size; ties -> the last dim
    candidates = [(int(d), i) for i, d in enumerate(shape) if int(d) % axis_size == 0]
    if not candidates:
        return P()
    _, best = max(candidates)
    spec = [None] * len(shape)
    spec[best] = axis
    return P(*spec)


def infer_fsdp_sharding(tree: Any, mesh: Any, *, axis: str = "fsdp", min_weight_size: int = 2**14
                        ) -> Dict[str, NamedSharding]:
    """Automatic FSDP layout: each leaf of at least ``min_weight_size``
    elements sharded over ``axis`` along its largest divisible dim."""
    return {path: NamedSharding(mesh, _fsdp_spec(tuple(leaf.shape), mesh, axis, min_weight_size))
            for path, leaf in _leaves(tree)}


def unbox_partitioned(tree: Any) -> Any:
    """The identity: torch modules carry no ``nn.Partitioned`` boxes."""
    return tree


def combine_fsdp_tp(tree: Any, mesh: Any, rules: Optional[PartitionRules], *, min_weight_size: int = 2**14,
                    logical_rules: Optional[Sequence[Tuple[str, Any]]] = None) -> Dict[str, NamedSharding]:
    """A sharding for every leaf: an explicit rule where one matches, else
    the inferred FSDP layout. ``logical_rules`` maps flax's logical-axis
    boxes, which a torch module never carries; it must stay None."""
    if logical_rules is not None:
        raise ValueError("logical_rules maps flax nn.Partitioned metadata, which torch modules do not carry")
    out = {}
    for path, leaf in _leaves(tree):
        spec = rules.spec_for(path) if rules is not None else None
        if spec is None:
            spec = _fsdp_spec(tuple(leaf.shape), mesh, "fsdp", min_weight_size)
        out[path] = NamedSharding(mesh, spec)
    return out


def scale_spec(scale_shape: Sequence[int], spec: Sequence[Any]) -> PartitionSpec:
    """An int8 kernel's per-channel scale keeps its kernel's axes on its
    non-unit dims only (``_quantized_shardings`` in the JAX package)."""
    padded = tuple(spec) + (None,) * (len(scale_shape) - len(spec))
    return P(*(None if dim == 1 else axis for dim, axis in zip(scale_shape, padded)))


def shard_pytree(tree: Any, shardings: Mapping[str, NamedSharding]) -> Any:
    """Each leaf of ``tree`` cut to this rank's shard. A nested mapping
    gives a new tree; a module is cut IN PLACE (parameters and int8 slots;
    see :func:`place_module`) and returned."""
    if isinstance(tree, nn.Module):
        place_module(tree, shardings)
        return tree

    def walk(node: Mapping[str, Any], prefix: str) -> dict:
        out = {}
        for key, leaf in node.items():
            path = f"{prefix}{key}"
            out[key] = walk(leaf, path + "/") if isinstance(leaf, Mapping) else shardings[path].local(leaf)
        return out

    return walk(tree, "")


def place_module(module: nn.Module, shardings: Mapping[str, NamedSharding]) -> None:
    """Cut a module's leaves to this rank's shards IN PLACE and record each
    leaf's spec on its owner (``owner._specs[leaf_name]``) with the mesh
    (``owner._mesh``): the sharded layers read both at their forward. An
    int8 slot's ``q`` takes its kernel's spec and its ``scale``
    :func:`scale_spec`. LoRA adapters and biases are placed like any leaf;
    the layers apply them over the mesh (``models/layers.py``)."""
    from unionml_tpu_torch.ops.quant import QuantizedKernel

    with torch.no_grad():
        for path, sharding in shardings.items():
            owner, leaf = _owner(module, path)
            target = getattr(owner, leaf)
            if isinstance(target, QuantizedKernel):
                target.q = sharding.local(target.q)
                target.scale = NamedSharding(sharding.mesh, scale_spec(target.scale.shape, sharding.spec)).local(
                    target.scale)
            else:
                target.data = sharding.local(target.data)
            record_spec(owner, leaf, sharding)


def unplace_module(module: nn.Module) -> None:
    """Undo :func:`place_module` IN PLACE: every placed leaf is all-gathered
    back whole over the mesh it was cut on (a collective: every rank of that
    mesh calls it at the same point) and its recorded spec dropped, so the
    module can be cut again for another mesh."""
    from unionml_tpu_torch.ops.quant import QuantizedKernel

    with torch.no_grad():
        for owner in list(module.modules()):
            specs, mesh = owner.__dict__.pop("_specs", None), owner.__dict__.pop("_mesh", None)
            for leaf, spec in (specs or {}).items():
                target = getattr(owner, leaf)
                if isinstance(target, QuantizedKernel):
                    target.q = gather_raw(target.q, _gather_axes(spec, mesh, ()), mesh)
                    sspec = scale_spec(target.scale.shape, spec)
                    target.scale = gather_raw(target.scale, _gather_axes(sspec, mesh, ()), mesh)
                else:
                    target.data = gather_raw(target.data, _gather_axes(spec, mesh, ()), mesh)


def _owner(module: nn.Module, path: str) -> Tuple[nn.Module, str]:
    owner_path, _, leaf = path.rpartition("/")
    return (module.get_submodule(owner_path.replace("/", ".")) if owner_path else module), leaf


def record_spec(owner: nn.Module, leaf: str, sharding: NamedSharding) -> None:
    """Record that ``owner``'s ``leaf`` holds this rank's shard under
    ``sharding`` (what :func:`place_module` leaves behind)."""
    owner.__dict__.setdefault("_specs", {})[leaf] = sharding.spec
    owner.__dict__["_mesh"] = sharding.mesh


def placed_mesh(module: nn.Module) -> Any:
    """The mesh ``module``'s leaves were placed on, or None."""
    for owner in module.modules():
        mesh = owner.__dict__.get("_mesh")
        if mesh is not None:
            return mesh
    return None


def leaf_specs(module: nn.Module) -> Dict[str, PartitionSpec]:
    """``{parameter name: spec}`` of a placed module (``P()`` for a leaf no
    rule placed)."""
    out = {}
    for name, _ in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        out[name] = (owner.__dict__.get("_specs") or {}).get(leaf, P())
    return out


def splits(spec: Sequence[Any], dim: int, axis: str, mesh: Any) -> bool:
    """Whether ``spec`` splits ``dim`` over ``axis`` (of size > 1)."""
    return dim < len(spec) and axis in _entry_axes(spec[dim]) and mesh.shape[axis] > 1


def spec_axes(spec: Sequence[Any]) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` splits some dim over."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def _gather_axes(spec: Sequence[Any], mesh: Any, keep: Tuple[str, ...]) -> list:
    """``[(dim, axis)]`` in the order :func:`gathered` gathers: per dim, the
    axes of ``spec`` but ``keep`` (size > 1), minor first."""
    out = []
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if mesh.shape[a] > 1]
        drop = [a for a in axes if a not in keep]
        if not drop:
            continue
        if any(axes.index(a) > axes.index(d) for a in axes if a in keep for d in drop):
            raise NotImplementedError(f"dim {dim} is split over {axes}: a kept axis after a gathered one leaves "
                                      "no contiguous block to compute on")
        out += [(dim, a) for a in reversed(drop)]
    return out


def gather_raw(t: torch.Tensor, steps: list, mesh: Any) -> torch.Tensor:
    """``t`` all-gathered along each ``(dim, axis)`` of ``steps`` in turn
    (no autograd)."""
    from unionml_tpu_torch.parallel.collectives import _raw_all_gather

    for dim, a in steps:
        t = _raw_all_gather(t, mesh.group(a), mesh.size(a), True, dim)
    return t


def _gather_args(mesh: Any, dim: int, a: str) -> tuple:
    """``(group, n, i, tiled, dim, scatter)`` of one gather step, as
    ``collectives._AllGather`` and its transpose take them: the transpose
    is a reduce-scatter over a batch axis (the ranks compute on their own
    rows), the tile alone over another (the ranks compute alike)."""
    return mesh.group(a), mesh.size(a), mesh.index(a), True, dim, a in BATCH_AXES


def gather_transpose(g: torch.Tensor, steps: list, mesh: Any) -> torch.Tensor:
    """The transpose of :func:`gather_raw` over ``steps`` (no autograd)."""
    from unionml_tpu_torch.parallel.collectives import gather_transpose as transpose

    for dim, a in reversed(steps):
        g = transpose(g, *_gather_args(mesh, dim, a))
    return g


def gathered(t: torch.Tensor, spec: Sequence[Any], mesh: Any, keep: Tuple[str, ...] = ("model", "expert")
             ) -> torch.Tensor:
    """A shard with every axis of ``spec`` but ``keep`` all-gathered back
    (FSDP's gather at use): what remains split is the tensor- and
    expert-parallel layout the layers compute in.

    A dim split over a tuple of axes is major-axis-first (shard ``f * M +
    m`` at ``(f, m)``), so the minor axes gather first; a kept axis must
    then come before every gathered one in the tuple. Differentiable, and
    the gathered tensor is saved by nothing here: over a batch axis (the
    ranks compute on their own rows) the backward is a reduce-scatter, over
    any other axis the ranks compute alike and the backward keeps this
    rank's tile."""
    from unionml_tpu_torch.parallel.collectives import _AllGather

    for dim, a in _gather_axes(spec, mesh, keep):
        t = _AllGather.apply(t, *_gather_args(mesh, dim, a))
    return t


#: the axes a loss's value and gradients are averaged over: the batch axes
#: (each rank holds its rows) and ``sequence`` (each rank its block of a
#: sequence-parallel model's positions)
REDUCE_AXES: Tuple[str, ...] = BATCH_AXES + ("sequence",)


class _ReduceScope:
    """Process-wide, not a thread's: a checkpointed loss recomputes where
    its backward runs, which for a card's tensors is autograd's device
    thread, and the recompute must take the quotient the forward took."""

    mesh: Any = None
    #: the axes the innermost :func:`row_scope` names (None: none is open)
    rows: Optional[Tuple[str, ...]] = None


_scope = _ReduceScope()


@contextlib.contextmanager
def reduce_scope(mesh: Any) -> Iterator[None]:
    """Run a step's losses over ``mesh``: inside, :func:`batch_mean` gives
    each rank its share of the global mean, and the driver averages every
    gradient and metric over the mesh's :data:`REDUCE_AXES`."""
    previous, _scope.mesh = _scope.mesh, mesh
    try:
        yield
    finally:
        _scope.mesh = previous


@contextlib.contextmanager
def row_scope(axes: Optional[Sequence[str]]) -> Iterator[None]:
    """Run the forwards inside over rows split over ``axes`` (``()``: every
    rank holds the same rows, as for a batch that does not divide over the
    batch axes, or a prefix every rank prefills whole). ``None`` leaves the
    enclosing layout as it is. See :func:`row_axes`."""
    if axes is None:
        yield
        return
    previous, _scope.rows = _scope.rows, tuple(axes)
    try:
        yield
    finally:
        _scope.rows = previous


def row_axes(mesh: Any) -> Tuple[str, ...]:
    """The axes of size > 1 whose ranks hold different rows of the batch
    the model runs now, in the rows' order (row-major): those of the
    innermost :func:`row_scope`, else inside a :func:`reduce_scope` the
    batch axes (the driver's batch sharding), else ``ROW_AXES`` (a
    ``Generator``'s rows). A layer whose result mixes rows (MoE's capacity)
    reads it to compute over the global batch, as JAX's jit does."""
    if _scope.rows is not None:
        axes = _scope.rows
    else:
        axes = BATCH_AXES if _scope.mesh is not None else ROW_AXES
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def scope_mesh() -> Any:
    """The mesh of the active :func:`reduce_scope`, or None."""
    return _scope.mesh


def reduce_axes(mesh: Any) -> Tuple[str, ...]:
    """The axes of :data:`REDUCE_AXES` that ``mesh`` splits (size > 1)."""
    return tuple(a for a in REDUCE_AXES if mesh.shape.get(a, 1) > 1)


def batch_mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / max(den, 1)`` as the mean over the global batch.

    ``num`` is this rank's sum of per-entry losses and ``den`` its count of
    those entries (a mask's sum). Outside a :func:`reduce_scope` (or on a
    mesh that splits nothing) this is the plain quotient. Inside, the
    counts are summed over the reduce axes (ranks that hold the same rows
    count them alike), and the rank's share ``n * num / sum(den)`` is
    returned: the average of the shares over the ``n`` ranks of those axes,
    which the driver takes, is the JAX package's global
    ``sum(l * m) / max(sum(m), 1)`` whether each rank holds its own rows,
    the same rows (an indivisible batch) or a block of each sequence, and
    whatever each rank's count."""
    mesh = _scope.mesh
    axes = () if mesh is None else reduce_axes(mesh)
    if not axes:
        return num / den.clamp_min(1.0)
    from unionml_tpu_torch.parallel.collectives import allreduce_sum

    total = den.detach().float()
    for a in axes:
        total = allreduce_sum(total, mesh, a)
    return num * (mesh.size(axes) / total.clamp_min(1.0))
