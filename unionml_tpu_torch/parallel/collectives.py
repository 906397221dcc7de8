"""Named collectives over one mesh axis, counterpart of
``unionml_tpu/parallel/collectives.py``.

In the JAX package these wrap ``lax`` collectives inside ``shard_map``,
where the axis name alone finds the peers. Here every rank calls them with
its :class:`~unionml_tpu_torch.parallel.mesh.Mesh` and the axis; each runs
over that axis's process group (a size-1 axis is a no-op). Tensors may be
pytrees of dicts, lists and tuples, as there.

Transport: NCCL carries every collective on CUDA tensors. A gloo group
(two ranks sharing one card cannot form an NCCL group) moves each CUDA
tensor through host memory: a copy to the host, the collective there, and
a copy back. gloo's build on the card machine does not take device
pointers for every collective (its TCP transport aborted the process on
one), so none is given one. The move happens when, and only when, the
group's backend is gloo and the tensor lies on a card; each adds one to
:data:`host_route`'s ``count``. It is the backend's transport, not a
fallback: a failure raises.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Union

import torch
import torch.distributed as dist

from unionml_tpu_torch._build import count_launch

__all__ = [
    "all_gather",
    "all_to_all",
    "allreduce_mean",
    "allreduce_sum",
    "axis_index",
    "axis_size",
    "broadcast",
    "host_route",
    "reduce_scatter",
    "ring_permute",
]

AxisName = Union[str, Sequence[str]]


class _HostRoute:
    """Tensors a gloo group moved through host memory (see the module doc)."""

    count = 0


host_route = _HostRoute()


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _via_host(group: Any, x: torch.Tensor) -> bool:
    """Whether ``x`` must cross ``group`` through host memory."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        count_launch(host_route, "count")
        return True
    return False


def axis_index(mesh: Any, axis: AxisName) -> int:
    return mesh.index(axis)


def axis_size(mesh: Any, axis: AxisName) -> int:
    return mesh.size(axis)


def allreduce_sum(tree: Any, mesh: Any, axis: AxisName) -> Any:
    """Sum a pytree over a mesh axis (new tensors; the inputs are kept)."""
    group = mesh.group(axis)
    if group is None:
        return tree

    def reduce(x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        if _via_host(group, y):
            host = y.cpu()
            dist.all_reduce(host, group=group)
            return host.to(x.device)
        dist.all_reduce(y, group=group)
        return y

    return _map(reduce, tree)


def allreduce_mean(tree: Any, mesh: Any, axis: AxisName) -> Any:
    """Mean-all-reduce a pytree over a mesh axis (data-parallel gradients)."""
    n = mesh.size(axis)
    return _map(lambda x: x / n, allreduce_sum(tree, mesh, axis)) if n > 1 else tree


def all_gather(x: torch.Tensor, mesh: Any, axis: AxisName, *, tiled: bool = True, gather_axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over the axis, in index order: concatenated along
    ``gather_axis`` (``tiled``) or stacked there."""
    group = mesh.group(axis)
    if group is None:
        return x if tiled else x.unsqueeze(gather_axis)
    src = x.contiguous()
    host = _via_host(group, src)
    if host:
        src = src.cpu()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=gather_axis) if tiled else torch.stack(parts, dim=gather_axis)
    return out.to(x.device) if host else out


def reduce_scatter(x: torch.Tensor, mesh: Any, axis: AxisName, *, scatter_axis: int = 0) -> torch.Tensor:
    """Sum over the axis, then keep this rank's tile of ``scatter_axis``:
    an all-reduce and a slice, the one reduction every backend carries on
    every device."""
    n = mesh.size(axis)
    if n == 1:
        return x
    return allreduce_sum(x, mesh, axis).chunk(n, dim=scatter_axis)[mesh.index(axis)].contiguous()


def broadcast(x: torch.Tensor, mesh: Any, axis: AxisName, *, src: int = 0) -> torch.Tensor:
    """The ``x`` of the rank at index ``src`` over the axis, on every rank."""
    group = mesh.group(axis)
    if group is None:
        return x
    y = x.contiguous().clone()
    if _via_host(group, y):
        host = y.cpu()
        dist.broadcast(host, src=mesh.peer(axis, src), group=group)
        return host.to(x.device)
    dist.broadcast(y, src=mesh.peer(axis, src), group=group)
    return y


def ring_permute(tree: Any, mesh: Any, axis: str, *, shift: int = 1) -> Any:
    """Rotate a pytree around the axis's ring: each rank sends its value to
    index ``(i + shift) % n`` and receives from ``(i - shift) % n``."""
    group = mesh.group(axis)
    if group is None:
        return tree
    n, i = mesh.size(axis), mesh.index(axis)
    dst, src = mesh.peer(axis, (i + shift) % n), mesh.peer(axis, (i - shift) % n)

    def rotate(x: torch.Tensor) -> torch.Tensor:
        send = x.contiguous()
        host = _via_host(group, send)
        if host:
            send = send.cpu()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device) if host else recv

    return _map(rotate, tree)


def all_to_all(x: torch.Tensor, mesh: Any, axis: str, *, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over the axis (the Ulysses sequence<->heads
    reshard): ``x`` splits into ``n`` tiles along ``split_axis``, tile ``j``
    goes to index ``j``, and the tiles received are concatenated along
    ``concat_axis`` in source order."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.size(axis)
    lead = x.movedim(split_axis, 0)
    send = lead.reshape(n, lead.shape[0] // n, *lead.shape[1:]).contiguous()
    host = _via_host(group, send)
    if host:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(x.device) if host else recv
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)], dim=concat_axis)
