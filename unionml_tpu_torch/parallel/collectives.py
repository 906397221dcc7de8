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
:data:`host_route`'s ``count``, in the forward and in the backward alike.
The host copies are page-locked (an all-gather lands in one buffer), and
the copies back to the card are asynchronous on the current stream. It is
the backend's transport, not a fallback: a failure raises.
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
    "gather_from",
    "host_route",
    "reduce_scatter",
    "ring_permute",
    "split_to",
    "sum_gradients",
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


def _staged(x: torch.Tensor) -> torch.Tensor:
    """A page-locked host copy of ``x`` (a card's tensor) for gloo: copies
    to and from page-locked memory run at the link's rate, and the caching
    host allocator keeps each buffer until its copy back has run."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x)


def _pinned_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _raw_all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; ``x`` is kept)."""
    y = x.contiguous()
    if _via_host(group, y):
        host = _staged(y)
        dist.all_reduce(host, group=group)
        return host.to(x.device, non_blocking=True)
    y = y.clone()
    dist.all_reduce(y, group=group)
    return y


def _all_reduce_(x: torch.Tensor, group: Any) -> None:
    """Sum a contiguous ``x`` over ``group`` in place."""
    if _via_host(group, x):
        host = _staged(x)
        dist.all_reduce(host, group=group)
        x.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(x, group=group)


def _joined(stacked: torch.Tensor, tiled: bool, axis: int) -> torch.Tensor:
    """``[n, *shape]`` parts in index order as ``torch.cat`` (``tiled``) or
    ``torch.stack`` along ``axis`` would join them."""
    if not tiled:
        return stacked.movedim(0, axis)
    axis %= stacked.dim() - 1
    moved = stacked.movedim(0, axis)
    return moved.reshape(moved.shape[:axis] + (-1,) + moved.shape[axis + 2:])


def _raw_all_gather(x: torch.Tensor, group: Any, n: int, tiled: bool, gather_axis: int) -> torch.Tensor:
    src = x.contiguous()
    if _via_host(group, src) and src.dim() > 0:
        host = _staged(src)
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, host, group=group)  # the parts in index order along dim 0
        stacked = out.to(x.device, non_blocking=True).view((n,) + tuple(src.shape))
        return _joined(stacked, tiled, gather_axis)
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=gather_axis) if tiled else torch.stack(parts, dim=gather_axis)


def _tile(x: torch.Tensor, n: int, i: int, dim: int, tiled: bool) -> torch.Tensor:
    """Tile ``i`` of ``n`` along ``dim`` (a stacked gather's entry ``i``)."""
    return x.chunk(n, dim=dim)[i].contiguous() if tiled else x.select(dim, i).contiguous()


def _raw_rotate(x: torch.Tensor, group: Any, dst: int, src: int) -> torch.Tensor:
    send = x.contiguous()
    host = _via_host(group, send)
    if host:
        send = _staged(send)
    recv = _pinned_like(send) if host else torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device, non_blocking=True) if host else recv


def _raw_all_to_all(x: torch.Tensor, group: Any, n: int, split_axis: int, concat_axis: int) -> torch.Tensor:
    lead = x.movedim(split_axis, 0)
    send = lead.reshape(n, lead.shape[0] // n, *lead.shape[1:]).contiguous()
    host = _via_host(group, send)
    if host:
        send = _staged(send)
    recv = _pinned_like(send) if host else torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(x.device, non_blocking=True) if host else recv
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)], dim=concat_axis)


# Each collective below is a ``torch.autograd.Function`` whose backward is
# the transpose JAX derives under ``jax.grad`` (all_gather <-> reduce-scatter,
# ppermute <-> the reverse rotation, all_to_all <-> the inverse all_to_all),
# plus Megatron's conjugate pairs for values every rank of an axis holds
# whole: ``allreduce_sum`` (g: sum forward, identity backward) beside
# ``sum_gradients`` (f: identity forward, sum backward), and ``gather_from``
# (gather forward, this rank's tile backward) beside ``split_to`` (this
# rank's tile forward, gather backward). A cotangent of a value every rank
# holds whole is taken to be whole on every rank; a rank-varying consumer of
# such a value puts ``sum_gradients`` (or a gather whose backward sums)
# between them. Every rank runs the same backward, so the backward's
# collectives meet in the same order on all of them.


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        return _raw_all_reduce(x, group)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return grad, None


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return _raw_all_reduce(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    """All-gather forward; backward: sum over the axis and keep this rank's
    tile (reduce-scatter) when ``scatter``, else keep the tile alone."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any, n: int, i: int, tiled: bool, gather_axis: int,
                scatter: bool) -> torch.Tensor:
        ctx.args = (group, n, i, tiled, gather_axis, scatter)
        return _raw_all_gather(x, group, n, tiled, gather_axis)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return (gather_transpose(grad, *ctx.args),) + (None,) * 6


def gather_transpose(grad: torch.Tensor, group: Any, n: int, i: int, tiled: bool, dim: int,
                     scatter: bool) -> torch.Tensor:
    """The transpose of an all-gather along ``dim``: the cotangents summed
    over ``group`` and this rank's tile kept (a reduce-scatter) when
    ``scatter``, else the tile alone (the ranks computed alike)."""
    if scatter:
        grad = _raw_all_reduce(grad, group)
    return _tile(grad, n, i, dim, tiled)


class _Split(torch.autograd.Function):
    """This rank's tile of a value every rank holds whole; backward gathers
    the tiles' cotangents (each whole for its tile) back into the whole."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any, n: int, i: int, dim: int) -> torch.Tensor:
        ctx.args = (group, n, dim)
        return _tile(x, n, i, dim, True)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        group, n, dim = ctx.args
        return _raw_all_gather(grad, group, n, True, dim), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any, n: int, i: int, dim: int) -> torch.Tensor:
        ctx.args = (group, n, dim)
        return _tile(_raw_all_reduce(x, group), n, i, dim, True)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        group, n, dim = ctx.args
        return _raw_all_gather(grad, group, n, True, dim), None, None, None, None


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any, dst: int, src: int) -> torch.Tensor:
        ctx.args = (group, dst, src)
        return _raw_rotate(x, group, dst, src)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        group, dst, src = ctx.args
        return _raw_rotate(grad, group, src, dst), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any, n: int, split_axis: int, concat_axis: int) -> torch.Tensor:
        ctx.args = (group, n, split_axis, concat_axis)
        return _raw_all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        group, n, split_axis, concat_axis = ctx.args
        return _raw_all_to_all(grad, group, n, concat_axis, split_axis), None, None, None, None


def allreduce_sum(tree: Any, mesh: Any, axis: AxisName) -> Any:
    """Sum a pytree over a mesh axis (new tensors; the inputs are kept).
    Differentiable as Megatron's *g*: the backward passes the cotangent of
    the sum, which every rank holds whole, to each rank's term."""
    group = mesh.group(axis)
    if group is None:
        return tree
    return _map(lambda x: _AllReduceSum.apply(x, group), tree)


def allreduce_mean(tree: Any, mesh: Any, axis: AxisName) -> Any:
    """Mean-all-reduce a pytree over a mesh axis (data-parallel gradients)."""
    n = mesh.size(axis)
    return _map(lambda x: x / n, allreduce_sum(tree, mesh, axis)) if n > 1 else tree


def sum_gradients(x: torch.Tensor, mesh: Any, axis: AxisName) -> torch.Tensor:
    """Megatron's *f*, the conjugate of :func:`allreduce_sum`: ``x`` itself
    forward, and in the backward the sum of the ranks' cotangents. Put it
    where a value every rank of ``axis`` holds whole enters computation
    that differs between them (a column-parallel layer's input): each
    rank's cotangent is then a part of the whole."""
    group = mesh.group(axis)
    return x if group is None else _SumGradients.apply(x, group)


def all_gather(x: torch.Tensor, mesh: Any, axis: AxisName, *, tiled: bool = True, gather_axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over the axis, in index order: concatenated along
    ``gather_axis`` (``tiled``) or stacked there. Its backward is JAX's
    transpose, a reduce-scatter: the ranks' cotangents summed, this rank's
    tile kept (each rank then uses the gathered value on its own data)."""
    group = mesh.group(axis)
    if group is None:
        return x if tiled else x.unsqueeze(gather_axis)
    return _AllGather.apply(x, group, mesh.size(axis), mesh.index(axis), tiled, gather_axis, True)


def gather_from(x: torch.Tensor, mesh: Any, axis: AxisName, *, gather_axis: int = 0) -> torch.Tensor:
    """:func:`all_gather` (tiled) for a result every rank of the axis then
    uses alike: the backward keeps this rank's tile of the cotangent, which
    each rank holds whole, and sums nothing."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _AllGather.apply(x, group, mesh.size(axis), mesh.index(axis), True, gather_axis, False)


def split_to(x: torch.Tensor, mesh: Any, axis: AxisName, *, dim: int = 0) -> torch.Tensor:
    """This rank's tile along ``dim`` of a value every rank of the axis
    holds whole (row-major over several axes); the backward gathers the
    tiles' cotangents into the whole value's."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    present = [a for a in axes if mesh.size(a) > 1]
    if not present:
        return x
    if len(present) == 1:
        a = present[0]
        return _Split.apply(x, mesh.group(a), mesh.size(a), mesh.index(a), dim)
    for a in present:  # major axis first: each cut takes a tile of the last
        x = _Split.apply(x, mesh.group(a), mesh.size(a), mesh.index(a), dim)
    return x


def reduce_scatter(x: torch.Tensor, mesh: Any, axis: AxisName, *, scatter_axis: int = 0) -> torch.Tensor:
    """Sum over the axis, then keep this rank's tile of ``scatter_axis``:
    an all-reduce and a slice, the one reduction every backend carries on
    every device. Its backward is JAX's transpose, an all-gather."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, mesh.size(axis), mesh.index(axis), scatter_axis)


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
    index ``(i + shift) % n`` and receives from ``(i - shift) % n``. The
    backward rotates the cotangents the other way."""
    group = mesh.group(axis)
    if group is None:
        return tree
    n, i = mesh.size(axis), mesh.index(axis)
    dst, src = mesh.peer(axis, (i + shift) % n), mesh.peer(axis, (i - shift) % n)
    return _map(lambda x: _Rotate.apply(x, group, dst, src), tree)


def all_to_all(x: torch.Tensor, mesh: Any, axis: str, *, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over the axis (the Ulysses sequence<->heads
    reshard): ``x`` splits into ``n`` tiles along ``split_axis``, tile ``j``
    goes to index ``j``, and the tiles received are concatenated along
    ``concat_axis`` in source order. The backward is the inverse
    all-to-all."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _AllToAll.apply(x, group, mesh.size(axis), split_axis, concat_axis)
