"""A CUDA graph's stand-in on the CPU for the AOT store's tests.

``serving/aot.py`` opens and ends each graph of a program through
``_begin_graph`` and ``_end_graph`` and captures only where ``_capturable``
says so. :func:`install` points those seams at a :class:`Tape`, so CPU
tensors take the graph route: between the open and the end of a graph the
tape records every aten op (running it, as the CPU cannot record without
running), and a replay runs the recorded ops again on the very tensors they
ran on, writing each fresh result into the tensor the capture returned.
That is what a graph does with the addresses it was captured on: no Python
runs at a replay, a program's own tensors are rewritten in place, and the
collectives between two graphs of a program run only as the store's eager
steps. A capture on the card runs nothing, so a tensor the recorded ops
write in place (a bound KV cache) gets its contents back when the tape
ends: what the capture computed from a collective's zeroed output never
reaches the caller. A host read inside a capture raises, as it does on the
card, and so does a collective that reached the process group without the
store's splitter.

This module imports torch only: the ranks of a gloo world install it too.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_aten = torch.ops.aten

#: ops that read a device value on the host: they end a capture on the card
HOST_READS = {_aten._local_scalar_dense.default, _aten.nonzero.default, _aten.equal.default}


class Tape(TorchDispatchMode):
    """The aten ops of one graph, replayed in order on their own tensors."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[Any] = []
        self.written: List[Any] = []  # (tensor, its contents before the tape first wrote it)

    def __torch_dispatch__(self, func: Any, types: Any, args: Any = (), kwargs: Any = None) -> Any:
        kwargs = kwargs or {}
        if func in HOST_READS:
            raise RuntimeError(f"operation not permitted when stream is capturing ({func})")
        if func.namespace == "c10d":  # gloo's host route cannot be captured: the store splits the graph there
            raise RuntimeError(f"a collective inside a capture ({func})")
        for i, arg in enumerate(func._schema.arguments):
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            if arg.alias_info is not None and arg.alias_info.is_write and isinstance(value, torch.Tensor) \
                    and not any(value is seen for seen, _ in self.written):
                self.written.append((value, value.clone()))
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out

    @torch.no_grad()  # the ops were recorded below autograd: a graph has none
    def replay(self) -> None:
        for func, args, kwargs, out in self.ops:
            fresh = func(*args, **kwargs)
            returns = func._schema.returns
            old, _ = tree_flatten(out)
            new, _ = tree_flatten(fresh)
            for i, (was, now) in enumerate(zip(old, new)):
                aliased = i < len(returns) and returns[i].alias_info is not None
                if isinstance(was, torch.Tensor) and not aliased and was is not now:
                    was.copy_(now)


def _end(tape: Tape) -> None:
    tape.__exit__(None, None, None)
    with torch.no_grad():
        for tensor, contents in reversed(tape.written):
            tensor.copy_(contents)


def install(aot: Any, captured: List[Any] = None) -> List[Any]:
    """Route ``aot``'s captures (the module ``unionml_tpu_torch.serving.aot``)
    through tapes; each tape opened is appended to ``captured``, which is
    returned. Undo by restoring the three names (:func:`installed`, or
    pytest's ``monkeypatch``)."""
    captured = [] if captured is None else captured

    def begin(device: Any, generators: Any, pool: Any) -> Tape:
        tape = Tape()
        tape.__enter__()
        captured.append(tape)
        return tape

    aot._capturable = lambda device: device is not None
    aot._begin_graph = begin
    aot._end_graph = _end
    return captured


@contextlib.contextmanager
def installed(aot: Any) -> Iterator[List[Any]]:
    """:func:`install` for the block; the seams restored after it."""
    saved = {name: getattr(aot, name) for name in ("_capturable", "_begin_graph", "_end_graph")}
    try:
        yield install(aot)
    finally:
        for name, value in saved.items():
            setattr(aot, name, value)
