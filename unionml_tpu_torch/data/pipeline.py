"""Host-to-device prefetch input pipeline.

Counterpart of ``unionml_tpu/data/pipeline.py``. Batches are

1. sliced on the host from numpy arrays by the same seeded schedule as the
   JAX package (``np.random.default_rng(seed + epoch)`` per epoch), so both
   packages see the same batches in the same order;
2. copied into pinned host memory and sent to an explicit device with
   non-blocking copies (the device defaults to CUDA; the CPU must be asked
   for), and
3. produced ``prefetch + 1`` batches ahead by one background thread, which
   keeps the order and overlaps the host gather and the copy with the step.

Over a mesh (``sharding=batch_sharding(mesh)``, one process a rank) every
rank computes the same global schedule and takes its rows of each batch,
cut as JAX's ``devices_indices_map`` cuts ``P(BATCH_AXES)``
(:func:`local_rows`); an indivisible batch arrives whole on every rank, as
the JAX package places it replicated. ``shard_by_process`` slices each
global batch per process as ``index_batches`` does there, every process of
the ``torch.distributed`` world counting as one.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, resolve_device


def _processes() -> Tuple[int, int]:
    """``(count, index)`` of the processes of the ``torch.distributed``
    world (``(1, 0)`` without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def splits_rows(rows: int, sharding: Any, microbatches: int = 1) -> bool:
    """Whether :func:`local_rows` splits a batch of ``rows`` over the
    batch axes (else every rank keeps it whole)."""
    if sharding is None or sharding.is_fully_replicated:
        return False
    return rows % (sharding.mesh.size(sharding.spec[0]) * microbatches) == 0


def local_rows(idx: np.ndarray, sharding: Any, microbatches: int = 1) -> np.ndarray:
    """This rank's rows of a global batch's sample indices ``idx`` under a
    batch ``sharding``. With ``microbatches=k`` the batch is the JAX
    accumulation step's ``[k, B / k]`` view cut ``P(None, batch axes)``:
    the rank's rows of each microbatch in turn, so its own split into ``k``
    is its part of each global microbatch. A batch that does not divide
    stays whole (replicated)."""
    if not splits_rows(len(idx), sharding, microbatches):
        return idx
    from unionml_tpu_torch.parallel.sharding import P, shard_slices

    mesh = sharding.mesh
    view = idx.reshape(microbatches, -1)
    index = shard_slices(view.shape, P(None, sharding.spec[0]), mesh.shape, mesh.coordinate)
    return view[index].reshape(-1)


def to_host_arrays(data: Any) -> Any:
    """A parsed-data leaf (DataFrame/Series/list/array/tensor) as a host numpy
    array; dicts convert value by value."""
    if isinstance(data, dict):
        return {k: to_host_arrays(v) for k, v in data.items()}
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, structure)`` of nested tuples/lists/dicts (dict keys sorted,
    as ``jax.tree_util`` orders them)."""
    if isinstance(tree, (tuple, list)):
        leaves, specs = [], []
        for item in tree:
            sub, spec = flatten(item)
            leaves += sub
            specs.append((len(sub), spec))
        return leaves, (type(tree), specs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, spec = flatten([tree[k] for k in keys])
        return leaves, (dict, (keys, spec))
    return [tree], None


def unflatten(structure: Any, leaves: List[Any]) -> Any:
    if structure is None:
        return leaves[0]
    kind, specs = structure
    if kind is dict:
        keys, spec = specs
        return dict(zip(keys, unflatten(spec, leaves)))
    out, at = [], 0
    for count, spec in specs:
        out.append(unflatten(spec, leaves[at : at + count]))
        at += count
    return kind(out)


class PrefetchIterator:
    """Iterator yielding device-resident batches (torch tensors in the data's
    structure).

    :param data: a list/tuple of per-column data (e.g. ``[features, targets]``),
        a single array, or a dict of arrays; every leaf shares a leading
        sample dimension.
    :param batch_size: the batch size.
    :param device: where batches land; ``None`` is CUDA (and raises without a
        CUDA device), ``"cpu"`` must be asked for.
    :param sharding: a batch sharding (:func:`~unionml_tpu_torch.parallel.batch_sharding`)
        over a mesh: each rank takes its rows (:func:`local_rows`, with
        ``microbatches``).
    :param shard_by_process: slice each global batch per process of the
        ``torch.distributed`` world (the short final batch dropped by every
        process alike); the slice is the rank's rows.
    """

    def __init__(
        self,
        data: Any,
        batch_size: int,
        *,
        device: DeviceLike = None,
        drop_remainder: bool = True,
        shuffle: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        shard_by_process: bool = False,
        epochs: int = 1,
        skip_batches: int = 0,
        sharding: Any = None,
        microbatches: int = 1,
    ):
        self.device = resolve_device(device)
        self.sharding, self.microbatches, self.shard_by_process = sharding, microbatches, shard_by_process
        if isinstance(data, (list, tuple)):
            data = tuple(leaf for leaf in data if leaf is not None and _nonempty(leaf))
        leaves, self._structure = flatten(data)
        self._leaves = [to_host_arrays(leaf) for leaf in leaves]
        lengths = {leaf.shape[0] for leaf in self._leaves}
        if len(lengths) != 1:
            raise ValueError(f"all data leaves must share a leading sample dimension, got lengths {lengths}")
        self._num_samples = lengths.pop()
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(0, prefetch)
        self.epochs = epochs
        # leading batches to skip (checkpoint resume: the epoch order is
        # seeded per epoch, so skipping reproduces the original schedule)
        self.skip_batches = skip_batches

    @property
    def num_samples(self) -> int:
        return self._num_samples

    def host_tree(self) -> Any:
        """The whole split as numpy arrays in the data's structure."""
        return unflatten(self._structure, self._leaves)

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self._num_samples // self.batch_size
        return -(-self._num_samples // self.batch_size)

    def epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self._num_samples)
        return np.random.default_rng(self.seed + epoch).permutation(self._num_samples)

    def contiguous_schedule(self) -> Iterator[tuple]:
        """Yield ``(epoch, offset, size)`` for each step of the schedule: after
        a once-per-epoch permutation of device-resident data, each batch is
        the contiguous slice ``[offset, offset + size)``. Honors
        ``skip_batches``."""
        emitted = 0
        for epoch in range(self.epochs):
            for step in range(self.steps_per_epoch()):
                lo = step * self.batch_size
                size = min(self.batch_size, self._num_samples - lo)
                emitted += 1
                if emitted <= self.skip_batches:
                    continue
                yield epoch, lo, size

    def index_batches(self) -> Iterator[np.ndarray]:
        """Yield each step's sample-index vector (host batching path); with
        ``shard_by_process``, this process's slice of it."""
        proc_count, proc_index = _processes() if self.shard_by_process else (1, 0)
        per_process = self.batch_size
        if proc_count > 1:
            if self.batch_size % proc_count:
                raise ValueError(f"global batch {self.batch_size} not divisible by process count {proc_count}")
            per_process = self.batch_size // proc_count
        emitted = 0
        for epoch in range(self.epochs):
            order = self.epoch_order(epoch)
            for step in range(self.steps_per_epoch()):
                emitted += 1
                if emitted <= self.skip_batches:
                    continue
                lo = step * self.batch_size
                idx = order[lo : lo + self.batch_size]
                if proc_count > 1:
                    if len(idx) < self.batch_size:
                        # a short final batch cannot be split alike over the
                        # processes: every process drops it
                        continue
                    idx = idx[proc_index * per_process : (proc_index + 1) * per_process]
                yield idx

    def rows(self, idx: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch ``idx`` (all of them without a
        sharding, or where ``shard_by_process`` already sliced it)."""
        if self.shard_by_process and _processes()[0] > 1:
            return idx
        return local_rows(idx, self.sharding, self.microbatches)

    def _place(self, idx: np.ndarray) -> Any:
        idx = self.rows(idx)

        def leaf_to_device(leaf: np.ndarray) -> torch.Tensor:
            host = torch.from_numpy(np.ascontiguousarray(leaf[idx]))
            if self.device.type != "cuda":
                return host.to(self.device)
            return host.pin_memory().to(self.device, non_blocking=True)

        return unflatten(self._structure, [leaf_to_device(leaf) for leaf in self._leaves])

    def __iter__(self) -> Iterator[Any]:
        if self.prefetch <= 0:
            for idx in self.index_batches():
                yield self._place(idx)
            return

        # one background thread produces (host gather, pinned copy, async
        # transfer) prefetch + 1 batches ahead; one worker keeps the order
        source = self.index_batches()
        sentinel = object()
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

        def produce() -> Any:
            try:
                idx = next(source)
            except StopIteration:
                return sentinel
            if stream is None:
                return self._place(idx)
            with torch.cuda.stream(stream):  # the consumer's stream: no cross-stream hazard
                return self._place(idx)

        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="unionml-tpu-torch-prefetch")
        try:
            futures: collections.deque = collections.deque(pool.submit(produce) for _ in range(self.prefetch + 1))
            while futures:
                item = futures.popleft().result()
                if item is sentinel:
                    break
                futures.append(pool.submit(produce))
                yield item
        finally:
            # abandoned mid-epoch: drop the queued batches; the one in flight finishes
            pool.shutdown(wait=True, cancel_futures=True)

    def __len__(self) -> int:
        return max(self.steps_per_epoch() * self.epochs - self.skip_batches, 0)


def _nonempty(leaf: Any) -> bool:
    """Filter out empty target frames produced by the default parser for unlabeled data."""
    try:
        return len(leaf) > 0
    except TypeError:
        return True
