"""The port's ``PrefetchIterator`` (``unionml_tpu_torch.data``) against the JAX
package's, on the CPU: the same seeded schedule gives the same batches in the
same order (bit-equal), with shuffle, across epochs, under ``skip_batches``
and with a partial final batch."""

import numpy as np
import pytest
import torch

from unionml_tpu.data.pipeline import PrefetchIterator as JaxPrefetchIterator
from unionml_tpu_torch.data import PrefetchIterator, to_host_arrays

torch.set_num_threads(2)


def _data(n=23):
    rng = np.random.RandomState(0)
    return [rng.randn(n, 3).astype(np.float32), rng.randint(0, 9, size=(n,)).astype(np.int32)]


def _leaves(batch):
    return [np.asarray(x) for x in (batch if isinstance(batch, (tuple, list)) else [batch])]


@pytest.mark.parametrize(
    "kw",
    [
        dict(shuffle=True, epochs=3),
        dict(shuffle=True, epochs=3, skip_batches=4),
        dict(shuffle=False, epochs=2, drop_remainder=False, skip_batches=1),
        dict(shuffle=True, epochs=2, drop_remainder=False, prefetch=0, seed=7),
    ],
    ids=["shuffle-epochs", "skip-batches", "partial-final", "no-prefetch-seed7"],
)
def test_same_batches_in_the_same_order_as_jax(kw):
    data = _data()
    ours = [[t.numpy() for t in batch] for batch in PrefetchIterator(data, 5, device="cpu", **kw)]
    ref = [_leaves(batch) for batch in JaxPrefetchIterator(data, 5, **kw)]
    assert len(ours) == len(ref) == len(PrefetchIterator(data, 5, device="cpu", **kw)) == len(
        JaxPrefetchIterator(data, 5, **kw))
    for got, want in zip(ours, ref):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_schedules_match_jax():
    data = _data()
    kw = dict(shuffle=True, epochs=3, skip_batches=2, seed=4)
    ours, ref = PrefetchIterator(data, 5, device="cpu", **kw), JaxPrefetchIterator(data, 5, **kw)
    assert list(ours.contiguous_schedule()) == list(ref.contiguous_schedule())
    for got, want in zip(ours.index_batches(), ref.index_batches()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours.epoch_order(1), ref._epoch_order(1))


def test_structures_and_host_conversion():
    """A single array yields tensors, a dict yields dicts; empty target
    leaves are dropped as in the JAX package; tensors convert to numpy."""
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert [b.shape for b in PrefetchIterator(x, 4, device="cpu", drop_remainder=False)] == [(4, 2), (2, 2)]
    batch = next(iter(PrefetchIterator({"x": x, "y": np.arange(6)}, 3, device="cpu")))
    assert set(batch) == {"x", "y"} and batch["y"].tolist() == [0, 1, 2]
    batches = list(PrefetchIterator([x, []], 3, device="cpu"))
    assert len(batches) == 2 and isinstance(batches[0], tuple) and len(batches[0]) == 1
    np.testing.assert_array_equal(to_host_arrays(torch.ones(2, 2)), np.ones((2, 2), np.float32))


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="leading sample dimension"):
        PrefetchIterator([np.zeros(3), np.zeros(4)], 2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        PrefetchIterator(np.zeros(3), 0, device="cpu")
    # shard_by_process in a world of one process: every batch whole, as JAX with one process
    whole = [b.tolist() for b in PrefetchIterator(np.arange(5), 2, device="cpu", drop_remainder=False)]
    assert [b.tolist() for b in PrefetchIterator(np.arange(5), 2, device="cpu", drop_remainder=False,
                                                 shard_by_process=True)] == whole == [[0, 1], [2, 3], [4]]


def test_abandoned_iteration_stops_its_producer():
    it = iter(PrefetchIterator(np.zeros((100, 2)), 2, device="cpu", prefetch=3))
    next(it)
    it.close()  # the generator's finally shuts the producer thread down
    import threading

    assert not any(t.name.startswith("unionml-tpu-torch-prefetch") for t in threading.enumerate())
