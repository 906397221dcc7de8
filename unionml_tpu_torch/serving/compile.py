"""Bucketed predictor dispatch for serving: the port's ``CompiledPredictor``.

The JAX package's ``CompiledPredictor`` (``unionml_tpu/serving/compile.py``)
wraps the user predictor in one ``jax.jit`` whose shape-keyed cache holds one
XLA executable per batch bucket. Its torch meaning here:

1. incoming features are padded along the batch dim to the nearest
   configured bucket, so the set of batch shapes the predictor ever sees is
   exactly ``config.buckets()`` (the same padding, by repeating the last
   row);
2. the padded batch becomes torch tensors on the device of the model
   object's tensors (the CPU when it holds none; float64 becomes float32,
   as under the JAX package's 32-bit default) and the predictor runs
   under ``torch.inference_mode()``; its outputs are sliced back to the real
   rows. Nothing is compiled: no ``torch.compile`` and no CUDA graph. A graph
   captured per bucket is the later speed step (ROADMAP.md, Queue B);
3. :meth:`warmup` runs every bucket once before traffic, so each shape's
   first-call costs (kernel builds, allocator growth) land at startup;
4. requests larger than the largest bucket are chunked through the largest
   bucket instead of minting new shapes.

``traces`` counts the distinct padded shapes the predictor has been called
with (a failed first call counts once), the counterpart of the JAX package's
trace count: it stays at ``len(config.buckets())`` across varied request
sizes. A predictor that cannot take the padded tensors (a ``TypeError`` or
``AttributeError``, e.g. sklearn bodies or DataFrame methods), or features
that are not fixed-shape arrays, permanently fall back to the eager path on
first failure — same results, no serving outage. Any other error serves that
request eagerly and keeps the bucketed path.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Set, Tuple

import numpy as np
import torch

from unionml_tpu_torch._logging import logger

__all__ = ["CompiledPredictor"]


class _Unjittable(Exception):
    """Features cannot be represented as fixed-shape arrays; use the eager path."""


def _as_batched_arrays(features: Any) -> Any:
    """Convert features into a pytree of numpy arrays with a leading batch dim."""
    try:
        import pandas as pd

        if isinstance(features, (pd.DataFrame, pd.Series)):
            arr = features.to_numpy()
            if arr.dtype == object:
                raise _Unjittable("DataFrame has object-dtype columns")
            return arr
    except ImportError:  # pragma: no cover
        pass
    if isinstance(features, (list, tuple)) and not isinstance(features, np.ndarray):
        arr = np.asarray(features)
        if arr.dtype == object:
            raise _Unjittable("ragged or non-numeric feature rows")
        return arr
    if isinstance(features, dict):
        return {k: _as_batched_arrays(v) for k, v in features.items()}
    arr = np.asarray(features)
    if arr.dtype == object:
        raise _Unjittable(f"features of type {type(features)} are not array-convertible")
    return arr


def _tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _model_device(model_object: Any) -> torch.device:
    """Where the model object's tensors live (the first one found): a
    module's parameters, or the leaves of a dict/list tree; the CPU when it
    holds no tensor."""
    if isinstance(model_object, torch.nn.Module):
        for param in model_object.parameters():
            return param.device
        return torch.device("cpu")
    for leaf in _leaves(model_object):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _as_32bit(a: Any) -> np.ndarray:
    """A padded leaf with float64 made float32, as under the JAX package's
    32-bit default (a float64 request then reuses a float32 bucket's shape)."""
    a = np.ascontiguousarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _num_rows(tree: Any) -> int:
    leaves = _leaves(tree)
    if not leaves:
        raise _Unjittable("empty feature pytree")
    n = int(np.shape(leaves[0])[0]) if np.ndim(leaves[0]) else None
    if n is None:
        raise _Unjittable("feature leaves have no batch dimension")
    return n


def pad_rows(features: Any, target: int) -> Any:
    """Pad a batch to ``target`` rows by repeating the last row.

    The one padding implementation for both serving layers: handles the
    batcher's request containers (DataFrame, list-of-rows) and the compiled
    path's array pytrees. No-op when the batch already has >= ``target`` rows
    or is empty (nothing to repeat).
    """
    try:
        import pandas as pd

        if isinstance(features, pd.DataFrame):
            n = len(features)
            if n >= target or n == 0:
                return features
            reps = features.iloc[[-1] * (target - n)]
            return pd.concat([features, reps], ignore_index=True)
    except ImportError:  # pragma: no cover
        pass
    if isinstance(features, list):  # a list is rows, not a pytree, at this layer
        n = len(features)
        if n >= target or n == 0:
            return features
        return features + [features[-1]] * (target - n)

    def pad(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a)
        n = a.shape[0]
        if n >= target or n == 0:
            return a
        reps = np.repeat(a[-1:], target - n, axis=0)
        return np.concatenate([a, reps], axis=0)

    return _tree_map(pad, features)


class CompiledPredictor:
    """Pad-to-bucket wrapper for a predictor fn, run under ``torch.inference_mode()``.

    ``traces`` counts the distinct padded shapes the predictor was called
    with (a failed first call also counts once before the eager fallback
    engages); tests assert it stays at ``len(config.buckets())`` across
    varied request sizes.

    The bucketed path returns torch tensors (or the predictor's own tree of
    them), sliced to the real rows; a predictor body written against
    DataFrames keeps its container type only on the eager path.
    """

    def __init__(self, predict_fn: Callable[[Any, Any], Any], config: Any):
        if getattr(config, "mesh", None) is not None:
            raise NotImplementedError(
                "CompiledPredictor over a mesh is not ported yet (ROADMAP.md, Queue A: parallelism and the "
                "replica layer)"
            )
        self._fn = predict_fn
        self.config = config
        self.traces = 0
        self._eager = False
        #: padded (shape, dtype) signatures already dispatched
        self._seen: Set[Tuple[Any, ...]] = set()

    # ------------------------------------------------------------------ buckets

    def _buckets(self) -> Tuple[int, ...]:
        return tuple(sorted({max(1, b) for b in self.config.buckets()}))

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets():
            if b >= n:
                return b
        return self._buckets()[-1]

    # ------------------------------------------------------------------ dispatch

    def _dispatch(self, model_object: Any, batch: Any, n: int) -> Any:
        """Pad one <=-largest-bucket chunk and run the predictor on it."""
        bucket = self._bucket_for(n)
        padded = _tree_map(_as_32bit, pad_rows(batch, bucket))
        key = tuple((a.shape, str(a.dtype)) for a in _leaves(padded))
        if key not in self._seen:
            self._seen.add(key)
            self.traces += 1  # the first call of each padded shape
        device = _model_device(model_object)
        placed = _tree_map(lambda a: torch.from_numpy(a).to(device), padded)
        with torch.inference_mode():
            out = self._fn(model_object, placed)
        return _tree_map(lambda a: a[:n], out)

    def __call__(self, model_object: Any, features: Any) -> Any:
        if self._eager:
            return self._fn(model_object, features)
        try:
            batch = _as_batched_arrays(features)
            n = _num_rows(batch)
        except _Unjittable as exc:
            logger.info(f"predictor features are not fixed-shape arrays ({exc}); serving eagerly")
            self._eager = True
            return self._fn(model_object, features)
        if n == 0:
            return self._fn(model_object, features)  # nothing to pad; eager returns empty
        try:
            largest = self._buckets()[-1]
            if n <= largest:
                return self._dispatch(model_object, batch, n)
            # oversized request: chunk through the largest bucket, no new shapes
            outs = []
            for lo in range(0, n, largest):
                hi = min(lo + largest, n)
                chunk = _tree_map(lambda a: a[lo:hi], batch)
                outs.append(self._dispatch(model_object, chunk, hi - lo))
            return _concat_trees(outs)
        except Exception as exc:
            # TypeError/AttributeError: the predictor body cannot take the
            # padded tensors (sklearn .predict, DataFrame-method calls, a
            # list of Python scalars that does not slice by rows). Anything
            # else (e.g. a CUDA runtime error) is treated as transient.
            permanent = isinstance(exc, (TypeError, AttributeError))
            if permanent:
                logger.warning(
                    f"predictor does not take bucketed tensors ({type(exc).__name__}: {exc}); "
                    "falling back to eager serving permanently"
                )
                self._eager = True
            else:
                logger.warning(
                    f"bucketed predictor dispatch failed ({type(exc).__name__}: {exc}); "
                    "serving this request eagerly"
                )
            return self._fn(model_object, features)

    # ------------------------------------------------------------------ warmup

    def warmup(self, model_object: Any, batch_size: "Optional[int]" = None) -> bool:
        """Run EVERY configured bucket once (each is its own shape), so no
        request pays a bucket's first call. ``batch_size`` is kept for caller
        compatibility and does not narrow the set. Needs
        ``config.feature_shape`` (per-row shape) to synthesize template
        batches; returns False when no template is configured. The first
        bucket that proves the predictor unfit for tensors stops the sweep —
        the eager fallback serves every shape anyway."""
        shape = getattr(self.config, "feature_shape", None)
        if shape is None or self._eager:
            return False
        dtype = getattr(self.config, "feature_dtype", "float32")
        for bucket in self._buckets():
            if self._eager:
                break
            template = np.zeros((bucket, *tuple(shape)), dtype=dtype)
            self(model_object, template)
        return not self._eager


def _concat_trees(outs: list) -> Any:
    """Join per-chunk outputs along the batch dim, leaf by leaf."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat_trees([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat_trees(list(parts)) for parts in zip(*outs))
    if isinstance(first, torch.Tensor):
        return torch.cat(outs, dim=0)
    return np.concatenate([np.asarray(o) for o in outs], axis=0)
