"""Dynamic micro-batching for serving, a copy of
``unionml_tpu/serving/batcher.py``.

Serving one request at a time straight through the predictor is fine for
sklearn on a CPU and wasteful on an accelerator, where a batch-1 dispatch
leaves most of the card idle. The batcher coalesces concurrent requests:

1. each request's features enqueue with a future,
2. a collector drains the queue until ``max_batch_size`` rows or ``max_wait_ms``
   elapse (first-come request never waits longer than the window); the window
   is ADAPTIVE — with an empty queue and no recent coalescing, a solo request
   dispatches immediately, so sparse traffic pays ~zero added latency while
   any sign of concurrency re-arms the full wait,
3. one predictor call runs on the concatenated batch,
4. per-request slices of the output resolve the futures.

Padding note: the predictor path buckets batch sizes (pow2 up to
``max_batch_size``) so the predictor sees a handful of shapes instead of one
per arrival pattern; see :class:`unionml_tpu_torch.serving.compile.CompiledPredictor`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

from unionml_tpu_torch.defaults import SERVE_QUEUE_MAXSIZE
from unionml_tpu_torch.observability.trace import current_trace
from unionml_tpu_torch.serving.overload import DeadlineExceeded, QueueFullError, expired


@dataclasses.dataclass
class ServingConfig:
    """Execution config attached to ``@model.predictor(config=...)``.

    ``bucket_sizes`` are the padded batch sizes the predictor is compiled for at
    startup (AOT warmup), avoiding cold-compiles on the request path.

    With ``jit=True`` (the default) the predictor runs through a
    :class:`~unionml_tpu_torch.serving.compile.CompiledPredictor`: array
    features padded to a bucket, under ``torch.inference_mode()``; a
    predictor that cannot take arrays falls back to eager serving
    automatically with unchanged semantics.

    ``mesh`` stays a field for the JAX package's signature; the port has no
    device mesh yet, and a non-``None`` value raises ``NotImplementedError``.
    """

    max_batch_size: int = 32
    max_wait_ms: float = 2.0
    bucket_sizes: Optional[Sequence[int]] = None
    mesh: Optional[Any] = None
    warmup: bool = True
    #: run the predictor through CompiledPredictor with pad-to-bucket shapes
    #: (falls back to eager automatically if the predictor cannot take arrays)
    jit: bool = True
    #: pad coalesced micro-batches up to the next bucket before dispatch so the
    #: predictor sees only bucket shapes even on the non-jitted path
    pad_to_bucket: bool = True
    #: per-row feature shape (e.g. ``(784,)``) used to synthesize warmup batches;
    #: without it, warmup is skipped and buckets compile lazily on first use
    feature_shape: Optional[Sequence[int]] = None
    feature_dtype: str = "float32"
    #: admission bound: requests waiting to join a dispatch. A full queue sheds
    #: new submissions with :class:`~unionml_tpu_torch.serving.overload.QueueFullError`
    #: (HTTP 429) instead of growing without bound under overload; ``0`` means
    #: unbounded (not recommended outside tests).
    max_queue: int = SERVE_QUEUE_MAXSIZE

    def __post_init__(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "ServingConfig(mesh=...) is not ported yet (ROADMAP.md, Queue A: parallelism and the replica layer)"
            )

    def buckets(self) -> List[int]:
        if self.bucket_sizes:
            return sorted(set(self.bucket_sizes))
        sizes, n = [], 1
        while n < self.max_batch_size:
            sizes.append(n)
            n *= 2
        sizes.append(self.max_batch_size)
        return sizes


def _signature(features: Any) -> Any:
    """Concat-compatibility key: only like-shaped parts may share a batch.
    Types ``_concat`` cannot merge get a per-object key so they rarely share a
    batch — and the dispatch path additionally treats a failed concat as
    "dispatch solo", so even identity-equal unconcatenatable objects never
    turn into a batched 500."""
    try:
        import pandas as pd

        if isinstance(features, pd.DataFrame):
            return ("df", tuple(features.columns))
    except ImportError:  # pragma: no cover
        pass
    import numpy as np

    if isinstance(features, np.ndarray):
        return ("nd", features.shape[1:], str(features.dtype))
    if isinstance(features, list):
        # rows of different widths must not share a concat (the ndarray
        # branch's shape[1:] guard, for the list-of-rows spelling)
        if not features:
            return ("list", "empty")
        row = features[0]
        if isinstance(row, (list, tuple)):
            return ("list", "row-len", len(row))
        return ("list", "scalar", type(row).__name__)
    return ("other", id(features))


def _num_rows(features: Any) -> int:
    try:
        return len(features)
    except TypeError:
        return 1


def _concat(parts: List[Any]) -> Any:
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    try:
        import pandas as pd

        if isinstance(first, pd.DataFrame):
            return pd.concat(parts, ignore_index=True)
    except ImportError:  # pragma: no cover
        pass
    import numpy as np

    if isinstance(first, np.ndarray):
        return np.concatenate(parts, axis=0)
    if isinstance(first, list):
        return [row for part in parts for row in part]
    raise TypeError(f"micro-batcher cannot concatenate features of type {type(first)}")


def _split(result: Any, sizes: List[int]) -> List[Any]:
    out, lo = [], 0
    for n in sizes:
        out.append(result[lo : lo + n])
        lo += n
    return out


class MicroBatcher:
    """Coalesce concurrent predict calls into single batched predictor dispatches."""

    def __init__(
        self,
        predict_fn: Callable[[Any], Any],
        config: Optional[ServingConfig] = None,
        pad_to_bucket: "Optional[bool | Callable[[], bool]]" = None,
        metrics: Any = None,
    ):
        self._predict_fn = predict_fn
        self.config = config or ServingConfig()
        # the serving app passes a callable that disables batcher-level padding
        # while a CompiledPredictor is actively padding downstream (on numpy, not
        # pandas) — but re-enables it if that predictor falls back to eager
        self._pad_to_bucket = self.config.pad_to_bucket if pad_to_bucket is None else pad_to_bucket
        #: bounded admission: queue items are (features, rows, future, deadline,
        #: enqueue_time); maxsize counts REQUESTS waiting to join a dispatch
        self._queue: "asyncio.Queue[Tuple[Any, int, asyncio.Future, Optional[float], float]]" = (
            asyncio.Queue(maxsize=self.config.max_queue)
        )
        self._worker: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        #: optional :class:`~unionml_tpu_torch.serving.metrics.ServingMetrics` sink for
        #: shed counters and queue-wait percentiles
        self._metrics = metrics
        #: None until the first coalesced dispatch proves the predictor's
        #: output row-aligned (splittable per request); False pins the solo
        #: path so a structured-output predictor never pays a doomed combined
        #: call more than once
        self._row_aligned: Optional[bool] = None
        #: /metrics telemetry: predictor dispatches vs requests/rows coalesced
        #: into them (avg rows per dispatch = the realized vectorization win)
        self.dispatches = 0
        self.batched_requests = 0
        self.batched_rows = 0
        #: overload telemetry: queue-full sheds, deadline sheds (expired while
        #: queued), and cancellations reaped before dispatch (client gone)
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.cancelled = 0
        self._queue_waits: "deque[float]" = deque(maxlen=2048)

    def _padding_active(self) -> bool:
        if callable(self._pad_to_bucket):
            return bool(self._pad_to_bucket())
        return bool(self._pad_to_bucket)

    def start(self) -> None:
        loop = asyncio.get_event_loop()
        if self._worker is not None and not self._worker.done() and self._loop is loop:
            return
        if self._loop is not loop:
            # the previous loop is gone (each asyncio.run creates a fresh loop —
            # the test-client surface, or a serve/stop/serve cycle): rebind the
            # queue + worker, otherwise submit() would enqueue onto a dead
            # loop's queue and hang. Requests stranded on the dead loop cannot
            # be completed (their futures belong to it) and are dropped with it.
            if self._worker is not None and not self._worker.done():
                try:
                    self._worker.cancel()  # foreign-loop task: cancel best-effort
                except RuntimeError:  # its loop is already closed
                    pass
            self._queue = asyncio.Queue(maxsize=self.config.max_queue)
            self._loop = loop
        # same loop: keep the queue — a restarted worker (e.g. after stop())
        # must drain any backlog already enqueued
        self._worker = loop.create_task(self._run())

    async def stop(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
            self._worker = None

    async def submit(self, features: Any, *, deadline: Optional[float] = None) -> Any:
        """Enqueue features; resolves with this request's slice of the batched
        output. ``deadline`` is an absolute ``time.monotonic()`` instant: a
        request still queued past it is shed with :class:`DeadlineExceeded`
        instead of burning a device dispatch on an answer nobody is waiting for.
        A full queue sheds immediately with :class:`QueueFullError` (429)."""
        self.start()
        future: asyncio.Future = asyncio.get_event_loop().create_future()
        # request timeline hook: submit runs in the handler's context, so the
        # trace (None when tracing is off — the zero-cost path) is reachable
        # here even though the dispatch happens on the worker task later
        trace = current_trace()
        if trace is not None:
            trace.event("batcher.enqueue", depth=self._queue.qsize())
        try:
            self._queue.put_nowait((features, _num_rows(features), future, deadline, time.monotonic()))
        except asyncio.QueueFull:
            self.shed_queue_full += 1
            if self._metrics is not None:
                self._metrics.inc("shed_queue_full")
            if trace is not None:
                trace.event("batcher.shed_queue_full")
            raise QueueFullError(
                f"micro-batcher admission queue full ({self.config.max_queue} requests waiting)"
            )
        result = await future
        if trace is not None:
            trace.event("batcher.complete")
        return result

    def _admit(self, item: "Tuple[Any, int, asyncio.Future, Optional[float], float]") -> bool:
        """Dequeue-side shedding: a request whose future is already done (its
        handler was cancelled — client disconnect or deadline at the HTTP
        layer) or whose own deadline passed while it was queued is dropped
        BEFORE it joins a batch, so overload never spends predictor dispatches
        on answers nobody will read."""
        _, _, future, deadline, enqueued = item
        if future.done():
            self.cancelled += 1
            if self._metrics is not None:
                self._metrics.inc("cancelled_before_dispatch")
            return False
        if expired(deadline):
            self.shed_deadline += 1
            if self._metrics is not None:
                self._metrics.inc("shed_deadline")
            future.set_exception(
                DeadlineExceeded("deadline exceeded while queued in the micro-batcher")
            )
            return False
        wait = time.monotonic() - enqueued
        self._queue_waits.append(wait)
        if self._metrics is not None:
            self._metrics.observe_queue_wait("micro_batcher", wait)
        return True

    async def _run(self) -> None:
        pending: "Optional[Tuple[Any, int, asyncio.Future, Optional[float], float]]" = None
        coalesced_last = False
        while True:
            preadmitted = pending is not None  # a mismatch handoff already passed _admit
            first = pending if pending is not None else await self._queue.get()
            pending = None
            if not preadmitted and not self._admit(first):
                continue
            batch = [first]
            total = first[1]
            # Adaptive wait: the max_wait_ms window only pays off when there is
            # concurrency to coalesce. If the queue is empty AND the previous
            # dispatch was solo, dispatch immediately — sparse traffic then
            # pays zero added latency, while any sign of concurrency (queued
            # requests now, or a coalesced previous batch whose clients are
            # about to come back) re-arms the full window.
            if not self._queue.empty() or coalesced_last:
                first_sig = _signature(first[0])
                deadline = asyncio.get_event_loop().time() + self.config.max_wait_ms / 1000.0
                while total < self.config.max_batch_size:
                    timeout = deadline - asyncio.get_event_loop().time()
                    if timeout <= 0:
                        break
                    try:
                        item = await asyncio.wait_for(self._queue.get(), timeout)
                    except asyncio.TimeoutError:
                        break
                    if not self._admit(item):
                        continue
                    if _signature(item[0]) != first_sig:
                        # concatenating mismatched column sets / row shapes would
                        # silently produce a NaN-unioned frame; dispatch what we
                        # have and start the next batch from the odd one out
                        pending = item
                        break
                    batch.append(item)
                    total += item[1]
            # a pending signature-mismatch handoff is itself direct evidence of
            # concurrency: the odd one out must re-arm the window or steady
            # mixed-schema traffic would pin one schema to solo dispatches
            coalesced_last = len(batch) > 1 or pending is not None

            await self._dispatch(batch, total)

    @property
    def queue_depth(self) -> int:
        """Requests currently waiting for a dispatch (bounded by ``max_queue``)."""
        return self._queue.qsize()

    def stats(self) -> dict:
        """Coalescing + overload telemetry for ``GET /metrics``. ``dispatches``
        counts PREDICTOR INVOCATIONS (solo reruns included), so
        ``avg_rows_per_dispatch`` is the realized vectorization win — an app
        pinned to the solo path honestly reads ~1.0, not its batch size. The
        overload block says why errors moved under load: queue-full sheds (429),
        deadline sheds (503), and cancellations reaped before dispatch."""
        out = {
            "dispatches": self.dispatches,
            "requests": self.batched_requests,
            "rows": self.batched_rows,
            "avg_rows_per_dispatch": round(self.batched_rows / self.dispatches, 2)
            if self.dispatches
            else 0.0,
            "row_aligned": self._row_aligned,
            "queue_depth": self.queue_depth,
            "max_queue": self.config.max_queue,
            "shed_queue_full": self.shed_queue_full,
            "shed_deadline": self.shed_deadline,
            "cancelled": self.cancelled,
        }
        if self._queue_waits:
            ordered = sorted(self._queue_waits)
            out["queue_wait_p50_ms"] = round(ordered[len(ordered) // 2] * 1e3, 3)
            out["queue_wait_p99_ms"] = round(
                ordered[min(len(ordered) - 1, round(0.99 * (len(ordered) - 1)))] * 1e3, 3
            )
        return out

    async def _call_predictor(self, features: Any) -> Any:
        self.dispatches += 1
        return await asyncio.get_event_loop().run_in_executor(None, self._predict_fn, features)

    async def _solo_all(self, batch: List[Tuple]) -> None:
        for item in batch:
            features, fut = item[0], item[2]
            if fut.done():  # cancelled while earlier solo reruns were in flight
                continue
            # each rerun fails alone: one request's predictor error (bad
            # features) must not poison the valid siblings queued behind it —
            # solo semantics means solo failures
            try:
                solo = await self._call_predictor(features)
            except Exception as exc:
                if not fut.done():
                    fut.set_exception(exc)
                continue
            if not fut.done():
                fut.set_result(solo)

    async def _dispatch(self, batch: List[Tuple], total: int) -> None:
        parts = [b[0] for b in batch]
        sizes = [b[1] for b in batch]
        futures = [b[2] for b in batch]
        self.batched_requests += len(batch)
        self.batched_rows += total
        # Padding-active configs predate default-on batching and keep their
        # original contract exactly: concat -> pad to bucket -> split (an app
        # that opted into bucket padding is declaring row-aligned outputs).
        # The detection/fallback safety below exists for the DEFAULT batcher,
        # where the app never opted into anything.
        strict = not self._padding_active()
        try:
            if strict and len(batch) == 1:
                # single request: hand the predictor's output through whole —
                # identical semantics to serving without a batcher, so
                # non-row-aligned predictors (aggregates, dicts) keep working
                result = await self._call_predictor(parts[0])
                if not futures[0].done():
                    futures[0].set_result(result)
                return
            if strict and self._row_aligned is False:
                # proven structured-output predictor: skip the doomed combined
                # call entirely, dispatch each request solo
                await self._solo_all(batch)
                return
            try:
                combined = _concat(parts)
            except TypeError:
                if strict:
                    # unconcatenatable feature type (identity-equal objects
                    # can even share a signature): solo semantics, not a 500
                    await self._solo_all(batch)
                    return
                raise
            if not strict and total > 0:
                # above the largest bucket we leave the batch unpadded: inventing
                # k*largest shapes would defeat the bounded-shape goal, and a
                # downstream CompiledPredictor chunks oversized batches itself
                bucket = next((b for b in self.config.buckets() if b >= total), None)
                if bucket is not None:
                    from unionml_tpu_torch.serving.compile import pad_rows

                    combined = pad_rows(combined, bucket)
            # run the (potentially blocking) device dispatch off the event loop
            result = await self._call_predictor(combined)
            if strict:
                pieces = self._try_split(result, sizes, total)
                if pieces is None:
                    # the predictor's output is not row-aligned (wrong length,
                    # or not a row-major container): coalescing is unsafe for
                    # this app — rerun each request individually, exact solo
                    # semantics, and pin the solo path for every later batch
                    self._row_aligned = False
                    await self._solo_all(batch)
                    return
                self._row_aligned = True
            else:
                pieces = _split(result, sizes)
            for fut, piece in zip(futures, pieces):
                if not fut.done():
                    fut.set_result(piece)
        except Exception as exc:  # propagate the batch failure to every caller
            for fut in futures:
                if not fut.done():
                    fut.set_exception(exc)

    @staticmethod
    def _row_major(result: Any) -> bool:
        """Only containers whose ``[lo:hi]`` slice means "these rows" may be
        split per request — a tuple/dict/str of coincidentally-matching length
        (e.g. ``(predictions, probabilities)`` from a 2-row batch) must not be
        sliced across callers."""
        if isinstance(result, list):
            return True
        try:
            import pandas as pd

            if isinstance(result, (pd.DataFrame, pd.Series)):
                return True
        except ImportError:  # pragma: no cover
            pass
        import numpy as np

        if isinstance(result, np.ndarray):
            return True
        import torch

        return isinstance(result, torch.Tensor)

    def _try_split(self, result: Any, sizes: List[int], total: int) -> Optional[List[Any]]:
        """Strict-mode split: the unpadded row count must match exactly and the
        container must be row-major for per-request slices to be valid."""
        if not self._row_major(result):
            return None
        try:
            rows = len(result)
        except TypeError:
            # a 0-d array (e.g. np.sum over the batch) passes the row-major
            # type check but is unsized — not row-aligned, so the solo
            # fallback engages instead of 500ing every coalesced batch
            return None
        if rows != total:
            return None
        try:
            return _split(result, sizes)
        except TypeError:
            return None
