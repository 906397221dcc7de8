"""The step trainer: run a ``(state, batch) -> (state, metrics)`` step over an
epoch schedule, on one card.

Counterpart of ``unionml_tpu/train/driver.py``. The user (or a model-library
preset) supplies the step; :func:`make_train_step` builds the canonical one
from a loss function, and :func:`fit` feeds it batches from
:class:`~unionml_tpu_torch.data.PrefetchIterator` (or, with
``device_data=True``, contiguous slices of the whole split kept on the card
and permuted once per epoch), with step-level checkpoints and resume,
``log_every_steps`` history, ``torch.profiler`` traces and anomaly mode.

What differs from the JAX driver:

- PyTorch runs eagerly, so there is no compile: ``compile_time_s`` is the
  wall time of the first step (first kernel builds and library warm-up),
  and ``steps_per_call`` runs K steps per payload as a plain loop.
- The optimizer updates parameters in place, so ``donate`` and
  ``debug_disable_donation`` change nothing.
- Checkpoints are ``torch.save`` files of the model, optimizer and step
  (``step_<N>.pt`` under ``checkpoint_dir``); orbax checkpoints of the JAX
  package do not load here (convert weights with
  :func:`~unionml_tpu_torch.models.llama_params_from_jax` instead).
- One card: ``mesh``, ``partition_rules``, ``logical_axis_rules`` and
  ``shard_batch_by_process`` raise ``NotImplementedError`` unless left at
  their defaults (``ROADMAP.md``, Queue A: parallelism and the replica
  layer); ``fsdp_min_weight_size`` is
  read only with a mesh.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unionml_tpu_torch._device import DeviceLike, module_device, resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.data.pipeline import PrefetchIterator, flatten, unflatten


@dataclasses.dataclass
class TrainerConfig:
    """Execution config of a step-mode trainer; every field of the JAX
    package's, with its name and default (see the module docstring for the
    fields that mean nothing or raise on one card)."""

    epochs: int = 1
    batch_size: int = 32
    mesh: Any = None
    partition_rules: Any = None
    logical_axis_rules: "Optional[Sequence[Tuple[str, Any]]]" = None
    fsdp_min_weight_size: int = 2**14
    grad_accum_steps: int = 1
    donate: bool = True
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True
    prefetch: int = 2
    shard_batch_by_process: bool = False
    #: keep the whole split on the card, permute it once per epoch and take
    #: each batch as a contiguous slice
    device_data: bool = False
    #: with device_data, optimizer steps per payload (a loop)
    steps_per_call: int = 1
    # checkpoint / resume
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 0
    max_checkpoints_to_keep: int = 3
    resume: bool = False
    # observability
    log_every_steps: int = 0
    profile_dir: Optional[str] = None
    profile_steps: Tuple[int, int] = (10, 15)
    #: autograd anomaly mode: a NaN in the backward raises, naming the forward op
    debug_nans: bool = False
    debug_disable_donation: bool = False


@dataclasses.dataclass
class FitResult:
    state: Any
    history: List[Dict[str, float]]
    steps: int
    samples_per_sec: float
    samples_per_sec_per_chip: float
    compile_time_s: float
    #: ``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` of the card
    #: from ``torch.cuda.memory_stats()`` after the final step; None on the CPU
    memory_stats: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class TrainState:
    """The port's stand-in for flax's ``TrainState``: the module (its
    parameters are the params), the optimizer over its trainable parameters,
    and the number of completed optimizer steps."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def _refuse_parallel(**options: Any) -> None:
    for name, value in options.items():
        if value not in (None, False):
            raise NotImplementedError(
                f"{name} is not ported: the port trains on one card (ROADMAP.md, Queue A: parallelism and the "
                "replica layer)"
            )


def _detached(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}


def make_train_step(
    loss_fn: Callable[..., Any],
    *,
    has_aux: bool = False,
    grad_accum_steps: int = 1,
    remat: bool = False,
) -> Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the canonical ``(state, batch) -> (state, metrics)`` step.

    ``loss_fn(model, batch)`` returns the loss (or ``(loss, aux_dict)`` with
    ``has_aux=True``). With ``grad_accum_steps > 1`` the batch is split along
    its leading dimension into that many microbatches; their gradients are
    averaged before one optimizer step, and the metrics are the microbatch
    means. ``remat`` checkpoints the whole loss computation."""

    def loss_and_aux(model: nn.Module, batch: Any) -> Tuple[torch.Tensor, Dict[str, Any]]:
        out = checkpoint(loss_fn, model, batch, use_reentrant=False) if remat else loss_fn(model, batch)
        return out if has_aux else (out, {})

    def single_step(state: TrainState, batch: Any) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_and_aux(state.model, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), **_detached(aux)}

    if grad_accum_steps <= 1:
        return single_step

    def accum_step(state: TrainState, batch: Any) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves, structure = flatten(batch)
        rows = leaves[0].shape[0]
        if rows % grad_accum_steps:
            raise ValueError(f"batch of {rows} does not split into {grad_accum_steps} microbatches")
        size = rows // grad_accum_steps
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum, auxes = None, []
        for i in range(grad_accum_steps):
            micro = unflatten(structure, [leaf[i * size : (i + 1) * size] for leaf in leaves])
            loss, aux = loss_and_aux(state.model, micro)
            (loss / grad_accum_steps).backward()  # the summed gradients are the mean
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            auxes.append(_detached(aux))
        state.optimizer.step()
        state.step += 1
        aux_mean = {k: sum(a[k] for a in auxes) / grad_accum_steps for k in auxes[0]}
        return state, {"loss": loss_sum / grad_accum_steps, **aux_mean}

    return accum_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_memory_stats(device: torch.device) -> Optional[Dict[str, int]]:
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


class _Checkpoints:
    """``step_<N>.pt`` files under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int):
        self.directory, self.keep = Path(directory), keep

    def steps(self) -> List[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.stem.split("_")[1]) for p in self.directory.glob("step_*.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self.directory / f"step_{step}.pt"
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)  # atomic: a reader sees all of a checkpoint or none
        for old in self.steps()[: -self.keep] if self.keep > 0 else []:
            (self.directory / f"step_{old}.pt").unlink(missing_ok=True)

    def restore(self, step: int, state: TrainState, device: torch.device) -> None:
        state.load_state_dict(torch.load(self.directory / f"step_{step}.pt", map_location=device, weights_only=True))


def fit(
    state: TrainState,
    step_fn: Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]],
    data: Any,
    config: TrainerConfig,
    *,
    device: DeviceLike = None,
) -> FitResult:
    """Run ``step_fn`` over the epoch schedule of ``data``.

    :param state: a :class:`TrainState` whose model already lives on
        ``device``.
    :param data: a per-split data list (``[features, targets, ...]``), or any
        nesting of tuples/lists/dicts of arrays with a shared leading sample
        dimension.
    :param device: ``None`` is CUDA (raises without a CUDA device); the CPU
        must be asked for with ``device="cpu"``.
    """
    _refuse_parallel(
        mesh=config.mesh, partition_rules=config.partition_rules, logical_axis_rules=config.logical_axis_rules,
        shard_batch_by_process=config.shard_batch_by_process,
    )
    device = resolve_device(device)
    placed = module_device(state.model)
    if placed is not None and placed != device:
        raise ValueError(f"the model lives on {placed}, not {device}; build it with device={str(device)!r}")

    manager = None
    if config.checkpoint_dir and config.checkpoint_every_steps > 0:
        manager = _Checkpoints(config.checkpoint_dir, config.max_checkpoints_to_keep)
    start_step = 0
    if manager is not None and config.resume:
        latest = manager.latest_step()
        if latest is not None:
            manager.restore(latest, state, device)
            start_step = latest
            logger.info(f"resumed train state from checkpoint step {latest}")

    if config.device_data:
        if not config.drop_remainder:
            logger.info("device_data mode always drops the partial final batch; drop_remainder=False is ignored")
        source = PrefetchIterator(
            data, batch_size=config.batch_size, device=device, drop_remainder=True, shuffle=config.shuffle,
            seed=config.seed, prefetch=0, epochs=config.epochs, skip_batches=start_step,
        )
        host_leaves, structure = flatten(source.host_tree())
        data_dev = [torch.from_numpy(leaf).to(device) for leaf in host_leaves]
        _sync(device)  # keep the copy of the split out of the timed loop
        steps_per_call = max(1, min(config.steps_per_call, source.steps_per_epoch() or 1))

        def payloads() -> Iterator[Tuple[Any, int, int]]:
            current_epoch, epoch_data, group = -1, data_dev, []
            for epoch, lo, _size in source.contiguous_schedule():
                if epoch != current_epoch:
                    if group:
                        yield (epoch_data, group), config.batch_size * len(group), len(group)
                        group = []
                    epoch_data = None  # release the last epoch's permuted copy first: peak 2x the split
                    if config.shuffle:
                        order = torch.from_numpy(source.epoch_order(epoch)).to(device)
                        epoch_data = [leaf.index_select(0, order) for leaf in data_dev]
                    else:
                        epoch_data = data_dev
                    current_epoch = epoch
                group.append(lo)
                if len(group) == steps_per_call:
                    yield (epoch_data, group), config.batch_size * len(group), len(group)
                    group = []
            if group:
                yield (epoch_data, group), config.batch_size * len(group), len(group)

        def run_step(state: TrainState, payload: Any):
            epoch_data, starts = payload
            metrics = {}
            for lo in starts:
                batch = unflatten(structure, [leaf[lo : lo + config.batch_size] for leaf in epoch_data])
                state, metrics = step_fn(state, batch)
            return state, metrics

    else:
        iterator = PrefetchIterator(
            data, batch_size=config.batch_size, device=device, drop_remainder=config.drop_remainder,
            shuffle=config.shuffle, seed=config.seed, prefetch=config.prefetch, epochs=config.epochs,
            skip_batches=start_step,  # resume reproduces the seeded schedule, minus consumed batches
        )

        def payloads() -> Iterator[Tuple[Any, int, int]]:
            for batch in iterator:
                yield batch, int(flatten(batch)[0][0].shape[0]), 1

        run_step = step_fn

    history: List[Dict[str, float]] = []
    step_idx = start_step  # completed optimizer steps
    compile_time = 0.0
    samples_seen = first_batch_samples = 0
    loop_start: Optional[float] = None
    last_metrics: Any = None
    profiler = None

    try:
        with torch.autograd.set_detect_anomaly(config.debug_nans):
            for payload, batch_n, steps_in_payload in payloads():
                # crossing semantics: step_idx may advance by steps_per_call
                if config.profile_dir and profiler is None and step_idx >= config.profile_steps[0]:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                with torch.profiler.record_function("unionml_tpu.train_step"):
                    if loop_start is None:
                        t0 = time.perf_counter()
                        state, last_metrics = run_step(state, payload)
                        _sync(device)
                        compile_time = time.perf_counter() - t0
                        loop_start = time.perf_counter()
                        first_batch_samples = batch_n
                    else:
                        state, last_metrics = run_step(state, payload)
                payload = None
                prev_step = step_idx
                step_idx += steps_in_payload
                samples_seen += batch_n
                if config.log_every_steps and (
                    step_idx // config.log_every_steps > prev_step // config.log_every_steps
                ):
                    host_metrics = {k: float(v) for k, v in last_metrics.items()}
                    history.append({"step": step_idx, **host_metrics})
                    logger.info(f"step {step_idx}: {host_metrics}")
                if manager is not None and (
                    step_idx // config.checkpoint_every_steps > prev_step // config.checkpoint_every_steps
                ):
                    manager.save(step_idx, state)
                if profiler is not None and step_idx > config.profile_steps[1]:
                    profiler = _stop_profiler(profiler, config.profile_dir, step_idx)
    finally:
        if profiler is not None:
            _stop_profiler(profiler, config.profile_dir, step_idx)

    if last_metrics is not None:
        _sync(device)
        host_metrics = {k: float(v) for k, v in last_metrics.items()}
        if not history or history[-1].get("step") != step_idx:
            history.append({"step": step_idx, **host_metrics})
    if manager is not None and manager.latest_step() != step_idx:
        manager.save(step_idx, state)

    post_compile_samples = samples_seen - first_batch_samples
    elapsed = (time.perf_counter() - loop_start) if loop_start is not None else 0.0
    sps = post_compile_samples / elapsed if elapsed > 0 and post_compile_samples > 0 else 0.0
    return FitResult(
        state=state,
        history=history,
        steps=step_idx - start_step,
        samples_per_sec=sps,
        samples_per_sec_per_chip=sps,  # one card
        compile_time_s=compile_time,
        memory_stats=_device_memory_stats(device),
    )


def _stop_profiler(profiler: Any, directory: str, step: int) -> None:
    """Stop the trace and write it as ``train_trace_step<N>.json``."""
    profiler.stop()
    os.makedirs(directory, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(directory, f"train_trace_step{step}.json"))
    return None


def evaluate(
    state: TrainState,
    eval_step: Callable[[TrainState, Any], Dict[str, Any]],
    data: Any,
    *,
    batch_size: int = 128,
    device: DeviceLike = None,
    mesh: Any = None,
    partition_rules: Any = None,
    fsdp_min_weight_size: int = 2**14,
    logical_axis_rules: "Optional[Sequence[Tuple[str, Any]]]" = None,
) -> Dict[str, float]:
    """Run ``eval_step`` (under ``torch.no_grad``) over a split, partial final
    batch included, and average each metric weighted by batch size."""
    del fsdp_min_weight_size  # read only with a mesh
    _refuse_parallel(mesh=mesh, partition_rules=partition_rules, logical_axis_rules=logical_axis_rules)
    totals: Dict[str, float] = {}
    count = 0
    with torch.no_grad():
        for batch in PrefetchIterator(data, batch_size=batch_size, device=device, drop_remainder=False):
            metrics = eval_step(state, batch)
            n = flatten(batch)[0][0].shape[0]
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
            count += n
    return {k: v / max(count, 1) for k, v in totals.items()}
