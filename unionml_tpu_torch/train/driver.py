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
- Over a mesh (``config.mesh``, a ``MeshSpec`` or a built ``Mesh``; one
  process a rank, every rank calling :func:`fit` alike) there is no
  partitioner to insert the collectives, so the port runs them itself. The
  model is cut to this rank's shards by ``partition_rules`` and the
  inferred FSDP layout (``fsdp_min_weight_size``), its layers run their
  collectives (``models/layers.py``), each rank takes its rows of every
  global batch (``data/pipeline.py``), and the step runs inside
  :func:`~unionml_tpu_torch.parallel.sharding.reduce_scope`: the losses
  give each rank its share of the global mean
  (:func:`~unionml_tpu_torch.parallel.sharding.batch_mean`),
  :func:`reduce_gradients` averages the gradients over the batch axes and
  ``sequence`` before the optimizer steps (in buckets of at most
  :data:`BUCKET_BYTES`), and the metrics of the steps the history keeps
  are averaged alike, so every rank sees the JAX package's global values. Without a
  mesh, a world of more than one process trains data-parallel over all of
  it (``MeshSpec()``), as the JAX driver's default mesh spans every device.
  ``logical_axis_rules`` maps flax metadata that torch modules do not
  carry, so it raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unionml_tpu_torch._device import DeviceLike, module_device, resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.data.pipeline import PrefetchIterator, _processes, flatten, local_rows, splits_rows, unflatten
from unionml_tpu_torch.parallel.sharding import (
    P,
    _leaves,
    batch_sharding,
    combine_fsdp_tp,
    leaf_specs,
    place_module,
    placed_mesh,
    reduce_axes,
    reduce_scope,
    row_scope,
    scope_mesh,
    spec_axes,
)


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


def _refuse_logical_rules(logical_axis_rules: Any) -> None:
    if logical_axis_rules is not None:
        raise ValueError("logical_rules maps flax nn.Partitioned metadata, which torch modules do not carry")


def _resolve_mesh(spec: Any, model: nn.Module, device: DeviceLike) -> Any:
    """The mesh a run goes over: ``spec`` (a ``MeshSpec`` built here, or a
    built ``Mesh``); the mesh ``model`` is already placed on when ``spec``
    is None or asks for that mesh's shape; ``MeshSpec()`` over a world of
    more than one process; else None (one device, no collectives)."""
    import torch.distributed as dist

    from unionml_tpu_torch.parallel.mesh import Mesh, MeshSpec

    placed = placed_mesh(model)
    if spec is None:
        if placed is not None:
            return placed
        if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
            return None
        spec = MeshSpec()
    if isinstance(spec, Mesh):
        return spec
    if not isinstance(spec, MeshSpec):
        raise TypeError(f"TrainerConfig.mesh must be a MeshSpec or a built Mesh, got {type(spec).__name__}")
    if placed is not None and placed.shape == spec.axis_sizes(placed.devices):
        return placed
    return spec.build(device=device)


def _place(model: nn.Module, mesh: Any, rules: Any, min_weight_size: int) -> None:
    """Cut ``model`` to this rank's shards unless it is placed on ``mesh``
    already; a model placed on another mesh is refused (its shards are
    not re-cut)."""
    placed = placed_mesh(model)
    if placed is None:
        place_module(model, combine_fsdp_tp(model, mesh, rules, min_weight_size=min_weight_size))
    elif placed is not mesh:
        raise ValueError(f"the model is placed on {placed!r}, not on {mesh!r}: build it again to train there")


#: the most bytes of gradients one collective of :func:`reduce_gradients`
#: carries (DDP's default ``bucket_cap_mb``): the extra memory a reduction
#: holds, on the card and, through gloo's host route, in page-locked memory
BUCKET_BYTES = 25 * 2**20


def _reduce_in_place(grads: List[torch.Tensor], mesh: Any, over: Tuple[str, ...], n: int) -> None:
    """Each gradient summed over the axes ``over`` and divided by ``n``, in
    place, at most :data:`BUCKET_BYTES` a collective: small gradients share
    a flat buffer, a large one is reduced slice by slice where it lies."""
    from unionml_tpu_torch.parallel.collectives import _all_reduce_

    def reduce(flat: torch.Tensor) -> None:
        for a in over:
            _all_reduce_(flat, mesh.group(a))
        flat.div_(n)

    pending: List[torch.Tensor] = []
    size = 0

    def flush() -> None:
        if pending:
            flat = torch.cat([g.reshape(-1) for g in pending])
            reduce(flat)
            at = 0
            for g in pending:
                g.copy_(flat[at : at + g.numel()].view_as(g))
                at += g.numel()
            pending.clear()

    for g in grads:  # the same order and sizes on every rank of the axes
        nbytes = g.numel() * g.element_size()
        if nbytes >= BUCKET_BYTES:
            whole = g if g.is_contiguous() else g.contiguous()
            for part in whole.view(-1).split(BUCKET_BYTES // g.element_size()):
                reduce(part)
            if whole is not g:
                g.copy_(whole)
            continue
        if size + nbytes > BUCKET_BYTES:
            flush()
            size = 0
        pending.append(g)
        size += nbytes
    flush()


@torch.no_grad()
def reduce_gradients(params: Any, specs: Optional[Dict[str, Any]] = None) -> None:
    """Average the gradients of ``params`` (a module, or a nested mapping of
    tensors with their ``{"a/b": spec}`` in ``specs``) over the active
    :func:`reduce_scope`'s reduce axes, IN PLACE: the step of
    :func:`make_train_step` calls it between the backward and the
    optimizer's step, and a step of one's own does the same.

    Each rank's gradient is its part of the global one: a leaf is summed
    over every reduce axis its spec does not split (an FSDP leaf's sum over
    ``fsdp`` came from its gather's backward) and divided by the number of
    ranks over those axes, the batch's extent. A leaf is never summed over
    ``model``: *f* already made its gradient whole. Outside a scope, or on
    a mesh that splits no reduce axis, nothing changes."""
    mesh = scope_mesh()
    axes = () if mesh is None else reduce_axes(mesh)
    if not axes:
        return
    if isinstance(params, nn.Module):
        named, specs = list(params.named_parameters()), leaf_specs(params)
    else:
        named, specs = list(_leaves(params)), specs or {}
    groups: Dict[Any, List[torch.Tensor]] = {}
    for name, param in named:
        if param.grad is None:
            continue
        split = set(spec_axes(specs.get(name, P())))
        key = (tuple(a for a in axes if a not in split), param.grad.dtype, param.grad.device)
        groups.setdefault(key, []).append(param.grad)
    n = mesh.size(axes)
    for (over, _, _), grads in groups.items():  # insertion order: the same on every rank
        _reduce_in_place(grads, mesh, over, n)


def _average_metrics(metrics: Dict[str, Any], mesh: Any) -> Dict[str, Any]:
    """The metrics averaged over the mesh's reduce axes (each rank's loss is
    its share of the global one, its accuracy its rows')."""
    axes = () if mesh is None else reduce_axes(mesh)
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not axes or not keys:
        return metrics
    with torch.no_grad():
        values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        _reduce_in_place([values], mesh, axes, mesh.size(axes))
    return {**metrics, **dict(zip(keys, values.unbind()))}


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
    means. ``remat`` checkpoints the whole loss computation. Over a mesh
    the gradients are averaged over the reduce axes before the optimizer
    steps (:func:`reduce_gradients`)."""

    def loss_and_aux(model: nn.Module, batch: Any) -> Tuple[torch.Tensor, Dict[str, Any]]:
        out = checkpoint(loss_fn, model, batch, use_reentrant=False) if remat else loss_fn(model, batch)
        return out if has_aux else (out, {})

    def single_step(state: TrainState, batch: Any) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_and_aux(state.model, batch)
        loss.backward()
        reduce_gradients(state.model)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), **_detached(aux)}

    if grad_accum_steps <= 1:
        single_step.grad_accum_steps = 1
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
        reduce_gradients(state.model)
        state.optimizer.step()
        state.step += 1
        aux_mean = {k: sum(a[k] for a in auxes) / grad_accum_steps for k in auxes[0]}
        return state, {"loss": loss_sum / grad_accum_steps, **aux_mean}

    # the driver cuts each rank's rows of a batch microbatch by microbatch
    accum_step.grad_accum_steps = grad_accum_steps
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
    """``step_<N>.pt`` files under ``directory`` (``step_<N>.rank<r>.pt``,
    each rank's shards, over a mesh of several ranks), the newest ``keep``
    kept."""

    def __init__(self, directory: str, keep: int, suffix: str = ""):
        self.directory, self.keep, self.suffix = Path(directory), keep, suffix

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}{self.suffix}.pt"

    def steps(self) -> List[int]:
        if not self.directory.is_dir():
            return []
        pattern = re.compile(rf"step_(\d+){re.escape(self.suffix)}\.pt")
        return sorted(int(m.group(1)) for p in self.directory.iterdir() if (m := pattern.fullmatch(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)  # atomic: a reader sees all of a checkpoint or none
        for old in self.steps()[: -self.keep] if self.keep > 0 else []:
            self._path(old).unlink(missing_ok=True)

    def restore(self, step: int, state: TrainState, device: torch.device) -> None:
        state.load_state_dict(torch.load(self._path(step), map_location=device, weights_only=True))


def _global_sizes(iterator: PrefetchIterator) -> Iterator[int]:
    """The global batch size of each batch ``iterator`` yields."""
    procs = _processes()[0] if iterator.shard_by_process else 1
    return (len(idx) * procs for idx in iterator.index_batches())


def _mesh_rows(config: "TrainerConfig", mesh: Any, microbatches: int) -> Any:
    """The batch sharding of a run over ``mesh`` (None without one), with
    ``shard_batch_by_process``'s checks: each process's slice is its rows,
    so the batch axes must hold every rank in process order."""
    if mesh is None:
        return None
    sharding = batch_sharding(mesh)
    if config.shard_batch_by_process and _processes()[0] > 1:
        axes = sharding.spec[0] if sharding.spec else None
        if axes is None or mesh.size(axes) != mesh.devices or mesh.index(axes) != mesh.rank:
            raise ValueError("shard_batch_by_process gives each process its own rows: the batch axes must span "
                             f"every rank in process order, not {mesh!r}")
        if microbatches > 1:
            raise ValueError("shard_batch_by_process cuts a process's rows of the whole batch, not of each "
                             "microbatch: use grad_accum_steps=1 with it")
    return sharding


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
        ``device`` (over a mesh, the mesh's device: the model is cut to this
        rank's shards here unless it is placed already; build the optimizer
        before, it keeps the same parameters).
    :param data: a per-split data list (``[features, targets, ...]``), or any
        nesting of tuples/lists/dicts of arrays with a shared leading sample
        dimension; over a mesh every rank passes the whole split.
    :param device: ``None`` is CUDA (raises without a CUDA device); the CPU
        must be asked for with ``device="cpu"``.
    """
    _refuse_logical_rules(config.logical_axis_rules)
    mesh = _resolve_mesh(config.mesh, state.model, device)
    device = mesh.device if mesh is not None else resolve_device(device)
    placed = module_device(state.model)
    if placed is not None and placed != device:
        raise ValueError(f"the model lives on {placed}, not {device}; build it with device={str(device)!r}")
    if mesh is not None:
        _place(state.model, mesh, config.partition_rules, config.fsdp_min_weight_size)
    microbatches = getattr(step_fn, "grad_accum_steps", 1)
    sharding = _mesh_rows(config, mesh, microbatches)

    manager = None
    if config.checkpoint_dir and config.checkpoint_every_steps > 0:
        suffix = f".rank{mesh.rank}" if mesh is not None and mesh.devices > 1 else ""
        manager = _Checkpoints(config.checkpoint_dir, config.max_checkpoints_to_keep, suffix)
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
        # over a mesh every rank keeps the whole split and takes its rows of each slice
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

        def take(leaf: torch.Tensor, lo: int) -> torch.Tensor:
            if sharding is None:
                return leaf[lo : lo + config.batch_size]
            rows = local_rows(np.arange(lo, lo + config.batch_size), sharding, microbatches)
            return leaf.index_select(0, torch.from_numpy(rows).to(device))

        def run_step(state: TrainState, payload: Any):
            epoch_data, starts = payload
            metrics = {}
            for lo in starts:
                state, metrics = step_fn(state, unflatten(structure, [take(leaf, lo) for leaf in epoch_data]))
            return state, metrics

    else:
        iterator = PrefetchIterator(
            data, batch_size=config.batch_size, device=device, drop_remainder=config.drop_remainder,
            shuffle=config.shuffle, seed=config.seed, prefetch=config.prefetch, epochs=config.epochs,
            skip_batches=start_step,  # resume reproduces the seeded schedule, minus consumed batches
            sharding=sharding, microbatches=microbatches, shard_by_process=config.shard_batch_by_process,
        )

        def payloads() -> Iterator[Tuple[Any, int, int]]:
            for batch, size in zip(iterator, _global_sizes(iterator)):
                yield batch, size, 1

        run_step = step_fn

    history: List[Dict[str, float]] = []
    step_idx = start_step  # completed optimizer steps
    compile_time = 0.0
    samples_seen = first_batch_samples = 0
    loop_start: Optional[float] = None
    last_metrics: Any = None
    profiler = None

    try:
        with torch.autograd.set_detect_anomaly(config.debug_nans), reduce_scope(mesh):
            for payload, batch_n, steps_in_payload in payloads():
                # crossing semantics: step_idx may advance by steps_per_call
                if config.profile_dir and profiler is None and step_idx >= config.profile_steps[0]:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                # a batch that does not divide stays whole on every rank: its rows are not split
                whole = sharding is not None and not splits_rows(batch_n // steps_in_payload, sharding, microbatches)
                with torch.profiler.record_function("unionml_tpu.train_step"), row_scope(() if whole else None):
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
                    last_metrics = _average_metrics(last_metrics, mesh)  # on the logged steps only
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
        if not history or history[-1].get("step") != step_idx:
            host_metrics = {k: float(v) for k, v in _average_metrics(last_metrics, mesh).items()}
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
        samples_per_sec_per_chip=sps / (mesh.devices if mesh is not None else 1),
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
    batch included, and average each metric weighted by batch size.

    Over a mesh (``mesh``, or the one the model is placed on: the state
    :func:`fit` returns keeps its placement) each rank runs its rows of
    every batch and the metrics are averaged over the reduce axes, as in
    :func:`fit`; every rank returns the same values."""
    _refuse_logical_rules(logical_axis_rules)
    built = _resolve_mesh(mesh, state.model, device)
    if built is not None:
        device = built.device
        _place(state.model, built, partition_rules, fsdp_min_weight_size)
    iterator = PrefetchIterator(data, batch_size=batch_size, device=device, drop_remainder=False,
                                sharding=None if built is None else batch_sharding(built))
    totals: Dict[str, float] = {}
    count = 0
    with torch.no_grad(), reduce_scope(built):
        for batch, n in zip(iterator, _global_sizes(iterator)):
            whole = built is not None and not splits_rows(n, iterator.sharding)
            with row_scope(() if whole else None):
                metrics = _average_metrics(eval_step(state, batch), built)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
            count += n
    return {k: v / max(count, 1) for k, v in totals.items()}
