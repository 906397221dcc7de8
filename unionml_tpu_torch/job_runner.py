"""Worker entrypoint: execute one job spec from the backend store.

The port's copy of ``unionml_tpu/job_runner.py`` (the reference's container
entrypoint + task resolver, unionml/task_resolver.py:16-21): re-import the
deployed app module from the bundle, run the requested workflow, write
outputs. Launched as ``python -m unionml_tpu_torch.job_runner <execution_dir>``
on every host of a slice; when ``UNIONML_TPU_COORDINATOR`` is set the hosts
join one ``torch.distributed`` process group before executing
(:func:`unionml_tpu_torch.distributed.maybe_initialize`: NCCL on cards, gloo
on the CPU), and only process 0 writes outputs and commits ``SUCCEEDED``.

The card: a step-mode app trains and predicts on the card, so a worker that
finds none fails the execution, unless the job asked for the CPU: a train
job's hyperparameters carry ``{"device": "cpu"}`` (the template's knob), or
a predict job's model was trained with them. An eager (host-side, e.g.
scikit-learn) app runs on the host and needs no card. The kernels keep their
strict routes in here: a kernel that fails to build or launch fails the job.

Failure detection: a daemon thread stamps ``<execution_dir>/heartbeat`` every
``UNIONML_TPU_HEARTBEAT_S`` seconds while the job runs. The backend watchdog
(:meth:`unionml_tpu_torch.remote.Backend.wait`) treats a RUNNING execution
with a stale heartbeat as a lost host and resubmits it; a trainer configured
with ``checkpoint_dir`` resumes from its last step checkpoint (the port's
``step_<N>.pt``; orbax checkpoints of the JAX package do not load here).
Fault injection for tests: ``UNIONML_TPU_FAULT_INJECT=N`` hard-kills
attempts ``< N`` mid-run (``UNIONML_TPU_FAULT_INJECT_PROCESS=i`` narrows the
kill to worker ``i`` — the lost-single-host scenario on a multi-worker slice).

Each worker ends its log with one line, ``job_runner: report {...}`` (JSON):
its seconds from start to the job (``startup_s``), in kernel builds and loads
(``kernel_load_s``), in the job itself (``job_s``) and in writing outputs
(``save_s``), its peak card memory (``peak_memory_gib``, null off the card)
and every port kernel's launches (``launches``).
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Dict

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import env_float, env_int


def _process_age() -> float:
    """Seconds since this process started (interpreter start and the package
    import included), from ``/proc``; since this module's import elsewhere."""
    try:
        with open("/proc/self/stat") as stat:
            ticks = int(stat.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as uptime:
            return max(0.0, float(uptime.read().split()[0]) - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def _start_heartbeat(exec_path: Path, my_attempt: int) -> threading.Event:
    """Stamp ``heartbeat`` periodically so the backend can detect a lost worker.

    Fencing: if the attempt counter moves past ``my_attempt`` the backend has
    declared this worker lost and resubmitted — a stalled-but-alive worker waking
    back up must not race the new attempt for the outputs dir, so it kills itself.
    """
    interval = env_float("UNIONML_TPU_HEARTBEAT_S", 5.0, minimum=0.1)
    stop = threading.Event()
    heartbeat = exec_path / "heartbeat"

    def beat() -> None:
        while not stop.is_set():
            if _current_attempt(exec_path) != my_attempt:
                os._exit(43)  # fenced: a newer attempt owns this execution
            try:
                heartbeat.write_text(repr(time.time()))
            except OSError:  # execution dir vanished (cancelled); nothing to report to
                return
            stop.wait(interval)

    threading.Thread(target=beat, daemon=True, name="unionml-tpu-heartbeat").start()
    return stop


def _current_attempt(exec_path: Path) -> int:
    attempt_file = exec_path / "attempt"
    try:
        return int(attempt_file.read_text().strip())
    except (OSError, ValueError):
        return 0


def _process_id() -> int:
    return env_int("UNIONML_TPU_PROCESS_ID", 0)


def _maybe_inject_fault(exec_path: Path) -> None:
    """Simulated host failure: die without writing a terminal status.

    ``UNIONML_TPU_FAULT_INJECT=N`` kills attempts ``< N``. With
    ``UNIONML_TPU_FAULT_INJECT_PROCESS=i`` set, only worker ``i`` dies — the
    lost-single-host scenario on a multi-worker slice (its peers block in the
    first collective until the watchdog reaps them).
    """
    inject_below = env_int("UNIONML_TPU_FAULT_INJECT", 0)
    if _current_attempt(exec_path) >= inject_below:
        return
    target = os.environ.get("UNIONML_TPU_FAULT_INJECT_PROCESS")
    if target is not None and os.environ.get("UNIONML_TPU_PROCESS_ID", "0") != target:
        return
    os._exit(42)


def _maybe_init_distributed() -> None:
    # one bootstrap shared by train and serve (unionml_tpu_torch/distributed.py),
    # which logs the group it joined
    from unionml_tpu_torch.distributed import maybe_initialize

    maybe_initialize()


def _asks_for_cpu(model: Any, spec: Dict[str, Any]) -> bool:
    """Whether this job runs without the card: an eager (host-side) app, or
    a device of ``"cpu"`` in the train job's hyperparameters or in those the
    predict job's model was trained with."""
    if getattr(model, "_trainer_mode", "eager") == "eager":
        return True
    if spec["kind"] == "train":
        hyperparameters = spec["inputs"].get("hyperparameters") or {}
    else:
        meta = Path(spec["model_execution"]) / "outputs" / "artifact.json"
        hyperparameters = (json.loads(meta.read_text()).get("hyperparameters") if meta.exists() else None) or {}
    return isinstance(hyperparameters, dict) and str(hyperparameters.get("device", "")) == "cpu"


def _require_card(model: Any, spec: Dict[str, Any]) -> None:
    import torch

    if not torch.cuda.is_available() and not _asks_for_cpu(model, spec):
        raise RuntimeError(
            f"job_runner: no CUDA device for the {spec['kind']} job of {spec['app_module']}; a step-mode app "
            'runs on the card unless its hyperparameters ask for {"device": "cpu"}'
        )


def _kernel_launches() -> Dict[str, int]:
    """Every port kernel's launch count in this process (the int8-page mode
    of the paged wrapper apart)."""
    from unionml_tpu_torch.ops.flash_attention import (
        flash_backward,
        flash_backward_f32,
        flash_forward,
        flash_forward_f32,
    )
    from unionml_tpu_torch.ops.int8_matmul import int8_matmul
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    counts = {fn.__name__: int(fn.launches) for fn in (
        flash_forward, flash_backward, flash_forward_f32, flash_backward_f32, int8_matmul, paged_decode_attention)}
    counts["paged_decode_attention_int8"] = int(paged_decode_attention.int8_launches)
    return counts


def _report(timings: Dict[str, float]) -> None:
    import torch

    from unionml_tpu_torch import _build

    peak = torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_initialized() else None
    report = {**{k: round(v, 3) for k, v in timings.items()}, "kernel_load_s": round(_build.load_seconds, 3),
              "peak_memory_gib": None if peak is None else round(peak, 3), "launches": _kernel_launches()}
    print(f"job_runner: report {json.dumps(report, sort_keys=True)}", flush=True)


def run_job(execution_dir: str) -> None:
    exec_path = Path(execution_dir)
    status = exec_path / "status"
    outputs = exec_path / "outputs"
    outputs.mkdir(exist_ok=True)
    status.write_text("RUNNING")
    my_attempt = _current_attempt(exec_path)
    stop_heartbeat = _start_heartbeat(exec_path, my_attempt)
    timings: Dict[str, float] = {}
    try:
        with open(exec_path / "spec.pkl", "rb") as f:
            spec = pickle.load(f)

        # the one guaranteed log line per worker: what runs, where, which attempt —
        # launcher log streams (files, `docker logs`, `kubectl logs`) key on it
        logger.info(
            f"job_runner: {spec['kind']} {spec['app_module']} "
            f"(attempt {my_attempt}, process {os.environ.get('UNIONML_TPU_PROCESS_ID', '0')})"
        )

        _maybe_init_distributed()
        _maybe_inject_fault(exec_path)

        from unionml_tpu_torch.resolver import locate

        model = locate(spec["app_module"])
        inputs = spec["inputs"]
        _require_card(model, spec)
        timings["startup_s"] = _process_age()

        t0 = time.perf_counter()
        if spec["kind"] == "train":
            model.train(
                hyperparameters=inputs.get("hyperparameters"),
                loader_kwargs=inputs.get("loader_kwargs"),
                splitter_kwargs=inputs.get("splitter_kwargs"),
                parser_kwargs=inputs.get("parser_kwargs"),
                trainer_kwargs=inputs.get("trainer_kwargs"),
                **(inputs.get("reader_kwargs") or {}),
            )
            timings["job_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            # only process 0 of a slice persists outputs (single writer)
            if _process_id() == 0:
                model.save(outputs / "model_object.bin")
                hp = model.artifact.hyperparameters
                from dataclasses import is_dataclass

                from unionml_tpu_torch.utils import dataclass_to_dict

                meta = {
                    "hyperparameters": dataclass_to_dict(hp) if is_dataclass(hp) else hp,
                    "metrics": model.artifact.metrics,
                }
                (outputs / "artifact.json").write_text(json.dumps(meta, default=str))
        elif spec["kind"] == "predict":
            model_exec_outputs = Path(spec["model_execution"]) / "outputs"
            model.load(model_exec_outputs / "model_object.bin")
            features = inputs.get("features")
            if features is not None:
                predictions = model.predict(features=features)
            else:
                predictions = model.predict(**(inputs.get("reader_kwargs") or {}))
            timings["job_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if _process_id() == 0:
                with open(outputs / "predictions.pkl", "wb") as f:
                    pickle.dump(predictions, f)
        else:
            raise ValueError(f"unknown job kind: {spec['kind']}")
        timings["save_s"] = time.perf_counter() - t0
        _report(timings)

        if _current_attempt(exec_path) != my_attempt:
            os._exit(43)  # fenced just before commit: a newer attempt owns the outputs
        # only process 0 commits SUCCEEDED: a fast non-primary worker must not mark
        # the execution done while the primary is still writing outputs
        if _process_id() == 0:
            status.write_text("SUCCEEDED")
    except Exception:
        traceback.print_exc()
        if _current_attempt(exec_path) != my_attempt:
            os._exit(43)  # fenced: don't clobber the replacement attempt's status
        try:
            committed = status.read_text().strip() == "SUCCEEDED"
        except OSError:
            committed = False
        if not committed:
            # don't clobber a SUCCEEDED the primary already committed (a late
            # non-primary failure after the outputs are complete is not a job failure)
            status.write_text("FAILED")
        sys.exit(1)
    finally:
        stop_heartbeat.set()


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print("usage: python -m unionml_tpu_torch.job_runner <execution_dir>", file=sys.stderr)
        sys.exit(2)
    run_job(sys.argv[1])
