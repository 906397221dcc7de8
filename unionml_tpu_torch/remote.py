"""Remote backend: app versioning, bundle packaging, job submission, model registry.

The port's copy of ``unionml_tpu/remote.py`` (reference unionml/remote.py +
the ``Model.remote_*`` methods): app version = git HEAD sha with a dirty-tree
guard (remote.py:43-57), deploy packages the app and registers its three
workflows (remote.py:111-147), the model registry is "the latest SUCCEEDED
training execution" (remote.py:150-183), and patch/fast registration re-ships
source without rebuilding the image (remote.py:124-138).

Substrate: an app deploy is a **source bundle** in a filesystem/GCS-style
store, and an execution is a **job spec** scheduled onto GPU hosts. The store
layout is the JAX package's, so either package reads the other's::

    <store>/<project>/<domain>/          # BackendConfig.store, default ~/.unionml_tpu or $UNIONML_TPU_STORE
      apps/<model>/<app_version>/bundle/...      # deployed source
      apps/<model>/<app_version>/manifest.json   # workflows, entrypoint, accelerator
      executions/<model>/<exec_id>/spec.json     # job spec (workflow, inputs)
      executions/<model>/<exec_id>/status        # QUEUED|RUNNING|SUCCEEDED|FAILED
      executions/<model>/<exec_id>/outputs/      # model_object / metrics / predictions

Execution: the submitting process launches ``python -m
unionml_tpu_torch.job_runner <exec>`` per host of the requested slice (one
locally for the in-tree executor), with the bundle and the port's package
root first on ``PYTHONPATH``. Each worker re-imports the app module out of
the bundle (:mod:`unionml_tpu_torch.resolver`), joins one
``torch.distributed`` group when ``UNIONML_TPU_COORDINATOR`` is set, and runs
the requested workflow on the card (:mod:`unionml_tpu_torch.job_runner`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.artifact import ModelArtifact
from unionml_tpu_torch.resolver import locate  # noqa: F401  (re-exported as the get_model analog)

get_model = locate


class VersionFetchError(RuntimeError):
    """Raised when the app version cannot be derived (dirty tree, no git repo)."""


@dataclasses.dataclass
class BackendConfig:
    """Deployment configuration (reference Model.remote kwargs, model.py:625-654)."""

    registry: Optional[str] = None
    image_name: Optional[str] = None
    dockerfile: str = "Dockerfile"
    patch_destination_dir: str = "/root"
    config_file: Optional[str] = None
    project: str = "unionml-tpu"
    domain: str = "development"
    store: Optional[str] = None
    accelerator: Optional[str] = None
    #: worker processes per execution. 1 = single-host. >1 = the local analog of a
    #: multi-host slice: N job_runner processes join one torch.distributed group
    #: (UNIONML_TPU_COORDINATOR/.._NUM_PROCESSES/.._PROCESS_ID; NCCL on cards,
    #: gloo on the CPU) and a step trainer trains data-parallel over all of them;
    #: process 0 is the single writer of outputs.
    n_workers: int = 1

    def store_path(self) -> Path:
        root = self.store or os.environ.get("UNIONML_TPU_STORE") or os.path.join(Path.home(), ".unionml_tpu")
        return Path(root) / self.project / self.domain


@dataclasses.dataclass
class Execution:
    """Handle to a submitted job (the FlyteWorkflowExecution analog)."""

    id: str
    workflow: str
    path: str
    #: process handle when launched by this client (local executor only, not serialized)
    proc: Optional[Any] = dataclasses.field(default=None, repr=False, compare=False)
    #: all worker process handles (multi-worker executions; procs[0] is proc)
    procs: List[Any] = dataclasses.field(default_factory=list, repr=False, compare=False)

    @property
    def status(self) -> str:
        status_file = Path(self.path) / "status"
        return status_file.read_text().strip() if status_file.exists() else "UNKNOWN"

    @property
    def is_done(self) -> bool:
        return self.status in ("SUCCEEDED", "FAILED", "LOST")

    @property
    def attempt(self) -> int:
        """0-based launch attempt, incremented by the backend on every (re)submit."""
        attempt_file = Path(self.path) / "attempt"
        try:
            return int(attempt_file.read_text().strip())
        except (OSError, ValueError):
            return 0

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the worker last stamped its heartbeat; None before the first stamp."""
        heartbeat = Path(self.path) / "heartbeat"
        try:
            return max(0.0, time.time() - float(heartbeat.read_text().strip()))
        except (OSError, ValueError):
            return None


def get_app_version(allow_uncommitted: bool = False, cwd: str = ".") -> str:
    """App version = git HEAD sha, guarded against dirty trees (reference remote.py:43-57)."""

    def git(*args: str) -> str:
        return subprocess.run(
            ["git", *args], cwd=cwd, capture_output=True, text=True, check=True
        ).stdout.strip()

    try:
        dirty = bool(git("status", "--porcelain"))
        if dirty and not allow_uncommitted:
            raise VersionFetchError("Version number cannot be determined with uncommitted changes present.")
        if dirty:
            logger.warning("You have uncommitted changes; using the latest commit as the app version.")
        return git("rev-parse", "HEAD")
    except subprocess.CalledProcessError as exc:
        raise VersionFetchError(f"could not derive app version from git: {exc.stderr}") from exc


_BUNDLE_IGNORE = shutil.ignore_patterns(
    ".git", "__pycache__", "*.pyc", ".pytest_cache", "node_modules", ".venv", "*.egg-info"
)


class Backend:
    """Filesystem-store backend with a pluggable worker launcher.

    The launcher seam (:mod:`unionml_tpu_torch.launcher`) is where a cluster control
    plane plugs in: the backend builds per-worker commands + env, the launcher
    decides where they run. Default: local subprocesses (``accelerator`` is then
    recorded in the manifest but does not provision hardware). Pass a
    :class:`~unionml_tpu_torch.launcher.GPUVMLauncher` (or a
    :class:`~unionml_tpu_torch.gke.GKELauncher`) to provision real hosts — with
    a non-local launcher the worker set is sized to the accelerator's host count.
    """

    def __init__(self, config: BackendConfig, launcher: Optional[Any] = None):
        from unionml_tpu_torch.launcher import LocalProcessLauncher

        self.config = config
        self.root = config.store_path()
        self.launcher = launcher if launcher is not None else LocalProcessLauncher()

    # ------------------------------------------------------------------ deploy

    def _app_dir(self, model_name: str, app_version: str) -> Path:
        return self.root / "apps" / model_name / app_version

    def _executions_dir(self, model_name: str) -> Path:
        return self.root / "executions" / model_name

    def deploy(
        self,
        model: Any,
        app_version: Optional[str] = None,
        allow_uncommitted: bool = False,
        patch: bool = False,
        source_dir: str = ".",
    ) -> str:
        """Package the app source into the store and register its workflows.

        ``patch=True`` mirrors the reference's fast-registration (remote.py:124-138):
        re-ship source under a ``-patch<hex>`` suffixed version without any image work.
        """
        explicit = app_version is not None
        app_version = app_version or get_app_version(allow_uncommitted=allow_uncommitted or patch, cwd=source_dir)
        if patch and not explicit:
            app_version = f"{app_version}-patch{uuid.uuid4().hex[:7]}"

        app_dir = self._app_dir(model.name, app_version)
        bundle = app_dir / "bundle"
        if bundle.exists():
            shutil.rmtree(bundle)
        bundle.parent.mkdir(parents=True, exist_ok=True)

        store_root = self.root.resolve()

        def ignore(directory: str, names: List[str]) -> set:
            ignored = set(_BUNDLE_IGNORE(directory, names))
            for name in names:
                # never bundle the backend store itself (it may live inside the app dir)
                if (Path(directory) / name).resolve() == store_root or (
                    Path(directory) / name
                ).resolve() in store_root.parents:
                    ignored.add(name)
            return ignored

        shutil.copytree(source_dir, bundle, ignore=ignore)

        # per-app container image, built FROM the bundle so image content ==
        # deployed source (reference remote.py:91-108; patch deploys skip image
        # work exactly like the reference's fast registration, model.py:700-701)
        image = None
        if self.config.registry and not patch:
            from unionml_tpu_torch.container import build_image, image_fqn, push_image

            image = image_fqn(
                model.name, app_version, registry=self.config.registry, image_name=self.config.image_name
            )
            try:
                build_image(bundle, image, dockerfile=self.config.dockerfile)
                push_image(image)
            except Exception:
                # a manifest-less bundle dir must not linger: latest_app_version
                # could hand it out and every consumer would crash on the
                # missing manifest
                shutil.rmtree(app_dir, ignore_errors=True)
                raise

        app_module = _infer_app_module(model)
        manifest = {
            "model_name": model.name,
            "app_version": app_version,
            "app_module": app_module,
            "workflows": [
                model.train_workflow_name,
                model.predict_workflow_name,
                model.predict_from_features_workflow_name,
            ],
            "accelerator": self.config.accelerator,
            "image": image,
            "deployed_at": time.time(),
        }
        (app_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
        logger.info(f"deployed app version {app_version} -> {app_dir}")
        return app_version

    def latest_app_version(self, model: Any) -> Optional[str]:
        apps = self.root / "apps" / model.name
        if not apps.exists():
            return None
        versions = sorted(
            apps.iterdir(), key=lambda p: (p / "manifest.json").stat().st_mtime if (p / "manifest.json").exists() else 0
        )
        return versions[-1].name if versions else None

    # ------------------------------------------------------------------ submit

    def _new_execution(self, model: Any, workflow: str, spec: Dict[str, Any]) -> Execution:
        exec_id = f"{workflow.split('.')[-1]}-{uuid.uuid4().hex[:12]}"
        exec_dir = self._executions_dir(model.name) / exec_id
        (exec_dir / "outputs").mkdir(parents=True, exist_ok=True)
        with open(exec_dir / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        (exec_dir / "spec.json").write_text(
            json.dumps({k: v for k, v in spec.items() if k != "inputs"}, indent=2, default=str)
        )
        (exec_dir / "status").write_text("QUEUED")
        return Execution(id=exec_id, workflow=workflow, path=str(exec_dir))

    def _launch(self, model_name: str, execution: Execution, app_version: str) -> None:
        """Build the per-worker commands/env for an execution and hand them to the
        configured launcher.

        With ``n_workers > 1`` every worker runs the same ``job_runner`` command
        with ``UNIONML_TPU_COORDINATOR`` / ``UNIONML_TPU_NUM_PROCESSES`` /
        ``UNIONML_TPU_PROCESS_ID`` set and joins one ``torch.distributed``
        group — locally that is the multi-host slice analog; through
        :class:`~unionml_tpu_torch.launcher.GPUVMLauncher` it is the real
        thing, one worker per host.
        """
        from unionml_tpu_torch.launcher import LaunchSpec, slice_hosts

        bundle = self._app_dir(model_name, app_version) / "bundle"
        framework_root = Path(__file__).resolve().parent.parent  # unionml_tpu_torch's parent dir
        base_env = dict(os.environ)
        base_env["PYTHONPATH"] = os.pathsep.join(
            filter(None, [str(bundle), str(framework_root), base_env.get("PYTHONPATH", "")])
        )
        attempt_file = Path(execution.path) / "attempt"
        attempt = int(attempt_file.read_text().strip()) + 1 if attempt_file.exists() else 0
        attempt_file.write_text(str(attempt))

        n_workers = max(1, self.config.n_workers)
        if n_workers == 1 and self.config.accelerator and not _is_local_launcher(self.launcher):
            # a non-local launcher sizes the worker set to the slice topology
            n_workers = slice_hosts(self.config.accelerator)
        if n_workers > 1 and "UNIONML_TPU_COORDINATOR" not in base_env:
            import socket

            with socket.socket() as probe:
                probe.bind(("127.0.0.1", 0))
                port = probe.getsockname()[1]
            base_env["UNIONML_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        if n_workers > 1:
            base_env["UNIONML_TPU_NUM_PROCESSES"] = str(n_workers)

        worker_envs, log_paths = [], []
        for worker in range(n_workers):
            env = dict(base_env)
            if n_workers > 1:
                env["UNIONML_TPU_PROCESS_ID"] = str(worker)
            worker_envs.append(env)
            log_paths.append(Path(execution.path) / ("logs.txt" if worker == 0 else f"logs.{worker}.txt"))

        manifest_path = self._app_dir(model_name, app_version) / "manifest.json"
        image = None
        if manifest_path.exists():
            image = json.loads(manifest_path.read_text()).get("image")
        spec = LaunchSpec(
            command=[sys.executable, "-m", "unionml_tpu_torch.job_runner", execution.path],
            worker_envs=worker_envs,
            log_paths=log_paths,
            log_mode="w" if attempt == 0 else "a",
            execution_path=execution.path,
            accelerator=self.config.accelerator,
            image=image,
            store_root=str(self.root.resolve()),
            attempt=attempt,
        )
        execution.procs = list(self.launcher.launch(spec))
        execution.proc = execution.procs[0]

    def resubmit(self, execution: Execution) -> Execution:
        """Relaunch a failed/lost execution in place (slice-failure recovery).

        The execution directory — spec, attempt counter, outputs — is reused, so a
        trainer with ``checkpoint_dir`` set resumes from its last step
        checkpoint (the port's ``step_<N>.pt``) rather than from scratch.
        """
        spec = json.loads((Path(execution.path) / "spec.json").read_text())
        exec_dir = Path(execution.path)
        for stale in ("heartbeat",):
            try:
                (exec_dir / stale).unlink()
            except OSError:
                pass
        (exec_dir / "status").write_text("QUEUED")
        self._launch(spec["model_name"], execution, spec["app_version"])
        logger.warning(f"resubmitted execution {execution.id} (attempt {execution.attempt})")
        return execution

    def submit_train(
        self,
        model: Any,
        app_version: Optional[str] = None,
        hyperparameters: Optional[Dict[str, Any]] = None,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
        trainer_kwargs: Optional[Dict[str, Any]] = None,
        reader_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Execution:
        app_version = app_version or self.latest_app_version(model)
        if app_version is None:
            raise RuntimeError(f"no deployed app versions for model '{model.name}'; run remote_deploy first")
        manifest = json.loads((self._app_dir(model.name, app_version) / "manifest.json").read_text())
        spec = {
            "workflow": model.train_workflow_name,
            "kind": "train",
            "app_module": manifest["app_module"],
            "app_version": app_version,
            "model_name": model.name,
            "accelerator": manifest.get("accelerator"),
            "inputs": {
                "hyperparameters": hyperparameters,
                "loader_kwargs": loader_kwargs,
                "splitter_kwargs": splitter_kwargs,
                "parser_kwargs": parser_kwargs,
                "trainer_kwargs": trainer_kwargs,
                "reader_kwargs": reader_kwargs or {},
            },
        }
        execution = self._new_execution(model, model.train_workflow_name, spec)
        self._launch(model.name, execution, app_version)
        logger.info(f"executing {model.train_workflow_name}, execution name: {execution.id}")
        return execution

    def submit_predict(
        self,
        model: Any,
        app_version: Optional[str] = None,
        model_version: Optional[str] = None,
        features: Any = None,
        reader_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Execution:
        app_version = app_version or self.latest_app_version(model)
        if app_version is None:
            raise RuntimeError(f"no deployed app versions for model '{model.name}'; run remote_deploy first")
        manifest = json.loads((self._app_dir(model.name, app_version) / "manifest.json").read_text())
        model_exec = self.get_model_execution(model, app_version=None, model_version=model_version or "latest")
        workflow = model.predict_workflow_name if features is None else model.predict_from_features_workflow_name
        spec = {
            "workflow": workflow,
            "kind": "predict",
            "app_module": manifest["app_module"],
            "app_version": app_version,
            "model_name": model.name,
            "model_execution": model_exec.path,
            "accelerator": manifest.get("accelerator"),
            "inputs": {"features": features, "reader_kwargs": reader_kwargs or {}},
        }
        execution = self._new_execution(model, workflow, spec)
        self._launch(model.name, execution, app_version)
        logger.info(f"executing {workflow}, execution name: {execution.id}")
        return execution

    # ------------------------------------------------------------------ wait / fetch

    def wait(
        self,
        execution: Execution,
        timeout: float = 600.0,
        poll_interval: float = 0.25,
        retries: int = 0,
        heartbeat_timeout: Optional[float] = None,
    ) -> Execution:
        """Watchdog wait: poll status, detect dead/lost workers, resubmit up to ``retries``.

        A worker is *dead* when its process exits without a terminal status (e.g. the
        interpreter was killed), and *lost* when the execution is RUNNING but the
        heartbeat is older than ``heartbeat_timeout`` (default: 6x the heartbeat
        interval) — the single-host analog of losing a host of a slice. Both cases
        consume a retry; with ``checkpoint_dir`` configured the retried run resumes
        from the last step checkpoint.
        """
        from unionml_tpu_torch.defaults import env_float

        interval = env_float("UNIONML_TPU_HEARTBEAT_S", 5.0, minimum=0.1)
        if heartbeat_timeout is None:
            heartbeat_timeout = 6 * interval
        # a timeout below the beat interval would kill healthy workers between stamps
        heartbeat_timeout = max(heartbeat_timeout, 2 * interval)
        deadline = time.monotonic() + timeout
        while True:
            while not execution.is_done:
                failure: Optional[str] = None
                procs = execution.procs or ([execution.proc] if execution.proc is not None else [])
                exited = [p for p in procs if p.poll() is not None]
                if procs and not execution.is_done and (
                    any(p.returncode != 0 for p in exited) or len(exited) == len(procs)
                ):
                    # a worker died without a terminal status (interpreter-level
                    # failure / killed host), or every worker exited without one
                    failure = "FAILED"
                elif execution.status == "RUNNING":
                    # stale heartbeat = lost slice; applies to live-proc executions too
                    # (a wedged worker whose beat thread stopped must be killed+retried).
                    # Live processes get 3x the margin: the beat thread can be starved
                    # by one long GIL-holding call in an otherwise-healthy worker.
                    age = execution.heartbeat_age()
                    any_live = any(p.poll() is None for p in procs)
                    threshold = 3 * heartbeat_timeout if any_live else heartbeat_timeout
                    if age is not None and age > threshold:
                        failure = "LOST"
                if failure is not None:
                    self._kill_workers(execution)
                    (Path(execution.path) / "status").write_text(failure)
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"execution {execution.id} did not finish within {timeout}s")
                time.sleep(poll_interval)
            if execution.status in ("FAILED", "LOST"):
                # a worker may have written the terminal status itself while its
                # peers are blocked in a collective — reap them before retry/raise
                self._kill_workers(execution)
            if execution.status in ("FAILED", "LOST") and execution.attempt < retries:
                self.resubmit(execution)
                continue
            break
        if execution.status in ("FAILED", "LOST"):
            tails = []
            for log in sorted(Path(execution.path).glob("logs*.txt")):
                if log.exists():
                    tails.append(f"--- {log.name} ---\n{log.read_text()[-2000:]}")
            tail = "\n".join(tails) or "<no logs>"
            raise RuntimeError(f"execution {execution.id} {execution.status}; log tail:\n{tail}")
        return execution

    @staticmethod
    def _kill_workers(execution: Execution) -> None:
        procs = execution.procs or ([execution.proc] if execution.proc is not None else [])
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def fetch_artifact(self, model: Any, execution: Execution) -> ModelArtifact:
        """Load the ModelArtifact from a SUCCEEDED training execution
        (reference Model.remote_load, model.py:872-894)."""
        outputs = Path(execution.path) / "outputs"
        model_object = model._loader(outputs / "model_object.bin")
        meta = json.loads((outputs / "artifact.json").read_text())
        return ModelArtifact(model_object, meta.get("hyperparameters"), meta.get("metrics"))

    def fetch_predictions(self, execution: Execution) -> Any:
        with open(Path(execution.path) / "outputs" / "predictions.pkl", "rb") as f:
            return pickle.load(f)

    def get_model_execution(
        self, model: Any, app_version: Optional[str] = None, model_version: str = "latest"
    ) -> Execution:
        """The model registry: executions are model versions (reference remote.py:150-183)."""
        exec_root = self._executions_dir(model.name)
        if model_version and model_version != "latest":
            exec_dir = exec_root / model_version
            if not exec_dir.exists():
                raise ValueError(f"model version '{model_version}' not found for model '{model.name}'")
            return Execution(id=model_version, workflow=model.train_workflow_name, path=str(exec_dir))
        candidates = self._successful_train_executions(model)
        if not candidates:
            raise ValueError(f"no SUCCEEDED training executions found for model '{model.name}'")
        return candidates[0]

    def _successful_train_executions(self, model: Any) -> List[Execution]:
        exec_root = self._executions_dir(model.name)
        if not exec_root.exists():
            return []
        out = []
        for exec_dir in sorted(exec_root.iterdir(), key=lambda p: p.stat().st_mtime, reverse=True):
            status = exec_dir / "status"
            spec = exec_dir / "spec.json"
            if not (status.exists() and spec.exists()):
                continue
            meta = json.loads(spec.read_text())
            if meta.get("kind") == "train" and status.read_text().strip() == "SUCCEEDED":
                out.append(Execution(id=exec_dir.name, workflow=meta["workflow"], path=str(exec_dir)))
        return out

    def fetch_latest_artifact(
        self, model: Any, app_version: Optional[str] = None, model_version: str = "latest"
    ) -> ModelArtifact:
        return self.fetch_artifact(model, self.get_model_execution(model, app_version, model_version))

    def list_model_versions(self, model: Any, app_version: Optional[str] = None, limit: int = 10) -> List[str]:
        return [e.id for e in self._successful_train_executions(model)[:limit]]


def _is_local_launcher(launcher: Any) -> bool:
    from unionml_tpu_torch.launcher import LocalProcessLauncher

    return isinstance(launcher, LocalProcessLauncher)


def _infer_app_module(model: Any) -> str:
    """Record where the Model object lives so workers can re-import it
    (the TrackedInstance ``instantiated_in``/``lhs`` analog, reference task_resolver.py:23-31)."""
    import inspect as _inspect

    module = getattr(model, "__app_module__", None)
    if module:
        return module
    frame = _inspect.currentframe()
    while frame is not None:
        mod_name = frame.f_globals.get("__name__", "")
        if not mod_name.startswith("unionml_tpu"):
            for var_name, var in frame.f_globals.items():
                if var is model:
                    return f"{mod_name}:{var_name}"
        frame = frame.f_back
    raise RuntimeError(
        "could not infer the app module for this model; set model.__app_module__ = 'module:variable'"
    )
