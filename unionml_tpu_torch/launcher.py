"""Pluggable slice launchers: how an execution's worker processes come to exist.

The port's counterpart of ``unionml_tpu/launcher.py``. The backend builds one
``job_runner`` command per worker (plus the process-group env) and a launcher
decides where those commands run. The TPU names map onto the card's:

- :class:`LocalProcessLauncher` — ``subprocess.Popen`` per worker on this
  host (the default; also the in-tree multi-host analog, N processes joining
  one ``torch.distributed`` group).
- :class:`ContainerLauncher` — one ``docker run --gpus all`` per worker from
  the app's deployed image (:mod:`unionml_tpu_torch.container`).
- :class:`GPUVMLauncher` — provisions the VMs of a GPU "slice" for the
  manifest's ``accelerator`` (``"h100-16"``: 16 H100s, two
  ``a3-highgpu-8g`` hosts) and runs one worker per VM through a ``gcloud
  compute ssh``-shaped transport. Where one TPU VM holds every worker of a
  slice, a GPU slice is N VMs, one a host. The provisioner, transport and
  deprovisioner are injectable, as in JAX.

Accelerator strings count GPUs: ``parse_accelerator("h100-16") == ("h100",
16)``, and :func:`slice_hosts` divides by the GPUs of one host (8 for an H100
host). Every launcher returns process-like handles (``poll() / returncode /
kill() / wait()``); the watchdog in :meth:`unionml_tpu_torch.remote.Backend.wait`
drives failure detection and resubmission through that contract alone.
"""

from __future__ import annotations

import dataclasses
import shlex
import subprocess
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

from unionml_tpu_torch._logging import logger

__all__ = [
    "ContainerLauncher",
    "GPUVMLauncher",
    "LaunchSpec",
    "Launcher",
    "LocalProcessLauncher",
    "parse_accelerator",
    "slice_hosts",
]

#: the env a worker needs from the submitting process, wherever it runs: the
#: framework's knobs and process-group exports, the bundle-first PYTHONPATH,
#: and the CUDA, NCCL and torch settings (JAX forwards ``JAX_*`` instead)
FORWARDED_ENV = ("UNIONML_TPU_", "PYTHONPATH", "CUDA_", "NCCL_", "TORCH_")


@dataclasses.dataclass
class LaunchSpec:
    """Everything a launcher needs to start one execution's workers.

    ``worker_envs[i]`` already carries the per-worker process-group variables
    (``UNIONML_TPU_COORDINATOR`` / ``.._NUM_PROCESSES`` / ``.._PROCESS_ID``)
    and the bundle-first ``PYTHONPATH``.
    """

    command: List[str]  # the job_runner invocation, identical on every worker
    worker_envs: List[Dict[str, str]]  # one env per worker, index = process id
    log_paths: List[Path]  # one log file per worker
    log_mode: str  # "w" first attempt, "a" on resubmit
    execution_path: str
    accelerator: Optional[str] = None
    #: 0-based relaunch counter (the watchdog's resubmit increments it) — lets
    #: launchers mint per-attempt resource names (container names must be fresh:
    #: a killed attempt's container lingers until the daemon reaps it)
    attempt: int = 0
    #: the app version's container image (deploy manifest's ``image``), when a
    #: registry was configured at deploy — what :class:`ContainerLauncher` runs
    image: Optional[str] = None
    #: the backend store root — container/remote launchers mount or sync it so
    #: the execution directory is visible inside the worker at the same path
    store_root: Optional[str] = None

    @property
    def n_workers(self) -> int:
        return len(self.worker_envs)


def forwarded(env: Dict[str, str]) -> Dict[str, str]:
    """The part of a worker env that crosses to another machine or container."""
    return {key: value for key, value in env.items() if key.startswith(FORWARDED_ENV)}


class Launcher:
    """Interface: turn a :class:`LaunchSpec` into live worker handles."""

    def launch(self, spec: LaunchSpec) -> List[Any]:  # pragma: no cover - interface
        raise NotImplementedError


class LocalProcessLauncher(Launcher):
    """Default launcher: one local subprocess per worker."""

    def launch(self, spec: LaunchSpec) -> List[Any]:
        handles: List[Any] = []
        for env, log_path in zip(spec.worker_envs, spec.log_paths):
            with open(log_path, spec.log_mode) as log_file:
                handles.append(
                    subprocess.Popen(spec.command, env=env, stdout=log_file, stderr=subprocess.STDOUT)
                )
        return handles


class ContainerLauncher(Launcher):
    """Run each worker as a container from the app's deployed image.

    The image built at deploy (:mod:`unionml_tpu_torch.container`, entrypoint
    ``python -m unionml_tpu_torch.job_runner``) is the execution vehicle. Per
    worker::

        docker run --rm --network host --gpus all \\
            -v <store_root>:<store_root> \\
            -e UNIONML_TPU_... -e CUDA_... -e NCCL_... -e TORCH_... -e PYTHONPATH=... \\
            <manifest image> <execution_path>

    ``--gpus all`` is always passed: a port worker with no card refuses to
    run (unless its app asked for the CPU). The store root is bind-mounted at
    the SAME path, so the execution directory (spec/status/outputs) and the
    bundle are visible inside the container where the host-side backend
    expects them; the process group's coordinator rides ``--network host``,
    so multi-worker containers join one group exactly like local processes.
    The handle is the local ``docker run`` process: the backend watchdog sees
    container death as docker exit.

    :param image: override the manifest image (e.g. a locally built tag); by
        default the :class:`LaunchSpec`'s ``image`` — the deploy manifest's —
        is required.
    :param docker_args: extra ``docker run`` arguments (``--shm-size``, ...).
    """

    def __init__(self, *, image: Optional[str] = None, docker_args: Sequence[str] = ()):
        self.image = image
        self.docker_args = list(docker_args)

    def launch(self, spec: LaunchSpec) -> List[Any]:
        image = self.image or spec.image
        if not image:
            raise ValueError(
                "ContainerLauncher needs an image: deploy with a registry configured "
                "(the manifest then records the built image) or pass ContainerLauncher(image=...)"
            )
        exec_name = Path(spec.execution_path).name
        handles: List[Any] = []
        for worker, (env, log_path) in enumerate(zip(spec.worker_envs, spec.log_paths)):
            # per-ATTEMPT name: a watchdog-killed attempt's container lingers
            # until the daemon reaps it, and a name reuse would fail every retry
            # with a daemon name conflict
            name = f"unionml-{exec_name}-a{spec.attempt}-w{worker}"
            command = ["docker", "run", "--rm", "--network", "host", "--gpus", "all", "--name", name]
            if spec.store_root:
                command += ["-v", f"{spec.store_root}:{spec.store_root}"]
            for key, value in forwarded(env).items():
                command += ["-e", f"{key}={value}"]
            command += self.docker_args
            # the image's entrypoint is `python -m unionml_tpu_torch.job_runner`;
            # the execution path is its argument
            command += [image, spec.execution_path]
            with open(log_path, spec.log_mode) as log_file:
                proc = subprocess.Popen(command, env=env, stdout=log_file, stderr=subprocess.STDOUT)
            handles.append(_ContainerHandle(proc, name))
        return handles


class _ContainerHandle:
    """Process-like handle for one containerized worker. ``poll``/``wait``/
    ``returncode`` proxy the local ``docker run`` client (container death IS
    client exit), but ``kill`` must target the CONTAINER — SIGKILL to the
    client is never proxied to the daemon-side process, and a worker that
    survived its own kill would keep mutating the bind-mounted execution dir
    while the resubmitted attempt writes the same files."""

    def __init__(self, proc: "subprocess.Popen", name: str):
        self._proc = proc
        self.container_name = name

    def poll(self):
        return self._proc.poll()

    def wait(self, timeout: Optional[float] = None):
        return self._proc.wait(timeout)

    @property
    def returncode(self):
        return self._proc.returncode

    def kill(self) -> None:
        result = subprocess.run(
            ["docker", "kill", self.container_name],
            check=False, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        if result.returncode != 0:
            # the daemon-side worker may still be running and mutating the
            # mounted execution dir — the one hazard this handle exists to
            # prevent; it must not fail silently
            logger.warning(
                f"docker kill {self.container_name} failed (rc={result.returncode}): "
                f"{result.stderr.decode(errors='replace').strip()}; the container may still be running"
            )
        self._proc.kill()


#: GPUs per host for each GPU generation — the worker count for a slice is
#: ceil(gpus / gpus_per_host). An H100 host is Google Cloud's
#: ``a3-highgpu-8g``: 8 H100 80GB cards joined by NVLink.
_GPUS_PER_HOST = {"h100": 8}

#: the machine type of one host of each generation (the VM launcher's default)
MACHINE_TYPES = {"h100": "a3-highgpu-8g"}


def parse_accelerator(accelerator: str) -> "tuple[str, int]":
    """``"h100-16"`` -> ``("h100", 16)`` (generation, GPU count). The single
    accelerator-string parser — :func:`slice_hosts`, the VM launcher and the
    GKE manifest emitter (:mod:`unionml_tpu_torch.gke`) resolve through it."""
    name, _, count_str = accelerator.rpartition("-")
    name = name.lower()
    try:
        count = int(count_str)
    except ValueError:
        raise ValueError(f"cannot parse accelerator {accelerator!r}; expected e.g. 'h100-8'")
    if name not in _GPUS_PER_HOST:
        raise ValueError(f"unknown GPU generation in accelerator {accelerator!r}; expected one of "
                         f"{sorted(_GPUS_PER_HOST)}")
    return name, max(1, count)


def gpus_per_host(accelerator: str) -> int:
    """GPUs one host of the accelerator's generation carries."""
    return _GPUS_PER_HOST[parse_accelerator(accelerator)[0]]


def slice_hosts(accelerator: str) -> int:
    """Number of hosts (worker processes) in an accelerator slice: ``h100-8``
    -> 1, ``h100-16`` -> 2 (8 H100s a host)."""
    name, gpus = parse_accelerator(accelerator)
    return max(1, -(-gpus // _GPUS_PER_HOST[name]))


class GPUVMLauncher(Launcher):
    """Launch workers onto provisioned GPU VMs, one VM a slice host.

    :param provisioner: ``(accelerator, execution_path) -> node_name``. Called
        at most once per execution — relaunches of the same execution (the
        watchdog's ``resubmit``) reuse the cached node instead of re-creating
        it. A node names the slice's VMs ``<node>-w<i>``. The default creates
        them with ``gcloud compute instances create``. Tests inject a fake.
    :param transport: ``(node_name, worker_index, command, env, log_path,
        log_mode) -> handle``. The default wraps the command in ``gcloud
        compute ssh <node>-w<i> --command``; the returned handle is the local
        ssh process, so the backend watchdog sees worker death as ssh exit.
    :param deprovisioner: ``(node_name) -> None``; the default deletes the
        node's VMs with ``gcloud compute instances delete``. Injected
        provisioners own their nodes' lifecycle, so with one the default is a
        no-op.
    :param image_family, image_project: the VM image. The default names the
        public Deep Learning VM family ``pytorch-latest-gpu`` of the
        ``deeplearning-platform-release`` project (PyTorch and CUDA; the
        GPU's kernel module installed at first boot).

    The default transport assumes the store root and the Python environment
    are visible on the VMs at the same paths as on the submitting machine (an
    NFS- or Filestore-mounted store and a baked image); for any other
    topology inject a transport that ships the bundle first. Node lifecycle
    is not tied to one execution: call :meth:`teardown` when done with it.
    """

    def __init__(
        self,
        *,
        project: Optional[str] = None,
        zone: Optional[str] = None,
        image_family: str = "pytorch-latest-gpu",
        image_project: str = "deeplearning-platform-release",
        provisioner: Optional[Callable[[str, str], str]] = None,
        transport: Optional[Callable[..., Any]] = None,
        deprovisioner: Optional[Callable[[str], None]] = None,
    ):
        self.project = project
        self.zone = zone
        self.image_family = image_family
        self.image_project = image_project
        self._provisioner = provisioner or self._gcloud_provision
        self._transport = transport or self._gcloud_ssh
        # injected provisioners own their nodes' lifecycle; only the default
        # gcloud provisioner pairs with the default gcloud delete
        self._deprovisioner = deprovisioner or (self._gcloud_delete if provisioner is None else (lambda node: None))
        self._nodes: Dict[str, str] = {}  # execution_path -> provisioned node
        self._hosts: Dict[str, int] = {}  # node -> VMs the default provisioner created

    # ---------------------------------------------------------------- defaults

    def _gcloud_args(self) -> List[str]:
        args: List[str] = []
        if self.project:
            args += ["--project", self.project]
        if self.zone:
            args += ["--zone", self.zone]
        return args

    @staticmethod
    def host_name(node: str, worker: int) -> str:
        return f"{node}-w{worker}"

    def _gcloud_provision(self, accelerator: str, execution_path: str) -> str:
        node = f"unionml-{Path(execution_path).name}"
        name, _ = parse_accelerator(accelerator)
        hosts = slice_hosts(accelerator)
        created: List[str] = []
        for worker in range(hosts):
            vm = self.host_name(node, worker)
            command = [
                "gcloud", "compute", "instances", "create", vm,
                f"--machine-type={MACHINE_TYPES[name]}",
                f"--image-family={self.image_family}",
                f"--image-project={self.image_project}",
                "--maintenance-policy=TERMINATE",
                "--metadata=install-nvidia-driver=True",
                *self._gcloud_args(),
            ]
            logger.info(f"provisioning GPU host: {' '.join(command)}")
            created.append(vm)
            try:
                subprocess.run(command, check=True)
            except subprocess.CalledProcessError as exc:
                # a failed create can still leave a half-provisioned (billed!) VM
                # behind, and the earlier hosts surely exist: delete all of them
                # best-effort so a retry's create doesn't hit "already exists",
                # then surface the original failure
                logger.warning(f"GPU host create failed (rc={exc.returncode}); cleaning up {created}")
                try:
                    self._delete_vms(created)
                except Exception as cleanup_exc:
                    logger.warning(f"cleanup of partially created hosts {created} also failed: {cleanup_exc}")
                raise RuntimeError(
                    f"provisioning GPU slice {node} ({accelerator}) failed with rc={exc.returncode}"
                ) from exc
        self._hosts[node] = hosts
        return node

    def _gcloud_ssh(
        self,
        node: str,
        worker: int,
        command: Sequence[str],
        env: Dict[str, str],
        log_path: Path,
        log_mode: str,
    ) -> Any:
        exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in forwarded(env).items())
        remote_cmd = f"{exports} {' '.join(shlex.quote(c) for c in command)}"
        ssh = [
            "gcloud", "compute", "ssh", self.host_name(node, worker),
            *self._gcloud_args(),
            "--command", remote_cmd,
        ]
        log_file = open(log_path, log_mode)
        return subprocess.Popen(ssh, env=env, stdout=log_file, stderr=subprocess.STDOUT)

    # ---------------------------------------------------------------- interface

    def launch(self, spec: LaunchSpec) -> List[Any]:
        if not spec.accelerator:
            raise ValueError("GPUVMLauncher requires an accelerator in the backend config/manifest")
        expected = slice_hosts(spec.accelerator)
        if spec.n_workers != expected:
            logger.warning(
                f"accelerator {spec.accelerator} has {expected} hosts but n_workers="
                f"{spec.n_workers}; launching one worker per configured process"
            )
        # resubmits of the same execution reuse the provisioned hosts — the
        # watchdog's retry path must not try to create already-existing VMs
        node = self._nodes.get(spec.execution_path)
        if node is None:
            node = self._provisioner(spec.accelerator, spec.execution_path)
            self._nodes[spec.execution_path] = node
        return [
            self._transport(node, worker, spec.command, env, log_path, spec.log_mode)
            for worker, (env, log_path) in enumerate(zip(spec.worker_envs, spec.log_paths))
        ]

    def _delete_vms(self, vms: Sequence[str]) -> None:
        command = ["gcloud", "compute", "instances", "delete", *vms, "--quiet", *self._gcloud_args()]
        logger.info(f"tearing down GPU hosts: {' '.join(command)}")
        proc = subprocess.run(command, check=False)
        if proc.returncode != 0:
            # a silently swallowed delete failure leaks billed hosts; raise so
            # teardown's caller knows they still exist
            raise RuntimeError(f"deleting GPU hosts {list(vms)} failed with rc={proc.returncode}")

    def _gcloud_delete(self, node: str) -> None:
        self._delete_vms([self.host_name(node, w) for w in range(self._hosts.get(node, 1))])
        self._hosts.pop(node, None)

    def teardown(self, execution_path: str) -> None:
        """Delete the hosts provisioned for an execution (no-op if none/unknown).

        On deprovision failure the node stays registered under its execution, so
        a later :meth:`teardown` retry targets it again instead of leaking it."""
        node = self._nodes.pop(execution_path, None)
        if node is None:
            return
        try:
            self._deprovisioner(node)
        except Exception:
            self._nodes[execution_path] = node  # keep it addressable for a retry
            raise
