"""GKE control plane: emit GPU job manifests and launch executions on a cluster.

The port's counterpart of ``unionml_tpu/gke.py``:

- :func:`gke_job_manifest` — a pure emitter:
  :class:`~unionml_tpu_torch.launcher.LaunchSpec` -> one ``kubectl
  apply``-able manifest (an Indexed `batch/v1` Job, one pod per host, plus the
  headless Service that gives the process group's coordinator a stable DNS
  name). No cluster needed; tests golden-check the manifest.
- :class:`GKELauncher` — the :class:`~unionml_tpu_torch.launcher.Launcher`
  implementation that applies the manifest through ``kubectl`` and adapts
  Job/pod status back to the process-handle contract the backend watchdog
  drives (:meth:`unionml_tpu_torch.remote.Backend.wait`).

GKE GPU scheduling contract (cloud.google.com/kubernetes-engine/docs/how-to/gpus):
a node pool of a GPU type is selected with the
``cloud.google.com/gke-accelerator`` node selector (``nvidia-h100-80gb`` for
H100s, the ``a3-highgpu-8g`` machine) and a container asks for its cards with
an ``nvidia.com/gpu`` limit. GPU node pools have no topology selector (the TPU
manifest's ``gke-tpu-topology``), so the manifest carries none and
``topology=`` raises. Multi-host executions use an Indexed Job whose pod
hostnames are ``<job>-<index>`` under a headless Service, the stable-address
shape ``torch.distributed``'s TCP rendezvous needs; the completion index
doubles as the process id. All of that is JAX's.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.launcher import (
    FORWARDED_ENV,
    Launcher,
    LaunchSpec,
    gpus_per_host,
    parse_accelerator,
    slice_hosts,
)

__all__ = [
    "GKELauncher",
    "gke_accelerator_type",
    "gke_job_manifest",
]

#: GPU generation -> GKE ``cloud.google.com/gke-accelerator`` node-selector value.
_GKE_ACCELERATOR = {"h100": "nvidia-h100-80gb"}


def gke_accelerator_type(accelerator: str) -> str:
    """GKE ``cloud.google.com/gke-accelerator`` value for e.g. ``"h100-8"``."""
    name, _ = parse_accelerator(accelerator)
    selector = _GKE_ACCELERATOR.get(name)
    if selector is None:
        raise ValueError(f"GPU generation {name!r} has no GKE node pool support")
    return selector


def _job_name(spec: LaunchSpec) -> str:
    # per-attempt name (ContainerLauncher precedent, launcher.py): a
    # watchdog-killed attempt's Job lingers until the cluster reaps it, and k8s
    # rejects a create under a still-terminating name
    return f"unionml-{Path(spec.execution_path).name}-a{spec.attempt}".lower().replace("_", "-")


def gke_job_manifest(
    spec: LaunchSpec,
    *,
    namespace: str = "default",
    topology: Optional[str] = None,
    store_claim: Optional[str] = None,
    service_account: Optional[str] = None,
    node_selector: Optional[Dict[str, str]] = None,
    host_gpus: Optional[int] = None,
    image: Optional[str] = None,
) -> Dict[str, Any]:
    """Emit the ``kubectl apply``-able manifest (a ``v1 List``) for one execution.

    One Indexed Job pod per host plus a headless Service. The pod spec
    carries the GPU node selector, the ``nvidia.com/gpu`` limit, the store
    volume, and the worker env — with the process group's coordinator
    rewritten to the index-0 pod's stable DNS name and the process id taken
    from the completion index, so the SAME job_runner entrypoint the other
    launchers run (container.py's default Dockerfile) joins the multi-host
    group unchanged.

    :param store_claim: PersistentVolumeClaim holding the backend store (mounted
        at ``spec.store_root``, the path every worker expects). Without it the
        store root is mounted ``hostPath`` — single-node/dev clusters only.
    :param topology: refused: GPU node pools have no topology selector.
    :param host_gpus: ``nvidia.com/gpu`` per pod; default: the slice's GPUs
        spread evenly over its hosts, at most one host's.
    :param node_selector: extra selectors merged in (e.g. spot/reservation).
    :param image: override the deploy manifest's image (the
        :class:`~unionml_tpu_torch.launcher.ContainerLauncher` ``image=`` precedent).
    """
    if topology is not None:
        raise ValueError(
            f"topology={topology!r}: GKE GPU node pools have no topology selector (a TPU slice's "
            "gke-tpu-topology); select the pool with the accelerator and node_selector= instead"
        )
    image = image or spec.image
    if not image:
        raise ValueError(
            "gke_job_manifest needs an image: deploy with a registry configured "
            "(the manifest then records the built image) or pass image="
        )
    if not spec.accelerator:
        raise ValueError("gke_job_manifest requires an accelerator in the backend config/manifest")
    _, gpus = parse_accelerator(spec.accelerator)
    hosts = slice_hosts(spec.accelerator)
    if spec.n_workers != hosts:
        logger.warning(
            f"accelerator {spec.accelerator} has {hosts} hosts but n_workers="
            f"{spec.n_workers}; emitting one pod per configured worker"
        )
    job = _job_name(spec)
    gpus_per_pod = host_gpus if host_gpus is not None else max(
        1, min(gpus_per_host(spec.accelerator), gpus // spec.n_workers))

    selectors = {"cloud.google.com/gke-accelerator": gke_accelerator_type(spec.accelerator)}
    selectors.update(node_selector or {})

    # the worker env, minus the per-worker vars the cluster provides: the
    # coordinator moves to pod-0's headless-service DNS name and the process id
    # comes from the completion index (the loopback values remote.py synthesized
    # are meaningless across pods)
    env: List[Dict[str, Any]] = []
    base_env = spec.worker_envs[0] if spec.worker_envs else {}
    port = (base_env.get("UNIONML_TPU_COORDINATOR", "").rpartition(":")[2]) or "8476"
    for key in sorted(base_env):
        if not key.startswith(FORWARDED_ENV):
            continue
        if key in ("UNIONML_TPU_COORDINATOR", "UNIONML_TPU_PROCESS_ID"):
            continue
        env.append({"name": key, "value": base_env[key]})
    if spec.n_workers > 1:
        env.append({"name": "UNIONML_TPU_COORDINATOR", "value": f"{job}-0.{job}:{port}"})
        env.append(
            {
                "name": "UNIONML_TPU_PROCESS_ID",
                "valueFrom": {
                    "fieldRef": {
                        "fieldPath": "metadata.annotations['batch.kubernetes.io/job-completion-index']"
                    }
                },
            }
        )

    volumes: List[Dict[str, Any]] = []
    mounts: List[Dict[str, Any]] = []
    if spec.store_root:
        source: Dict[str, Any] = (
            {"persistentVolumeClaim": {"claimName": store_claim}}
            if store_claim
            else {"hostPath": {"path": spec.store_root, "type": "DirectoryOrCreate"}}
        )
        volumes.append({"name": "store", **source})
        # mounted at the SAME path as on the submitting machine — the execution
        # dir (spec/status/outputs) and bundle resolve without path translation
        mounts.append({"name": "store", "mountPath": spec.store_root})

    pod_spec: Dict[str, Any] = {
        "subdomain": job,  # + Indexed hostnames <job>-<i> => stable coordinator DNS
        "restartPolicy": "Never",  # the backend watchdog owns retries, not kubelet
        "nodeSelector": selectors,
        "containers": [
            {
                "name": "worker",
                "image": image,
                # the image's entrypoint is `python -m unionml_tpu_torch.job_runner`
                # (container.py); the execution path is its argument
                "args": [spec.execution_path],
                "env": env,
                "resources": {"limits": {"nvidia.com/gpu": gpus_per_pod}},
                "volumeMounts": mounts,
            }
        ],
        "volumes": volumes,
    }
    if service_account:
        pod_spec["serviceAccountName"] = service_account

    items: List[Dict[str, Any]] = []
    if spec.n_workers > 1:
        # the headless Service exists solely to give pod-0 a stable coordinator
        # DNS name; single-host slices don't need one (and don't leak one)
        items.append(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {"name": job, "namespace": namespace},
                "spec": {"clusterIP": "None", "selector": {"job-name": job}},
            }
        )
    items.append(
        {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {
                "name": job,
                "namespace": namespace,
                "labels": {"app.kubernetes.io/managed-by": "unionml-tpu"},
            },
            "spec": {
                "completionMode": "Indexed",
                "completions": spec.n_workers,
                "parallelism": spec.n_workers,
                "backoffLimit": 0,  # ditto restartPolicy: resubmission is the watchdog's
                # terminal jobs are left for inspection (a dead worker needs no
                # kill, so nothing deletes them) — the cluster GCs them after a day
                "ttlSecondsAfterFinished": 86400,
                "template": {"spec": pod_spec},
            },
        }
    )
    return {"apiVersion": "v1", "kind": "List", "items": items}


class GKELauncher(Launcher):
    """Apply the execution's Job manifest to a GKE cluster and watch it.

    The ``kubectl`` binary is the injectable seam (the gcloud/docker shim
    precedent): tests put a recording
    shim on PATH and the REAL apply/get/delete code paths run. Handles adapt
    Job+pod status to the process contract the watchdog polls: ``poll()`` is the
    worker pod's phase (index-matched via the completion-index annotation),
    falling back to the Job's terminal conditions; ``kill()`` deletes the Job
    (foreground pods included). Worker logs stream into the spec's log paths via
    a background ``kubectl logs -f`` per pod once it exists.

    Manifest knobs (namespace, topology, store claim, ...) are
    :func:`gke_job_manifest` kwargs, passed through the constructor.
    """

    def __init__(self, *, kubectl: str = "kubectl", poll_throttle_s: float = 2.0, **manifest_kwargs: Any):
        self.kubectl = kubectl
        self.poll_throttle_s = poll_throttle_s
        self.manifest_kwargs = manifest_kwargs
        self.namespace = manifest_kwargs.get("namespace", "default")
        # job -> (fetched_at, pod items | None): one API-server list per job per
        # throttle window, shared by every worker handle of an N-host slice
        self._pods_cache: Dict[str, "tuple[float, Optional[List[Dict[str, Any]]]]"] = {}

    def launch(self, spec: LaunchSpec) -> List[Any]:
        manifest = gke_job_manifest(spec, **self.manifest_kwargs)
        job = _job_name(spec)
        apply = subprocess.run(
            [self.kubectl, "apply", "-f", "-"],
            input=json.dumps(manifest),
            text=True,
            capture_output=True,
        )
        if apply.returncode != 0:
            raise RuntimeError(
                f"kubectl apply for job {job} failed (rc={apply.returncode}): {apply.stderr.strip()}"
            )
        logger.info(f"applied GKE job {job} ({spec.n_workers} pods) to namespace {self.namespace}")
        return [
            _GKEWorkerHandle(self, job, worker, log_path, spec.log_mode)
            for worker, log_path in enumerate(spec.log_paths)
        ]

    # ------------------------------------------------------------- kubectl I/O

    def _get_json(self, kind: str, *args: str) -> Optional[Dict[str, Any]]:
        proc = subprocess.run(
            [self.kubectl, "get", kind, "-n", self.namespace, *args, "-o", "json"],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            return None
        try:
            return json.loads(proc.stdout)
        except ValueError:
            return None

    def list_pods(self, job: str) -> Optional[List[Dict[str, Any]]]:
        """The job's pods, one API-server list per throttle window (failures are
        cached too, so a flapping API server isn't hammered)."""
        now = time.monotonic()
        hit = self._pods_cache.get(job)
        if hit is not None and now - hit[0] < self.poll_throttle_s:
            return hit[1]
        data = self._get_json("pods", "-l", f"job-name={job}")
        items = None if data is None else data.get("items", [])
        self._pods_cache[job] = (now, items)
        return items

    def delete_job(self, job: str) -> None:
        proc = subprocess.run(
            [self.kubectl, "delete", "job", job, "-n", self.namespace, "--wait=false"],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            # a swallowed delete failure leaks slice pods that keep mutating the
            # store (the ContainerHandle.kill hazard, cluster-sized)
            logger.warning(
                f"kubectl delete job {job} failed (rc={proc.returncode}): {proc.stderr.strip()}; "
                "pods may still be running"
            )
        self.delete_service(job)

    def delete_service(self, job: str) -> None:
        """Reap the job's headless Service (nothing TTLs Services; without this
        every multi-host attempt would leak one). Safe on single-host jobs —
        there is no Service and ``--ignore-not-found`` makes that a no-op."""
        subprocess.run(
            [
                self.kubectl, "delete", "service", job,
                "-n", self.namespace, "--ignore-not-found", "--wait=false",
            ],
            capture_output=True,
            text=True,
        )


class _GKEWorkerHandle:
    """Process-like handle for one indexed worker pod of a GKE Job.

    ``poll()`` maps pod phase -> returncode (Succeeded -> 0, Failed -> 1, else
    still-running) and is throttled: the backend watchdog polls every 250 ms
    (remote.py), which would be 4 kubectl execs/s/worker against the API server —
    results are cached for ``poll_throttle_s`` and terminal states forever.
    """

    def __init__(self, launcher: GKELauncher, job: str, worker: int, log_path: Path, log_mode: str):
        self._launcher = launcher
        self.job = job
        self.worker = worker
        self._log_path = log_path
        self._log_mode = log_mode
        self._returncode: Optional[int] = None
        self._last_poll = 0.0
        self._log_proc: Optional[subprocess.Popen] = None
        self._pod: Optional[str] = None

    # ---------------------------------------------------------------- contract

    def poll(self) -> Optional[int]:
        if self._returncode is not None:
            return self._returncode
        now = time.monotonic()
        if now - self._last_poll < self._launcher.poll_throttle_s:
            return None
        self._last_poll = now
        phase = self._pod_phase()
        if phase == "Succeeded":
            self._returncode = 0
        elif phase == "Failed":
            self._returncode = 1
        elif phase is None:
            # no pod visible (pending schedule, or reaped) — fall back to the
            # Job's terminal conditions so a finished/failed job still resolves
            self._returncode = self._job_returncode()
        if self._returncode is not None:
            self._finalize_logs()
            if self.worker == 0:
                # the coordinator Service outlived its purpose the moment the
                # job went terminal; worker 0's resolving poll reaps it
                self._launcher.delete_service(self.job)
        return self._returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"gke job {self.job} worker {self.worker}", timeout)
            time.sleep(min(self._launcher.poll_throttle_s, 1.0))

    @property
    def returncode(self) -> Optional[int]:
        return self._returncode

    def kill(self) -> None:
        # snapshot BEFORE the delete: the failure tail is read right after a
        # watchdog kill, and the pod's logs vanish with the job
        self._finalize_logs()
        self._launcher.delete_job(self.job)
        if self._returncode is None:
            self._returncode = -9

    # ---------------------------------------------------------------- internal

    def _pod_phase(self) -> Optional[str]:
        pods = self._launcher.list_pods(self.job)
        if not pods:
            return None
        for item in pods:
            index = item.get("metadata", {}).get("annotations", {}).get(
                "batch.kubernetes.io/job-completion-index"
            )
            if index is not None and int(index) != self.worker:
                continue
            self._ensure_logs(item.get("metadata", {}).get("name"))
            return item.get("status", {}).get("phase")
        return None

    def _job_returncode(self) -> Optional[int]:
        info = self._launcher._get_json("job", self.job)
        if info is None:
            return None
        for cond in info.get("status", {}).get("conditions", []) or []:
            if cond.get("status") != "True":
                continue
            if cond.get("type") == "Complete":
                return 0
            if cond.get("type") in ("Failed", "FailureTarget"):
                return 1
        return None

    def _ensure_logs(self, pod: Optional[str]) -> None:
        """Stream the worker pod's logs into the spec's log path (the watchdog
        and `unionml logs` read these files; other launchers get them for free
        from Popen redirection). A dead streamer is restarted — ``logs -f``
        exits immediately while the container is still creating, and without a
        restart the run would never stream. Restarts reopen with the same mode;
        ``-f`` replays from the pod start, so a "w" reopen rewrites exactly and
        an "a" (resubmit) reopen may duplicate already-streamed lines, which
        beats losing the tail."""
        if pod is None or (self._log_proc is not None and self._log_proc.poll() is None):
            return
        self._pod = pod
        log_file = open(self._log_path, self._log_mode)
        self._log_proc = subprocess.Popen(
            [self._launcher.kubectl, "logs", "-f", pod, "-n", self._launcher.namespace],
            stdout=log_file,
            stderr=subprocess.STDOUT,
        )

    def _finalize_logs(self) -> None:
        """Replace the streamed logs with a terminal snapshot (``kubectl logs``
        on a terminated pod returns its full output). The ``-f`` streamer races
        termination — a pod that completes within one poll interval would leave
        an empty file right when the failure tail needs it. First attempts
        (mode "w") are rewritten exactly; resubmit attempts append, accepting a
        possible overlap with already-streamed lines over losing the tail."""
        if self._log_proc is not None:
            self._log_proc.terminate()
            self._log_proc = None
        if self._pod is None:
            return
        proc = subprocess.run(
            [self._launcher.kubectl, "logs", self._pod, "-n", self._launcher.namespace],
            capture_output=True,
            text=True,
        )
        if proc.returncode == 0 and proc.stdout:
            with open(self._log_path, self._log_mode) as fh:
                fh.write(proc.stdout)
