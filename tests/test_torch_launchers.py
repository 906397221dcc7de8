"""The port's launchers, container images and GKE manifests on the CPU.

- The accelerator table: GPU strings count GPUs, an H100 host carries 8.
- ``gke_job_manifest``: the GPU node selector and ``nvidia.com/gpu`` limit,
  no topology selector (``topology=`` raises), and the Indexed-Job,
  coordinator-DNS, completion-index, env-forwarding and volume cases of
  ``tests/unit/test_gke.py`` at GPU accelerator strings.
- ``GPUVMLauncher``'s real ``gcloud`` code path through a shim ``gcloud`` on
  ``PATH`` that logs every call and runs the ``ssh --command`` locally (the
  pattern of ``tests/integration/test_launcher_gcloud.py``): a remote train
  end to end, a create that fails partway deleting every host it made, an
  ssh failure retried on the same hosts, and a teardown failure keeping
  the node registered.
- ``ContainerLauncher`` and the image build through a shim ``docker`` that
  runs the container's ``job_runner`` locally (the pattern of
  ``tests/integration/test_container.py``): the default GPU Dockerfile,
  ``--gpus all`` and the forwarded env, per-attempt names on a retry, and a
  kill that targets the container.
"""

import json
import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tests.unit.test_remote import APP_SOURCE as JAX_APP_SOURCE
from unionml_tpu_torch.gke import gke_accelerator_type, gke_job_manifest
from unionml_tpu_torch.launcher import (
    ContainerLauncher,
    GPUVMLauncher,
    LaunchSpec,
    _ContainerHandle,
    parse_accelerator,
    slice_hosts,
)

APP_SOURCE = JAX_APP_SOURCE.replace("from unionml_tpu import", "from unionml_tpu_torch import")


def test_accelerator_table():
    assert parse_accelerator("h100-16") == ("h100", 16)
    assert parse_accelerator("H100-8") == ("h100", 8)
    assert slice_hosts("h100-1") == 1 and slice_hosts("h100-8") == 1
    assert slice_hosts("h100-16") == 2 and slice_hosts("h100-24") == 3
    with pytest.raises(ValueError, match="unknown GPU generation"):
        slice_hosts("v5e-8")
    with pytest.raises(ValueError, match="cannot parse"):
        slice_hosts("h100")
    assert gke_accelerator_type("h100-8") == "nvidia-h100-80gb"


# ---------------------------------------------------------------------- GKE manifests


def make_spec(n_workers=2, accelerator="h100-16", image="gcr.io/p/app:v1", **overrides):
    envs = []
    for worker in range(n_workers):
        envs.append({
            "PYTHONPATH": "/store/bundle:/repo",
            "UNIONML_TPU_NUM_PROCESSES": str(n_workers),
            "UNIONML_TPU_COORDINATOR": "127.0.0.1:43210",
            "UNIONML_TPU_PROCESS_ID": str(worker),
            "NCCL_DEBUG": "WARN",
            "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
            "CUDA_MODULE_LOADING": "LAZY",
            "JAX_PLATFORMS": "tpu",  # must NOT be forwarded: the port's workers never run JAX
            "HOME": "/root",  # must NOT leak into the pod env
        })
    kwargs = dict(
        command=["python", "-m", "unionml_tpu_torch.job_runner", "/store/executions/m/e1"],
        worker_envs=envs,
        log_paths=[Path(f"/tmp/logs.{i}.txt") for i in range(n_workers)],
        log_mode="w",
        execution_path="/store/executions/m/e1",
        accelerator=accelerator,
        image=image,
        store_root="/store",
    )
    kwargs.update(overrides)
    return LaunchSpec(**kwargs)


def job_of(manifest):
    return next(i for i in manifest["items"] if i["kind"] == "Job")


def pod_of(manifest):
    return job_of(manifest)["spec"]["template"]["spec"]


def env_of(manifest):
    return {e["name"]: e for e in pod_of(manifest)["containers"][0]["env"]}


def test_gpu_node_selector_and_limits_without_topology():
    pod = pod_of(gke_job_manifest(make_spec()))  # h100-16: 2 hosts x 8 GPUs
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert pod["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": 8}
    single = pod_of(gke_job_manifest(make_spec(n_workers=1, accelerator="h100-4")))
    assert single["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": 4}
    override = pod_of(gke_job_manifest(make_spec(), host_gpus=2, node_selector={"cloud.google.com/gke-spot": "true"}))
    assert override["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": 2}
    assert override["nodeSelector"]["cloud.google.com/gke-spot"] == "true"
    with pytest.raises(ValueError, match="no topology selector"):
        gke_job_manifest(make_spec(), topology="2x4")


def test_indexed_job_with_headless_service_and_per_attempt_names():
    manifest = gke_job_manifest(make_spec())
    assert [i["kind"] for i in manifest["items"]] == ["Service", "Job"]
    svc, job = manifest["items"]
    name = job["metadata"]["name"]
    assert svc["spec"] == {"clusterIP": "None", "selector": {"job-name": name}}
    assert job["spec"]["completionMode"] == "Indexed"
    assert job["spec"]["completions"] == job["spec"]["parallelism"] == 2
    assert job["spec"]["backoffLimit"] == 0 and job["spec"]["ttlSecondsAfterFinished"] == 86400
    assert pod_of(manifest)["restartPolicy"] == "Never" and pod_of(manifest)["subdomain"] == name
    retry = job_of(gke_job_manifest(make_spec(attempt=1)))["metadata"]["name"]
    assert name.endswith("-a0") and retry.endswith("-a1")
    container = pod_of(manifest)["containers"][0]
    assert container["image"] == "gcr.io/p/app:v1" and container["args"] == ["/store/executions/m/e1"]


def test_worker_env_coordinator_process_id_and_forwarding():
    manifest = gke_job_manifest(make_spec())
    env, job = env_of(manifest), job_of(manifest)["metadata"]["name"]
    assert env["UNIONML_TPU_COORDINATOR"]["value"] == f"{job}-0.{job}:43210"
    field = env["UNIONML_TPU_PROCESS_ID"]["valueFrom"]["fieldRef"]["fieldPath"]
    assert field == "metadata.annotations['batch.kubernetes.io/job-completion-index']"
    assert env["UNIONML_TPU_NUM_PROCESSES"]["value"] == "2"
    assert env["NCCL_DEBUG"]["value"] == "WARN" and env["CUDA_MODULE_LOADING"]["value"] == "LAZY"
    assert "TORCH_NCCL_ASYNC_ERROR_HANDLING" in env
    assert "HOME" not in env and "JAX_PLATFORMS" not in env
    single = make_spec(n_workers=1, accelerator="h100-8")
    for worker_env in single.worker_envs:
        for key in ("UNIONML_TPU_COORDINATOR", "UNIONML_TPU_PROCESS_ID", "UNIONML_TPU_NUM_PROCESSES"):
            worker_env.pop(key)
    single_manifest = gke_job_manifest(single)
    assert [i["kind"] for i in single_manifest["items"]] == ["Job"]
    assert "UNIONML_TPU_COORDINATOR" not in env_of(single_manifest)
    assert "UNIONML_TPU_PROCESS_ID" not in env_of(single_manifest)


def test_volumes_service_account_and_errors():
    pod = pod_of(gke_job_manifest(make_spec()))
    assert pod["volumes"] == [{"name": "store", "hostPath": {"path": "/store", "type": "DirectoryOrCreate"}}]
    assert pod["containers"][0]["volumeMounts"] == [{"name": "store", "mountPath": "/store"}]
    pod = pod_of(gke_job_manifest(make_spec(), store_claim="unionml-store", service_account="gpu-sa"))
    assert pod["volumes"] == [{"name": "store", "persistentVolumeClaim": {"claimName": "unionml-store"}}]
    assert pod["serviceAccountName"] == "gpu-sa"
    with pytest.raises(ValueError, match="image"):
        gke_job_manifest(make_spec(image=None))
    assert pod_of(gke_job_manifest(make_spec(image=None), image="local/app:dev"))["containers"][0]["image"] == \
        "local/app:dev"
    with pytest.raises(ValueError, match="accelerator"):
        gke_job_manifest(make_spec(accelerator=None))


# ---------------------------------------------------------------------- the app the shims train


@pytest.fixture
def remote_app(tmp_path, monkeypatch):
    app_dir = tmp_path / "appsrc"
    app_dir.mkdir()
    (app_dir / "launcher_app.py").write_text(APP_SOURCE.replace('"remote_app:model"', '"launcher_app:model"'))
    monkeypatch.syspath_prepend(str(app_dir))
    monkeypatch.chdir(app_dir)
    import importlib

    import launcher_app

    return importlib.reload(launcher_app)


def _shim(tmp_path, monkeypatch, name, script, **env):
    bin_dir = tmp_path / "shimbin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / name
    shim.write_text(script)
    shim.chmod(0o755)
    log = tmp_path / f"{name}_calls.log"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("SHIM_LOG", str(log))
    monkeypatch.setenv("SHIM_STATE", str(tmp_path / "shim_state"))
    monkeypatch.setenv("PYTHON_FOR_SHIM", sys.executable)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    return lambda: [line for line in log.read_text().splitlines() if line]


# ---------------------------------------------------------------------- gcloud

_GCLOUD = textwrap.dedent(
    """\
    #!/usr/bin/env bash
    # gcloud shim: logs every call; failures injected through GCLOUD_* env vars
    echo "$*" >> "$SHIM_LOG"
    if [ "$2" = "instances" ] && [ "$3" = "create" ]; then
      if [ -n "$GCLOUD_FAIL_CREATE_HOST" ] && [[ "$4" == *"-w$GCLOUD_FAIL_CREATE_HOST" ]] \\
         && [ ! -f "$SHIM_STATE/create_failed" ]; then
        mkdir -p "$SHIM_STATE"; touch "$SHIM_STATE/create_failed"
        echo "ERROR: quota exceeded" >&2; exit 1
      fi
      exit 0
    fi
    if [ "$2" = "instances" ] && [ "$3" = "delete" ]; then
      if [ -n "$GCLOUD_FAIL_DELETE" ]; then echo "ERROR: delete failed" >&2; exit 1; fi
      exit 0
    fi
    if [ "$2" = "ssh" ]; then
      cmd=""; prev=""
      for a in "$@"; do [ "$prev" = "--command" ] && cmd="$a"; prev="$a"; done
      if [ -n "$GCLOUD_FAIL_SSH_ONCE" ] && [ ! -f "$SHIM_STATE/ssh_failed" ]; then
        mkdir -p "$SHIM_STATE"; touch "$SHIM_STATE/ssh_failed"
        echo "ssh: connection refused ($3)" >&2; exit 255
      fi
      exec bash -c "$cmd"
    fi
    exit 0
    """
)


def _verb(line):
    words = line.split()
    return words[2] if words[1] == "instances" else words[1]


def test_gcloud_path_trains_end_to_end_and_tears_down(tmp_path, monkeypatch, remote_app):
    calls = _shim(tmp_path, monkeypatch, "gcloud", _GCLOUD)
    launcher = GPUVMLauncher(project="proj-1", zone="us-central1-a")
    model = remote_app.model
    model.remote(backend_store=str(tmp_path / "store"), accelerator="h100-8", launcher=launcher)
    model.remote_deploy(app_version="gcloud-v1")
    assert model.remote_train(hyperparameters={"max_iter": 200}, wait=True).metrics["train"] > 0.8
    creates = [c for c in calls() if _verb(c) == "create"]
    sshes = [c for c in calls() if _verb(c) == "ssh"]
    assert len(creates) == 1 and len(sshes) == 1
    node = creates[0].split()[3]
    assert node.endswith("-w0") and f"ssh {node}" in sshes[0]
    for flag in ("--machine-type=a3-highgpu-8g", "--image-family=pytorch-latest-gpu",
                 "--image-project=deeplearning-platform-release", "--maintenance-policy=TERMINATE",
                 "--project proj-1", "--zone us-central1-a"):
        assert flag in creates[0], flag
    assert "PYTHONPATH=" in sshes[0] and "unionml_tpu_torch.job_runner" in sshes[0]
    execution_path = list(launcher._nodes)[0]
    monkeypatch.setenv("GCLOUD_FAIL_DELETE", "1")
    with pytest.raises(RuntimeError, match="deleting GPU hosts"):
        launcher.teardown(execution_path)
    assert list(launcher._nodes) == [execution_path]  # still registered for a retry
    monkeypatch.delenv("GCLOUD_FAIL_DELETE")
    launcher.teardown(execution_path)
    deletes = [c for c in calls() if _verb(c) == "delete"]
    assert len(deletes) == 2 and deletes[-1].split()[3] == node and "--quiet" in deletes[-1]
    assert launcher._nodes == {}


def test_partial_create_deletes_every_host_it_made(tmp_path, monkeypatch, remote_app):
    """h100-16 is two VMs; the second create fails: both are deleted (the
    first exists, the second may be half made), nothing is cached, and the
    next launch provisions from scratch."""
    calls = _shim(tmp_path, monkeypatch, "gcloud", _GCLOUD, GCLOUD_FAIL_CREATE_HOST="1")
    launcher = GPUVMLauncher()
    spec = LaunchSpec(command=["true"], worker_envs=[dict(os.environ), dict(os.environ)],
                      log_paths=[tmp_path / "l0", tmp_path / "l1"], log_mode="w",
                      execution_path=str(tmp_path / "exec-1"), accelerator="h100-16")
    with pytest.raises(RuntimeError, match="provisioning GPU slice"):
        launcher.launch(spec)
    assert launcher._nodes == {}
    creates = [c.split()[3] for c in calls() if _verb(c) == "create"]
    deletes = [c for c in calls() if _verb(c) == "delete"]
    assert [c[-3:] for c in creates] == ["-w0", "-w1"]
    assert len(deletes) == 1 and deletes[0].split()[3:5] == creates
    handles = launcher.launch(spec)  # retry: both hosts made again, one worker each
    assert [h.wait(timeout=30) for h in handles] == [0, 0]
    assert len([c for c in calls() if _verb(c) == "create"]) == 4
    assert sorted(c.split()[2] for c in calls() if _verb(c) == "ssh") == creates  # the workers run concurrently


def test_ssh_failure_consumes_a_retry_on_the_same_hosts(tmp_path, monkeypatch, remote_app):
    calls = _shim(tmp_path, monkeypatch, "gcloud", _GCLOUD, GCLOUD_FAIL_SSH_ONCE="1")
    launcher = GPUVMLauncher()
    model = remote_app.model
    model.remote(backend_store=str(tmp_path / "store"), accelerator="h100-8", launcher=launcher)
    model.remote_deploy(app_version="gcloud-v3")
    assert model.remote_train(hyperparameters={"max_iter": 200}, wait=True, retries=1).metrics["train"] > 0.8
    assert len([c for c in calls() if _verb(c) == "create"]) == 1  # the resubmit reused the host
    assert len([c for c in calls() if _verb(c) == "ssh"]) == 2


# ---------------------------------------------------------------------- docker

_DOCKER = textwrap.dedent(
    """\
    #!/usr/bin/env bash
    echo "$*" >> "$SHIM_LOG"
    verb="$1"
    if [ "$verb" = "build" ] && [ -n "$DOCKER_FAIL_BUILD" ]; then echo "ERROR: build failed" >&2; exit 1; fi
    if [ "$verb" = "kill" ] && [ -n "$DOCKER_FAIL_KILL" ]; then echo "ERROR: no such container" >&2; exit 1; fi
    if [ "$verb" = "run" ]; then
      # run the container locally: its entrypoint is `python -m unionml_tpu_torch.job_runner`,
      # its argument rides the docker argv, and -e vars become the process env
      if [ -n "$DOCKER_FAIL_RUN_ONCE" ] && [ ! -f "$SHIM_STATE/run_failed" ]; then
        mkdir -p "$SHIM_STATE"; touch "$SHIM_STATE/run_failed"
        echo "docker: container exited unexpectedly" >&2; exit 125
      fi
      shift
      envs=(); pos=()
      while [ $# -gt 0 ]; do
        case "$1" in
          -e) envs+=("$2"); shift 2;;
          -v|--name|--network|--gpus) shift 2;;
          --rm) shift;;
          *) pos+=("$1"); shift;;
        esac
      done
      exec env "${envs[@]}" "$PYTHON_FOR_SHIM" -m unionml_tpu_torch.job_runner "${pos[1]}"
    fi
    exit 0
    """
)


def test_registry_deploy_builds_the_gpu_image_from_the_bundle(tmp_path, monkeypatch, remote_app):
    calls = _shim(tmp_path, monkeypatch, "docker", _DOCKER)
    model = remote_app.model
    model.remote(backend_store=str(tmp_path / "store"), registry="gcr.io/proj")
    version = model.remote_deploy(app_version="img-v1")
    builds = [c for c in calls() if c.startswith("build")]
    pushes = [c for c in calls() if c.startswith("push")]
    fqn = "gcr.io/proj/unionml-tpu:remote-model-img-v1"
    assert len(builds) == len(pushes) == 1 and fqn in builds[0] and fqn in pushes[0]
    bundle = tmp_path / "store" / "unionml-tpu" / "development" / "apps" / "remote_model" / version / "bundle"
    assert builds[0].split()[1] == str(bundle)
    dockerfile = (bundle / "Dockerfile").read_text()
    assert dockerfile.startswith("FROM pytorch/pytorch:") and "-devel" in dockerfile.splitlines()[0]
    assert '"-m", "unionml_tpu_torch.job_runner"' in dockerfile and "jax" not in dockerfile
    assert json.loads((bundle.parent / "manifest.json").read_text())["image"] == fqn
    model.remote_deploy(app_version="img-v1b", patch=True)  # a patch deploy does no image work
    assert len([c for c in calls() if c.startswith("build")]) == 1
    monkeypatch.setenv("DOCKER_FAIL_BUILD", "1")
    with pytest.raises(RuntimeError, match="docker build"):
        model.remote_deploy(app_version="img-v2")
    assert not (bundle.parent.parent / "img-v2" / "manifest.json").exists()


def test_container_launcher_trains_with_gpus_and_fresh_names_on_retry(tmp_path, monkeypatch, remote_app):
    calls = _shim(tmp_path, monkeypatch, "docker", _DOCKER, DOCKER_FAIL_RUN_ONCE="1", NCCL_DEBUG="WARN")
    model = remote_app.model
    model.remote(backend_store=str(tmp_path / "store"), registry="gcr.io/proj", launcher=ContainerLauncher())
    model.remote_deploy(app_version="run-v1")
    assert model.remote_train(hyperparameters={"max_iter": 200}, wait=True, retries=1).metrics["train"] > 0.8
    runs = [c for c in calls() if c.startswith("run")]
    assert len(runs) == 2
    for line in runs:
        assert "--gpus all" in line and "--network host" in line and "--rm" in line
        assert f"-v {(tmp_path / 'store').resolve()}" in line
        assert "-e PYTHONPATH=" in line and "-e NCCL_DEBUG=WARN" in line
        assert "gcr.io/proj/unionml-tpu:remote-model-run-v1" in line
    names = [line.split()[line.split().index("--name") + 1] for line in runs]
    assert names[0].endswith("-a0-w0") and names[1].endswith("-a1-w0")
    model.remote(backend_store=str(tmp_path / "store2"), launcher=ContainerLauncher())
    model.remote_deploy(app_version="run-v2")  # no registry: no image to run
    with pytest.raises(ValueError, match="ContainerLauncher needs an image"):
        model.remote_train(hyperparameters={"max_iter": 200}, wait=True)


def test_container_kill_targets_the_container_and_logs_a_failure(tmp_path, monkeypatch):
    calls = _shim(tmp_path, monkeypatch, "docker", _DOCKER)
    from unionml_tpu_torch._logging import logger

    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    procs = [subprocess.Popen(["sleep", "30"]) for _ in range(2)]
    catcher = Catch(level=logging.WARNING)
    logger.addHandler(catcher)
    try:
        _ContainerHandle(procs[0], "unionml-t-a0-w0").kill()
        monkeypatch.setenv("DOCKER_FAIL_KILL", "1")
        _ContainerHandle(procs[1], "unionml-t-a0-w1").kill()
        for proc in procs:
            proc.wait(timeout=10)
    finally:
        logger.removeHandler(catcher)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert [c.split()[1] for c in calls() if c.startswith("kill")] == ["unionml-t-a0-w0", "unionml-t-a0-w1"]
    assert any("docker kill unionml-t-a0-w1 failed" in m for m in records)
