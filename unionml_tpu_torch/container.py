"""Container images for app deployment, the port's copy of ``unionml_tpu/container.py``.

The reference builds a per-app docker image at deploy time and tags it
``{registry}/{image_name}:{model-name}-{version}`` (unionml/remote.py:60-108);
``patch`` deploys skip image work. The image is built FROM the deployed
source bundle (not the working tree), so its content is exactly what the
store records for the app version. The default Dockerfile starts from a
public PyTorch CUDA *devel* image, because the port builds its kernels with
``nvcc`` at first use, and enters through ``unionml_tpu_torch.job_runner``:
one container a host.

The docker invocation is a plain CLI shell-out with an injectable ``runner``,
the same seam the VM launcher uses for gcloud; tests drive the real code path
through a shim ``docker`` binary on PATH.
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Callable, Optional

from unionml_tpu_torch._logging import logger

__all__ = ["DEFAULT_DOCKERFILE", "build_image", "ensure_dockerfile", "image_fqn", "push_image"]

#: GPU training/serving base image: the app bundle is the build context, so
#: COPY ships exactly the deployed source. The devel tag carries ``nvcc``,
#: which builds the port's kernels at their first launch; the package is
#: installed without its JAX dependencies, which the port never imports.
DEFAULT_DOCKERFILE = """\
FROM pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel

WORKDIR /app
ENV PYTHONPATH=/app
ENV PIP_NO_CACHE_DIR=1

RUN pip install numpy && pip install --no-deps unionml-tpu

# the deployed source bundle is the build context
COPY . /app

# one container per host; the backend supplies the torch.distributed env
# (UNIONML_TPU_COORDINATOR / .._NUM_PROCESSES / .._PROCESS_ID) at run time
ENTRYPOINT ["python", "-m", "unionml_tpu_torch.job_runner"]
"""

Runner = Callable[..., "subprocess.CompletedProcess"]


def image_fqn(
    model_name: str, app_version: str, registry: Optional[str] = None, image_name: Optional[str] = None
) -> str:
    """``{registry}/{image_name}:{model-name}-{version}`` (reference remote.py:60-66)."""
    name = image_name or "unionml-tpu"
    uri = f"{registry}/{name}" if registry else name
    return f"{uri}:{model_name.replace('_', '-')}-{app_version}"


def ensure_dockerfile(bundle_dir: Path, dockerfile: str = "Dockerfile") -> Path:
    """Return the bundle's Dockerfile path, writing :data:`DEFAULT_DOCKERFILE`
    if the app did not ship one (a generated default keeps simple apps
    zero-config)."""
    path = Path(bundle_dir) / dockerfile
    if not path.exists():
        logger.info(f"app has no {dockerfile}; writing the default GPU Dockerfile")
        path.write_text(DEFAULT_DOCKERFILE)
    return path


def build_image(
    bundle_dir: Path, fqn: str, dockerfile: str = "Dockerfile", runner: Optional[Runner] = None
) -> None:
    """``docker build`` the app bundle into ``fqn`` (reference remote.py:91-105)."""
    run = runner or subprocess.run
    dockerfile_path = ensure_dockerfile(Path(bundle_dir), dockerfile)
    command = [
        "docker", "build", str(bundle_dir), "--file", str(dockerfile_path), "--tag", fqn,
    ]
    logger.info(f"building image: {' '.join(command)}")
    proc = run(command)
    if getattr(proc, "returncode", 0) != 0:
        raise RuntimeError(f"docker build of {fqn} failed with rc={proc.returncode}")


def push_image(fqn: str, runner: Optional[Runner] = None) -> None:
    """``docker push`` (reference remote.py:106-108)."""
    run = runner or subprocess.run
    command = ["docker", "push", fqn]
    logger.info(f"pushing image: {' '.join(command)}")
    proc = run(command)
    if getattr(proc, "returncode", 0) != 0:
        raise RuntimeError(f"docker push of {fqn} failed with rc={proc.returncode}")
