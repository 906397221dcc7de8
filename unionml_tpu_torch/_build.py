"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/`` at first use
and loaded with :mod:`ctypes`; nothing of PyTorch's headers is compiled, so a
build takes seconds. The library's file name carries a digest of its sources
and flags, so an edited source rebuilds and an unchanged one loads as is.
Nothing here runs at import time: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, kept in build_logs
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: the compiler's output (``-Xptxas -v``) of each library built by this process
build_logs: Dict[str, str] = {}


def kernel_names() -> List[str]:
    """Every kernel source the package ships."""
    return sorted(path.stem for path in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile the named kernels (default: all), one ``nvcc`` per source, all
    started together. Returns each library's path; raises with the compiler's
    output if any build fails."""
    names = list(names) or kernel_names()
    BUILD_DIR.mkdir(exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    running = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (tmp, proc) in running.items():
        output, _ = proc.communicate()
        build_logs[name] = output
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu:\n{output}")
            continue
        os.replace(tmp, paths[name])  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built, loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib


def count_launch(counter: Any, attr: str = "launches", key: Optional[str] = None) -> None:
    """Add one to a kernel wrapper's launch count, ``counter.<attr>`` (or its
    entry ``key`` where that is a dict), under one lock: the engines of a
    replica fleet launch from threads of their own, and a bare ``+= 1`` can
    lose counts between them."""
    with _count_lock:
        if key is None:
            setattr(counter, attr, getattr(counter, attr) + 1)
        else:
            getattr(counter, attr)[key] += 1
