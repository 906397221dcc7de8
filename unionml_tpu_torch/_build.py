"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/`` at first use
and loaded with :mod:`ctypes`; nothing of PyTorch's headers is compiled, so a
build takes seconds. The library's file name carries a digest of its sources
and flags, so an edited source rebuilds and an unchanged one loads as is.
Nothing here runs at import time: the CPU tests import every module, and this
machine class has no ``nvcc``.

The build directory is ``_build/`` beside this file unless
:func:`~unionml_tpu_torch.compile_cache.enable_compile_cache` points it
elsewhere (:func:`set_build_dir`). The AOT program store
(:mod:`unionml_tpu_torch.serving.aot`) carries the libraries a captured
program launched and installs them here (:func:`install_library`), so a
process that loads its programs from the store runs no ``nvcc``; each
launch a wrapper counts is also offered to the store's recorder
(:func:`recording`), which keeps a graph's launches per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

from unionml_tpu_torch._logging import logger

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
_loaded_paths: Dict[str, Path] = {}
#: the compiler's output (``-Xptxas -v``) of each library built by this process
build_logs: Dict[str, str] = {}
#: ``nvcc`` processes this process started (a store hit starts none)
nvcc_runs = 0
_dir = BUILD_DIR
_local = threading.local()


def build_dir() -> Path:
    """Where libraries are built and looked for."""
    return _dir


def set_build_dir(path: os.PathLike) -> Path:
    """Build and look for libraries under ``path`` from now on (libraries
    this process already loaded stay loaded)."""
    global _dir
    _dir = Path(path)
    return _dir


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


def library_digest(name: str) -> str:
    """The digest of ``csrc/<name>.cu``, the shared headers and the flags:
    the library's identity, in its file name."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_digests() -> Dict[str, str]:
    """:func:`library_digest` of every kernel source the package ships."""
    return {name: library_digest(name) for name in kernel_names()}


def _library_path(name: str) -> Path:
    return _dir / f"lib{name}-{library_digest(name)}.so"


def install_library(name: str, data: bytes) -> Path:
    """Put a library built elsewhere from these very sources (the AOT
    store's copy) where :func:`build_all` looks for it, atomically; a
    library already there is kept."""
    path = _library_path(name)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)
    return path


def build_all(names: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile the named kernels (default: all), one ``nvcc`` per source, all
    started together. Returns each library's path; raises with the compiler's
    output if any build fails."""
    global nvcc_runs
    names = list(names) or kernel_names()
    _dir.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    running = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        logger.info(f"nvcc: building csrc/{name}.cu into {path}")
        running[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
        nvcc_runs += 1
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
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
            _loaded_paths[name] = path
        return lib


def library_bytes(name: str) -> bytes:
    """The bytes of the library this process loaded for ``name`` (else of
    the one in the build directory)."""
    return _loaded_paths.get(name, _library_path(name)).read_bytes()


class Recorder:
    """What a program launched while this thread recorded it
    (:func:`recording`): the libraries, and each count's launches. While
    ``capturing`` (a CUDA graph capture, which runs nothing) the counts go
    only here, not to the wrappers; :func:`add_launches` adds them at each
    replay."""

    def __init__(self, capturing: bool):
        self.capturing = capturing
        self.libraries: Set[str] = set()
        self.launches: Dict[Tuple[Any, str, Optional[str]], int] = {}


@contextlib.contextmanager
def recording(capturing: bool = False) -> Iterator[Recorder]:
    """Record this thread's launches into a :class:`Recorder`."""
    previous, _local.recorder = getattr(_local, "recorder", None), Recorder(capturing)
    try:
        yield _local.recorder
    finally:
        _local.recorder = previous


def count_launch(counter: Any, attr: str = "launches", key: Optional[str] = None, *,
                 library: Optional[str] = None) -> None:
    """Add one to a kernel wrapper's launch count, ``counter.<attr>`` (or its
    entry ``key`` where that is a dict), under one lock: the engines of a
    replica fleet launch from threads of their own, and a bare ``+= 1`` can
    lose counts between them. ``library`` names the kernel's library for
    this thread's :func:`recording`, which, while it captures, takes the
    count in place of the wrapper."""
    recorder = getattr(_local, "recorder", None)
    if recorder is not None:
        if library is not None:
            recorder.libraries.add(library)
        slot = (counter, attr, key)
        recorder.launches[slot] = recorder.launches.get(slot, 0) + 1
        if recorder.capturing:
            return
    add_launches({(counter, attr, key): 1})


def add_launches(launches: Dict[Tuple[Any, str, Optional[str]], int]) -> None:
    """Add recorded launch counts (a graph's, at each replay) to the wrappers."""
    with _count_lock:
        for (counter, attr, key), n in launches.items():
            if key is None:
                setattr(counter, attr, getattr(counter, attr) + n)
            else:
                getattr(counter, attr)[key] += n
