"""Native host runtime: the records parser in C++, with Python fallbacks.

A copy of ``unionml_tpu/native/__init__.py``. ``records.cpp`` (JSON feature
records -> one contiguous float64 matrix, the host side of serving) is
compiled at first use with the system ``g++`` into the package's ignored
``_build/`` directory (beside the CUDA kernels, never under ``~/.cache``) and
bound with ``ctypes``. The contract is the JAX package's: a missing
toolchain, a failed compile or input outside the parser's strict subset all
return ``None``, and the caller keeps the Python path, so the native layer
never changes semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np

from unionml_tpu_torch._logging import logger

_SOURCE = Path(__file__).with_name("records.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Any = None
_lib_failed = False


def library_path() -> Path:
    """Where the shared library lives: its name carries a digest of the
    source and flags, so an edited source rebuilds."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librecords-{digest}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_out = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp_out)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        logger.info(f"native runtime unavailable (g++ launch failed: {exc}); using Python paths")
        return None
    if proc.returncode != 0:
        tmp_out.unlink(missing_ok=True)
        logger.info(f"native runtime compile failed; using Python paths:\n{proc.stderr[-500:]}")
        return None
    os.replace(tmp_out, out)  # atomic: concurrent builders race benignly
    return out


def _load() -> Any:
    """Compile (once) and bind the shared library; None when unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so_path = _build()
        if so_path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so_path))
            lib.urt_version.restype = ctypes.c_int
            if lib.urt_version() != _ABI_VERSION:
                raise OSError(f"ABI mismatch: {lib.urt_version()} != {_ABI_VERSION}")
            lib.urt_parse_records.restype = ctypes.c_int
            lib.urt_parse_records.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_long),
            ]
            lib.urt_free.argtypes = [ctypes.c_void_p]
        except OSError as exc:
            logger.info(f"native runtime load failed ({exc}); using Python paths")
            _lib_failed = True
            return None
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def parse_records(
    payload: bytes, allow_trailing: bool = False
) -> Optional[Tuple[np.ndarray, List[str], int]]:
    """Parse a JSON array of flat numeric records into ``(float64 [n, d], columns,
    bytes_consumed)``. float64 matches json.loads exactly, so values cannot differ
    between native-enabled and fallback deployments.

    With ``allow_trailing=False`` the array must span the whole payload. With
    ``allow_trailing=True`` the array may sit at the head of a larger buffer (the
    serving envelope case) and ``bytes_consumed`` tells the caller where it ended.
    Returns ``None`` when the native library is unavailable or the payload falls
    outside the supported subset (strings, nesting, ragged keys) — callers must
    fall back to the Python path.
    """
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    data = ctypes.POINTER(ctypes.c_double)()
    names = ctypes.c_char_p()
    consumed = ctypes.c_long()
    rc = lib.urt_parse_records(
        payload,
        len(payload),
        ctypes.byref(rows),
        ctypes.byref(cols),
        ctypes.byref(data),
        ctypes.byref(names),
        ctypes.byref(consumed),
    )
    if rc != 0:
        return None
    try:
        if not allow_trailing and consumed.value != len(payload):
            return None
        n, d = rows.value, cols.value
        if n == 0:
            matrix: np.ndarray = np.zeros((0, 0), np.float64)
            columns: List[str] = []
        else:
            matrix = np.ctypeslib.as_array(data, shape=(n, d)).copy()
            # d > 0 here (records were non-empty); split on the count, not on
            # truthiness — a single empty-string column name is legitimate
            columns = names.value.decode().split("\n") if d > 0 else []
    finally:
        if data:
            lib.urt_free(ctypes.cast(data, ctypes.c_void_p))
        if names.value is not None:
            lib.urt_free(ctypes.cast(names, ctypes.c_void_p))
    return matrix, columns, consumed.value
