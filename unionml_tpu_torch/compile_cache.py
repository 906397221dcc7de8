"""Persistent kernel-build cache, counterpart of ``unionml_tpu/compile_cache.py``.

In the JAX package the compile step is XLA's, and this module points JAX's
persistent compilation cache at a directory. In the port the only compile
step is ``nvcc`` building the hand-written kernels (``csrc/*.cu``) into
shared libraries (:mod:`unionml_tpu_torch._build`); PyTorch runs everything
else eagerly. So the cache here is the kernel build directory itself:
:func:`enable_compile_cache` points it at a directory that outlives the
checkout's ``unionml_tpu_torch/_build/`` (the default, which a process
without the cache keeps using). Each library's file name carries a digest of
its sources, the shared headers and the compiler flags, so an edited source
rebuilds and an unchanged one loads as it is: a second process, a restarted
server or a rebuilt replica finds every kernel built.

Enabled two ways, as in the JAX package:

- ``UNIONML_TPU_COMPILE_CACHE=<dir>`` (or a truthy flag for the default
  location) in the environment, honored at package import (the serve CLI's
  ``--compile-cache`` exports it before the app imports);
- :func:`enable_compile_cache` programmatically.

The AOT program store (:mod:`unionml_tpu_torch.serving.aot`, ``serve
--aot-preload``) sits one layer above: it carries the libraries a program
launched beside its entry and installs them into this directory, so a cold
process that loads its programs from the store runs no ``nvcc`` even with
an empty cache. The two compose.
"""

from __future__ import annotations

import os
from typing import Optional

from unionml_tpu_torch import _build, defaults
from unionml_tpu_torch._logging import logger

__all__ = ["enable_compile_cache"]

_enabled_dir: Optional[str] = None


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Build and load the kernel libraries under ``cache_dir`` and return
    the resolved path.

    ``cache_dir`` defaults to ``$UNIONML_TPU_COMPILE_CACHE`` (a path, or a
    truthy flag for the default location) and then
    ``~/.cache/unionml_tpu/xla``. Libraries this process already loaded stay
    loaded; later builds and loads use the new directory.
    """
    global _enabled_dir
    if cache_dir is not None and str(cache_dir).strip().lower() in defaults._TRUTHY_FLAGS:
        cache_dir = None  # "1" on the command line: the default location
    chosen = cache_dir or defaults.serve_compile_cache() or defaults.COMPILE_CACHE_DEFAULT_DIR
    path = os.path.abspath(os.path.expanduser(chosen))
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
    if _enabled_dir != path:
        logger.info(f"persistent kernel build cache: {path}")
        _enabled_dir = path
    return path


def _maybe_enable_from_env() -> None:
    """Package-import hook: honor ``UNIONML_TPU_COMPILE_CACHE`` unless it is
    unset or an explicit off-flag (``0``/``false``/``no``/``off``), the
    natural opt-out for processes that inherit the variable."""
    if defaults.serve_compile_cache() is None:
        return
    try:
        enable_compile_cache()
    except OSError as exc:  # an unwritable dir must not break import
        logger.warning(f"could not enable the kernel build cache: {exc}")
