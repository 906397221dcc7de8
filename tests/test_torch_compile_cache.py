"""The kernel build cache (``unionml_tpu_torch/compile_cache.py``): the cases
of ``tests/unit/test_compile_cache.py`` against the port, where the compile
step is ``nvcc`` and the cache is the kernel build directory. Each resolves
the same path as the JAX package's ``enable_compile_cache`` given the same
argument and environment."""

import os

import jax
import pytest
import torch

from unionml_tpu.compile_cache import enable_compile_cache as jax_enable_compile_cache
from unionml_tpu_torch import _build, enable_compile_cache
from unionml_tpu_torch.compile_cache import _maybe_enable_from_env

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def restore_build_dir():
    """These tests move process-wide state (the port's build directory and
    JAX's cache config): later tests in this process must not inherit a
    directory under a deleted tmpdir."""
    build_dir = _build.build_dir()
    cache_dir = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    _build.set_build_dir(build_dir)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)


def test_enable_sets_build_dir_and_creates_dir(tmp_path):
    target = tmp_path / "kernel-cache"
    resolved = enable_compile_cache(str(target))
    assert resolved == str(target) == jax_enable_compile_cache(str(target))
    assert target.is_dir()
    assert _build.build_dir() == target


def test_env_flag_uses_default_location(tmp_path, monkeypatch):
    # "1" means "on, default location"; HOME under tmp_path keeps the default inside the test's directory
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("UNIONML_TPU_COMPILE_CACHE", "1")
    resolved = enable_compile_cache()
    assert resolved == str(tmp_path / ".cache" / "unionml_tpu" / "xla") == jax_enable_compile_cache()
    assert os.path.isdir(resolved) and _build.build_dir() == tmp_path / ".cache" / "unionml_tpu" / "xla"
    # the serve CLI passes its flag's value through: "1" is the default location there too
    assert enable_compile_cache("1") == resolved


def test_env_path_wins_and_import_hook_applies_it(tmp_path, monkeypatch):
    target = tmp_path / "from-env"
    monkeypatch.setenv("UNIONML_TPU_COMPILE_CACHE", str(target))
    _maybe_enable_from_env()
    assert _build.build_dir() == target
    assert target.is_dir()


def test_import_hook_respects_off_flags(monkeypatch, tmp_path):
    # inherited-env opt-out: =0 is never mistaken for a directory path
    monkeypatch.chdir(tmp_path)
    for off in ("0", "false", "no", "off"):
        monkeypatch.setenv("UNIONML_TPU_COMPILE_CACHE", off)
        before = _build.build_dir()
        _maybe_enable_from_env()
        assert _build.build_dir() == before
        assert not os.path.exists(off)


def test_kernel_library_lands_in_the_cache(tmp_path):
    """Where JAX writes a compiled program into its cache, the port builds
    and looks for each kernel library under the enabled directory, its file
    named by the digest of its sources and flags; a library put there (the
    AOT store's copy) is found without a build."""
    target = tmp_path / "cache-e2e"
    enable_compile_cache(str(target))
    for name in _build.kernel_names():
        path = _build._library_path(name)
        assert path.parent == target
        assert path.name == f"lib{name}-{_build.library_digest(name)}.so"
    installed = _build.install_library("paged_decode_attention", b"\x7fELF stand-in")
    assert installed == _build._library_path("paged_decode_attention") and installed.read_bytes() == b"\x7fELF stand-in"
    runs = _build.nvcc_runs
    assert _build.build_all(["paged_decode_attention"]) == {"paged_decode_attention": installed}
    assert _build.nvcc_runs == runs  # found, not built (this machine has no nvcc)
