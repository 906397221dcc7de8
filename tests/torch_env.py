"""The serve CLI's exports kept out of the port's tests.

A ``Generator`` of either package reads ``UNIONML_TPU_QUANTIZE`` and
``UNIONML_TPU_KV_CACHE_DTYPE`` when it is built, and a test that leaves one
set in a pytest worker changes every later build there that names no
``kv_cache_dtype``: ``tests/unit/test_quantized_serving.py`` once left
``UNIONML_TPU_KV_CACHE_DTYPE=int8`` behind, which turned a JAX oracle into
an int8-cache run. A test module that builds generators imports
:func:`no_serve_exports` (an autouse fixture): every ``UNIONML_TPU_*``
variable is then unset for the module's run, its fixtures and spawned ranks
included, and restored after. Tests that need an export set it themselves
(``monkeypatch.setenv``)."""

import contextlib
import os
from typing import Iterator

import pytest


@contextlib.contextmanager
def without_serve_exports() -> Iterator[None]:
    """Unset every ``UNIONML_TPU_*`` variable inside the block."""
    with pytest.MonkeyPatch.context() as env:
        for name in [k for k in os.environ if k.startswith("UNIONML_TPU_")]:
            env.delenv(name)
        yield


@pytest.fixture(scope="module", autouse=True)
def no_serve_exports() -> Iterator[None]:
    with without_serve_exports():
        yield
