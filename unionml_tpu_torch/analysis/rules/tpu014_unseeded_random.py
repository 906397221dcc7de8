"""TPU014 — unseeded randomness in benchmarks and workloads.

Determinism is the replay contract: the traffic engine's whole premise
(workloads/scenarios.py) is that the same spec + seed produce byte-identical
traces, and every bench lane's keep-best accretion assumes a rerun measures
the SAME workload. A draw from the process-global RNG — ``random.random()``,
``np.random.randint(...)`` — silently breaks both: the global state is shared
across modules and threads, so an unrelated import or an extra warmup call
shifts every subsequent draw, and "same seed" stops meaning "same trace".

The fixed forms in-tree: a local ``random.Random(seed)`` instance, a
``np.random.default_rng(seed)`` Generator, or ``jax.random`` keys — all draws
hang off an object whose state the caller owns.

The rule: inside ``benchmarks/`` and ``workloads/`` (path-scoped
— library code that legitimately wants entropy, like request-id minting, is
out of scope), flag any CALL of a draw function on the ``random`` module
(``random.random``/``randint``/``choice``/``shuffle``/``uniform``/
``expovariate``/...) or on ``np.random``/``numpy.random`` (``rand``/
``randn``/``randint``/``choice``/``permutation``/``normal``/...). NOT
flagged: constructors (``random.Random(seed)``, ``np.random.default_rng``,
``np.random.Generator``, ``random.SystemRandom``), method calls on rng
instances (``rng.integers(...)``), and ``jax.random.*`` (explicitly keyed —
the root name is ``jax``, not ``random``). Conservative posture: aliased
imports (``import random as rnd``) are not chased — the in-tree idiom never
aliases these modules.

The port's reading: ``torch.rand``/``randn``/``randint``/``randperm``/
``normal``/``bernoulli``/``multinomial`` and the ``*_like`` forms
(``rand_like``, ``randn_like``, ``randint_like``) draw from torch's global
generator unless they are given ``generator=``, and then flag the same way;
a call with ``generator=`` draws from a ``torch.Generator`` the caller seeded.
The scope is the same segments, so ``unionml_tpu_torch/workloads/`` is in it.
"""

from __future__ import annotations

import ast
from pathlib import PurePath
from typing import List

from unionml_tpu_torch.analysis.engine import Finding, Rule

#: draw functions on the stdlib ``random`` module's GLOBAL instance
_RANDOM_DRAWS = {
    "random", "randint", "randrange", "getrandbits", "choice", "choices",
    "shuffle", "sample", "uniform", "triangular", "betavariate", "expovariate",
    "gammavariate", "gauss", "lognormvariate", "normalvariate", "vonmisesvariate",
    "paretovariate", "weibullvariate", "randbytes", "binomialvariate", "seed",
}

#: draw functions on numpy's legacy GLOBAL RandomState (np.random.*)
_NP_DRAWS = {
    "rand", "randn", "randint", "random", "random_sample", "ranf", "sample",
    "choice", "permutation", "shuffle", "uniform", "normal", "standard_normal",
    "poisson", "exponential", "beta", "gamma", "binomial", "bytes", "integers",
    "laplace", "lognormal", "multinomial", "geometric", "seed",
}

#: torch's draws from its global generator when no ``generator=`` is given
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial",
    "rand_like", "randn_like", "randint_like",
}

#: the directories the determinism contract governs (path segments)
_SCOPED_SEGMENTS = ("benchmarks", "workloads")


def _in_scope(path: str) -> bool:
    return any(segment in PurePath(path).parts for segment in _SCOPED_SEGMENTS)


class UnseededRandomness(Rule):
    id = "TPU014"
    title = "unseeded global-RNG draw in benchmarks/workloads"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        if not _in_scope(path):
            return []
        findings: "List[Finding]" = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            func = node.func
            target = self._global_draw(func)
            if target is not None:
                findings.append(self.finding(
                    path, node,
                    f"{target} draws from the process-global RNG — determinism is "
                    "the replay/bench contract (same seed, same trace); draw from a "
                    "local random.Random(seed) or np.random.default_rng(seed) instead",
                ))
            elif self._torch_draw(node):
                findings.append(self.finding(
                    path, node,
                    f"torch.{func.attr} without generator= draws from torch's process-global "
                    "generator — determinism is the replay/bench contract (same seed, same "
                    "trace); pass generator=torch.Generator().manual_seed(seed) instead",
                ))
        return findings

    @staticmethod
    def _torch_draw(node: ast.Call) -> bool:
        """``torch.<draw>(...)`` with no ``generator=`` keyword."""
        func = node.func
        return (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "torch"
            and func.attr in _TORCH_DRAWS
            and not any(kw.arg == "generator" for kw in node.keywords)
        )

    @staticmethod
    def _global_draw(func: ast.Attribute) -> "str | None":
        """``random.<draw>`` or ``np.random.<draw>``/``numpy.random.<draw>``
        -> the dotted name; None for anything else (rng instances, jax.random,
        constructors)."""
        # random.<fn>(...): the receiver is the bare name `random`
        if isinstance(func.value, ast.Name) and func.value.id == "random":
            if func.attr in _RANDOM_DRAWS:
                return f"random.{func.attr}"
            return None
        # np.random.<fn>(...) / numpy.random.<fn>(...)
        if (
            isinstance(func.value, ast.Attribute)
            and func.value.attr == "random"
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id in ("np", "numpy")
        ):
            if func.attr in _NP_DRAWS:
                return f"{func.value.value.id}.random.{func.attr}"
        return None
