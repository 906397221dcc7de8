"""tpu-lint, the port's copy: the TPU/concurrency-aware static analyzer of
``unionml_tpu/analysis/``, with the same rules (TPU001-TPU019), messages,
suppression comments, JSON schema and SARIF layout, so the two packages'
reports compare field for field.

Nine rules are per-file AST rules (host syncs under jit, use-after-donate,
unlocked cross-thread mutation, blocking calls in engine loops, bare env-var
numeric parses, wall-clock durations, unlocked ``*_locked`` calls, leaked
engine threads, unbounded per-key registries); three are whole-program rules
over a cross-module project index (lock-order cycles, recompile hazards at
jit static positions, contextvar reads behind executor/thread hops), and a
CFG + dataflow layer adds the exception-path rules (TPU015-TPU019). The
engine walks files, applies per-line ``# tpu-lint: disable=RULE``
suppressions, and renders text, JSON, or SARIF 2.1.0.

Four rules also read the port's idioms, where the JAX hazard has a PyTorch
counterpart: TPU001 (a host sync inside a program captured by
``AOTFunction`` or a ``torch.cuda.graph`` block), TPU011 (a per-call scalar
at a call of an AOT-wrapped program: a capture storm), TPU013
(``torch.distributed`` and the port's collectives under a lock) and TPU014
(``torch`` draws without ``generator=``). TPU002 has no PyTorch reading: the
port donates no buffer, it writes in place. The JAX forms stay recognised.

Standard library only; it imports nothing of what it analyzes. Run it as
``unionml-tpu-torch lint [paths]`` or ``python -m unionml_tpu_torch.analysis``;
the tier-1 gate (tests/test_torch_analysis.py) asserts
``run_lint(["unionml_tpu_torch"])`` stays clean.
"""

from __future__ import annotations

from unionml_tpu_torch.analysis.engine import (
    Finding,
    LintResult,
    Rule,
    all_rules,
    main,
    render_json,
    render_sarif,
    render_text,
    run_lint,
)
from unionml_tpu_torch.analysis.project import ProjectIndex, build_index, clear_index_cache

__all__ = [
    "Finding",
    "LintResult",
    "ProjectIndex",
    "Rule",
    "all_rules",
    "build_index",
    "clear_index_cache",
    "main",
    "render_json",
    "render_sarif",
    "render_text",
    "run_lint",
]
