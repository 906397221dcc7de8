"""TPU012 — executor/thread target reads a ContextVar without a ctx.run wrap.

The serving stack carries per-request identity in ``contextvars``: the
request id and trace (observability/trace.py), the tenant and priority tier
(serving/tenancy.py), the request deadline (serving/overload.py), the query
params (serving/http.py). ``loop.run_in_executor`` and ``threading.Thread``
do NOT propagate the submitting context — the target runs in the worker's
empty context, every ``.get()`` silently returns its default, and the symptom
is subtle: a stream billed to no tenant, a trace that loses its request id
the moment work hops threads. PR 5 fixed several of these holes by hand with
the canonical wrap::

    ctx = contextvars.copy_context()
    await loop.run_in_executor(None, ctx.run, next, iterator, sentinel)

but nothing kept new call sites honest — the read is usually two or three
helper calls below the submitted target, in another module, invisible to any
per-file rule. This rule closes the class: for every
``run_in_executor``/``submit``/``Thread(target=...)`` submission in the
index, it resolves the target through the cross-module call graph and flags
it when anything reachable reads a ContextVar, unless the submission is
already wrapped (``ctx.run`` as the submitted callable, or
``partial(ctx.run, fn)``). Targets the index cannot resolve (stored
callables, dynamic dispatch) are never guessed at; lambdas are followed into
their call targets.
"""

from __future__ import annotations

import ast
from typing import List

from unionml_tpu_torch.analysis.engine import Finding, Rule


class ContextvarExecutorHole(Rule):
    id = "TPU012"
    title = "executor/thread target reads a ContextVar without ctx.run"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        return []  # the read is typically modules away from the submission; index-only

    def check_project(self, index) -> "List[Finding]":
        findings: "List[Finding]" = []
        for facts in sorted(index.iter_functions(), key=lambda f: (f.path, f.line, f.qualname)):
            summary = index.modules.get(facts.module)
            if summary is None:
                continue
            for sub in facts.executor_calls:
                if sub.wrapped:
                    continue
                targets = []
                if sub.target_raw is not None:
                    targets.append(sub.target_raw)
                targets.extend(sub.lambda_calls)
                hit = None
                for raw in targets:
                    callee = index.resolve_call(raw, summary, facts)
                    if callee is None:
                        continue
                    reads = index.transitive_contextvar_reads(callee)
                    if reads:
                        var = sorted(reads)[0]
                        chain, line = reads[var]
                        hit = (raw, var, chain, line)
                        break
                if hit is None:
                    continue
                raw, var, chain, line = hit
                via = " -> ".join(chain)
                kind = "Thread target" if sub.kind == "thread" else "executor target"
                findings.append(
                    Finding(
                        rule=self.id,
                        path=facts.path,
                        line=sub.line,
                        col=0,
                        message=(
                            f"{kind} '{raw}' reads ContextVar '{var}' (via {via}, line {line}) "
                            "but executors/threads do not inherit the submitting context — the "
                            "read silently returns the default; wrap the callable: "
                            "ctx = contextvars.copy_context(); submit ctx.run(...) instead"
                        ),
                    )
                )
        return findings
