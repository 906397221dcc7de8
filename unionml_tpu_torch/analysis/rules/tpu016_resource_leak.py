"""TPU016 — resource leaks when an exception skips its release.

The serving stack is built out of paired acquire/release protocols: paged KV
blocks popped from a free list and extended back, radix prefix blocks pinned
and released, sockets/HTTP connections opened and closed, file handles.  The
happy path releases everything; the bug class that erodes a weeks-long
serving process is the *exception* path — a call that can raise between the
acquire and the release, outside any ``try/finally`` or ``with``, leaks the
resource forever (a leaked KV block shrinks batch capacity; a leaked pin
makes a prefix unevictable; a leaked connection pins a worker socket).

Mechanically: for every function that mentions a protocol acquire, solve the
:class:`~unionml_tpu_torch.analysis.rules._flow.ResourceFlow` dataflow problem over
its CFG (exception edges included) and flag every acquisition fact that
reaches the synthetic RAISE exit — i.e. some path acquires, then propagates
an exception out of the function without releasing.  Ownership transfers
(returning the resource, storing it on an object, passing it to another
callable) kill the fact; ``with`` blocks and ``finally`` release on every
path by construction, so the only way to be flagged is a genuinely unguarded
window.

One-hop acquire wrappers are resolved through the project index: a call to a
function whose body is ``return HTTPConnection(...)`` acquires exactly what
the wrapped call does (``RemoteHost._connect`` is the in-tree case).
"""

from __future__ import annotations

import ast
from typing import List

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import call_target
from unionml_tpu_torch.analysis.rules._flow import (
    PROTOCOLS,
    ResourceFlow,
    derived_acquirers,
    function_hints,
    solve_resources,
)


def _relevant(hints, derived_names) -> bool:
    if hints.protos or hints.has_pin:
        return True
    return any(raw.rsplit(".", 1)[-1] in derived_names for raw in hints.calls)


def _make_resolver(index, summary, facts, derived, derived_names):
    def resolve(call: ast.Call):
        target = call_target(call)
        if target is None or target.rsplit(".", 1)[-1] not in derived_names:
            return None
        callee = index.resolve_call(target, summary, facts)
        if callee is None:
            return None
        return derived.get(callee.fq)

    return resolve


class ResourceLeakOnException(Rule):
    id = "TPU016"
    title = "resource acquired but an exception path skips its release"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        return []  # flow analysis runs in the project pass (CFGs are cached there)

    def check_project(self, index) -> "List[Finding]":
        from unionml_tpu_torch.analysis.project import function_cfg

        derived = derived_acquirers(index)
        derived_names = {fq.rsplit(".", 1)[-1] for fq in derived}
        findings: "List[Finding]" = []
        for summary in sorted(index.modules.values(), key=lambda s: s.path):
            for facts in sorted(
                summary.functions.values(), key=lambda f: (f.line, f.qualname)
            ):
                hints = function_hints(summary, facts)
                if not _relevant(hints, derived_names):
                    continue
                resolve = _make_resolver(index, summary, facts, derived, derived_names)
                cfg = function_cfg(summary, facts)
                sol = solve_resources(cfg, ResourceFlow(resolve))
                for var, proto_name, line in sorted(sol.at_raise):
                    proto = PROTOCOLS[proto_name]
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=facts.path,
                            line=line,
                            col=0,
                            message=(
                                f"'{var}' ({proto.noun}) acquired here can leak: a call "
                                f"between the acquire and its release may raise, and the "
                                f"exception path skips the release — {proto.fix}"
                            ),
                        )
                    )
        return findings
