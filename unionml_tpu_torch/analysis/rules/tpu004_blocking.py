"""TPU004 — blocking call inside a serving handler or engine-loop method.

The serving stack's latency budget lives in two kinds of code: ``async def``
request handlers (one blocked coroutine stalls the whole event loop — every
concurrent request, not just the offender) and engine-loop methods (the
``*_loop`` threads that own device dispatch — a sleep or sync there stalls
every resident stream's time-to-next-token). A ``time.sleep``, sync
subprocess/HTTP call, or ``block_until_ready`` in either is a whole-service
stall, not a per-request cost.

Scope: functions defined with ``async def`` (anywhere), plus sync methods
whose names mark them as serving loops (``*_loop``) or handlers
(``handle*``/``on_*``). A deliberate throttle in a watcher loop belongs in a
plain helper thread — or carries a justified suppression.
"""

from __future__ import annotations

import ast
from typing import List

from unionml_tpu_torch.analysis.engine import Finding, Rule
from unionml_tpu_torch.analysis.rules._common import call_target, iter_scope

#: dotted call names that block the calling thread
_BLOCKING_CALLS = {
    "time.sleep": "time.sleep() blocks the thread (asyncio.sleep / Condition.wait with timeout)",
    "urllib.request.urlopen": "sync HTTP inside a serving path blocks the loop",
    "socket.create_connection": "sync socket connect inside a serving path blocks the loop",
}

_BLOCKING_PREFIXES = {
    "subprocess.": "sync subprocess call inside a serving path blocks the loop",
    "requests.": "sync HTTP (requests) inside a serving path blocks the loop",
}


def _is_serving_scope(func) -> bool:
    if isinstance(func, ast.AsyncFunctionDef):
        return True
    name = func.name
    return name.endswith("_loop") or name.startswith("handle") or name.startswith("on_")


class BlockingCallInServingLoop(Rule):
    id = "TPU004"
    title = "blocking call inside a serving handler / engine loop"

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        findings: "List[Finding]" = []
        for func in ast.walk(tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_serving_scope(func):
                continue
            where = "async handler" if isinstance(func, ast.AsyncFunctionDef) else "engine-loop method"
            for node in iter_scope(func):
                if not isinstance(node, ast.Call):
                    continue
                target = call_target(node)
                if target in _BLOCKING_CALLS:
                    findings.append(
                        self.finding(path, node, f"{_BLOCKING_CALLS[target]} — in {where} '{func.name}'")
                    )
                    continue
                if target is not None:
                    for prefix, message in _BLOCKING_PREFIXES.items():
                        if target.startswith(prefix):
                            findings.append(
                                self.finding(path, node, f"{message} — in {where} '{func.name}'")
                            )
                            break
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "block_until_ready"
                ):
                    findings.append(
                        self.finding(
                            path, node,
                            f"block_until_ready() fences the device queue — in {where} "
                            f"'{func.name}'; fetch the result (np.asarray) outside the hot "
                            "section or let async dispatch overlap",
                        )
                    )
        return findings
