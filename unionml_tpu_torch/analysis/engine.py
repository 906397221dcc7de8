"""tpu-lint rule engine: walk files, dispatch rules, report findings.

The repo's only static gate used to be the ``compileall`` syntax check
(tests/unit/test_syntax.py) — which exists because a trivially lintable
f-string bug once broke docs collection. The hazards that actually cost TPU
time are semantic, not syntactic: a host sync inside a jitted function turns
an async dispatch into a device round-trip, a donated buffer read after the
call is a use-after-free, an unlocked cross-thread attribute mutation is a
race that only fires under production load. Each is mechanically visible in
the AST; this engine makes them review-time failures instead of TPU-time
mysteries (the same layering JAX's own lint/pytype gates give the upstream
stack).

Architecture: one parse per file feeds BOTH rule protocols. Per-file rules
are stateless classes with a ``check(tree, path)`` method that sees one tree;
interprocedural rules additionally implement ``check_project(index)`` against
the cross-module :class:`~unionml_tpu_torch.analysis.project.ProjectIndex` (symbol
table, class hierarchy, call graph, per-function lock/jit/contextvar facts),
which the engine builds once per run from a content-hash cache — a warm run
re-summarizes only edited files, so a second run over an unchanged tree
parses nothing. Findings from both protocols funnel through per-line
``# tpu-lint: disable=RULE`` and file-level ``# tpu-lint: disable-file=RULE``
(first five lines of a module) suppressions into a :class:`LintResult`; a
JSON baseline (``--baseline``) can additionally absorb known findings so a
stricter rule lands without a same-PR repo sweep — baselined findings are
reported separately and do not fail the gate. Reporters render text
(``path:line: RULE id: message``), a stable JSON schema
(``{"findings": [...], "counts": ...}``, version 1), or SARIF 2.1.0 for CI
annotation surfaces (suppression records carry which mechanism fired;
baseline runs annotate ``baselineState``). Exit codes: 0 clean (justified
suppressions and baselined findings included), 1 findings, 2 usage/parse
errors.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "LintResult",
    "Rule",
    "all_rules",
    "apply_baseline",
    "load_baseline",
    "main",
    "render_json",
    "render_sarif",
    "render_text",
    "run_lint",
    "write_baseline",
]

#: ``# tpu-lint: disable=TPU001`` or ``disable=TPU001,TPU003`` or ``disable=all``,
#: anywhere on the offending line (typically a trailing comment)
_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable=([A-Za-z0-9_,\s]+)")

#: ``# tpu-lint: disable-file=TPU016`` (or a comma list, or ``all``) — whole-file
#: opt-out, honored only within the first :data:`_FILE_SUPPRESS_WINDOW` lines so
#: the opt-out is visible at the top of the module, next to the docstring
_FILE_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable-file=([A-Za-z0-9_,\s]+)")
_FILE_SUPPRESS_WINDOW = 5


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, addressable as ``path:line``."""

    rule: str  #: rule id, e.g. "TPU003"
    path: str  #: file path as given to the walker
    line: int  #: 1-indexed source line
    col: int  #: 0-indexed column
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class Rule:
    """Base class for tpu-lint rules.

    Subclasses set ``id``/``title`` and implement :meth:`check`. Rules are
    stateless across files — the engine instantiates each once per run and
    calls ``check`` per file, so a rule must not carry per-file state between
    calls (everything it needs is derivable from the tree).

    Interprocedural rules additionally override :meth:`check_project` (and may
    leave :meth:`check` returning nothing): the engine builds one
    :class:`~unionml_tpu_torch.analysis.project.ProjectIndex` per run and hands it to
    every selected rule after the per-file pass, so a rule can follow call
    graphs, lock orders, and contextvar flows across module boundaries.
    """

    id: str = ""
    title: str = ""

    def check(self, tree: ast.Module, path: str) -> "List[Finding]":
        raise NotImplementedError

    def check_project(self, index) -> "List[Finding]":
        """Whole-program pass over the cross-module index; default: nothing.

        Findings may duplicate :meth:`check`'s (e.g. TPU001's project pass
        re-walks intra-module reachability on its way across modules) — the
        engine deduplicates on (rule, path, line, col)."""
        return []

    def finding(self, path: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.id,
            path=path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


def all_rules() -> "List[Rule]":
    """Fresh instances of every registered rule, in id order."""
    from unionml_tpu_torch.analysis.rules import RULES

    return [cls() for _, cls in sorted(RULES.items())]


@dataclasses.dataclass
class LintResult:
    """What a lint run produced: active findings, suppressed findings, errors."""

    findings: "List[Finding]" = dataclasses.field(default_factory=list)
    suppressed: "List[Finding]" = dataclasses.field(default_factory=list)
    #: files that failed to parse (path, message) — reported and exit-coded 2,
    #: since an unparseable file is a gate failure of its own
    errors: "List[Tuple[str, str]]" = dataclasses.field(default_factory=list)
    files: int = 0
    #: project-index cache accounting for this run ({"hits": n, "misses": m});
    #: the benchmark lane reports these to pin the incremental contract
    index_stats: "Dict[str, int]" = dataclasses.field(default_factory=dict)
    #: findings absorbed by a ``--baseline`` file (known debt, not new): kept
    #: out of ``findings`` so they do not fail the gate, reported separately
    baselined: "List[Finding]" = dataclasses.field(default_factory=list)
    #: True once :func:`apply_baseline` ran — SARIF then annotates every
    #: result with ``baselineState`` (new vs unchanged)
    baseline_applied: bool = False
    #: (rule, path, line, col) of suppressed findings silenced by a file-level
    #: ``disable-file`` comment rather than a per-line one — SARIF suppression
    #: records name the mechanism so dashboards can audit each budget
    file_suppressed_keys: "set" = dataclasses.field(default_factory=set)

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors

    def counts(self) -> "Dict[str, int]":
        out: "Dict[str, int]" = {}
        for finding in self.findings:
            out[finding.rule] = out.get(finding.rule, 0) + 1
        return out

    def exit_code(self) -> int:
        if self.errors:
            return 2
        return 0 if not self.findings else 1


def iter_py_files(paths: "Sequence[str | Path]") -> "List[Path]":
    """Expand files/directories into a sorted, deduplicated .py file list."""
    seen: "Dict[Path, None]" = {}
    for raw in paths:
        path = Path(raw)
        if path.is_dir():
            for sub in sorted(path.rglob("*.py")):
                if "__pycache__" not in sub.parts and ".git" not in sub.parts:
                    seen.setdefault(sub, None)
        elif path.suffix == ".py":
            seen.setdefault(path, None)
        elif not path.exists():
            raise FileNotFoundError(f"lint path does not exist: {path}")
    return sorted(seen)


def _suppressions(source: str) -> "Dict[int, set]":
    """Map of 1-indexed line -> rule ids (or {"ALL"}) disabled on that line."""
    out: "Dict[int, set]" = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        match = _SUPPRESS_RE.search(line)
        if match is None:
            continue
        ids = {part.strip().upper() for part in match.group(1).split(",") if part.strip()}
        out[lineno] = ids
    return out


def _file_suppressions(source: str) -> "set":
    """Rule ids (or {"ALL"}) disabled for the whole file via
    ``# tpu-lint: disable-file=...`` within the first five lines."""
    out: "set" = set()
    for line in source.splitlines()[:_FILE_SUPPRESS_WINDOW]:
        match = _FILE_SUPPRESS_RE.search(line)
        if match is not None:
            out |= {
                part.strip().upper() for part in match.group(1).split(",") if part.strip()
            }
    return out


def _select_rules(
    select: "Optional[Iterable[str]]" = None, ignore: "Optional[Iterable[str]]" = None
) -> "List[Rule]":
    rules = all_rules()
    known = {rule.id for rule in rules}
    for group, ids in (("select", select), ("ignore", ignore)):
        unknown = {i.upper() for i in ids or ()} - known
        if unknown:
            raise ValueError(f"unknown rule id(s) in --{group}: {', '.join(sorted(unknown))}")
    if select:
        wanted = {i.upper() for i in select}
        rules = [rule for rule in rules if rule.id in wanted]
    if ignore:
        dropped = {i.upper() for i in ignore}
        rules = [rule for rule in rules if rule.id not in dropped]
    return rules


def run_lint(
    paths: "Sequence[str | Path]",
    *,
    select: "Optional[Iterable[str]]" = None,
    ignore: "Optional[Iterable[str]]" = None,
    only: "Optional[Sequence[str | Path]]" = None,
) -> LintResult:
    """Lint ``paths`` (files and/or directory trees) with the selected rules.

    The project index is always built over ALL of ``paths`` (interprocedural
    facts must be whole-program to be true); ``only`` restricts which files'
    findings are REPORTED — the ``--changed-only`` fast path — without
    shrinking what the index sees. This is the library surface the tier-1
    gate calls (``run_lint(["unionml_tpu_torch"])`` must be clean); the CLI in
    :func:`main` is a thin reporter over it.
    """
    from unionml_tpu_torch.analysis.project import build_index

    rules = _select_rules(select, ignore)
    result = LintResult()
    files = iter_py_files(paths)
    index, parse_errors, stats = build_index(files)
    result.errors.extend(parse_errors)
    result.index_stats = stats
    only_set: "Optional[set]" = None
    if only is not None:
        only_set = {str(Path(p).resolve()) for p in only}
    summaries = sorted(index.by_path.values(), key=lambda s: s.path)

    def reported(path: str) -> bool:
        return only_set is None or str(Path(path).resolve()) in only_set

    def place(finding: Finding, disabled: "Dict[int, set]", file_disabled: "set") -> None:
        if finding.rule in file_disabled or "ALL" in file_disabled:
            result.suppressed.append(finding)
            result.file_suppressed_keys.add(
                (finding.rule, finding.path, finding.line, finding.col)
            )
            return
        ids = disabled.get(finding.line, ())
        if finding.rule in ids or "ALL" in ids:
            result.suppressed.append(finding)
        else:
            result.findings.append(finding)

    for summary in summaries:
        if not reported(summary.path):
            continue
        result.files += 1
        for rule in rules:
            # per-file rules are pure functions of (tree, path): their output
            # is memoized on the summary, which the index invalidates on any
            # content change — a warm run re-checks only edited files
            cached = summary.rule_findings.get(rule.id)
            if cached is None:
                cached = rule.check(summary.tree, summary.path)
                summary.rule_findings[rule.id] = cached
            for finding in cached:
                place(finding, summary.suppressions, summary.file_suppressions)

    # whole-program pass: every rule gets the index; findings land in the
    # file they point at, under that file's suppression comments
    for rule in rules:
        for finding in rule.check_project(index):
            if not reported(finding.path):
                continue
            owner = index.by_path.get(finding.path)
            place(
                finding,
                owner.suppressions if owner is not None else {},
                owner.file_suppressions if owner is not None else set(),
            )

    result.findings = _dedupe(result.findings)
    result.suppressed = _dedupe(result.suppressed)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    result.suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    return result


def _dedupe(findings: "List[Finding]") -> "List[Finding]":
    """Drop repeats on (rule, path, line, col): a project rule re-deriving an
    intra-module finding (TPU001/TPU002's upgraded reachability covers the
    per-file rule's ground on its way across modules) reports it once."""
    seen: "Dict[Tuple[str, str, int, int], None]" = {}
    out: "List[Finding]" = []
    for finding in findings:
        key = (finding.rule, finding.path, finding.line, finding.col)
        if key in seen:
            continue
        seen[key] = None
        out.append(finding)
    return out


# ------------------------------------------------------------------- baseline
#
# A baseline is a JSON multiset of known findings. Entries are keyed on
# (rule, path, message) — deliberately NOT line/col, so unrelated edits that
# shift a known finding up or down the file do not resurface it — with a
# count, so introducing a SECOND instance of an already-baselined finding in
# the same file still fails the gate.


def write_baseline(result: LintResult, path: "str | Path") -> None:
    """Record ``result``'s active findings as the new baseline at ``path``."""
    counts: "Dict[Tuple[str, str, str], int]" = {}
    for finding in result.findings:
        key = (finding.rule, finding.path, finding.message)
        counts[key] = counts.get(key, 0) + 1
    payload = {
        "version": 1,
        "entries": [
            {"rule": rule, "path": fpath, "message": message, "count": count}
            for (rule, fpath, message), count in sorted(counts.items())
        ],
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def load_baseline(path: "str | Path") -> "Dict[Tuple[str, str, str], int]":
    """Parse a baseline file into its (rule, path, message) -> count multiset."""
    try:
        payload = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise ValueError(f"unreadable baseline {path}: {exc}") from exc
    entries = payload.get("entries") if isinstance(payload, dict) else None
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path} has no 'entries' list")
    out: "Dict[Tuple[str, str, str], int]" = {}
    for entry in entries:
        key = (str(entry["rule"]), str(entry["path"]), str(entry["message"]))
        out[key] = out.get(key, 0) + int(entry.get("count", 1))
    return out


def apply_baseline(result: LintResult, baseline: "Dict[Tuple[str, str, str], int]") -> None:
    """Move findings matched by ``baseline`` from ``findings`` to ``baselined``
    (in place). Matching consumes baseline budget: the N+1th instance of a
    finding baselined N times is still new."""
    remaining = dict(baseline)
    fresh: "List[Finding]" = []
    for finding in result.findings:
        key = (finding.rule, finding.path, finding.message)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            result.baselined.append(finding)
        else:
            fresh.append(finding)
    result.findings = fresh
    result.baseline_applied = True


def render_text(result: LintResult, *, show_suppressed: bool = False) -> str:
    lines = [finding.render() for finding in result.findings]
    if show_suppressed:
        lines += [f"{finding.render()} [suppressed]" for finding in result.suppressed]
    for path, message in result.errors:
        lines.append(f"{path}: PARSE-ERROR {message}")
    summary = (
        f"{len(result.findings)} finding(s), {len(result.suppressed)} suppressed, "
        f"{result.files} file(s) checked"
    )
    if result.baseline_applied:
        summary += f", {len(result.baselined)} baselined"
    lines.append(summary)
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    """Stable JSON schema (version 1) — the benchmark lane and external CI
    consume this, so field names are a contract."""
    payload = {
        "version": 1,
        "files": result.files,
        "findings": [dataclasses.asdict(finding) for finding in result.findings],
        "suppressed": [dataclasses.asdict(finding) for finding in result.suppressed],
        "errors": [{"path": path, "message": message} for path, message in result.errors],
        "counts": result.counts(),
        "exit_code": result.exit_code(),
    }
    if result.baseline_applied:
        payload["baselined"] = [dataclasses.asdict(f) for f in result.baselined]
    return json.dumps(payload, indent=2)


def render_sarif(result: LintResult) -> str:
    """SARIF 2.1.0 — the interchange schema CI annotation surfaces (GitHub
    code scanning, VS Code SARIF viewers) render natively. Active findings
    are ``warning``-level results; suppressed findings are carried with an
    ``inSource`` suppression record whose justification names the mechanism
    (per-line ``disable`` vs file-level ``disable-file``) so dashboards can
    audit each budget; baseline runs annotate every result's
    ``baselineState`` (``new`` vs ``unchanged``); parse errors surface as
    tool ``notifications``."""
    from unionml_tpu_torch.analysis.rules import RULES

    def _result(
        finding: Finding, suppressed: bool, baseline_state: "Optional[str]" = None
    ) -> "Dict[str, object]":
        record: "Dict[str, object]" = {
            "ruleId": finding.rule,
            "level": "warning",
            "message": {"text": finding.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": finding.path},
                        "region": {
                            "startLine": finding.line,
                            # SARIF columns are 1-indexed; Finding.col is 0-indexed
                            "startColumn": finding.col + 1,
                        },
                    }
                }
            ],
        }
        if suppressed:
            key = (finding.rule, finding.path, finding.line, finding.col)
            mechanism = (
                "# tpu-lint: disable-file"
                if key in result.file_suppressed_keys
                else "# tpu-lint: disable"
            )
            record["suppressions"] = [{"kind": "inSource", "justification": mechanism}]
        if baseline_state is not None:
            record["baselineState"] = baseline_state
        return record

    state_new = "new" if result.baseline_applied else None
    state_old = "unchanged" if result.baseline_applied else None

    payload = {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "tpu-lint",
                        "informationUri": "docs/static-analysis.md",
                        "rules": [
                            {"id": rule_id, "shortDescription": {"text": cls.title}}
                            for rule_id, cls in sorted(RULES.items())
                        ],
                    }
                },
                "results": [
                    _result(f, suppressed=False, baseline_state=state_new)
                    for f in result.findings
                ]
                + [
                    _result(f, suppressed=False, baseline_state=state_old)
                    for f in result.baselined
                ]
                + [_result(f, suppressed=True) for f in result.suppressed],
                "invocations": [
                    {
                        "executionSuccessful": not result.errors,
                        "toolExecutionNotifications": [
                            {"level": "error", "message": {"text": f"{path}: {message}"}}
                            for path, message in result.errors
                        ],
                    }
                ],
            }
        ],
    }
    return json.dumps(payload, indent=2)


def _changed_files(ref: str) -> "List[Path]":
    """Files named by ``git diff --name-only <ref>`` plus untracked .py files
    — the ``--changed-only`` pre-push scope. Git prints paths relative to the
    repository toplevel, so they are anchored there (the command may run from
    any subdirectory)."""
    top = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"], capture_output=True, text=True
    )
    if top.returncode != 0:
        raise ValueError(
            f"--changed-only requires a git checkout: {top.stderr.strip() or 'git failed'}"
        )
    root = Path(top.stdout.strip())
    out: "List[Path]" = []
    for args in (
        ["git", "diff", "--name-only", ref],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        proc = subprocess.run(args, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ValueError(f"`{' '.join(args)}` failed: {proc.stderr.strip()}")
        out.extend(root / line for line in proc.stdout.splitlines() if line.endswith(".py"))
    return out


def main(argv: "Optional[Sequence[str]]" = None) -> int:
    """``python -m unionml_tpu_torch.analysis [paths]`` entry point (also backs the
    ``unionml-tpu-torch lint`` CLI command)."""
    parser = argparse.ArgumentParser(
        prog="tpu-lint",
        description="TPU/concurrency-aware static analyzer (rules TPU001-TPU019)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files or directories (default: the installed unionml_tpu_torch package tree)",
    )
    parser.add_argument("--format", choices=("text", "json", "sarif"), default="text")
    parser.add_argument("--select", default=None, help="comma-separated rule ids to run")
    parser.add_argument("--ignore", default=None, help="comma-separated rule ids to skip")
    parser.add_argument(
        "--show-suppressed", action="store_true", help="list suppressed findings in text output"
    )
    parser.add_argument(
        "--changed-only",
        nargs="?",
        const="HEAD",
        default=None,
        metavar="REF",
        help="report findings only for files in `git diff --name-only REF` (default HEAD) "
        "plus untracked files; the project index is still built over all PATHS",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help="JSON baseline of known findings: matched findings are reported as "
        "baselined (and do not fail the gate), only new ones count; "
        "composes with --changed-only and --format sarif (baselineState)",
    )
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help="record the run's findings to --baseline FILE (then report zero new)",
    )
    args = parser.parse_args(argv)
    if args.update_baseline and not args.baseline:
        print("tpu-lint: --update-baseline requires --baseline FILE", file=sys.stderr)
        return 2
    # no paths: lint the package itself, wherever it is installed — so
    # `python -m unionml_tpu_torch.analysis` works from any working directory
    paths = args.paths or [Path(__file__).resolve().parents[1]]
    split = lambda raw: [part.strip() for part in raw.split(",") if part.strip()] if raw else None
    try:
        only = _changed_files(args.changed_only) if args.changed_only else None
        result = run_lint(paths, select=split(args.select), ignore=split(args.ignore), only=only)
        if args.baseline:
            if args.update_baseline:
                write_baseline(result, args.baseline)
            elif not Path(args.baseline).exists():
                raise ValueError(
                    f"baseline {args.baseline} does not exist "
                    "(record one with --update-baseline)"
                )
            apply_baseline(result, load_baseline(args.baseline))
    except (FileNotFoundError, ValueError, OSError) as exc:
        print(f"tpu-lint: {exc}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(render_json(result))
    elif args.format == "sarif":
        print(render_sarif(result))
    else:
        print(render_text(result, show_suppressed=args.show_suppressed))
    return result.exit_code()
