"""Whole-program project index for tpu-lint's interprocedural rules.

The per-file rules see one ``ast.parse`` tree and nothing else, so TPU001's
jit-reachability stops at module boundaries and whole hazard classes — a lock
acquired in ``replicas.py`` while a ``continuous.py`` lock is held, a
recompile storm at a call site two modules away from the ``jax.jit`` wrap, an
executor target that reads a tenancy contextvar through three helper calls —
are structurally invisible. This module builds the missing layer: **one pass
over every file** resolves imports to modules, assembles a cross-module symbol
table, class hierarchy, and call graph, and records per-function facts (locks
acquired via ``with self.<lock>:`` and the ``*_locked`` convention, jit-entry
status and static-argument positions, contextvar reads, executor/thread
submissions). Rules that implement ``check_project(index)`` (the second rule
protocol in :mod:`unionml_tpu_torch.analysis.engine`) query the index instead of a
single tree — the same shape Meta's Infer/RacerD use for interprocedural lock
analysis.

The index is **content-hash cached and incremental**: each file's summary
(including its parsed tree) is keyed on a SHA-256 of its bytes in a
process-global cache, so a warm :func:`unionml_tpu_torch.analysis.engine.run_lint`
re-summarizes only edited files (the tier-1 gate asserts a warm run misses
nothing). :func:`clear_index_cache` drops the cache (for cold vs warm
timings).

Everything here is stdlib-only and purely syntactic — no imports of the
analyzed code are ever executed.

The port's counterpart of a jit wrap is ``AOTFunction(fn, ...)``
(:mod:`unionml_tpu_torch.serving.aot`), which records one CUDA graph per
signature: such a wrap is a :class:`JitBinding` of kind ``"aot"`` and marks
``fn`` a *capture* entry, as do the calls made inside a
``with torch.cuda.graph(...):`` block. The JAX forms are read as before.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from unionml_tpu_torch.analysis.rules._common import (
    LOCK_FACTORIES,
    aot_aliases,
    call_target,
    dotted,
    is_capture_context,
    is_jit_decorator,
    iter_scope,
    jit_wrap_call,
    literal_argnums,
)

__all__ = [
    "CallSite",
    "ClassFacts",
    "ExecutorCall",
    "FunctionFacts",
    "JitBinding",
    "ModuleSummary",
    "ProjectIndex",
    "build_index",
    "clear_index_cache",
    "function_cfg",
]

#: raw lock tokens: ``self.<attr>`` for instance locks, ``mod:<name>`` for
#: module-level locks — resolved to global lock node ids by the index
_MOD_LOCK_PREFIX = "mod:"

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One call expression inside a function body."""

    raw: str  #: dotted target as written ("helper", "mod.helper", "self.x.f")
    line: int
    held: Tuple[str, ...]  #: raw lock tokens held at the call site


@dataclasses.dataclass(frozen=True)
class ExecutorCall:
    """A ``run_in_executor``/``submit``/``threading.Thread`` submission."""

    kind: str  #: "executor" (run_in_executor/submit) or "thread"
    target_raw: Optional[str]  #: dotted callable, None when unresolvable
    line: int
    wrapped: bool  #: already routed through contextvars ``ctx.run``
    lambda_calls: Tuple[str, ...] = ()  #: call targets inside a lambda target


@dataclasses.dataclass(frozen=True)
class JitBinding:
    """A name that, when called, invokes a jit-compiled program."""

    binding: str  #: how call sites spell it ("self._decode", "step", ...)
    target_raw: Optional[str]  #: the wrapped function, as written
    static_argnums: Tuple[int, ...]
    static_argnames: Tuple[str, ...]
    donate_argnums: Tuple[int, ...]
    line: int
    cls: Optional[str]  #: owning class for "self." bindings
    #: "jit" (jax.jit/pjit) or "aot" (the port's AOTFunction: a captured
    #: CUDA graph per signature, keyed on every Python scalar's value)
    kind: str = "jit"


@dataclasses.dataclass
class FunctionFacts:
    """Per-function facts recorded in the one indexing pass."""

    module: str
    cls: Optional[str]
    name: str
    qualname: str  #: "name" or "Class.name" (module-local key)
    path: str
    line: int
    node: ast.AST
    params: Tuple[str, ...] = ()
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    #: (raw lock token, line, raw locks already held at that point)
    acquisitions: List[Tuple[str, int, Tuple[str, ...]]] = dataclasses.field(default_factory=list)
    #: raw receivers of ``<recv>.get(...)`` calls (candidate contextvar reads)
    cv_reads: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    executor_calls: List[ExecutorCall] = dataclasses.field(default_factory=list)
    jit_entry: bool = False
    #: wrapped by the port's AOTFunction: its body is recorded into a CUDA graph
    capture_entry: bool = False
    #: raw targets of the calls made inside ``with torch.cuda.graph(...):``
    graph_calls: List[str] = dataclasses.field(default_factory=list)
    #: local/param names with an inferable class type (raw dotted class name)
    local_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: names assigned from contextvars.copy_context() in this function
    ctx_names: Set[str] = dataclasses.field(default_factory=set)

    @property
    def fq(self) -> str:
        return f"{self.module}:{self.qualname}"


@dataclasses.dataclass
class ClassFacts:
    name: str
    module: str
    bases: Tuple[str, ...] = ()  #: raw dotted base names, resolved lazily
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: self.<attr> -> raw dotted class name of the constructor/annotation
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Set[str] = dataclasses.field(default_factory=set)

    def primary_lock(self) -> Optional[str]:
        """The lock a ``*_locked`` method of this class is assumed to hold:
        ``_lock`` when present (the repo-wide convention), else the class's
        single lock, else None (ambiguous — never guessed)."""
        if "_lock" in self.lock_attrs:
            return "_lock"
        if len(self.lock_attrs) == 1:
            return next(iter(self.lock_attrs))
        return None


@dataclasses.dataclass
class ModuleSummary:
    """Everything the project rules need from one file."""

    path: str
    module: str
    tree: ast.Module
    source: str
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionFacts] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassFacts] = dataclasses.field(default_factory=dict)
    module_locks: Set[str] = dataclasses.field(default_factory=set)
    contextvars: Set[str] = dataclasses.field(default_factory=set)
    jit_bindings: List[JitBinding] = dataclasses.field(default_factory=list)
    #: spellings that call the port's AOTFunction here (see ``aot_aliases``)
    aot_aliases: Set[str] = dataclasses.field(default_factory=set)
    #: module-level donor callables -> literal donated positions
    donors: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    suppressions: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    #: rule ids (or {"ALL"}) disabled for the whole file via a
    #: ``# tpu-lint: disable-file=...`` comment in the first five lines
    file_suppressions: Set[str] = dataclasses.field(default_factory=set)
    #: per-file rule findings memo, keyed by rule id — per-file rules are pure
    #: functions of (tree, path), so their output is valid as long as the
    #: content hash matches; the engine consults this to skip re-checks on
    #: warm runs (cleared with the summary on any edit)
    rule_findings: Dict[str, list] = dataclasses.field(default_factory=dict)
    #: per-function CFG memo keyed by (qualname, line) — CFGs are pure
    #: functions of the AST, so like ``rule_findings`` they live exactly as
    #: long as the content-hashed summary (see :func:`function_cfg`)
    cfgs: Dict[Tuple[str, int], object] = dataclasses.field(default_factory=dict)
    #: per-function prescan memo for the flow rules (TPU016-TPU019): which
    #: protocols/locks/yields a function mentions at all, so warm project
    #: passes skip CFG construction and dataflow for the ~95% of functions
    #: that touch none of them
    flow_hints: Dict[Tuple[str, int], object] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------- naming


def module_name_for(path: Path) -> str:
    """Dotted module name for ``path``, walking up while ``__init__.py``
    exists (loose files — test fixtures — get their bare stem)."""
    path = path.resolve()
    parts: List[str] = [] if path.stem == "__init__" else [path.stem]
    parent = path.parent
    while (parent / "__init__.py").exists():
        parts.insert(0, parent.name)
        parent = parent.parent
    return ".".join(parts) or path.stem


# ------------------------------------------------------------- summary build


def _lambda_call_targets(node: ast.Lambda) -> Tuple[str, ...]:
    out: List[str] = []
    for child in ast.walk(node):
        if isinstance(child, ast.Call):
            target = call_target(child)
            if target:
                out.append(target)
    return tuple(out)


class _FunctionWalker:
    """Walks one function body recording calls, lock acquisitions (with the
    held-set at each point), contextvar-read candidates, executor/thread
    submissions, local type hints, copy_context() bindings, and jit-wrap
    assignments — ONE traversal per function (a cold run's cost is the index
    build, so every fact rides the same pass). Nested
    defs/lambdas/classes are separate scopes: their statements are not
    charged to this function, and nested defs are handed back to the builder
    for their own FunctionFacts."""

    def __init__(self, builder: "_SummaryBuilder", facts: FunctionFacts, lock_attrs: Set[str], cls: Optional[str]):
        self.builder = builder
        self.facts = facts
        self.lock_attrs = lock_attrs
        self.cls = cls
        self.module_locks = builder.summary.module_locks

    def walk(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _visit(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        """Per-node dispatch, entered both from :meth:`walk` (children) and
        for each With-body statement — a ``with self._b:`` textually nested
        inside ``with self._a:`` must re-enter the With branch, or its
        acquisition (and the held-set under it) is silently lost."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.builder.visit_function(node, cls=None)
            return
        if isinstance(node, (ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            self.builder.record_import(node)
            return
        if isinstance(node, ast.Assign):
            self._record_locals(node)
            self.builder.record_assign(node, self.cls)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            if any(is_capture_context(item) for item in node.items):
                for stmt in node.body:
                    for child in [stmt, *iter_scope(stmt)]:
                        target = call_target(child) if isinstance(child, ast.Call) else None
                        if target is not None:
                            self.facts.graph_calls.append(target)
            inner = held
            for item in node.items:
                raw = self._lock_token(item.context_expr)
                if raw is not None:
                    self.facts.acquisitions.append((raw, node.lineno, inner))
                    inner = inner + (raw,)
            for item in node.items:  # guards/`as` targets may contain calls
                self._record(item.context_expr, held)
                self.walk(item.context_expr, held)
            for stmt in node.body:
                self._visit(stmt, inner)
            return
        self._record(node, held)
        self.walk(node, held)

    def _record_locals(self, node: ast.Assign) -> None:
        """Local type hints (``x = ClassName(...)``) and copy_context names
        (``ctx = contextvars.copy_context()``), folded into the main walk."""
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            return
        name = node.targets[0].id
        if isinstance(node.value, ast.Call):
            ctor = call_target(node.value)
            if ctor in ("contextvars.copy_context", "copy_context"):
                self.facts.ctx_names.add(name)
            # CapWord final segment — a constructor, not a factory function
            elif ctor and ctor.rsplit(".", 1)[-1][:1].isupper():
                self.facts.local_types.setdefault(name, ctor)

    def _lock_token(self, expr: ast.AST) -> Optional[str]:
        raw = dotted(expr)
        if raw is None:
            return None
        if raw.startswith(("self.", "cls.")):
            attr = raw.split(".", 1)[1]
            if "." not in attr and attr in self.lock_attrs:
                return f"self.{attr}"
        elif "." not in raw and raw in self.module_locks:
            return _MOD_LOCK_PREFIX + raw
        return None

    def _record(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if not isinstance(node, ast.Call):
            return
        target = call_target(node)
        if target is not None:
            self.facts.calls.append(CallSite(raw=target, line=node.lineno, held=held))
            # contextvar-read candidate: <recv>.get(...)
            if target.endswith(".get"):
                self.facts.cv_reads.append((target[: -len(".get")], node.lineno))
            # copy_context() binding: ctx = contextvars.copy_context()
        self._record_executor(node, target)

    def _record_executor(self, node: ast.Call, target: Optional[str]) -> None:
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        if attr == "run_in_executor" and len(node.args) >= 2:
            self._submission("executor", node, node.args[1])
        elif attr == "submit" and node.args:
            # `.submit` is overloaded in this codebase (the engine's stream
            # submission API takes a prompt, not a callable) — only receivers
            # that are recognizably thread/process pools count
            recv = dotted(func.value)
            last = (recv or "").rsplit(".", 1)[-1].lower()
            if "executor" in last or "pool" in last:
                self._submission("executor", node, node.args[0])
        elif target in ("threading.Thread", "Thread"):
            for kw in node.keywords:
                if kw.arg == "target":
                    self._submission("thread", node, kw.value)

    def _submission(self, kind: str, node: ast.Call, callable_expr: ast.AST) -> None:
        if isinstance(callable_expr, ast.Lambda):
            self.facts.executor_calls.append(
                ExecutorCall(
                    kind=kind,
                    target_raw=None,
                    line=node.lineno,
                    wrapped=False,
                    lambda_calls=_lambda_call_targets(callable_expr),
                )
            )
            return
        raw = dotted(callable_expr)
        wrapped = False
        if raw is not None and raw.endswith(".run"):
            base = raw[: -len(".run")]
            if base in self.facts.ctx_names or base in ("ctx", "context"):
                wrapped = True
        # functools.partial(ctx.run, fn, ...) as the submitted callable
        if isinstance(callable_expr, ast.Call) and call_target(callable_expr) in (
            "partial",
            "functools.partial",
        ):
            if callable_expr.args:
                first = dotted(callable_expr.args[0])
                if first is not None and first.endswith(".run"):
                    wrapped = True
                elif len(callable_expr.args) >= 1:
                    raw = first
        self.facts.executor_calls.append(
            ExecutorCall(kind=kind, target_raw=raw, line=node.lineno, wrapped=wrapped)
        )


def _params_of(func_node: ast.AST) -> Tuple[str, ...]:
    args = func_node.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return tuple(names)


def _static_positions(call: ast.Call) -> Tuple[Tuple[int, ...], Tuple[str, ...], Tuple[int, ...]]:
    nums: Tuple[int, ...] = ()
    names: Tuple[str, ...] = ()
    donate: Tuple[int, ...] = ()
    for kw in call.keywords:
        if kw.arg == "static_argnums":
            nums = literal_argnums(kw.value) or ()
        elif kw.arg == "static_argnames":
            if isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
                names = (kw.value.value,)
            elif isinstance(kw.value, (ast.Tuple, ast.List)):
                names = tuple(
                    e.value for e in kw.value.elts if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
        elif kw.arg == "donate_argnums":
            donate = literal_argnums(kw.value) or ()
    return nums, names, donate


def build_summary(path: Path, source: str, tree: ast.Module) -> ModuleSummary:
    """One fused pass over ``tree`` extracting every fact the project rules
    use (imports, defs, locks, contextvars, jit bindings, executor calls) —
    the build rides the tier-1 gate's clock, so nothing walks the tree
    twice except the per-class attribute pre-scan (lock attributes must be
    known before the class's methods are walked, wherever ``__init__`` sits)."""
    from unionml_tpu_torch.analysis.engine import (  # shared comment grammar
        _file_suppressions,
        _suppressions,
    )

    module = module_name_for(path)
    summary = ModuleSummary(
        path=str(path),
        module=module,
        tree=tree,
        source=source,
        suppressions=_suppressions(source),
        file_suppressions=_file_suppressions(source),
    )
    _SummaryBuilder(summary, is_pkg=path.name == "__init__.py").run()
    return summary


class _SummaryBuilder:
    def __init__(self, summary: ModuleSummary, is_pkg: bool):
        self.summary = summary
        module = summary.module
        self._pkg_parts = module.split(".") if is_pkg else module.split(".")[:-1]
        #: (cls-or-None, bare name, kind) of functions jit- or AOT-wrapped by
        #: assignment, marked after the full pass (the def may come later)
        self._pending_marks: List[Tuple[Optional[str], str, str]] = []

    def run(self) -> None:
        tree = self.summary.tree
        # module-level locks and contextvars (top level only: a lock behind an
        # `if` is still module-global; one inside a function is not)
        for node in tree.body:
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            if not isinstance(node.value, ast.Call):
                continue
            ctor = call_target(node.value)
            for target in targets:
                if not isinstance(target, ast.Name):
                    continue
                if ctor in LOCK_FACTORIES:
                    self.summary.module_locks.add(target.id)
                elif ctor in ("contextvars.ContextVar", "ContextVar"):
                    self.summary.contextvars.add(target.id)
        self.summary.aot_aliases = aot_aliases(tree)
        self.visit_body(tree, cls=None)
        for cls, bare, kind in self._pending_marks:
            facts = self.summary.functions.get(f"{cls}.{bare}" if cls else bare)
            if facts is not None:
                if kind == "aot":
                    facts.capture_entry = True
                else:
                    facts.jit_entry = True

    # ------------------------------------------------------------ traversal

    def visit_body(self, node: ast.AST, cls: Optional[str]) -> None:
        """Module/class-level recursion; function bodies hand off to
        :class:`_FunctionWalker` (one traversal each)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                self.record_import(child)
            elif isinstance(child, ast.ClassDef):
                facts = ClassFacts(
                    name=child.name,
                    module=self.summary.module,
                    bases=tuple(b for b in (dotted(base) for base in child.bases) if b),
                )
                self.summary.classes[child.name] = facts
                _scan_class_attrs(facts, child)
                self.visit_body(child, cls=child.name)
            elif isinstance(child, _FUNC_NODES):
                self.visit_function(child, cls)
            else:
                if isinstance(child, ast.Assign):
                    self.record_assign(child, cls)
                self.visit_body(child, cls)

    def visit_function(self, func_node: ast.AST, cls: Optional[str]) -> None:
        summary = self.summary
        qualname = f"{cls}.{func_node.name}" if cls else func_node.name
        local_types: Dict[str, str] = {}
        args = func_node.args
        for arg in args.posonlyargs + args.args + args.kwonlyargs:
            if arg.annotation is not None:
                raw = dotted(arg.annotation)
                if raw:
                    local_types[arg.arg] = raw
        facts = FunctionFacts(
            module=summary.module,
            cls=cls,
            name=func_node.name,
            qualname=qualname,
            path=summary.path,
            line=func_node.lineno,
            node=func_node,
            params=_params_of(func_node),
            jit_entry=False,
            local_types=local_types,
        )
        for dec in func_node.decorator_list:
            if not is_jit_decorator(dec):
                continue
            facts.jit_entry = True
            nums: Tuple[int, ...] = ()
            names: Tuple[str, ...] = ()
            donate: Tuple[int, ...] = ()
            if isinstance(dec, ast.Call):
                nums, names, donate = _static_positions(dec)
            if cls:
                # decorator argnums are relative to the UNBOUND function
                # (position 0 = self), but call sites spell `self.name(...)`
                # without the receiver — store call-site-relative positions
                nums = tuple(n - 1 for n in nums if n > 0)
                donate = tuple(n - 1 for n in donate if n > 0)
            binding = f"self.{facts.name}" if cls else facts.name
            summary.jit_bindings.append(
                JitBinding(
                    binding=binding,
                    target_raw=binding,
                    static_argnums=nums,
                    static_argnames=names,
                    donate_argnums=donate,
                    line=func_node.lineno,
                    cls=cls,
                )
            )
            if cls is None and donate:
                summary.donors[facts.name] = donate
        class_facts = summary.classes.get(cls) if cls else None
        lock_attrs = class_facts.lock_attrs if class_facts else set()
        # *_locked convention: the body runs with the class lock held
        held: Tuple[str, ...] = ()
        if cls and func_node.name.endswith("_locked") and class_facts is not None:
            primary = class_facts.primary_lock()
            if primary is not None:
                held = (f"self.{primary}",)
        summary.functions[qualname] = facts
        if class_facts is not None:
            class_facts.methods.add(func_node.name)
        _FunctionWalker(self, facts, lock_attrs, cls).walk(func_node, held)

    # ------------------------------------------------------------- recording

    def record_import(self, node: ast.AST) -> None:
        table = self.summary.imports
        if isinstance(node, ast.Import):
            for alias in node.names:
                # `import a.b.c` binds `a`, but call sites spell the full
                # dotted path — keep the full name resolvable
                table[alias.asname or alias.name] = alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = self._pkg_parts
                base_parts = parts[: len(parts) - (node.level - 1)] if node.level > 1 else parts
                base = ".".join(base_parts + ([node.module] if node.module else []))
            else:
                base = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                table[alias.asname or alias.name] = f"{base}.{alias.name}" if base else alias.name

    def record_assign(self, node: ast.Assign, cls: Optional[str]) -> None:
        """``<target> = jax.jit(fn, ...)`` and ``<target> = AOTFunction(fn,
        ...)`` bindings, wherever they appear (module level, class body,
        ``__init__``, a local helper scope)."""
        if len(node.targets) != 1:
            return
        wrap = jit_wrap_call(node.value)
        kind = "jit"
        if wrap is None and isinstance(node.value, ast.Call) and call_target(node.value) in self.summary.aot_aliases:
            wrap, kind = node.value, "aot"
        target = dotted(node.targets[0])
        if wrap is None or target is None or not wrap.args:
            return
        nums, names, donate = _static_positions(wrap)
        target_raw = dotted(wrap.args[0])
        if target.startswith(("self.", "cls.")):
            binding = "self." + target.split(".", 1)[1]
        else:
            binding = target
        self.summary.jit_bindings.append(
            JitBinding(
                binding=binding,
                target_raw=target_raw,
                static_argnums=nums,
                static_argnames=names,
                donate_argnums=donate,
                line=node.lineno,
                cls=cls,
                kind=kind,
            )
        )
        # mark the wrapped function as a jit/capture entry for reachability rules
        if target_raw:
            if target_raw.startswith(("self.", "cls.")) and cls:
                self._pending_marks.append((cls, target_raw.split(".", 1)[1], kind))
            elif "." not in target_raw:
                self._pending_marks.append((None, target_raw, kind))
        if cls is None and donate and "." not in binding:
            self.summary.donors[binding] = donate


def _scan_class_attrs(facts: ClassFacts, cls: ast.ClassDef) -> None:
    """Lock attributes and constructor-derived attribute types, anywhere in
    the class body (the TPU003/TPU007 discovery, widened with types)."""
    ann: Dict[str, str] = {}
    for method in cls.body:
        if not isinstance(method, _FUNC_NODES):
            continue
        for arg in method.args.posonlyargs + method.args.args + method.args.kwonlyargs:
            if arg.annotation is not None:
                raw = dotted(arg.annotation)
                if raw:
                    ann[arg.arg] = raw
    for node in ast.walk(cls):
        value = getattr(node, "value", None)
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else []
        )
        if not targets or value is None:
            continue
        for target in targets:
            raw = dotted(target)
            if raw is None or not raw.startswith(("self.", "cls.")):
                continue
            attr = raw.split(".", 1)[1]
            if "." in attr:
                continue
            if isinstance(value, ast.Call):
                ctor = call_target(value)
                if ctor in LOCK_FACTORIES:
                    facts.lock_attrs.add(attr)
                elif ctor and ctor.rsplit(".", 1)[-1][:1].isupper():
                    facts.attr_types.setdefault(attr, ctor)
            elif isinstance(value, ast.Name) and value.id in ann:
                # self._engine = engine   (param annotated with a class)
                facts.attr_types.setdefault(attr, ann[value.id])


# ----------------------------------------------------------------- the index


class ProjectIndex:
    """Cross-module symbol table + call graph over a set of summaries."""

    def __init__(self, summaries: "List[ModuleSummary]"):
        self.modules: Dict[str, ModuleSummary] = {}
        for summary in summaries:
            self.modules[summary.module] = summary
        self.by_path: Dict[str, ModuleSummary] = {s.path: s for s in summaries}
        self._acq_memo: Dict[str, Dict[str, Tuple[Tuple[str, ...], int]]] = {}

    # -- symbol resolution ---------------------------------------------------

    def iter_functions(self) -> "Iterable[FunctionFacts]":
        for summary in self.modules.values():
            yield from summary.functions.values()

    def resolve_class(self, raw: str, summary: ModuleSummary) -> Optional[ClassFacts]:
        """Resolve a raw dotted class name written in ``summary``'s module."""
        if raw in summary.classes:
            return summary.classes[raw]
        fq = self._resolve_alias(raw, summary)
        if fq is None:
            return None
        mod, _, sym = fq.rpartition(".")
        target = self.modules.get(mod)
        if target is not None and sym in target.classes:
            return target.classes[sym]
        return None

    def class_mro(self, facts: ClassFacts) -> "List[ClassFacts]":
        """BFS linearization over raw base names (cycles guarded)."""
        out: List[ClassFacts] = [facts]
        seen = {(facts.module, facts.name)}
        queue = [facts]
        while queue:
            current = queue.pop(0)
            summary = self.modules.get(current.module)
            if summary is None:
                continue
            for base_raw in current.bases:
                base = self.resolve_class(base_raw, summary)
                if base is not None and (base.module, base.name) not in seen:
                    seen.add((base.module, base.name))
                    out.append(base)
                    queue.append(base)
        return out

    def _resolve_alias(self, raw: str, summary: ModuleSummary) -> Optional[str]:
        """Map a raw dotted name through the module's import table (longest
        alias prefix wins)."""
        parts = raw.split(".")
        for cut in range(len(parts), 0, -1):
            prefix = ".".join(parts[:cut])
            if prefix in summary.imports:
                rest = parts[cut:]
                return ".".join([summary.imports[prefix]] + rest)
        return None

    def _lookup_fq(self, fq: str) -> Optional[FunctionFacts]:
        """``pkg.mod.sym`` or ``pkg.mod.Class.method`` -> FunctionFacts
        (constructors resolve to ``__init__``)."""
        parts = fq.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            summary = self.modules.get(mod)
            if summary is None:
                continue
            sym = ".".join(parts[cut:])
            if sym in summary.functions:
                return summary.functions[sym]
            if sym in summary.classes:
                return self._method(summary.classes[sym], "__init__")
            if "." in sym:
                cls_name, meth = sym.split(".", 1)
                if cls_name in summary.classes and "." not in meth:
                    return self._method(summary.classes[cls_name], meth)
            return None
        return None

    def _method(self, cls: ClassFacts, name: str) -> Optional[FunctionFacts]:
        for candidate in self.class_mro(cls):
            summary = self.modules.get(candidate.module)
            if summary is None:
                continue
            facts = summary.functions.get(f"{candidate.name}.{name}")
            if facts is not None:
                return facts
        return None

    def resolve_call(
        self, raw: str, summary: ModuleSummary, caller: Optional[FunctionFacts] = None
    ) -> Optional[FunctionFacts]:
        """Best-effort resolution of a call target string to function facts.

        Handles: same-module functions and classes, ``self.method`` (through
        the class hierarchy), ``self.<attr>.method`` (through constructor /
        annotation attribute types), annotated-parameter and local-constructor
        variables, and imported names (``from m import f``, ``import m`` +
        ``m.f``). Returns None for anything it cannot prove — project rules
        must treat unresolved calls as opaque, never guessed.
        """
        if raw.startswith(("self.", "cls.")) and caller is not None and caller.cls is not None:
            rest = raw.split(".", 1)[1]
            cls = summary.classes.get(caller.cls)
            if cls is None:
                return None
            if "." not in rest:
                return self._method(cls, rest)
            attr, _, meth = rest.partition(".")
            if "." in meth:
                return None
            for candidate in self.class_mro(cls):
                attr_type = candidate.attr_types.get(attr)
                if attr_type is None:
                    continue
                target_cls = self.resolve_class(attr_type, self.modules.get(candidate.module, summary))
                if target_cls is not None:
                    return self._method(target_cls, meth)
            return None
        head, _, rest = raw.partition(".")
        # local variable / parameter with an inferable class type
        if caller is not None and head in caller.local_types and rest and "." not in rest:
            cls_facts = self.resolve_class(caller.local_types[head], summary)
            if cls_facts is not None:
                return self._method(cls_facts, rest)
        # same-module lookups
        if raw in summary.functions:
            return summary.functions[raw]
        if raw in summary.classes:
            return self._method(summary.classes[raw], "__init__")
        if rest and head in summary.classes and "." not in rest:
            return self._method(summary.classes[head], rest)
        # imported names
        fq = self._resolve_alias(raw, summary)
        if fq is not None:
            return self._lookup_fq(fq)
        return None

    # -- locks ---------------------------------------------------------------

    def lock_node(self, token: str, summary: ModuleSummary, facts: FunctionFacts) -> Optional[str]:
        """Global lock id for a raw token: instance locks are named by their
        DECLARING class (``module.Class._lock``, subclasses share the node),
        module locks by ``module.name``."""
        if token.startswith(_MOD_LOCK_PREFIX):
            return f"{summary.module}.{token[len(_MOD_LOCK_PREFIX):]}"
        attr = token.split(".", 1)[1]
        if facts.cls is None:
            return None
        cls = summary.classes.get(facts.cls)
        if cls is None:
            return None
        for candidate in self.class_mro(cls):
            if attr in candidate.lock_attrs:
                return f"{candidate.module}.{candidate.name}.{attr}"
        return f"{cls.module}.{cls.name}.{attr}"

    def transitive_acquisitions(self, facts: FunctionFacts) -> "Dict[str, Tuple[Tuple[str, ...], int]]":
        """All lock nodes ``facts`` may acquire, directly or through resolved
        calls: ``{lock_node: (call chain of "module:qualname" ids, line)}``.
        Memoized; call-graph cycles terminate via the in-progress marker."""
        memo = self._acq_memo
        if facts.fq in memo:
            return memo[facts.fq]
        memo[facts.fq] = {}  # in-progress marker breaks recursion
        out: Dict[str, Tuple[Tuple[str, ...], int]] = {}
        summary = self.modules.get(facts.module)
        if summary is None:
            return out
        for token, line, _held in facts.acquisitions:
            node = self.lock_node(token, summary, facts)
            if node is not None:
                out.setdefault(node, ((facts.fq,), line))
        # a *_locked method's contract is "caller holds the lock": any caller
        # must acquire its class's lock around the call, so the convention
        # lock counts as an acquisition for lock-ORDER purposes
        if facts.cls is not None and facts.name.endswith("_locked"):
            cls = summary.classes.get(facts.cls)
            primary = cls.primary_lock() if cls is not None else None
            if primary is not None:
                node = self.lock_node(f"self.{primary}", summary, facts)
                if node is not None:
                    out.setdefault(node, ((facts.fq,), facts.line))
        for call in facts.calls:
            callee = self.resolve_call(call.raw, summary, facts)
            if callee is None or callee.fq == facts.fq:
                continue
            for node, (chain, line) in self.transitive_acquisitions(callee).items():
                out.setdefault(node, ((facts.fq,) + chain, line))
        memo[facts.fq] = out
        return out

    # -- contextvars ---------------------------------------------------------

    def contextvar_reads(self, facts: FunctionFacts) -> "List[Tuple[str, int]]":
        """Resolved ContextVar reads in ``facts``: ``[(fq var name, line)]``."""
        summary = self.modules.get(facts.module)
        if summary is None:
            return []
        out: List[Tuple[str, int]] = []
        for recv, line in facts.cv_reads:
            if "." not in recv and recv in summary.contextvars:
                out.append((f"{summary.module}.{recv}", line))
                continue
            fq = self._resolve_alias(recv, summary)
            if fq is None:
                continue
            mod, _, sym = fq.rpartition(".")
            target = self.modules.get(mod)
            if target is not None and sym in target.contextvars:
                out.append((f"{mod}.{sym}", line))
        return out

    def transitive_contextvar_reads(
        self, facts: FunctionFacts
    ) -> "Dict[str, Tuple[Tuple[str, ...], int]]":
        """ContextVars read by ``facts`` or anything it (resolvably) calls:
        ``{fq var: (call chain, line)}``. BFS with a visited set."""
        out: Dict[str, Tuple[Tuple[str, ...], int]] = {}
        queue: List[Tuple[FunctionFacts, Tuple[str, ...]]] = [(facts, (facts.fq,))]
        seen = {facts.fq}
        while queue:
            current, chain = queue.pop(0)
            for var, line in self.contextvar_reads(current):
                out.setdefault(var, (chain, line))
            summary = self.modules.get(current.module)
            if summary is None:
                continue
            for call in current.calls:
                callee = self.resolve_call(call.raw, summary, current)
                if callee is not None and callee.fq not in seen:
                    seen.add(callee.fq)
                    queue.append((callee, chain + (callee.fq,)))
        return out

    # -- jit reachability ----------------------------------------------------

    def jit_entry_functions(self) -> "List[FunctionFacts]":
        return [facts for facts in self.iter_functions() if facts.jit_entry]

    def capture_entry_functions(self) -> "List[FunctionFacts]":
        """AOTFunction-wrapped functions, and the functions called (resolvably)
        inside a ``with torch.cuda.graph(...):`` block."""
        out: List[FunctionFacts] = []
        for facts in self.iter_functions():
            if facts.capture_entry:
                out.append(facts)
            summary = self.modules.get(facts.module)
            for raw in facts.graph_calls if summary is not None else ():
                callee = self.resolve_call(raw, summary, facts)
                if callee is not None:
                    out.append(callee)
        return out

    def reachable_from(self, entries: "Sequence[FunctionFacts]") -> "List[FunctionFacts]":
        """Cross-module call-graph closure from ``entries`` (the index-backed
        upgrade of TPU001's intra-module BFS)."""
        seen: Dict[str, FunctionFacts] = {}
        queue = list(entries)
        while queue:
            facts = queue.pop()
            if facts.fq in seen:
                continue
            seen[facts.fq] = facts
            summary = self.modules.get(facts.module)
            if summary is None:
                continue
            for call in facts.calls:
                callee = self.resolve_call(call.raw, summary, facts)
                if callee is not None and callee.fq not in seen:
                    queue.append(callee)
        return list(seen.values())


def function_cfg(summary: ModuleSummary, facts: FunctionFacts):
    """The control-flow graph for ``facts``, memoized on its module summary.

    Summaries are content-hash cached (:data:`_CACHE`), so this inherits the
    same invalidation: a warm ``run_lint`` reuses every CFG of every unchanged
    file, and an edited file drops its summary — and with it its CFGs —
    atomically.  Keyed by ``(qualname, line)`` so nested/shadowed defs cannot
    collide.
    """
    from unionml_tpu_torch.analysis.cfg import build_cfg

    key = (facts.qualname, facts.line)
    cfg = summary.cfgs.get(key)
    if cfg is None:
        cfg = build_cfg(facts.node)
        summary.cfgs[key] = cfg
    return cfg


# --------------------------------------------------------------------- cache

#: path -> (sha256 of file bytes, summary). Process-global: a warm run_lint
#: re-summarizes only files whose content changed.
_CACHE: Dict[str, Tuple[str, ModuleSummary]] = {}


def clear_index_cache() -> None:
    """Drop all cached summaries (benchmarks use this for cold-run timing)."""
    _CACHE.clear()


def build_index(
    files: "Sequence[Path]",
) -> "Tuple[ProjectIndex, List[Tuple[str, str]], Dict[str, int]]":
    """Build (or incrementally refresh) the project index over ``files``.

    Returns ``(index, parse_errors, stats)`` where ``stats`` counts cache
    ``hits``/``misses`` — the incremental contract the tier-1 perf gate and
    the benchmark lane both ride on.
    """
    summaries: List[ModuleSummary] = []
    errors: List[Tuple[str, str]] = []
    hits = 0
    misses = 0
    for path in files:
        key = str(path)
        try:
            data = path.read_bytes()
        except OSError as exc:
            errors.append((key, str(exc)))
            continue
        digest = hashlib.sha256(data).hexdigest()
        cached = _CACHE.get(key)
        if cached is not None and cached[0] == digest:
            summaries.append(cached[1])
            hits += 1
            continue
        misses += 1
        try:
            source = data.decode("utf-8")
            tree = ast.parse(source, filename=key)
        except (SyntaxError, ValueError, UnicodeDecodeError) as exc:
            errors.append((key, str(exc)))
            _CACHE.pop(key, None)
            continue
        summary = build_summary(path, source, tree)
        _CACHE[key] = (digest, summary)
        summaries.append(summary)
    return ProjectIndex(summaries), errors, {"hits": hits, "misses": misses}
