"""The port's static analyzer (``unionml_tpu_torch/analysis/``) on the CPU.

- The gate: ``run_lint(["unionml_tpu_torch"])`` is clean over at least 80
  files, every suppression it honours gives its reason on the line, and a
  second run over the unchanged tree parses nothing (its index misses 0).
- Parity with ``unionml_tpu/analysis/``: every case of
  ``tests/unit/test_analysis.py`` runs with each lint run it makes given to
  both analyzers (same paths, same options), and every source snippet of
  the case (and the case's own source) is linted by both as a file of its
  own. Findings (rule, path, line, column, message), suppressed findings,
  parse errors and the text, JSON and SARIF renderings must be equal once
  the package name is masked. Then both analyzers read ``unionml_tpu/``
  whole, with its suppressed findings.
- The four PyTorch readings (TPU001 host syncs in captured programs,
  TPU011 capture storms, TPU013 ``torch.distributed`` and the port's
  collectives under a lock, TPU014 ``torch`` draws without ``generator=``),
  each with cases that must flag and cases that must not.

The analyzer is the standard library only: no case needs a card.
"""

import ast
import inspect
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import unionml_tpu.analysis.engine as jax_engine
import unionml_tpu_torch.analysis.engine as port_engine
from tests.unit import test_analysis as jax_cases
from unionml_tpu_torch.analysis import run_lint
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

ROOT = Path(__file__).resolve().parents[1]
UNIT_FILE = ROOT / "tests" / "unit" / "test_analysis.py"


def _case_nodes():
    tree = ast.parse(UNIT_FILE.read_text())
    return {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")}


CASES = _case_nodes()


# ------------------------------------------------------------------ the gate


def test_port_tree_is_lint_clean(monkeypatch):
    monkeypatch.chdir(ROOT)
    result = run_lint(["unionml_tpu_torch"])
    assert result.errors == []
    assert result.findings == [], "\n".join(finding.render() for finding in result.findings)
    assert result.files >= 80
    for finding in result.suppressed:
        line = (ROOT / finding.path).read_text().splitlines()[finding.line - 1]
        reason = line.split("tpu-lint:", 1)[1].split("--", 1)
        assert len(reason) == 2 and reason[1].strip(), f"{finding.render()}: a suppression names its reason"
    warm = run_lint(["unionml_tpu_torch"])
    assert warm.clean and warm.files == result.files
    assert warm.index_stats["misses"] == 0
    assert warm.suppressed == result.suppressed


def test_module_entry_point_and_default_paths(tmp_path, monkeypatch):
    """``python -m unionml_tpu_torch.analysis``: exit codes 1 (findings),
    0 (clean), 2 (usage); with no PATHS ``main`` lints the installed port
    tree."""
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nA = int(os.environ['A'])\n")
    run = lambda *args: subprocess.run([sys.executable, "-m", "unionml_tpu_torch.analysis", *args],
                                       capture_output=True, text=True, cwd=tmp_path,
                                       env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    found = run("bad.py", "--format", "json")
    assert found.returncode == 1 and json.loads(found.stdout)["counts"] == {"TPU005": 1}
    assert run("bad.py", "--ignore", "TPU005").returncode == 0
    assert run("bad.py", "--select", "NOPE").returncode == 2
    seen = []
    monkeypatch.setattr(port_engine, "run_lint", lambda paths, **kwargs: seen.append(paths) or run_lint([bad]))
    assert port_engine.main(["--select", "TPU005"]) == 1
    assert seen == [[ROOT / "unionml_tpu_torch"]]


# -------------------------------------------------------------------- parity


def _masked(text):
    return text.replace("unionml_tpu_torch", "unionml_tpu")


def _fields(findings):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


def assert_same_report(jax_result, port_result):
    """The two analyzers' results are equal field for field, and so are
    their text (suppressed included), JSON and SARIF renderings."""
    assert _fields(port_result.findings) == _fields(jax_result.findings)
    assert _fields(port_result.suppressed) == _fields(jax_result.suppressed)
    assert port_result.errors == jax_result.errors
    assert port_result.files == jax_result.files
    assert _masked(port_engine.render_text(port_result, show_suppressed=True)) == jax_engine.render_text(
        jax_result, show_suppressed=True)
    assert _masked(port_engine.render_json(port_result)) == jax_engine.render_json(jax_result)
    assert _masked(port_engine.render_sarif(port_result)) == jax_engine.render_sarif(jax_result)


class BothAnalyzers:
    """``run_lint`` that lints with the JAX analyzer and the port's on the
    same arguments, holds the reports equal and returns the JAX one (so the
    JAX case's own assertions run unchanged)."""

    def __init__(self):
        self.jax_run_lint = jax_engine.run_lint
        self.compared = 0

    def __call__(self, paths, **kwargs):
        try:
            jax_result = self.jax_run_lint(paths, **kwargs)
        except Exception as exc:
            with pytest.raises(type(exc)) as port_exc:
                port_engine.run_lint(paths, **kwargs)
            assert _masked(str(port_exc.value)) == str(exc)
            self.compared += 1
            raise
        assert_same_report(jax_result, port_engine.run_lint(paths, **kwargs))
        self.compared += 1
        return jax_result


def _snippets(node):
    """The source snippets a case holds: its string constants that parse as
    Python modules of at least one statement, dedented as the case does."""
    out = []
    for child in ast.walk(node):
        if isinstance(child, ast.Constant) and isinstance(child.value, str) and "\n" in child.value:
            source = textwrap.dedent(child.value)
            try:
                parsed = ast.parse(source)
            except SyntaxError:
                continue
            if parsed.body:
                out.append(source)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_jax_unit_case_gives_equal_reports(case, tmp_path, monkeypatch, request):
    both = BothAnalyzers()
    monkeypatch.setattr(jax_engine, "run_lint", both)
    monkeypatch.setattr(jax_cases, "run_lint", both)
    fn = getattr(jax_cases, case)
    fn(**{name: request.getfixturevalue(name) for name in inspect.signature(fn).parameters})
    sources = _snippets(CASES[case]) + [ast.get_source_segment(UNIT_FILE.read_text(), CASES[case])]
    for i, source in enumerate(sources):
        snippet = tmp_path / "parity" / str(i) / "snippet.py"
        snippet.parent.mkdir(parents=True)
        snippet.write_text(source)
        both([snippet])
    assert both.compared >= len(sources)


def test_every_unit_case_is_a_parity_case():
    assert len(CASES) >= 96
    assert set(CASES) == {name for name in vars(jax_cases) if name.startswith("test_")}


def _tree_run(engine):
    return engine.run_lint(["unionml_tpu"])


@pytest.fixture(scope="module")
def jax_package_reports():
    """Both analyzers over ``unionml_tpu/`` (each builds its whole-program
    index once)."""
    import os

    here = os.getcwd()
    os.chdir(ROOT)
    try:
        return _tree_run(jax_engine), _tree_run(port_engine)
    finally:
        os.chdir(here)


def test_jax_package_findings_and_suppressed_equal(jax_package_reports):
    jax_result, port_result = jax_package_reports
    assert port_result.files == jax_result.files >= 80
    assert _fields(port_result.findings) == _fields(jax_result.findings)
    assert _fields(port_result.suppressed) == _fields(jax_result.suppressed)


@pytest.mark.parametrize("form", ["text-show-suppressed", "json", "sarif"])
def test_jax_package_renderings_equal(jax_package_reports, form):
    jax_result, port_result = jax_package_reports
    render = {
        "text-show-suppressed": lambda engine, result: engine.render_text(result, show_suppressed=True),
        "json": lambda engine, result: engine.render_json(result),
        "sarif": lambda engine, result: engine.render_sarif(result),
    }[form]
    assert _masked(render(port_engine, port_result)) == render(jax_engine, jax_result)


#: the port's analyzer modules that hold a PyTorch reading, or speak of the port in their docs
READ_FOR_THE_PORT = {"__init__.py", "engine.py", "project.py", "rules/_common.py", "rules/tpu001_host_sync.py",
                     "rules/tpu005_env.py", "rules/tpu011_recompile.py", "rules/tpu013_locked_collectives.py",
                     "rules/tpu014_unseeded_random.py"}
COPIED = sorted(p.relative_to(ROOT / "unionml_tpu" / "analysis").as_posix()
                for p in (ROOT / "unionml_tpu" / "analysis").rglob("*.py")
                if p.relative_to(ROOT / "unionml_tpu" / "analysis").as_posix() not in READ_FOR_THE_PORT)


@pytest.mark.parametrize("module", COPIED)
def test_module_without_a_reading_is_the_jax_module(module):
    """Every other module is the JAX package's, with only its own package
    name changed."""
    jax_source = (ROOT / "unionml_tpu" / "analysis" / module).read_text()
    port_source = (ROOT / "unionml_tpu_torch" / "analysis" / module).read_text()
    assert port_source == jax_source.replace("unionml_tpu.analysis", "unionml_tpu_torch.analysis")


def test_rule_registry_matches():
    from unionml_tpu.analysis.rules import RULES as JAX_RULES
    from unionml_tpu_torch.analysis.rules import RULES

    assert {k: v.title for k, v in RULES.items()} == {k: v.title for k, v in JAX_RULES.items()}
    assert len(RULES) == 19


# ---------------------------------------------------------- the PyTorch readings


def lint_tree(tmp_path, files, **kwargs):
    """Write ``{relative path: source}`` under ``tmp_path`` (packages get an
    ``__init__.py`` on every level) and lint the tree."""
    for rel, source in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        parent = path.parent
        while parent != tmp_path:
            (parent / "__init__.py").touch()
            parent = parent.parent
        path.write_text(textwrap.dedent(source))
    return run_lint([tmp_path], **kwargs)


def found(result, rule):
    return [(Path(f.path).name, f.line, f.message) for f in result.findings if f.rule == rule]


PORT_GENERATOR = """
    from pkg.helpers import to_host


    class Generator:
        def enable_aot(self, store, ctx):
            from unionml_tpu_torch.serving.aot import AOTFunction

            self._decode = AOTFunction(self._decode, "decode", store, ctx, static_argnames=("steps",))
            self._prefill = AOTFunction(self._prefill, "prefill", store, ctx)

        def _decode(self, carry, steps):
            return to_host(carry)

        def _prefill(self, tokens, start):
            return tokens
"""


def port_generator(methods=""):
    """:data:`PORT_GENERATOR` with ``methods`` added to its class."""
    return textwrap.dedent(PORT_GENERATOR) + textwrap.indent(textwrap.dedent(methods), "    ")


def test_tpu001_helper_across_modules_flags_in_its_module(tmp_path):
    """The port's shape: ``self._decode = AOTFunction(self._decode, ...)``
    reaches a helper of another module that calls ``.item()``: the finding
    is in the helper's module, on its line."""
    result = lint_tree(tmp_path, {
        "pkg/gen.py": PORT_GENERATOR,
        "pkg/helpers.py": """
            def to_host(x):
                return x.item()


            def unrelated(x):
                return x.item()
        """,
    }, select=["TPU001"])
    assert [(name, line) for name, line, _ in found(result, "TPU001")] == [("helpers.py", 3)]
    assert "captured program" in result.findings[0].message and ".item()" in result.findings[0].message


def test_tpu001_graph_block_and_module_wrap(tmp_path):
    """A ``with torch.cuda.graph(g):`` body and a module-level
    ``AOTFunction`` wrap are captured programs:
    ``.cpu()``, ``torch.cuda.synchronize()``, ``.tolist()``, ``.numpy()``
    and ``np.asarray`` flag there."""
    result = lint_tree(tmp_path, {
        "pkg/serving/step.py": """
            import numpy as np
            import torch

            from unionml_tpu_torch.serving.aot import AOTFunction


            def capture(g, x):
                with torch.cuda.graph(g):
                    y = x.cpu()
                    torch.cuda.synchronize()
                return y


            def _step(x):
                return np.asarray(x), x.tolist(), x.numpy()


            step = AOTFunction(_step, "step", None, {})
        """,
    }, select=["TPU001"])
    lines = [line for _, line, _ in found(result, "TPU001")]
    assert lines == [10, 11, 16, 16, 16]
    assert "torch.cuda.synchronize() waits for the device" in result.findings[1].message


def test_tpu001_jax_aot_store_and_host_code_stay_clean(tmp_path):
    """The JAX package's ``AOTFunction`` wraps a jitted executable and
    captures nothing; the reads a host function makes after calling a
    captured program are host code."""
    result = lint_tree(tmp_path, {
        "pkg/gen.py": """
            from unionml_tpu.serving.aot import AOTFunction


            class Generator:
                def enable_aot(self, store, ctx):
                    self._decode = AOTFunction(self._decode, "decode", store, ctx)

                def _decode(self, carry):
                    return carry.item()
        """,
        "pkg/host.py": """
            from unionml_tpu_torch.serving.aot import AOTFunction


            def _step(x):
                return x * 2


            step = AOTFunction(_step, "step", None, {})


            def serve(x):
                out = step(x)
                return out.item(), out.cpu().tolist(), out.numpy()
        """,
    }, select=["TPU001"])
    assert result.findings == []


def test_tpu001_sync_with_arguments_stays_clean(tmp_path):
    """``.cpu(...)``/``.numpy(...)`` with arguments are someone else's API,
    as the JAX rule's zero-argument methods are."""
    result = lint_tree(tmp_path, {
        "pkg/gen.py": """
            from unionml_tpu_torch.serving.aot import AOTFunction


            def _step(x, pool):
                return pool.cpu(x), pool.numpy(x)


            step = AOTFunction(_step, "step", None, {})
        """,
    }, select=["TPU001"])
    assert result.findings == []


def test_tpu011_loop_variable_in_a_static_position(tmp_path):
    result = lint_tree(tmp_path, {"pkg/gen.py": port_generator("""
        def decode_all(self, carry):
            for n in range(4):
                carry = self._decode(carry, steps=n)
            return carry
    """)}, select=["TPU011"])
    messages = [message for _, _, message in found(result, "TPU011")]
    assert len(messages) == 1
    assert "loop variable 'n'" in messages[0] and "static argument 'steps'" in messages[0]
    assert "captured program 'self._decode'" in messages[0] and "CUDA graph" in messages[0]


def test_tpu011_per_call_scalars_in_any_position(tmp_path):
    """``len()`` of a parameter, a ``time.*`` draw and an f-string flag in a
    position that is not static: a captured program keys every Python
    scalar by its value."""
    result = lint_tree(tmp_path, {
        "pkg/serve.py": """
            import time

            from unionml_tpu_torch.serving.aot import AOTFunction


            def _prefill(tokens, start, tag=None):
                return tokens


            prefill = AOTFunction(_prefill, "prefill", None, {})


            def admit(tokens, prompt):
                prefill(tokens, len(prompt))
                prefill(tokens, time.monotonic())
                prefill(tokens, 0, tag=f"req-{prompt}")
        """,
    }, select=["TPU011"])
    messages = [message for _, _, message in found(result, "TPU011")]
    assert len(messages) == 3
    assert "len() of parameter 'prompt'" in messages[0] and "argument 1" in messages[0]
    assert "'time.monotonic()'" in messages[1]
    assert "an f-string" in messages[2] and "argument 'tag'" in messages[2]


def test_tpu011_tensors_in_loops_and_bucketed_scalars_stay_clean(tmp_path):
    """A loop variable in a dynamic position may be a tensor, and constants,
    config attributes and forwarded parameters are not provably varying;
    nor is anything given to the JAX store's ``AOTFunction``, which keys a
    dynamic scalar by its type."""
    result = lint_tree(tmp_path, {"pkg/gen.py": port_generator("""
        def run(self, chunks, carry, start):
            for chunk in chunks:
                self._prefill(chunk, start)
            return self._decode(carry, steps=self.config.max_new_tokens - 1)
    """),
        "pkg/jax_store.py": """
            from unionml_tpu.serving.aot import AOTFunction


            def _prefill(tokens, start):
                return tokens


            prefill = AOTFunction(_prefill, "prefill", None, {})


            def admit(tokens, prompt):
                return prefill(tokens, len(prompt))
        """,
    }, select=["TPU011"])
    assert result.findings == []


def test_tpu013_plan_broadcast_under_the_lock(tmp_path):
    """The port's shape (``serving/mesh.py``'s ``StepPlan.record``):
    ``dist.broadcast_object_list`` under ``with self._lock:``."""
    result = lint_tree(tmp_path, {
        "pkg/mesh.py": """
            import threading

            import torch.distributed as dist


            class StepPlan:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._pending = []

                def record(self, op):
                    with self._lock:
                        self._pending.append(op)
                        dist.broadcast_object_list([self._pending], src=0)
                        self._pending = []
        """,
    }, select=["TPU013"])
    messages = [message for _, _, message in found(result, "TPU013")]
    assert len(messages) == 1
    assert messages[0].startswith("'dist.broadcast_object_list' blocks on another PROCESS while record()")


def test_tpu013_torch_distributed_and_port_collectives(tmp_path):
    """``torch.distributed.all_reduce`` in a ``*_locked`` method, and the
    port's own collectives (imported from their module, or from the
    ``parallel`` package) under the lock."""
    result = lint_tree(tmp_path, {
        "pkg/engine.py": """
            import threading

            import torch
            from unionml_tpu_torch.parallel import all_gather as gather
            from unionml_tpu_torch.parallel.collectives import allreduce_sum


            class Engine:
                def __init__(self, mesh):
                    self._lock = threading.RLock()
                    self.mesh = mesh

                def _sync_locked(self, t):
                    torch.distributed.all_reduce(t)

                def step(self, x):
                    with self._lock:
                        y = allreduce_sum(x, self.mesh, "model")
                        return gather(y, self.mesh, "model")
        """,
    }, select=["TPU013"])
    labels = [message.split("'")[1] for _, _, message in found(result, "TPU013")]
    assert labels == ["torch.distributed.all_reduce", "allreduce_sum", "gather"]


def test_tpu013_outside_the_lock_and_non_rendezvous_calls_stay_clean(tmp_path):
    """A snapshot taken under the lock and broadcast after it; a rank query
    under the lock; the port's collectives whose forward is local
    (``sum_gradients``, ``split_to``); and a same-named function of another
    module."""
    result = lint_tree(tmp_path, {
        "pkg/plan.py": """
            import threading

            import torch.distributed as dist
            from unionml_tpu_torch.parallel.collectives import split_to, sum_gradients
            from pkg.mine import allreduce_sum


            class StepPlan:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._pending = []

                def record(self, op, x, mesh):
                    with self._lock:
                        self._pending.append(op)
                        batch, self._pending = self._pending, []
                        rank = dist.get_rank()
                        x = sum_gradients(split_to(x, mesh, "model"), mesh, "model")
                        allreduce_sum(x)
                    dist.broadcast_object_list([batch], src=0)
                    return rank, x
        """,
        "pkg/mine.py": "def allreduce_sum(x):\n    return x\n",
    }, select=["TPU013"])
    assert result.findings == []


def test_tpu014_torch_draws_in_workloads_and_benchmarks(tmp_path):
    result = lint_tree(tmp_path, {
        "unionml_tpu_torch/workloads/gen.py": """
            import torch


            def traffic(n):
                lengths = torch.randint(1, 64, (n,))
                order = torch.randperm(n)
                return torch.randn(n, 4), lengths, order
        """,
        "benchmarks/bench_sample.py": """
            import torch


            def sample(p, x):
                return torch.multinomial(p, 1), torch.rand_like(x), torch.bernoulli(p)
        """,
    }, select=["TPU014"])
    flagged = [(name, message.split(" ", 1)[0]) for name, _, message in found(result, "TPU014")]
    assert flagged == [("bench_sample.py", "torch.multinomial"), ("bench_sample.py", "torch.rand_like"),
                       ("bench_sample.py", "torch.bernoulli"), ("gen.py", "torch.randint"),
                       ("gen.py", "torch.randperm"), ("gen.py", "torch.randn")]
    assert "generator=" in result.findings[0].message


def test_tpu014_seeded_generators_and_out_of_scope_stay_clean(tmp_path):
    result = lint_tree(tmp_path, {
        "unionml_tpu_torch/workloads/gen.py": """
            import torch


            def traffic(n, seed):
                g = torch.Generator().manual_seed(seed)
                lengths = torch.randint(1, 64, (n,), generator=g)
                return torch.randn(n, 4, generator=g), lengths, torch.zeros(n)
        """,
        "unionml_tpu_torch/serving/ids.py": """
            import torch


            def request_noise(n):
                return torch.randn(n)
        """,
    }, select=["TPU014"])
    assert result.findings == []
