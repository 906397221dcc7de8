"""The port's CLI (``unionml_tpu_torch/cli.py``, ``templating.py``,
``resolver.py``) on the CPU.

The local cases of ``tests/unit/test_cli.py`` run against the port (see
``test_torch_serving_units.py``): the templating cases, the ``serve``
model-path guards and the ``--reload`` source snapshot. ``CliRunner`` is a
shim whose ``invoke(app, args)`` calls the port's ``app(args)`` and gathers
stdout and stderr into ``.output`` and the ``SystemExit`` code into
``.exit_code``; the ``cli_project`` fixture is the same app over the port's
``Dataset``/``Model``, with its backend store under the test's directory:
the remote round trip (``:48``: ``deploy``, ``train``,
``list-model-versions``, ``predict``, ``fetch-model`` through
``job_runner`` workers) and ``replay``'s ``--fault-plan`` check (``:168``)
run here too; ``test_templating_list_and_validate`` asks for the JAX
package's templates, so its copy here expects the port's four.

The cluster and fault-tolerance cases (``:90``, ``:128``) become export
checks: the fleet's seven flags, like the in-process replica fleet's, are
exported as the JAX CLI exports them (both CLIs run on the same arguments),
before the app module is imported, and their bad values are usage errors.
``lint`` runs the port's analyzer: the same temporary tree goes through
the JAX CLI's ``lint`` (click's ``CliRunner``) and the port's, with the same
exit code and the same JSON (or SARIF, or text) for ``--format``,
``--select``, ``--ignore``, ``--show-suppressed``, a ``--baseline`` /
``--update-baseline`` round trip, ``--changed-only`` in a git checkout and
a usage error.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

from tests.test_torch_serving_units import port_cases

CASES = (
    "test_init_renders_template",
    "test_init_rejects_existing_dir",
    "test_render_template_unknown",
    "test_serve_rejects_preset_env",
    "test_serve_requires_existing_model_path",
    "test_app_source_files_snapshot",
    "test_deploy_train_predict_roundtrip",
    "test_replay_fault_plan_requires_self_host",
)

port_cases(globals(), "test_cli.py")
for _name in [n for n in globals() if n.startswith("test_") and n not in CASES]:
    del globals()[_name]

from unionml_tpu_torch.cli import _reload_argv, app  # noqa: E402
from unionml_tpu_torch.templating import list_templates, render_template, validate_app_name  # noqa: E402


class CliRunner:
    """``click.testing.CliRunner`` over the port's argparse ``app``."""

    def invoke(self, command, args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            try:
                command(list(args))
                code = 0
            except SystemExit as exc:
                code = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
        return types.SimpleNamespace(output=out.getvalue(), exit_code=code)


#: ``tests/conftest.py``'s CLI app on the port's Dataset/Model
CLI_APP_SOURCE = textwrap.dedent(
    """
    from typing import List

    import pandas as pd
    from sklearn.linear_model import LogisticRegression

    from unionml_tpu_torch import Dataset, Model

    dataset = Dataset(name="ds", test_size=0.2, shuffle=True, targets=["y"])
    model = Model(name="cli_test_model", init=LogisticRegression, dataset=dataset)
    model.__app_module__ = "cli_app:model"


    @dataset.reader
    def reader(n: int = 60) -> pd.DataFrame:
        rows = []
        for i in range(n):
            rows.append({"x0": float(i % 7), "x1": float((i * 3) % 5), "y": i % 2})
        return pd.DataFrame(rows)


    @model.trainer
    def trainer(est: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
        return est.fit(features, target.squeeze())


    @model.predictor
    def predictor(est: LogisticRegression, features: pd.DataFrame) -> List[float]:
        return [float(v) for v in est.predict(features)]
    """
)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cli_project(tmp_path, monkeypatch):
    """A committed git project holding the port's CLI app (and, as
    ``boom_app.py``, an app module that raises when imported), and an
    isolated backend store."""
    (tmp_path / "cli_app.py").write_text(CLI_APP_SOURCE)
    (tmp_path / "boom_app.py").write_text('raise RuntimeError("the app module was imported")\n')
    subprocess.run(["git", "init", "-q"], cwd=tmp_path, check=True)
    subprocess.run(["git", "add", "."], cwd=tmp_path, check=True)
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", "commit", "-q", "-m", "init"],
                   cwd=tmp_path, check=True)
    monkeypatch.setenv("UNIONML_TPU_STORE", str(tmp_path / "store"))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path), _REPO_ROOT]))
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield tmp_path
    sys.modules.pop("cli_app", None)
    sys.modules.pop("boom_app", None)


TEMPLATES = ["basic", "basic-serverless", "image-classification", "text-generation"]


def test_templating_list_and_validate():
    """The unit case's checks, over the port's four templates (the JAX
    package's, ``basic-serverless`` included)."""
    assert set(list_templates()) == {"basic", "basic-serverless", "image-classification", "text-generation"}
    validate_app_name("my-app_1")
    with pytest.raises(ValueError):
        validate_app_name("1bad")
    with pytest.raises(ValueError):
        validate_app_name("bad name")


def test_templates_command_lists_both_and_init_renders_each(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = CliRunner().invoke(app, ["templates"])
    assert result.exit_code == 0 and result.output.split() == TEMPLATES
    for template in TEMPLATES:
        result = CliRunner().invoke(app, ["init", f"app-{template}", "-t", template])
        assert result.exit_code == 0, result.output
        project = tmp_path / f"app-{template}"
        assert f"app-{template}" in (project / "README.md").read_text()
        assert "python -m unionml_tpu_torch.cli serve" in (project / "README.md").read_text()
        for path in project.rglob("*"):
            assert "__pycache__" not in path.parts
            if path.is_file() and ".git" not in path.parts:
                assert "{{app_name}}" not in path.read_text()
    assert "unionml_tpu_torch.cli" in (tmp_path / "app-basic" / "Dockerfile").read_text()


def test_help_version_and_usage_codes():
    """``--help`` exits 0; an unknown option or a missing argument is a
    usage error (2, as click's); a check that fails exits 1."""
    runner = CliRunner()
    assert runner.invoke(app, ["--help"]).exit_code == 0
    assert runner.invoke(app, ["serve", "--help"]).exit_code == 0
    assert runner.invoke(app, ["--version"]).exit_code == 0
    assert runner.invoke(app, ["serve", "x:model", "--no-such-option"]).exit_code == 2
    assert runner.invoke(app, ["serve"]).exit_code == 2
    assert runner.invoke(app, ["serve", "x:model", "--quantize", "int4"]).exit_code == 2
    result = runner.invoke(app, ["init", "1bad"])
    assert result.exit_code == 1 and result.output.startswith("Error: ")


USAGE = "usage"
#: (serve flags, None: a flag of a ported part, exported as the JAX CLI
#: exports it; USAGE: a usage error in both CLIs)
REFUSED_FLAGS = [
    (["--dp-replicas", "2"], None),
    (["--replica-roles", "prefill=1,decode=1"], None),
    (["--prefill-threshold", "8"], None),
    (["--autoscale-high", "0.8"], None),
    (["--autoscale-low", "0.1"], None),
    (["--autoscale-interval", "1.0"], None),
    (["--min-replicas", "1"], None),
    (["--max-replicas", "2"], None),
    (["--num-hosts", "2"], USAGE),
    (["--coordinator", "127.0.0.1:9"], None),
    (["--process-id", "0"], None),
    (["--fault-plan", '{"events": []}'], None),
    (["--probe-interval", "0.5"], None),
    (["--probation-probes", "3"], None),
    (["--lease-ttl", "2.0"], None),
    (["--compile-cache", "cache-dir"], None),
    (["--aot-preload"], None),
    (["--aot-preload", "store-dir"], None),
]
#: the cold-start stores' exports (ported: exported as the JAX CLI exports them)
STORE_EXPORTS = ("UNIONML_TPU_COMPILE_CACHE", "UNIONML_TPU_AOT_PRELOAD")
#: the replica fleet's exports, and the multi-host fleet's
REPLICA_EXPORTS = ("UNIONML_TPU_DP_REPLICAS", "UNIONML_TPU_REPLICA_ROLES", "UNIONML_TPU_PREFILL_THRESHOLD",
                   "UNIONML_TPU_AUTOSCALE_HIGH", "UNIONML_TPU_AUTOSCALE_LOW", "UNIONML_TPU_AUTOSCALE_INTERVAL_S",
                   "UNIONML_TPU_MIN_REPLICAS", "UNIONML_TPU_MAX_REPLICAS",
                   "UNIONML_TPU_NUM_PROCESSES", "UNIONML_TPU_COORDINATOR", "UNIONML_TPU_PROCESS_ID",
                   "UNIONML_TPU_FAULT_PLAN", "UNIONML_TPU_PROBE_INTERVAL_S", "UNIONML_TPU_PROBATION_PROBES",
                   "UNIONML_TPU_LEASE_TTL_S")
#: knobs of ported parts given beside a refused flag: a refusal must leave every one unexported
EXPORTS = {
    "UNIONML_TPU_ADMIT_CHUNK": ["--admit-chunk", "8"],
    "UNIONML_TPU_PREFIX_CACHE": ["--prefix-cache"],
    "UNIONML_TPU_QUANTIZE": ["--quantize", "int8"],
    "UNIONML_TPU_TRACE": ["--trace"],
    "UNIONML_TPU_SLO_TTFT_P95_MS": ["--slo-ttft-p95-ms", "100"],
    "UNIONML_TPU_DP_REPLICAS": [],
    "UNIONML_TPU_COMPILE_CACHE": [],
    "UNIONML_TPU_AOT_PRELOAD": [],
}


@pytest.fixture
def clean_exports(monkeypatch):
    import jax

    from unionml_tpu_torch import _build

    for name in [*EXPORTS, *REPLICA_EXPORTS, "UNIONML_MODEL_PATH", "UNIONML_TPU_LOGLEVEL"]:
        monkeypatch.delenv(name, raising=False)
    # --compile-cache points both packages' caches at a directory in this process: put them back
    build_dir, jax_cache = _build.build_dir(), jax.config.jax_compilation_cache_dir
    yield
    for name in [*EXPORTS, *REPLICA_EXPORTS, "UNIONML_MODEL_PATH", "UNIONML_TPU_LOGLEVEL"]:
        # plain pop: the CLI set these after the delenv, and monkeypatch would restore nothing for them
        os.environ.pop(name, None)
    _build.set_build_dir(build_dir)
    jax.config.update("jax_compilation_cache_dir", jax_cache)


@pytest.mark.parametrize("flags,item", REFUSED_FLAGS, ids=[" ".join(f) for f, _ in REFUSED_FLAGS])
def test_refused_serve_flag_exits_before_export_and_import(cli_project, clean_exports, flags, item):
    """A flag of a ported part (the replica fleet, the multi-host fleet and
    its fault injection, the cold-start stores; ``item`` None) is exported
    as the JAX CLI exports it, and then the app module is imported;
    ``--num-hosts 2`` without a rendezvous address is a usage error in both
    CLIs. (No serve flag is refused any more: ``--remote`` is ported.)"""
    model_file = cli_project / "m.joblib"
    model_file.write_text("x")
    if item == USAGE:
        from click.testing import CliRunner as ClickRunner

        from unionml_tpu.cli import app as jax_app

        args = ["serve", "boom_app:model", *flags, "--model-path", str(model_file)]
        jax_result, result = ClickRunner().invoke(jax_app, args), CliRunner().invoke(app, args)
        assert jax_result.exit_code == result.exit_code == 1, (jax_result.output, result.output)
        assert "--num-hosts > 1 needs --coordinator HOST:PORT" in jax_result.output
        assert "--num-hosts > 1 needs --coordinator HOST:PORT" in result.output
        assert "boom_app" not in sys.modules
        for name in REPLICA_EXPORTS:
            assert name not in os.environ, name
        return
    if item is None:
        from click.testing import CliRunner as ClickRunner

        from unionml_tpu.cli import app as jax_app

        exports = REPLICA_EXPORTS + STORE_EXPORTS
        args = ["serve", "boom_app:model", *flags, "--model-path", str(model_file)]
        result = ClickRunner().invoke(jax_app, args)
        assert "the app module was imported" in str(result.exception), result.output
        jax_exported = {name: os.environ.pop(name, None) for name in exports}
        os.environ.pop("UNIONML_MODEL_PATH", None)
        with pytest.raises(RuntimeError, match="the app module was imported"):
            app(args)
        assert {name: os.environ.get(name) for name in exports} == jax_exported
        assert sum(value is not None for value in jax_exported.values()) == 1
        return
    raise AssertionError(f"unknown case {item!r}")


#: a lint tree: findings of TPU005 and TPU006, a suppressed TPU005, a clean file
LINT_TREE = {
    "lintpkg/env.py": "import os\n\nA = int(os.environ['A'])\nB = float(os.environ['B'])  # tpu-lint: disable=TPU005 -- test\n",
    "lintpkg/clock.py": "import time\n\n\ndef elapsed(t0):\n    return time.time() - t0\n",
    "lintpkg/clean.py": "X = 1\n",
}
LINT_CASES = {
    "json": [["--format", "json"]],
    "sarif": [["--format", "sarif"]],
    "text-show-suppressed": [["--show-suppressed"]],
    "select": [["--format", "json", "--select", "TPU005"]],
    "ignore": [["--format", "json", "--ignore", "TPU005,TPU006"]],
    "baseline": [["--format", "json", "--baseline", "base.json", "--update-baseline"],
                 ["--format", "json", "--baseline", "base.json"]],
    "changed-only": [["--format", "json", "--changed-only"], ["--format", "json", "--changed-only", "HEAD"]],
    "unknown-rule": [["--select", "TPU999"]],
}


@pytest.mark.parametrize("case", list(LINT_CASES))
def test_lint_matches_the_jax_cli(cli_project, case):
    """Each run of a case goes through both CLIs on the same tree; a
    baseline file written by one is removed before the other writes its
    own, and the two files must be equal. ``changed-only`` commits the
    tree, then edits one file: only that file is reported."""
    from click.testing import CliRunner as ClickRunner

    from unionml_tpu.cli import app as jax_app

    for rel, source in LINT_TREE.items():
        (cli_project / rel).parent.mkdir(exist_ok=True)
        (cli_project / rel).write_text(source)
    if case == "changed-only":
        subprocess.run(["git", "add", "lintpkg"], check=True)
        subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", "commit", "-q", "-m", "lint"], check=True)
        (cli_project / "lintpkg/clean.py").write_text("import os\nX = int(os.environ['X'])\n")
    codes = set()
    for extra in LINT_CASES[case]:
        args = ["lint", "lintpkg", *extra]
        jax_result = ClickRunner().invoke(jax_app, args)
        jax_base = (cli_project / "base.json").read_text() if (cli_project / "base.json").exists() else None
        if "--update-baseline" in extra:
            (cli_project / "base.json").unlink()
        result = CliRunner().invoke(app, args)
        assert result.exit_code == jax_result.exit_code, (result.output, jax_result.output)
        codes.add(result.exit_code)
        if "--update-baseline" in extra:
            assert (cli_project / "base.json").read_text() == jax_base
        if case == "unknown-rule":
            assert "unknown rule id(s) in --select: TPU999" in result.output
        elif "json" in extra or "sarif" in extra:
            assert json.loads(result.output) == json.loads(jax_result.stdout)
        else:
            assert result.output == jax_result.stdout
    expected = {"json": {1}, "sarif": {1}, "text-show-suppressed": {1}, "select": {1}, "ignore": {0},
                "baseline": {0}, "changed-only": {1}, "unknown-rule": {2}}[case]
    assert codes == expected
    if case == "changed-only":
        assert {f["path"] for f in json.loads(result.output)["findings"]} == {"lintpkg/clean.py"}


def test_ported_knobs_export_before_the_app_imports(cli_project, clean_exports):
    """One engine (``--dp-replicas 1``), the off value of the compile
    cache (``--compile-cache 0``) and the ported knobs are exported, and
    only then is the app module imported (it raises here)."""
    knobs = [arg for args in EXPORTS.values() for arg in args]
    with pytest.raises(RuntimeError, match="the app module was imported"):
        app(["serve", "boom_app:model", "--dp-replicas", "1", "--compile-cache", "0", *knobs])
    assert os.environ["UNIONML_TPU_DP_REPLICAS"] == "1"
    assert os.environ["UNIONML_TPU_COMPILE_CACHE"] == "0"
    assert os.environ["UNIONML_TPU_ADMIT_CHUNK"] == "8"
    assert os.environ["UNIONML_TPU_PREFIX_CACHE"] == "1"
    assert os.environ["UNIONML_TPU_QUANTIZE"] == "int8"
    assert os.environ["UNIONML_TPU_TRACE"] == "1"
    assert os.environ["UNIONML_TPU_SLO_TTFT_P95_MS"] == "100.0"


@pytest.mark.parametrize("flags,message", [
    (["--admit-chunk", "-1"], "--admit-chunk must be >= 0"),
    (["--max-admissions", "-2"], "--max-admissions must be >= 0"),
    (["--slo-shed-ratio", "-0.5"], "--slo-shed-ratio must be >= 0"),
    (["--flight-recorder-size", "0"], "--flight-recorder-size must be >= 1"),
    (["--default-tenant-rate", "-1"], "--default-tenant-rate must be >= 0"),
    (["--tenant-config", "no-such-tenants.json"], "does not exist"),
    (["--dp-replicas", "-1"], "--dp-replicas must be >= 0"),
    (["--replica-roles", "turbo=1"], "--replica-roles: bad replica-role entry"),
    (["--prefill-threshold", "-1"], "--prefill-threshold must be >= 0"),
    (["--autoscale-high", "-0.5"], "--autoscale-high must be >= 0"),
    (["--min-replicas", "0"], "--min-replicas must be >= 1"),
    (["--max-replicas", "-1"], "--max-replicas must be >= 0"),
    (["--num-hosts", "0"], "--num-hosts must be >= 1"),
    (["--num-hosts", "2", "--coordinator", "127.0.0.1:9", "--process-id", "2"], "--process-id must be in [0, 2)"),
    (["--fault-plan", "{bad"], "--fault-plan: fault plan is not valid JSON"),
    (["--fault-plan", '{"events": [{"t": 0, "kind": "meteor"}]}'], "--fault-plan: unknown fault kind"),
    (["--probe-interval", "0"], "--probe-interval must be > 0 seconds"),
    (["--probation-probes", "0"], "--probation-probes must be >= 1"),
    (["--lease-ttl", "0"], "--lease-ttl must be > 0 seconds"),
])
def test_bad_knob_values_are_usage_errors(cli_project, clean_exports, flags, message):
    result = CliRunner().invoke(app, ["serve", "boom_app:model", *flags])
    assert result.exit_code == 1 and message in result.output
    assert "boom_app" not in sys.modules


def test_workers_refused_once_startup_initialized_cuda(cli_project, clean_exports, monkeypatch):
    """``--workers 2`` forks after ``startup()``; CUDA does not survive a
    fork, so an app whose startup initialized it exits 1 before forking
    (the card's state is simulated here)."""
    import torch

    import cli_app

    cli_app.model.train(hyperparameters={"max_iter": 500})
    model_file = cli_project / "model.joblib"
    cli_app.model.save(str(model_file))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(os, "fork", lambda: pytest.fail("forked"))
    result = CliRunner().invoke(app, ["serve", "cli_app:model", "--model-path", str(model_file), "--workers", "2"])
    assert result.exit_code == 1
    assert "--workers 2" in result.output and "does not survive a fork" in result.output


def test_reload_reexecs_the_module_without_reload_and_model_path():
    argv = ["serve", "app:model", "--reload", "--model-path", "m.ckpt", "--port", "9", "--model-path=x"]
    assert _reload_argv(argv) == [sys.executable, "-m", "unionml_tpu_torch.cli", "serve", "app:model", "--port", "9"]


def test_cli_module_imports_no_click():
    """The card's machine has no ``click``: the port's CLI runs without it."""
    code = ("import sys; sys.modules['click'] = None; from unionml_tpu_torch.cli import app\n"
            "try:\n    app(['templates'])\nexcept SystemExit as e:\n    assert e.code == 0")
    env = dict(os.environ, PYTHONPATH=_REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == TEMPLATES
