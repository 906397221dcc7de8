"""The port's remote backend (``remote.py``, ``job_runner.py``) on the CPU.

The cases of ``tests/unit/test_remote.py`` run against the port (see
``test_torch_serving_units.py``), their ``APP_SOURCE`` importing
``unionml_tpu_torch``: train without a deploy, a patch deploy, the dirty
tree, a failed execution's logs, fault injection with and without retries
and a stale heartbeat's resubmission. Its deploy/train/predict round trip
runs below beside the JAX backend's, and its TPU launcher cases become the
GPU ones of ``test_torch_launchers.py``.

Then:

- the unit file's deploy/train/predict round trip through both packages'
  backends on the same sklearn app: equal predictions and metrics;
- a 2-worker execution, two ``job_runner`` processes in one gloo group,
  whose tiny-Llama LoRA adapters equal the world of one's within 1e-6 (the
  counterpart of ``tests/emulated/test_multihost.py:124``): a step-mode app
  asks for the CPU with ``{"device": "cpu"}``, and without it a worker with
  no card fails the execution;
- the CLI round trip on the torch ``text-generation`` template (the
  counterpart of ``tests/unit/test_cli.py:48``): ``deploy``, ``train``,
  ``list-model-versions``, ``predict``, ``fetch-model``, then ``serve
  --remote`` booting on the registry's artifact and streaming a ``@word``.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.test_torch_serving_units import port_cases

torch.set_num_threads(2)

#: the unit file's cases on the port's backend
CASES = (
    "test_train_without_deploy_raises",
    "test_patch_deploy_suffixes_version",
    "test_get_app_version_clean_and_dirty",
    "test_failed_execution_surfaces_logs",
    "test_backend_config_store_path",
    "test_fault_injected_train_recovers_with_retries",
    "test_fault_without_retries_raises",
    "test_stale_heartbeat_marks_lost_and_resubmits",
)

port_cases(globals(), "test_remote.py")
for _name in [n for n in globals() if n.startswith("test_") and n not in CASES]:
    del globals()[_name]

from tests.test_torch_cli_live import _post, _served  # noqa: E402
from tests.unit.test_remote import APP_SOURCE as JAX_APP_SOURCE  # noqa: E402
from unionml_tpu_torch.cli import app as cli  # noqa: E402
from unionml_tpu_torch.remote import Execution  # noqa: E402
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

_REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
FEATURES = [{"x1": 2.0, "x2": -2.0}, {"x1": -2.0, "x2": 2.0}] + [
    {"x1": float(a), "x2": float(b)} for a, b in np.random.RandomState(0).normal(size=(6, 2))]


def _import_app(app_dir, name, source):
    import importlib

    (app_dir / f"{name}.py").write_text(source)
    if str(app_dir) not in sys.path:
        sys.path.insert(0, str(app_dir))
    module = importlib.import_module(name)
    return importlib.reload(module)


def test_round_trip_predictions_equal_the_jax_backends(tmp_path, monkeypatch):
    """The unit file's app, renamed per package, through each backend."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    got = {}
    for package, name in (("unionml_tpu", "remote_app_jax"), ("unionml_tpu_torch", "remote_app_port")):
        source = JAX_APP_SOURCE.replace("from unionml_tpu import", f"from {package} import").replace(
            '"remote_app:model"', f'"{name}:model"')
        model = _import_app(tmp_path, name, source).model
        model.remote(backend_store=str(tmp_path / f"store_{package}"))
        assert model.remote_deploy(app_version="v1") == "v1"
        artifact = model.remote_train(hyperparameters={"max_iter": 200}, wait=True)
        got[package] = (artifact.metrics, model.remote_predict(features=FEATURES), model.remote_list_model_versions())
    (jax_metrics, jax_predictions, jax_versions), (metrics, predictions, versions) = got.values()
    assert predictions == jax_predictions and len(predictions) == len(FEATURES) and predictions[:2] == [1.0, 0.0]
    assert metrics == jax_metrics and metrics["train"] > 0.8
    assert len(versions) == len(jax_versions) == 1 and versions[0].startswith("train-")


LORA_APP = textwrap.dedent(
    """
    import numpy as np
    import torch

    from unionml_tpu_torch import Dataset, Model, TrainerConfig, TrainState, make_train_step
    from unionml_tpu_torch.models import Llama, LlamaConfig, causal_lm_loss, lora_optimizer

    torch.set_num_threads(1)
    config = LlamaConfig.tiny(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64,
                              max_seq_len=32, lora_rank=4, dtype=torch.float32, param_dtype=torch.float32)
    dataset = Dataset(name="tokens", test_size=0.2, shuffle=False)
    model = Model(name="lora_app", dataset=dataset)
    model.__app_module__ = "lora_app:model"


    @dataset.reader
    def reader(n: int = 10, seq: int = 16) -> np.ndarray:
        return np.random.RandomState(0).randint(1, 64, size=(n, seq)).astype(np.int64)


    @model.init
    def init(hyperparameters: dict) -> TrainState:
        module = Llama(config, device=hyperparameters.get("device"), seed=0)
        with torch.no_grad():  # nonzero adapters, so both factors take gradients from the first step
            gen = torch.Generator().manual_seed(1)
            for name, param in module.named_parameters():
                if name.endswith("lora_b"):
                    param.copy_(torch.randn(param.shape, generator=gen) * 0.05)
        lora_optimizer(module)  # freezes the base weights
        # SGD: an update linear in the gradient, which the world of two must reproduce
        return TrainState(module, torch.optim.SGD([p for p in module.parameters() if p.requires_grad], lr=0.5))


    _step = make_train_step(causal_lm_loss)


    @model.trainer(config=TrainerConfig(epochs=2, batch_size=4, shuffle=False))
    def trainer(state: TrainState, batch) -> tuple:
        return _step(state, batch)
    """
)


def _adapters(model):
    state = model.artifact.model_object
    return {name: p.detach().clone() for name, p in state.model.named_parameters() if "lora" in name}


def test_two_worker_execution_equals_the_world_of_one(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    model = _import_app(tmp_path, "lora_app", LORA_APP).model
    fresh = model._init(hyperparameters={"device": "cpu"})
    initial = {name: p.detach().clone() for name, p in fresh.model.named_parameters() if "lora" in name}
    trained = {}
    for n_workers in (1, 2):
        model.remote(backend_store=str(tmp_path / f"store{n_workers}"), n_workers=n_workers)
        model.remote_deploy(app_version="lora-v1")
        execution = model.remote_train(wait=False, hyperparameters={"device": "cpu"})
        assert len(execution.procs) == n_workers
        model.remote_wait(execution, timeout=300)
        assert execution.status == "SUCCEEDED", (pathlib.Path(execution.path) / "logs.txt").read_text()[-2000:]
        model.remote_load(execution)
        trained[n_workers] = _adapters(model)
        logs = [pathlib.Path(execution.path) / ("logs.txt" if w == 0 else f"logs.{w}.txt") for w in range(n_workers)]
        assert all(log.exists() for log in logs)
        report = json.loads(logs[0].read_text().split("job_runner: report ", 1)[1].splitlines()[0])
        assert report["peak_memory_gib"] is None and report["launches"]["flash_forward"] == 0
        if n_workers == 2:
            assert "joined torch.distributed process group: rank 0/2 over gloo" in logs[0].read_text()
            assert not (pathlib.Path(execution.path) / "outputs" / "predictions.pkl").exists()
    assert set(trained[1]) == set(initial) and len(initial) > 0
    for name, value in trained[1].items():
        assert not torch.equal(value, initial[name]), name  # both factors trained
        torch.testing.assert_close(trained[2][name], value, rtol=0, atol=1e-6)
    # the same step-mode job without {"device": "cpu"}: no card here, so the worker fails the execution
    execution = model.remote_train(wait=False, hyperparameters={})
    with pytest.raises(RuntimeError, match="FAILED"):
        model.remote_wait(execution, timeout=120)
    assert "no CUDA device for the train job of lora_app:model" in (pathlib.Path(execution.path) / "logs.txt").read_text()


def _cli(*args):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        try:
            cli(list(args))
            code = 0
        except SystemExit as exc:
            code = exc.code
    return code, out.getvalue()


def test_cli_round_trip_on_the_text_generation_template(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    code, out = _cli("init", "genapp", "--template", "text-generation")
    assert code == 0, out
    project = tmp_path / "genapp"
    assert subprocess.run(["git", "rev-parse", "HEAD"], cwd=project, capture_output=True).returncode == 0  # init committed
    store = tmp_path / "store"
    monkeypatch.setenv("UNIONML_TPU_STORE", str(store))
    monkeypatch.chdir(project)
    monkeypatch.syspath_prepend(str(project))
    sys.modules.pop("app", None)
    try:
        code, out = _cli("deploy", "app:model", "--allow-uncommitted")
        assert code == 0 and "Deployed app:model version" in out, out
        code, out = _cli("train", "app:model", "-i", json.dumps({"hyperparameters": {"device": "cpu"}, "repeats": 2}))
        assert code == 0 and "Metrics" in out, out
        code, out = _cli("list-model-versions", "app:model")
        assert code == 0 and "- train-" in out, out
        (project / "features.json").write_text(json.dumps(["the quick ", "@word a stitch "]))
        code, out = _cli("predict", "app:model", "--features", str(project / "features.json"))
        assert code == 0 and "Predictions" in out, out
        predictions = eval(out.split("Predictions: ", 1)[1].strip())  # a printed list of strings
        assert len(predictions) == 2 and predictions[1].startswith("a stitch "), predictions
        assert re.fullmatch(r"[a-z]+", predictions[1][len("a stitch "):]), predictions  # the @word grammar
        code, out = _cli("fetch-model", "app:model", "-o", str(tmp_path / "fetched.pt"))
        assert code == 0 and (tmp_path / "fetched.pt").exists(), out
        import app

        app.model.load(str(tmp_path / "fetched.pt"), hyperparameters={"device": "cpu"})
        assert app.model.predict(features=["@word a stitch "]) == predictions[1:]
    finally:
        import app

        batcher = getattr(app.model, "generation_batcher", None)
        if batcher is not None:
            batcher.close()
        sys.modules.pop("app", None)
    env = {k: v for k, v in os.environ.items() if k != "UNIONML_MODEL_PATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(project), _REPO_ROOT])
    with _served(["app:model", "--remote"], project, env, tmp_path / "server.log", 300) as base:
        with _post(base + "/predict-stream", {"features": ["@word the quick brown "]}) as resp:
            assert resp.status == 200
            pieces = [json.loads(line)[0] for line in resp.read().decode().strip().splitlines()]
        text = "".join(pieces)
        assert text and re.fullmatch(r"[a-z]+", text), text


def test_executions_read_across_the_packages(tmp_path):
    """The store layout is JAX's: the port's ``Execution`` reads a status,
    attempt and heartbeat file as JAX's does."""
    from unionml_tpu.remote import Execution as JaxExecution

    (tmp_path / "status").write_text("RUNNING\n")
    (tmp_path / "attempt").write_text("2")
    (tmp_path / "heartbeat").write_text("0.0")
    ours, theirs = Execution("e", "w", str(tmp_path)), JaxExecution("e", "w", str(tmp_path))
    assert (ours.status, ours.is_done, ours.attempt) == (theirs.status, theirs.is_done, theirs.attempt)
    assert ours.heartbeat_age() > 1e6 and theirs.heartbeat_age() > 1e6
