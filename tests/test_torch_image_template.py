"""The torch ``image-classification`` template on the CPU.

The port's ``init`` renders it; the rendered app trains on the CPU past the
JAX template test's bar (``metrics["train"] > 0.8``), predicts digit
classes, and reloads to the same predictions. With the JAX template's
``init({})`` parameters carried across as they are (``Conv_0``,
``Conv_1``, ``Dense_0``, ``Dense_1`` in flax's layouts), its CNN gives the
JAX template's logits within 1e-5 (f32) on seeded inputs and on the digits,
and its predictor the same classes. Its own ``tests/test_app.py`` passes.
"""

import contextlib
import importlib.util
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from sklearn.datasets import load_digits

from unionml_tpu_torch.cli import app as cli_app
from unionml_tpu_torch.models.convert import state_dict_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_TEMPLATE = ROOT / "unionml_tpu" / "templates" / "image-classification"
APP_NAME = "digits-app"
CPU = {"learning_rate": 1e-3, "device": "cpu"}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _cwd(path: Path):
    before = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(before)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """The template rendered by ``python -m unionml_tpu_torch.cli init``."""
    root = tmp_path_factory.mktemp("rendered")
    with _cwd(root), pytest.raises(SystemExit) as done:
        cli_app(["init", APP_NAME, "-t", "image-classification"])
    assert done.value.code == 0
    return root / APP_NAME


@pytest.fixture(scope="module")
def trained(project):
    module = _load("torch_image_app", project / "app.py")
    _, metrics = module.model.train(hyperparameters=CPU)
    return module, metrics


def _digits(n=6):
    frame = load_digits(as_frame=True).frame.sample(n, random_state=0)
    return frame.drop(columns=["target"]).to_numpy(dtype=np.float32)


def test_rendered_project(project):
    assert sorted(p.relative_to(project).as_posix() for p in project.rglob("*")
                  if p.is_file() and ".git" not in p.parts) == [
        "README.md", "app.py", "requirements.txt", "tests/test_app.py"]
    readme = (project / "README.md").read_text()
    assert APP_NAME in readme and "python -m unionml_tpu_torch.cli serve" in readme
    assert f'Model(name="{APP_NAME}"' in (project / "app.py").read_text()


def test_trains_on_the_cpu_past_the_jax_tests_bar(trained):
    module, metrics = trained
    assert metrics["train"] > 0.8
    assert module.model.last_fit_result.steps == 10 * (1437 // 64)  # 10 epochs of the 80 % split, batch 64
    assert next(module.model.artifact.model_object.model.parameters()).device == torch.device("cpu")


def test_predicts_digit_classes_and_reloads_to_them(trained, tmp_path):
    module, _ = trained
    predictions = module.model.predict(features=_digits())
    assert len(predictions) == 6 and all(p in range(10) for p in predictions)
    path = tmp_path / "model_object.ckpt"
    module.model.save(str(path))
    module.model.artifact = None
    module.model.load(str(path), hyperparameters=CPU)
    assert module.model.predict(features=_digits()) == predictions


@pytest.fixture(scope="module")
def carried(project):
    """The JAX template's ``init({})`` parameters in the torch CNN."""
    jax_app = _load("jax_image_app", JAX_TEMPLATE / "app.py")
    torch_app = _load("torch_image_app_carried", project / "app.py")
    jax_state = jax_app.init({})
    tree = jax.tree_util.tree_map(np.asarray, jax_state.params)
    assert sorted(tree) == ["Conv_0", "Conv_1", "Dense_0", "Dense_1"]
    state = torch_app.init({"device": "cpu"})
    state.model.load_state_dict(state_dict_from_jax(tree, state.model))
    return jax_app, jax_state, torch_app, state


@pytest.mark.parametrize("inputs", ["seeded", "digits"])
def test_carried_weights_give_the_jax_templates_logits_within_1e_5(carried, inputs):
    jax_app, jax_state, _, state = carried
    if inputs == "seeded":
        x = np.random.RandomState(0).rand(5, 64).astype(np.float32)
    else:
        x = _digits() / 16.0
    want = np.asarray(jax_app.module.apply({"params": jax_state.params}, x))
    with torch.no_grad():
        got = state.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_carried_weights_give_the_jax_templates_predictions(carried):
    jax_app, jax_state, torch_app, state = carried
    x = _digits(16) / 16.0
    assert torch_app.predictor(state, x) == jax_app.predictor(jax_state, x)


def test_init_without_a_device_asks_for_the_card(carried, monkeypatch):
    """Unset ``device`` means the card: with none present, ``init({})`` raises
    naming ``device="cpu"`` instead of training on the CPU."""
    torch_app = carried[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        torch_app.init({})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        torch_app.CNN()


def test_the_templates_own_test_file_passes(project, monkeypatch):
    """``tests/test_app.py`` of the rendered project, against a fresh copy of its app."""
    monkeypatch.setitem(sys.modules, "app", _load("app", project / "app.py"))
    own = _load("torch_image_test_app", project / "tests" / "test_app.py")
    own.test_train_and_predict()
