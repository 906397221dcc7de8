"""The port's artifacts: each branch of ``save_model_object``/``load_model_object`` round-trips.

sklearn (joblib), ``nn.Module`` (state dict), the state branch (the port's
``TrainState`` and a tree of tensors, written by ``torch.save`` and read
back with ``weights_only=True``), the pickle fallback and the directory
pair; a flax msgpack artifact of the JAX package is refused with a message
that names the weight bridge.
"""

import importlib.util
import io

import numpy as np
import pytest
import torch

from unionml_tpu_torch import Llama, LlamaConfig, ModelArtifact, TrainState, make_train_step
from unionml_tpu_torch.artifact import (
    STATE_FORMAT,
    load_artifact_checkpoint,
    load_model_object,
    save_artifact_checkpoint,
    save_model_object,
)
from unionml_tpu_torch.models import causal_lm_loss
from unionml_tpu_torch.utils import is_keras_model

torch.set_num_threads(2)

CFG = LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64, vocab_size=32,
                       dtype=torch.float32, param_dtype=torch.float32)


def _trained_state(seed: int = 0) -> TrainState:
    """A TrainState after two AdamW steps, so the optimizer holds moments."""
    model = Llama(CFG, device="cpu", seed=seed)
    state = TrainState(model, torch.optim.AdamW(model.parameters(), lr=1e-2))
    step = make_train_step(causal_lm_loss)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(1, 32, size=(2, 8)))
    for _ in range(2):
        state, _ = step(state, tokens)
    return state


def _fresh_state(hyperparameters: dict) -> TrainState:
    model = Llama(CFG, device=hyperparameters.get("device", "cpu"), seed=hyperparameters.get("seed", 1))
    return TrainState(model, torch.optim.AdamW(model.parameters(), lr=1e-2))


def _assert_states_equal(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sa.keys() == sb.keys()
        for key in sa:
            assert torch.equal(torch.as_tensor(sa[key]), torch.as_tensor(sb[key])), key


@pytest.mark.parametrize("target", ["path", "fileobj"])
def test_train_state_round_trip(tmp_path, target):
    state = _trained_state()
    file = tmp_path / "state.pt" if target == "path" else io.BytesIO()
    save_model_object(state, {"seed": 1, "device": "cpu"}, file)
    if target == "path":
        payload = torch.load(file, weights_only=True)  # tensors, str, numbers, dicts and lists only
        assert payload["format"] == STATE_FORMAT and payload["hyperparameters"] == '{"seed": 1, "device": "cpu"}'
    else:
        file.seek(0)
    seen = []

    def init(hp):
        seen.append(hp)
        return _fresh_state(hp)

    loaded = load_model_object(file, TrainState, init=init)
    assert seen == [{"seed": 1, "device": "cpu"}]
    _assert_states_equal(loaded, state)
    assert all(p.device == torch.device("cpu") for p in loaded.model.parameters())


def test_hyperparameter_overrides_reach_init(tmp_path):
    path = tmp_path / "state.pt"
    save_model_object(_trained_state(), {"seed": 1, "device": "cuda"}, path)
    seen = []
    loaded = load_model_object(path, TrainState, init=lambda hp: seen.append(hp) or _fresh_state(hp),
                               hyperparameters={"device": "cpu"})
    assert seen == [{"seed": 1, "device": "cpu"}]
    assert next(loaded.model.parameters()).device == torch.device("cpu")


def test_state_without_init_or_template_raises(tmp_path):
    path = tmp_path / "state.pt"
    save_model_object(_trained_state(), None, path)
    with pytest.raises(ValueError, match="'init' callable"):
        load_model_object(path, TrainState)


def test_tensor_tree_round_trip(tmp_path):
    tree = {"w": torch.randn(3, 4), "layers": [torch.arange(5), {"b": torch.ones(2, dtype=torch.bfloat16)}]}
    path = tmp_path / "tree.pt"
    save_model_object(tree, {"lr": 0.1}, path)
    template = {"w": torch.zeros(3, 4), "layers": [torch.zeros(5), {"b": torch.zeros(2)}]}
    loaded = load_model_object(path, dict, template=template)
    assert torch.equal(loaded["w"], tree["w"]) and torch.equal(loaded["layers"][0], tree["layers"][0])
    assert loaded["layers"][1]["b"].dtype == torch.bfloat16  # the saved dtype, the template's device
    with pytest.raises(ValueError, match="structure"):
        load_model_object(path, dict, template={"w": torch.zeros(3, 4)})


def test_nn_module_round_trip(tmp_path):
    model = Llama(CFG, device="cpu", seed=3)
    path = tmp_path / "module.pt"
    save_model_object(model, {"seed": 5}, path)
    loaded = load_model_object(path, Llama, init=lambda hp: Llama(CFG, device="cpu", seed=hp["seed"]))
    for (name, x), (_, y) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(x, y), name


def test_sklearn_round_trip(tmp_path):
    from sklearn.linear_model import LogisticRegression

    x = np.random.default_rng(0).normal(size=(40, 3))
    est = LogisticRegression().fit(x, (x.sum(1) > 0).astype(int))
    path = tmp_path / "est.joblib"
    save_model_object(est, {"C": 1.0}, path)
    loaded = load_model_object(path, LogisticRegression)
    np.testing.assert_array_equal(loaded.predict(x), est.predict(x))


def test_pickle_fallback_round_trip(tmp_path):
    obj = {"vocab": ["a", "b"], "n": 3}
    path = tmp_path / "obj.pkl"
    save_model_object(obj, None, path)
    assert load_model_object(path, dict) == obj


def test_jax_msgpack_artifact_is_refused_naming_the_bridge(tmp_path):
    """A flax msgpack artifact of the JAX package, written by its own saver."""
    import jax.numpy as jnp

    from unionml_tpu.artifact import save_model_object as jax_save

    path = tmp_path / "jax.ckpt"
    jax_save({"params": {"w": jnp.ones((2, 2))}}, {"lr": 0.1}, str(path))
    with pytest.raises(ValueError, match="llama_params_from_jax"):
        load_model_object(path, dict, init=lambda hp: None)


def test_keras_branch_dispatch_and_guard(tmp_path):
    saved = {}

    class FakeKerasModel:
        pass

    FakeKerasModel.__module__ = "keras.engine.training"
    FakeKerasModel.save = lambda self, file, *a, **k: saved.setdefault("file", file)
    assert is_keras_model(FakeKerasModel)
    out = tmp_path / "keras_model"
    save_model_object(FakeKerasModel(), {}, str(out))
    assert saved["file"] == str(out)
    if importlib.util.find_spec("tensorflow") is None:
        with pytest.raises(RuntimeError, match="requires tensorflow"):
            load_model_object(str(out), FakeKerasModel)


def test_artifact_checkpoint_directory_round_trip(tmp_path):
    state = _trained_state()
    save_artifact_checkpoint(ModelArtifact(state, {"seed": 1}, {"train": 0.5}), tmp_path / "ckpt")
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["artifact.json", "model_object.pt"]
    artifact = load_artifact_checkpoint(tmp_path / "ckpt", _fresh_state({}))
    _assert_states_equal(artifact.model_object, state)
    assert (artifact.hyperparameters, artifact.metrics) == ({"seed": 1}, {"train": 0.5})


def test_hyperparameters_travel_as_json(tmp_path):
    """The nn.Module branch, too, keeps its payload to what
    ``weights_only=True`` reads: the hyperparameters are a JSON string."""
    path = tmp_path / "module.pt"
    save_model_object(Llama(CFG, device="cpu", seed=0), {"seed": 2, "tags": ["a"]}, path)
    payload = torch.load(path, weights_only=True)
    assert payload["hyperparameters"] == '{"seed": 2, "tags": ["a"]}'
