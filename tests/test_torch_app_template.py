"""The torch ``text-generation`` template, imported by path, on the CPU.

Its app trains under 3 nats, predicts deterministic text within the corpus's
characters, reloads to the same text, streams single prompts through the
shared ``ContinuousBatcher`` to the predicted text, and constrains
``@word``/``@sentence`` prompts to their grammars. With the JAX template's
``init({})`` weights carried across by ``llama_params_from_jax``, its
``predictor`` gives the JAX template's ``predictor`` text token for token
(f32, greedy), plain and constrained prompts alike.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from unionml_tpu_torch.models import llama_params_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TORCH_TEMPLATE = ROOT / "unionml_tpu_torch" / "templates" / "text-generation"
JAX_TEMPLATE = ROOT / "unionml_tpu" / "templates" / "text-generation"
PROMPTS = ["the quick brown ", "a stitch ", "@word the ", "@sentence a "]
#: a valid prefix of each grammar's language (a stream may stop at the token budget before EOS)
GRAMMAR_PREFIX = {"word": r"[a-z]*", "sentence": r"([a-z][a-z ]*[.!]?)?"}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def app():
    """The torch template, trained on the CPU, with its first predictions."""
    module = _load("torch_text_generation_app", TORCH_TEMPLATE / "app.py")
    _, metrics = module.model.train(hyperparameters={"learning_rate": 3e-3, "device": "cpu"})
    outputs = module.model.predict(features=PROMPTS)
    return module, metrics, outputs


def test_train_loss_under_three_nats(app):
    module, metrics, _ = app
    assert metrics["train"] < 3.0
    assert module.model.last_fit_result.steps > 0
    assert next(module.model.artifact.model_object.model.parameters()).device == torch.device("cpu")


def test_predict_starts_with_the_prompt_within_chars_and_is_deterministic(app):
    module, _, outputs = app
    for prompt, text in zip(PROMPTS, outputs):
        _, plain = module._split_grammar(prompt)
        assert text.startswith(plain)
        continuation = text[len(plain):]
        assert 0 < len(continuation) <= module.NEW_TOKENS
        assert set(continuation) <= set(module.CHARS)
    assert module.model.predict(features=PROMPTS) == outputs


@pytest.mark.parametrize("grammar", list(GRAMMAR_PREFIX))
def test_grammar_prompts_are_constrained(app, grammar):
    module, _, outputs = app
    prompt = f"@{grammar} the "
    text = module.model.predict(features=[prompt])[0]
    continuation = text[len("the "):]
    assert re.fullmatch(GRAMMAR_PREFIX[grammar], continuation), continuation
    if grammar == "sentence":  # once the sentence ends, EOS: nothing follows
        assert all(c not in ".!" for c in continuation[:-1])


def test_save_and_reload_give_the_same_text(app, tmp_path):
    module, _, outputs = app
    path = tmp_path / "model_object.ckpt"
    module.model.save(str(path))
    trained = module.model.artifact
    try:
        module.model.artifact = None
        module.model.load(str(path))
        assert module.model.artifact.model_object is not trained.model_object
        assert module.model.predict(features=PROMPTS) == outputs
    finally:
        module.model.artifact = trained


@pytest.mark.parametrize("index", range(len(PROMPTS)))
def test_single_prompt_stream_reassembles_to_predict(app, index):
    module, _, outputs = app
    state = module.model.artifact.model_object
    pieces = [chunk[0] for chunk in module.stream_predictor(state, [PROMPTS[index]])]
    _, plain = module._split_grammar(PROMPTS[index])
    assert plain + "".join(pieces) == outputs[index]


def test_multi_prompt_stream_reassembles_to_predict(app):
    module, _, outputs = app
    state = module.model.artifact.model_object
    pieces = ["" for _ in PROMPTS]
    for chunk in module.stream_predictor(state, PROMPTS):
        pieces = [p + c for p, c in zip(pieces, chunk)]
    assert [module._split_grammar(p)[1] + piece for p, piece in zip(PROMPTS, pieces)] == outputs


def test_speculative_generator_is_not_ported(app):
    module, _, _ = app
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        module.speculative_generator(module.model.artifact.model_object)


def test_the_templates_own_test_file_passes(monkeypatch):
    """``tests/test_app.py`` of the template, against a fresh copy of its app."""
    monkeypatch.setitem(sys.modules, "app", _load("app", TORCH_TEMPLATE / "app.py"))
    own = _load("torch_text_generation_test_app", TORCH_TEMPLATE / "tests" / "test_app.py")
    own.test_train_and_generate()


@pytest.fixture(scope="module")
def carried():
    """The JAX template and the torch template's predictor on the same
    weights: the JAX template's ``init({})`` parameters, converted."""
    jax_app = _load("jax_text_generation_app", JAX_TEMPLATE / "app.py")
    torch_app = _load("torch_text_generation_app_carried", TORCH_TEMPLATE / "app.py")
    jax_state = jax_app.init({})
    tree = jax.tree_util.tree_map(np.asarray, jax_state.params)
    state = torch_app.init({"device": "cpu"})
    state.model.load_state_dict(llama_params_from_jax(tree, torch_app.config))
    return jax_app, jax_state, torch_app, state


@pytest.mark.parametrize(
    "prompts",
    [["the quick brown ", "a stitch ", ""], ["@word the ", "@word pack my ", "all that"],
     ["@sentence a ", "@sentence the early ", "@word how "]],
    ids=["plain", "word", "sentence"],
)
def test_carried_weights_give_the_jax_templates_text(carried, prompts):
    jax_app, jax_state, torch_app, state = carried
    assert torch_app.predictor(state, prompts) == jax_app.predictor(jax_state, prompts)
