"""The torch ``text-generation`` template, imported by path, on the CPU.

Its app trains under 3 nats, predicts deterministic text within the corpus's
characters, reloads to the same text, streams single prompts through the
shared ``ContinuousBatcher`` to the predicted text, and constrains
``@word``/``@sentence`` prompts to their grammars. With the JAX template's
``init({})`` weights carried across by ``llama_params_from_jax``, its
``predictor`` gives the JAX template's ``predictor`` text token for token
(f32, greedy), plain and constrained prompts alike. ``model.serve()`` passes
the serve half of the JAX template test (``tests/unit/test_templates.py``,
without its speculative lines); the half-depth speculative generator's text
equals ``model.predict``'s.
"""

import asyncio
import importlib.util
import json
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


@pytest.mark.parametrize("gamma", [2, 4])
def test_speculative_generator_equals_predict(app, gamma):
    """The half-depth draft through the Generator façade is greedy-exact:
    its text equals ``model.predict``'s, plain and grammar prompts alike
    (the draft proposes under the same grammar set and eos)."""
    module, _, outputs = app
    spec = module.speculative_generator(module.model.artifact.model_object, gamma=gamma)
    gids, texts = zip(*(module._split_grammar(p) for p in PROMPTS))
    rows = spec(module._encode_prompts(list(texts)), constraint=list(gids))
    assert [t + module.decode(row) for t, row in zip(texts, rows)] == outputs
    assert spec._speculative().rounds > 0


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


def test_serve_half_of_the_jax_template_test(app):
    """``tests/unit/test_templates.py``'s generation-over-HTTP lines on the
    torch template: ``/predict``, a batch stream and two concurrent
    single-prompt streams reassemble to the predicted text, ``/metrics``
    reports the shared engine, and an ``@word`` prompt is constrained on both
    routes alike."""
    module, _, _ = app
    prompts = ["the quick brown ", "a stitch "]
    outputs = module.model.predict(features=prompts)
    served = module.model.serve()
    status, texts, _ = asyncio.run(served.dispatch("POST", "/predict", json.dumps({"features": prompts}).encode()))
    assert status == 200 and texts == outputs

    async def consume():
        status, payload, content_type = await served.dispatch(
            "POST", "/predict-stream", json.dumps({"features": prompts}).encode()
        )
        assert status == 200 and content_type == "application/x-ndjson"
        return [chunk async for chunk in payload]

    chunks = asyncio.run(consume())
    assert len(chunks) > 1  # actually incremental, not one blob
    pieces = [json.loads(c.decode()) for c in chunks]
    for i, prompt in enumerate(prompts):
        assert prompt + "".join(p[i] for p in pieces) == outputs[i]

    async def consume_one(prompt):
        status, payload, _ = await served.dispatch(
            "POST", "/predict-stream", json.dumps({"features": [prompt]}).encode()
        )
        assert status == 200
        return "".join([json.loads(c.decode())[0] async for c in payload])

    async def concurrent():
        return await asyncio.gather(*(consume_one(p) for p in prompts))

    streamed = asyncio.run(concurrent())
    assert [p + s for p, s in zip(prompts, streamed)] == outputs
    entry = module._continuous.get(id(module.model.artifact.model_object))
    assert entry is not None and entry[0] is module.model.artifact.model_object
    batcher = entry[1]
    assert batcher.decode_dispatches > 0

    status, metrics_payload, _ = asyncio.run(served.dispatch("GET", "/metrics"))
    assert status == 200
    generation = metrics_payload["generation"]
    assert generation["slots"] == 4 and generation["decode_dispatches"] > 0
    assert generation["speculative"] is False
    kv = generation["kv_blocks"]
    assert kv["block_size"] == 16 and kv["used"] == 0

    g_prompt = "@word the quick brown "
    g_out = module.model.predict(features=[g_prompt, "plain "])
    cont = g_out[0][len("the quick brown "):]
    assert cont and re.fullmatch(r"[a-z]+", cont), g_out[0]
    assert g_out[1] == module.model.predict(features=["plain "])[0]
    streamed_word = asyncio.run(consume_one(g_prompt))
    assert "the quick brown " + streamed_word == g_out[0]
