"""The port's ``ServingApp`` against the JAX package's, over the same weights.

Both ``text-generation`` templates are imported by path, the JAX template's
``init({})`` parameters are carried across to the torch template with
``llama_params_from_jax``, and each template's ``model.serve()`` app starts
up (its ``generation_warmup`` builds and warms the shared
``ContinuousBatcher``). The same requests then go to both apps in-process:
``/predict`` and ``/predict-stream`` texts, ``/v1/completions`` and
``/v1/chat/completions`` tokens (exactly) and logprobs (within 1e-5, f32
greedy), the same 400s, the ``/metrics`` key set and the Prometheus metric
names.
"""

import asyncio
import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from unionml_tpu.artifact import ModelArtifact as JaxModelArtifact
from unionml_tpu_torch.artifact import ModelArtifact
from unionml_tpu_torch.models import llama_params_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LOGPROB_ATOL = 1e-5
PROMPTS = ["the quick brown ", "@word a stitch "]
#: stats() and /metrics leaves that are timings, rates or SLO verdicts: compared by key only
TIMED = ("ttft_ms", "tbt_ms", "rates", "routes", "queues")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def apps():
    """``{"jax": (template, app), "torch": (template, app)}``, started up."""
    jax_app = _load("jax_text_generation_serving", ROOT / "unionml_tpu" / "templates" / "text-generation" / "app.py")
    torch_app = _load("torch_text_generation_serving",
                      ROOT / "unionml_tpu_torch" / "templates" / "text-generation" / "app.py")
    jax_state = jax_app.init({})
    state = torch_app.init({"device": "cpu"})
    state.model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jax_state.params),
                                                      torch_app.config))
    jax_app.model.artifact = JaxModelArtifact(jax_state)
    torch_app.model.artifact = ModelArtifact(state)
    out = {}
    for name, module in (("jax", jax_app), ("torch", torch_app)):
        app = module.model.serve()
        app.startup()
        out[name] = (module, app)
    yield out
    for module, _ in out.values():
        module.model.generation_batcher.close()


def _dispatch(app, method, path, body=None):
    """Dispatch in-process and drain a streaming payload in the same loop."""

    async def run():
        raw = b"" if body is None else json.dumps(body).encode()
        status, payload, content_type = await app.dispatch(method, path, raw)
        if hasattr(payload, "__aiter__"):
            payload = [chunk async for chunk in payload]
        return status, payload, content_type

    return asyncio.run(run())


def _both(apps, method, path, body=None):
    return {name: _dispatch(app, method, path, body) for name, (_, app) in apps.items()}


def test_predict_texts_are_identical(apps):
    got = _both(apps, "POST", "/predict", {"features": PROMPTS})
    assert got["torch"] == got["jax"]
    status, texts, _ = got["torch"]
    assert status == 200 and [t.startswith(p.removeprefix("@word ")) for t, p in zip(texts, PROMPTS)] == [True] * 2


@pytest.mark.parametrize("features", [[PROMPTS[0]], [PROMPTS[1]], PROMPTS], ids=["single", "grammar", "batch"])
def test_predict_stream_chunks_are_identical(apps, features):
    got = _both(apps, "POST", "/predict-stream", {"features": features})
    assert got["torch"] == got["jax"]
    status, chunks, content_type = got["torch"]
    assert status == 200 and content_type == "application/x-ndjson" and len(chunks) > 1


def _sse(payload):
    events = [line[len(b"data: "):] for chunk in payload for line in chunk.split(b"\n\n") if line]
    assert events[-1] == b"[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _tokens_and_logprobs(path, status, payload, stream):
    """(token strings, logprobs, texts, finish reasons, usage) of one /v1 response."""
    assert status == 200, payload
    choices = [c for p in (_sse(payload) if stream else [payload]) for c in p["choices"]]
    tokens, logprobs, texts, finish = [], [], [], []
    for choice in choices:
        block = choice.get("logprobs")
        if block:
            if path.endswith("chat/completions"):
                tokens += [e["token"] for e in block["content"]]
                logprobs += [e["logprob"] for e in block["content"]]
            else:
                tokens += block["tokens"]
                logprobs += block["token_logprobs"]
        texts.append(choice.get("text", choice.get("delta", choice.get("message", {})).get("content")))
        finish.append(choice["finish_reason"])
    usage = (_sse(payload)[-1] if stream else payload).get("usage")
    return tokens, logprobs, texts, finish, usage


V1_CASES = {
    "completions": ("/v1/completions", {"prompt": [5, 6, 7, 8], "max_tokens": 12, "logprobs": 1}),
    "completions-stream": ("/v1/completions", {"prompt": [9, 3, 12], "max_tokens": 12, "logprobs": 1,
                                                "stream": True}),
    "completions-stop": ("/v1/completions", {"prompt": [5, 6, 7, 8], "max_tokens": 12, "stop": " 1"}),
    "chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "the quick brown"}],
                                      "max_tokens": 10, "logprobs": True}),
    "chat-stream": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a stitch"}],
                                             "max_tokens": 10, "logprobs": True, "stream": True}),
}


@pytest.fixture
def tokenizers(apps):
    """Each template's character codec as ``model.tokenizer`` (for string and chat prompts)."""
    for module, _ in apps.values():
        module.model.tokenizer = SimpleNamespace(encode=module.encode, decode=module.decode)
    yield
    for module, _ in apps.values():
        del module.model.tokenizer


@pytest.mark.parametrize("case", list(V1_CASES))
def test_v1_tokens_identical_and_logprobs_close(apps, tokenizers, case):
    path, body = V1_CASES[case]
    got = {name: _tokens_and_logprobs(path, *result[:2], body.get("stream", False))
           for name, result in _both(apps, "POST", path, body).items()}
    (tokens, logprobs, texts, finish, usage), (jax_tokens, jax_logprobs, jax_texts, jax_finish, jax_usage) = (
        got["torch"], got["jax"])
    assert (tokens, texts, finish, usage) == (jax_tokens, jax_texts, jax_finish, jax_usage)
    np.testing.assert_allclose(logprobs, jax_logprobs, atol=LOGPROB_ATOL, rtol=0)
    if body.get("logprobs"):
        assert len(tokens) == usage["completion_tokens"] > 0 and all(np.isfinite(logprobs))


@pytest.mark.parametrize(
    "body",
    [{"prompt": [5, 6], "n": 2}, {"prompt": [5, 6], "echo": True}, {"prompt": "the quick"},
     {"prompt": []}, {"prompt": [5, 6], "stop": ["a", "b", "c", "d", "e"]}],
    ids=["n2", "echo", "string-prompt-no-tokenizer", "empty-prompt", "five-stops"],
)
def test_v1_rejections_are_the_same_400s(apps, body):
    got = _both(apps, "POST", "/v1/completions", body)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 400


def _paths(tree, prefix=()):
    out = set()
    for key, value in tree.items():
        if isinstance(value, dict) and key not in TIMED:
            out |= _paths(value, prefix + (key,))
        out.add(prefix + (key,))
    return out


def test_metrics_key_set_and_prometheus_names_match(apps):
    _both(apps, "POST", "/predict", {"features": PROMPTS[:1]})
    _both(apps, "POST", "/predict-stream", {"features": PROMPTS[:1]})
    got = _both(apps, "GET", "/metrics")
    (status, metrics, _), (jax_status, jax_metrics, _) = got["torch"], got["jax"]
    assert status == jax_status == 200
    assert _paths(metrics) == _paths(jax_metrics)
    generation = metrics["generation"]
    assert generation["slots"] == 4 and generation["kv_blocks"]["used"] == 0 and generation["speculative"] is False
    for key in ("slots", "max_waiting", "decode_dispatches", "rows_per_dispatch", "kv_blocks", "prefill",
                "grammar_submissions", "shed_queue_full", "shed_deadline"):
        assert generation[key] == jax_metrics["generation"][key], key
    texts = {name: result[1] for name, result in _both(apps, "GET", "/metrics?format=prometheus").items()}
    names = {name: {re.split(r"[{ ]", line, 1)[0] for line in text.splitlines() if line and not line.startswith("#")}
             for name, text in texts.items()}
    assert names["torch"] == names["jax"] and names["torch"]
