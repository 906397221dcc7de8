"""Serverless adapters (``unionml_tpu_torch/serving/serverless.py``): the cases
of ``tests/unit/test_serverless.py`` against the port. The same app is
built and trained in both packages (scikit-learn on the host), the same
API-Gateway and S3 events go through the JAX handler and the port's, and
their status codes and bodies must be equal (minted request ids aside).
Last, the port's ``basic-serverless`` template is rendered by the CLI's
``init`` and its own tests run."""

import base64
import json
import sys
from pathlib import Path
from typing import List

import pandas as pd
import pytest
import torch
from sklearn.linear_model import LogisticRegression

import unionml_tpu
import unionml_tpu_torch
from unionml_tpu.serving.serverless import lambda_handler as jax_lambda_handler
from unionml_tpu.serving.serverless import make_batch_handler as jax_make_batch_handler
from unionml_tpu_torch.serving.serverless import lambda_handler, make_batch_handler

torch.set_num_threads(2)

FEATURES = [{"x0": 1.0, "x1": 2.0}, {"x0": 3.0, "x1": 1.0}, {"x0": 0.0, "x1": 4.0}]


def _app(package, feature_loader: bool = False):
    """The unit file's app over ``package`` (the JAX package or the port)."""
    dataset = package.Dataset(name="ds", test_size=0.2, shuffle=True, targets=["y"])
    model = package.Model(name="serverless_model", init=LogisticRegression, dataset=dataset)

    @dataset.reader
    def reader(n: int = 60) -> pd.DataFrame:
        rows = [{"x0": float(i % 7), "x1": float((i * 3) % 5), "y": i % 2} for i in range(n)]
        return pd.DataFrame(rows)

    if feature_loader:
        @dataset.feature_loader
        def loader(features: Path) -> pd.DataFrame:
            assert isinstance(features, Path), f"feature_loader re-invoked on {type(features)}"
            return pd.DataFrame(json.loads(features.read_text()))

    @model.trainer
    def trainer(est: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
        return est.fit(features, target.squeeze())

    @model.predictor
    def predictor(est: LogisticRegression, features: pd.DataFrame) -> List[float]:
        return [float(v) for v in est.predict(features)]

    model.train(hyperparameters={"max_iter": 500})
    return model


@pytest.fixture(scope="module")
def models():
    return _app(unionml_tpu), _app(unionml_tpu_torch)


def _v1(payload: dict) -> dict:
    return {"httpMethod": "POST", "path": "/predict", "headers": {"Content-Type": "application/json"},
            "body": json.dumps(payload), "isBase64Encoded": False}


def _v2(payload: dict) -> dict:
    return {"rawPath": "/predict", "requestContext": {"http": {"method": "POST", "path": "/predict"}},
            "body": json.dumps(payload)}


def _b64(event: dict) -> dict:
    return dict(event, body=base64.b64encode(event["body"].encode()).decode(), isBase64Encoded=True)


EVENTS = {
    "predict_v1": _v1({"features": FEATURES}),
    "predict_v2": _v2({"features": FEATURES}),
    "health": {"httpMethod": "GET", "path": "/health"},
    "404": {"httpMethod": "GET", "path": "/nope"},
    "base64_body": _b64(_v1({"features": FEATURES})),
    "bad_json": dict(_v1({}), body="{not json"),
}


def _same(jax_response: dict, response: dict) -> None:
    assert response["statusCode"] == jax_response["statusCode"]
    assert json.loads(response["body"]) == json.loads(jax_response["body"])
    assert response["headers"]["Content-Type"] == jax_response["headers"]["Content-Type"]
    assert response["isBase64Encoded"] is jax_response["isBase64Encoded"] is False


@pytest.mark.parametrize("name", list(EVENTS))
def test_lambda_handler_answers_as_the_jax_handler(models, name):
    """``test_lambda_handler_predict_v1``/``_v2``, ``_health_and_404`` and
    ``_base64_body`` (and a body that is no JSON): the same status and body."""
    jax_model, model = models
    got = lambda_handler(model.serve())(EVENTS[name], None)
    _same(jax_lambda_handler(jax_model.serve())(EVENTS[name], None), got)
    if name.startswith("predict") or name == "base64_body":
        assert got["statusCode"] == 200
        predictions = json.loads(got["body"])
        assert len(predictions) == len(FEATURES) and all(p in (0.0, 1.0) for p in predictions)
    if name == "404":
        assert got["statusCode"] == 404


def test_lambda_handler_warm_reuse_across_invocations(models):
    """Scale-to-zero: one container, one startup; the second invocation
    reuses the started app."""
    _, model = models
    handler = lambda_handler(model.serve())
    assert handler.stats == {"invocations": 0, "startups": 0, "cold_start_s": None}
    assert handler(EVENTS["predict_v1"], None)["statusCode"] == 200
    assert handler.stats["startups"] == 1 and handler.stats["cold_start_s"] is not None
    cold = handler.stats["cold_start_s"]
    assert handler(EVENTS["predict_v1"], None)["statusCode"] == 200
    assert handler.stats == {"invocations": 2, "startups": 1, "cold_start_s": cold}


def test_lambda_handler_preload_moves_startup_to_init(models):
    _, model = models
    handler = lambda_handler(model.serve(), preload=True)
    assert handler.stats["startups"] == 1 and handler.stats["invocations"] == 0
    assert handler(EVENTS["predict_v1"], None)["statusCode"] == 200
    assert handler.stats["startups"] == 1


def test_lambda_handler_echoes_request_id(models):
    """Inbound ids come back on success and error responses, absent ids are
    minted (32 hex characters), as from the JAX handler."""
    jax_model, model = models
    for build, m in ((jax_lambda_handler, jax_model), (lambda_handler, model)):
        handler = build(m.serve())
        event = _v1({"features": FEATURES})
        event["headers"]["X-Request-Id"] = "lambda-rid-1"
        response = handler(event, None)
        assert response["statusCode"] == 200 and response["headers"]["X-Request-Id"] == "lambda-rid-1"
        missing = handler({"httpMethod": "GET", "path": "/nope", "headers": {"X-Request-Id": "lambda-rid-2"}}, None)
        assert missing["statusCode"] == 404 and missing["headers"]["X-Request-Id"] == "lambda-rid-2"
        minted = handler({"httpMethod": "GET", "path": "/health"}, None)
        assert len(minted["headers"]["X-Request-Id"]) == 32


class InMemoryStore:
    """Object-store stand-in with ``download_file``/``upload_file``."""

    def __init__(self, objects=None):
        self.objects = dict(objects or {})

    def download_file(self, bucket: str, key: str, filename: str) -> None:
        Path(filename).write_bytes(self.objects[(bucket, key)])

    def upload_file(self, filename: str, bucket: str, key: str) -> None:
        self.objects[(bucket, key)] = Path(filename).read_bytes()


def _s3_event(bucket: str, key: str) -> dict:
    return {"Records": [{"s3": {"bucket": {"name": bucket}, "object": {"key": key}}}]}


BATCH_CASES = {
    # test_batch_handler_s3_flow: the input key's prefix is kept
    "s3_flow": ({("inbox", "uploads/features.json"): FEATURES}, _s3_event("inbox", "uploads/features.json"), {}),
    # test_batch_handler_skips_malformed_records
    "malformed": ({}, {"Records": [{"s3": {}}]}, {}),
    # test_batch_handler_ignores_own_outputs, then a distinct output bucket
    "own_outputs": ({("inbox", "predictions/features.json"): [1.0]}, _s3_event("inbox", "predictions/features.json"),
                    {}),
    "output_bucket": ({("inbox", "predictions/features.json"): FEATURES},
                      _s3_event("inbox", "predictions/features.json"), {"output_bucket": "outbox"}),
    # test_batch_handler_url_encoded_keys
    "url_encoded": ({("inbox", "daily report.json"): FEATURES}, _s3_event("inbox", "daily+report.json"), {}),
}


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_batch_handler_matches_the_jax_handler(models, name):
    """The S3-event batch cases: the same result, and the same objects in the
    store afterwards."""
    objects, event, kwargs = BATCH_CASES[name]
    stores = []
    results = []
    for build, m in zip((jax_make_batch_handler, make_batch_handler), models):
        store = InMemoryStore({k: json.dumps(v).encode() for k, v in objects.items()})
        results.append(build(m, store, **kwargs)(event, None))
        stores.append({k: json.loads(v) for k, v in store.objects.items()})
    assert results[1] == results[0] and stores[1] == stores[0]
    if name == "s3_flow":
        assert results[1]["outputs"] == [{"bucket": "inbox", "key": "predictions/uploads/features.json"}]
        assert len(stores[1][("inbox", "predictions/uploads/features.json")]) == len(FEATURES)


def test_batch_handler_runs_feature_pipeline_once():
    """A feature loader that takes only a Path: the handler runs the feature
    pipeline once, then predicts from the loaded features."""
    model = _app(unionml_tpu_torch, feature_loader=True)
    store = InMemoryStore({("inbox", "uploads/features.json"): json.dumps(FEATURES).encode()})
    result = make_batch_handler(model, store)(_s3_event("inbox", "uploads/features.json"), None)
    assert result["statusCode"] == 200
    assert len(json.loads(store.objects[("inbox", "predictions/uploads/features.json")])) == len(FEATURES)


def test_basic_serverless_template_tests_pass(tmp_path, monkeypatch):
    """``init -t basic-serverless`` renders the port's template, whose own
    tests (train, then a ``POST /predict`` event through ``handler``) pass.
    They run in this process: the project's ``app`` and ``handler``
    modules are dropped from ``sys.modules`` before and after."""
    from unionml_tpu_torch.cli import app

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exit_info:
        app(["init", "lambda-app", "-t", "basic-serverless"])
    assert exit_info.value.code == 0
    project = tmp_path / "lambda-app"
    assert "unionml_tpu_torch" in (project / "handler.py").read_text()
    names = ("app", "handler", "test_handler")
    saved = {name: sys.modules.pop(name) for name in names if name in sys.modules}
    monkeypatch.syspath_prepend(str(project))
    monkeypatch.delenv("UNIONML_MODEL_PATH", raising=False)
    try:
        code = pytest.main([str(project / "tests"), "-q", "-p", "no:cacheprovider", "-p", "no:randomly"])
    finally:
        for name in names:
            sys.modules.pop(name, None)
        sys.modules.update(saved)
    assert code == 0
