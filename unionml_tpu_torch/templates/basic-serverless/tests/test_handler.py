import json
import os

import pytest
from sklearn.datasets import load_breast_cancer


@pytest.fixture(scope="module")
def trained_model(tmp_path_factory):
    from app import model

    model.train(hyperparameters={"alpha": 1e-4, "max_iter": 2000})
    path = tmp_path_factory.mktemp("model") / "model_object.joblib"
    model.save(path)
    os.environ["UNIONML_MODEL_PATH"] = str(path)
    yield model
    os.environ.pop("UNIONML_MODEL_PATH", None)


def test_train_quality(trained_model):
    assert trained_model.artifact.metrics["test"] > 0.95  # ROC-AUC


def test_predict_event(trained_model):
    from handler import handler

    sample = (
        load_breast_cancer(as_frame=True)
        .frame.rename(columns={"target": "diagnosis"})
        .sample(5, random_state=42)
        .drop(["diagnosis"], axis="columns")
    )
    event = {
        "httpMethod": "POST",
        "path": "/predict",
        "body": json.dumps({"features": json.loads(sample.to_json(orient="records"))}),
    }
    response = handler(event, None)
    assert response["statusCode"] == 200
    probabilities = json.loads(response["body"])
    assert len(probabilities) == 5
    assert all(0.0 <= p <= 1.0 for p in probabilities)
