"""{{app_name}}: serverless tumor-diagnosis scoring (breast-cancer dataset).

The model trains offline (``python app.py``) and is served from a function
runtime via ``handler.py`` — the HTTP handler answers API-Gateway-style events,
and the batch handler scores feature files dropped into an object store. The
predictor returns malignancy probabilities rather than hard labels so callers
can pick their own decision threshold.
"""

from typing import List

import pandas as pd
from sklearn.datasets import load_breast_cancer
from sklearn.linear_model import SGDClassifier
from sklearn.metrics import roc_auc_score
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import StandardScaler

from unionml_tpu_torch import Dataset, Model

dataset = Dataset(name="tumor_dataset", test_size=0.3, shuffle=True, targets=["diagnosis"])


def build_pipeline(alpha: float = 1e-4, max_iter: int = 1000) -> Pipeline:
    """Scaler + logistic-loss SGD in one estimator, so serving needs no side state."""
    classifier = SGDClassifier(loss="log_loss", alpha=alpha, max_iter=max_iter, random_state=0)
    return Pipeline([("scale", StandardScaler()), ("classify", classifier)])


model = Model(name="tumor_scorer", init=build_pipeline, dataset=dataset)
model.__app_module__ = "app:model"


@dataset.reader
def reader(limit: int = 0) -> pd.DataFrame:
    bunch = load_breast_cancer(as_frame=True)
    table = bunch.frame.rename(columns={"target": "diagnosis"})
    return table.head(limit) if limit else table


@model.trainer
def trainer(pipeline: Pipeline, features: pd.DataFrame, target: pd.DataFrame) -> Pipeline:
    pipeline.fit(features.to_numpy(), target.to_numpy().ravel())
    return pipeline


@model.predictor
def predictor(pipeline: Pipeline, features: pd.DataFrame) -> List[float]:
    malignant = pipeline.predict_proba(features.to_numpy())[:, 1]
    return [round(float(p), 6) for p in malignant]


@model.evaluator
def evaluator(pipeline: Pipeline, features: pd.DataFrame, target: pd.DataFrame) -> float:
    scores = pipeline.predict_proba(features.to_numpy())[:, 1]
    return float(roc_auc_score(target.to_numpy().ravel(), scores))


if __name__ == "__main__":
    _, auc = model.train(hyperparameters={"alpha": 1e-4, "max_iter": 2000})
    print(f"ROC-AUC  train={auc['train']:.4f}  test={auc['test']:.4f}")
    model.save("model_object.joblib")
