"""{{app_name}}: wine-cultivar classification with a standardized feature pipeline.

Train/serve flow:

    python app.py                                   # local train + sample predictions
    python -m unionml_tpu_torch.cli serve app:model --model-path wine_model.joblib

The app demonstrates the three core hooks beyond the minimum (reader/trainer/
predictor/evaluator): a ``feature_transformer`` that standardizes columns with
statistics captured at read time, a probability-aware predictor, and macro-F1
evaluation (the wine classes are imbalanced enough that accuracy alone flatters).
The model is a scikit-learn forest on the host: it needs no card.
"""

from typing import List

import numpy as np
import pandas as pd
from sklearn.datasets import load_wine
from sklearn.ensemble import RandomForestClassifier
from sklearn.metrics import f1_score

from unionml_tpu_torch import Dataset, Model

TARGET = "cultivar"

dataset = Dataset(name="wine_dataset", test_size=0.25, shuffle=True, targets=[TARGET])
model = Model(name="wine_classifier", init=RandomForestClassifier, dataset=dataset)
model.__app_module__ = "app:model"

# standardization statistics captured once from the full table so serving-time
# requests (single rows) are scaled identically to training batches
_bunch = load_wine(as_frame=True)
_STATS = {"mean": _bunch.data.mean(), "std": _bunch.data.std(ddof=0).replace(0.0, 1.0)}


@dataset.reader
def reader(max_rows: int = 0) -> pd.DataFrame:
    table = _bunch.frame.rename(columns={"target": TARGET})
    return table.head(max_rows) if max_rows else table


@dataset.feature_transformer
def feature_transformer(features: pd.DataFrame) -> pd.DataFrame:
    scaled = (features - _STATS["mean"]) / _STATS["std"]
    return scaled.astype(np.float32)


@model.trainer
def trainer(
    forest: RandomForestClassifier, features: pd.DataFrame, target: pd.DataFrame
) -> RandomForestClassifier:
    forest.fit(features.to_numpy(), target.to_numpy().ravel())
    return forest


@model.predictor
def predictor(forest: RandomForestClassifier, features: pd.DataFrame) -> List[int]:
    probabilities = forest.predict_proba(features.to_numpy())
    return [int(label) for label in probabilities.argmax(axis=1)]


@model.evaluator
def evaluator(forest: RandomForestClassifier, features: pd.DataFrame, target: pd.DataFrame) -> float:
    predicted = forest.predict(features.to_numpy())
    return float(f1_score(target.to_numpy().ravel(), predicted, average="macro"))


if __name__ == "__main__":
    trained, scores = model.train(hyperparameters={"n_estimators": 200, "random_state": 7})
    print(f"macro-F1  train={scores['train']:.3f}  test={scores['test']:.3f}")

    tasting_flight = reader().drop(columns=[TARGET]).sample(4, random_state=11)
    for row_id, cultivar in zip(tasting_flight.index, model.predict(features=tasting_flight)):
        print(f"sample {row_id}: cultivar {cultivar}")

    model.save("wine_model.joblib")
