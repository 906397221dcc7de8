import numpy as np
from sklearn.datasets import load_digits

from app import model

#: the tests ask for the CPU; unset, the app trains and predicts on the card
HYPERPARAMETERS = {"learning_rate": 1e-3, "device": "cpu"}


def test_train_and_predict():
    model_object, metrics = model.train(hyperparameters=HYPERPARAMETERS)
    assert metrics["train"] > 0.8
    frame = load_digits(as_frame=True).frame.sample(4, random_state=0)
    features = frame.drop(columns=["target"]).to_numpy(dtype=np.float32)
    predictions = model.predict(features=features)
    assert len(predictions) == 4
