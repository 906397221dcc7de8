from app import TARGET, model, reader


def test_train_and_predict():
    _, scores = model.train(hyperparameters={"n_estimators": 50, "random_state": 0})
    assert scores["train"] > 0.95
    assert scores["test"] > 0.85

    flight = reader().drop(columns=[TARGET]).sample(6, random_state=3)
    predictions = model.predict(features=flight)
    assert len(predictions) == 6
    assert all(label in (0, 1, 2) for label in predictions)


def test_reader_kwargs_flow_through_predict():
    model.train(hyperparameters={"n_estimators": 50, "random_state": 0})
    predictions = model.predict(max_rows=10)
    assert len(predictions) == 10
