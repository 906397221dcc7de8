"""The port's app protocol (Dataset, Model, stages, type guards) against the JAX package's.

The cases of ``tests/unit/test_model.py``, ``test_dataset.py`` and
``test_type_guards.py`` run over both packages (``pkg``), with the same user
functions decorated by each; the cross-package tests then hold what the
protocol derives from those functions equal, case by case: the
hyperparameter dataclass (class name, fields, types, defaults), the stage
interfaces (input names and annotations, output names), the workflow names,
the rows of each split, the guard errors and sklearn predictions. Last, the
port imports with pandas, scikit-learn and joblib absent, and its step mode
trains on the device of the state ``init`` builds.
"""

import dataclasses
import io
import json
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union, get_args, get_origin

import numpy as np
import pandas as pd
import pytest
import torch

import unionml_tpu
import unionml_tpu.dataset
import unionml_tpu.model
import unionml_tpu.type_guards
import unionml_tpu_torch
import unionml_tpu_torch.dataset
import unionml_tpu_torch.model
import unionml_tpu_torch.type_guards

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_SAMPLES = 100
TEST_SIZE = 0.2

PACKAGES = {
    name: SimpleNamespace(
        name=name, Dataset=top.Dataset, Model=top.Model, ExecutionGraph=top.ExecutionGraph, stage=top.stage,
        BaseHyperparameters=model_mod.BaseHyperparameters, type_guards=guards,
        ReaderReturnTypeSource=dataset_mod.ReaderReturnTypeSource,
    )
    for name, top, model_mod, dataset_mod, guards in (
        ("jax", unionml_tpu, unionml_tpu.model, unionml_tpu.dataset, unionml_tpu.type_guards),
        ("torch", unionml_tpu_torch, unionml_tpu_torch.model, unionml_tpu_torch.dataset,
         unionml_tpu_torch.type_guards),
    )
}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class Estimator:
    ...


# ------------------------------------------------------------------ apps, the same user functions for both


def make_dataset(pkg, **kwargs) -> Any:
    dataset = pkg.Dataset(name="test_dataset", targets=["y"], test_size=TEST_SIZE, **kwargs)

    @dataset.reader
    def reader(sample_frac: float = 1.0, random_state: int = 42) -> pd.DataFrame:
        rng = np.random.default_rng(17)
        frame = pd.DataFrame({"x1": rng.normal(size=N_SAMPLES), "x2": rng.normal(size=N_SAMPLES)})
        frame["y"] = (frame["x1"] + frame["x2"] > 0).astype(int)
        return frame.sample(frac=sample_frac, random_state=random_state)

    return dataset


def make_sklearn_model(pkg, dataset=None) -> Any:
    from sklearn.linear_model import LogisticRegression

    model = pkg.Model(name="test_model", init=LogisticRegression, dataset=dataset or make_dataset(pkg))

    @model.trainer
    def trainer(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
        return estimator.fit(features, target.squeeze())

    @model.predictor
    def predictor(estimator: LogisticRegression, features: pd.DataFrame) -> List[float]:
        return [float(x) for x in estimator.predict(features)]

    @model.evaluator
    def evaluator(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> float:
        return float(estimator.score(features, target.squeeze()))

    return model


@pytest.fixture
def sklearn_model(pkg):
    return make_sklearn_model(pkg)


# ------------------------------------------------------------------ test_model.py, over both packages


def test_train_task_interface(sklearn_model):
    train_stage = sklearn_model.train_task()
    inputs = train_stage.interface.inputs
    assert list(inputs)[:2] == ["hyperparameters", "data"]
    assert {"loader_kwargs", "splitter_kwargs", "parser_kwargs"} <= set(inputs)
    assert list(train_stage.interface.outputs) == ["model_object", "hyperparameters", "metrics"]


def test_hyperparameter_type_synthesis(pkg):
    def init(C: float = 1.0, max_iter: int = 100) -> object:
        ...

    hp_type = pkg.Model(name="m", init=init, dataset=make_dataset(pkg)).hyperparameter_type
    assert issubclass(hp_type, pkg.BaseHyperparameters)
    hp = hp_type()
    assert hp.C == 1.0 and hp.max_iter == 100
    assert hp_type.from_json(hp.to_json()) == hp


def test_hyperparameter_type_untyped_init_falls_back_to_dict(pkg):
    def init(C=1.0):
        ...

    assert pkg.Model(name="m", init=init, dataset=make_dataset(pkg)).hyperparameter_type is dict


def test_hyperparameter_config_override(pkg):
    model = pkg.Model(name="m", dataset=make_dataset(pkg), hyperparameter_config={"alpha": float})
    assert model.hyperparameter_type(alpha=0.5).alpha == 0.5


def test_local_train(sklearn_model):
    model_obj, metrics = sklearn_model.train(hyperparameters={"max_iter": 500})
    assert model_obj is sklearn_model.artifact.model_object
    assert set(metrics) == {"train", "test"}
    assert metrics["train"] > 0.8


def test_local_train_with_stage_kwargs(sklearn_model):
    _, metrics = sklearn_model.train(
        hyperparameters={"max_iter": 500}, splitter_kwargs={"test_size": 0.5}, sample_frac=1.0
    )
    assert set(metrics) == {"train", "test"}


def test_predict_from_reader_vs_features_equivalence(sklearn_model):
    sklearn_model.train(hyperparameters={"max_iter": 500})
    preds_reader = sklearn_model.predict(sample_frac=1.0, random_state=0)
    raw = sklearn_model.dataset.dataset_task()(sample_frac=1.0, random_state=0)
    preds_features = sklearn_model.predict(features=raw[["x1", "x2"]].to_dict(orient="records"))
    assert preds_reader == preds_features


def test_predict_without_training_raises(sklearn_model):
    with pytest.raises(RuntimeError, match="ModelArtifact not found"):
        sklearn_model.predict(sample_frac=1.0)


def test_predict_requires_features_or_reader_kwargs(sklearn_model):
    with pytest.raises(ValueError, match="At least one of features"):
        sklearn_model.predict()


def test_save_load_path(sklearn_model, tmp_path):
    sklearn_model.train(hyperparameters={"max_iter": 500})
    path = tmp_path / "model.joblib"
    sklearn_model.save(str(path))
    preds_before = sklearn_model.predict(sample_frac=1.0, random_state=0)
    sklearn_model.artifact = None
    sklearn_model.load(str(path))
    assert sklearn_model.predict(sample_frac=1.0, random_state=0) == preds_before


def test_save_load_fileobj(sklearn_model):
    sklearn_model.train(hyperparameters={"max_iter": 500})
    buf = io.BytesIO()
    sklearn_model.save(buf)
    buf.seek(0)
    loaded = sklearn_model._loader(buf)
    assert loaded.coef_.shape == sklearn_model.artifact.model_object.coef_.shape


def test_load_from_env(sklearn_model, tmp_path, monkeypatch):
    sklearn_model.train(hyperparameters={"max_iter": 500})
    path = tmp_path / "model.joblib"
    sklearn_model.save(str(path))
    monkeypatch.setenv("UNIONML_MODEL_PATH", str(path))
    assert sklearn_model.load_from_env() is sklearn_model.artifact.model_object


def test_custom_saver_loader(sklearn_model, tmp_path):
    import joblib

    @sklearn_model.saver
    def saver(model_obj, hyperparameters, file):
        joblib.dump(model_obj, file)
        return file

    @sklearn_model.loader
    def loader(file):
        return joblib.load(file)

    sklearn_model.train(hyperparameters={"max_iter": 500})
    path = tmp_path / "custom.joblib"
    sklearn_model.save(str(path))
    sklearn_model.load(str(path))
    assert sklearn_model.artifact is not None


def test_model_stages_in_custom_graph(pkg, sklearn_model):
    sklearn_model.train(hyperparameters={"max_iter": 500})

    @pkg.stage
    def select_columns(data: pd.DataFrame) -> pd.DataFrame:
        return data[["x1", "x2"]]

    graph = pkg.ExecutionGraph("custom_predict")
    graph.add_input("model_object", object)
    graph.add_input("sample_frac", float)
    graph.add_input("random_state", int)
    reader_node = graph.add_node(
        sklearn_model.dataset.dataset_task(),
        sample_frac=graph.inputs["sample_frac"], random_state=graph.inputs["random_state"],
    )
    select_node = graph.add_node(select_columns, data=reader_node.outputs["data"])
    predict_node = graph.add_node(
        sklearn_model.predict_from_features_task(),
        model_object=graph.inputs["model_object"], features=select_node.outputs["o0"],
    )
    graph.add_output("predictions", predict_node.outputs[list(predict_node.outputs)[0]])
    preds = graph(model_object=sklearn_model.artifact.model_object, sample_frac=1.0, random_state=0)
    assert isinstance(preds, list) and len(preds) == 100


def test_trainer_type_guard_rejects_bad_signature(pkg):
    from sklearn.linear_model import LogisticRegression

    model = pkg.Model(name="m", init=LogisticRegression, dataset=make_dataset(pkg))
    with pytest.raises(TypeError):

        @model.trainer
        def trainer(estimator: LogisticRegression, features: int, target: int) -> LogisticRegression:
            return estimator


def test_workflow_names(sklearn_model):
    assert sklearn_model.train_workflow_name == "test_model.train"
    assert sklearn_model.predict_workflow_name == "test_model.predict"
    assert sklearn_model.predict_from_features_workflow_name == "test_model.predict_from_features"


# ------------------------------------------------------------------ test_dataset.py, over both packages


def test_reader_registration_and_stage(pkg):
    stage = make_dataset(pkg).dataset_task()
    assert stage.name == "test_dataset.dataset_task"
    assert "sample_frac" in stage.interface.inputs
    assert list(stage.interface.outputs) == ["data"]
    data = stage(sample_frac=1.0, random_state=0)
    assert isinstance(data, pd.DataFrame) and len(data) == 100


def test_reader_requires_return_annotation(pkg):
    dataset = pkg.Dataset(name="d")
    with pytest.raises(TypeError, match="return annotation cannot be empty"):

        @dataset.reader
        def reader():
            return pd.DataFrame()


def test_get_data_default_pipeline(pkg):
    dataset = make_dataset(pkg)
    data = dataset.get_data(dataset.dataset_task()(sample_frac=1.0, random_state=0))
    assert set(data) == {"train", "test"}
    (X_train, y_train), (X_test, _) = data["train"], data["test"]
    assert list(X_train.columns) == ["x1", "x2"] and list(y_train.columns) == ["y"]
    assert len(X_train) == 80 and len(X_test) == 20
    assert not set(X_train.index) & set(X_test.index)


def test_get_data_splitter_kwargs_override(pkg):
    dataset = make_dataset(pkg)
    data = dataset.get_data(dataset.dataset_task()(sample_frac=1.0, random_state=0), splitter_kwargs={"test_size": 0.5})
    assert len(data["train"][0]) == 50


def test_get_features_from_records(pkg):
    features = make_dataset(pkg).get_features([{"x1": 0.1, "x2": -0.2}, {"x1": 1.0, "x2": 2.0}])
    assert isinstance(features, pd.DataFrame)
    assert list(features.columns) == ["x1", "x2"] and len(features) == 2


def test_get_features_from_json_file(pkg, tmp_path):
    path = tmp_path / "features.json"
    path.write_text(json.dumps([{"x1": 0.5, "x2": 0.5}]))
    assert len(make_dataset(pkg).get_features(path)) == 1


def test_custom_loader_overrides_datatype(pkg):
    dataset = pkg.Dataset(name="d", targets=["y"])

    @dataset.reader
    def reader() -> str:
        return json.dumps([{"x": 1, "y": 0}, {"x": 2, "y": 1}])

    assert dataset.dataset_datatype_source is pkg.ReaderReturnTypeSource.READER

    @dataset.loader
    def loader(data: str) -> pd.DataFrame:
        return pd.DataFrame(json.loads(data))

    assert dataset.dataset_datatype_source is pkg.ReaderReturnTypeSource.LOADER
    assert dataset.dataset_datatype["data"] is pd.DataFrame
    assert isinstance(dataset.get_data(reader())["train"][0], pd.DataFrame)


def test_custom_splitter_and_parser_on_list_data(pkg):
    dataset = pkg.Dataset(name="d")

    @dataset.reader
    def reader() -> List[Dict]:
        return [{"x": i, "y": i % 2} for i in range(10)]

    @dataset.splitter
    def splitter(data: List[Dict], test_size: float, shuffle: bool, random_state: int) -> Tuple[List[Dict], List[Dict]]:
        n_test = int(len(data) * test_size)
        return data[:-n_test], data[-n_test:]

    @dataset.parser
    def parser(data: List[Dict], features: Optional[List[str]], targets: List[str]) -> Tuple[List[Dict], List[Dict]]:
        return [{k: v for k, v in row.items() if k != "y"} for row in data], [{"y": row["y"]} for row in data]

    data = dataset.get_data(reader())
    assert len(data["train"][0]) == 8 and len(data["test"][0]) == 2
    assert "y" not in data["train"][0][0]


def test_kwargs_dataclass_synthesis(pkg):
    dataset = make_dataset(pkg)
    splitter_kwargs = dataset.splitter_kwargs_type()
    assert (splitter_kwargs.test_size, splitter_kwargs.shuffle, splitter_kwargs.random_state) == (0.2, True, 12345)
    assert type(splitter_kwargs).from_json(splitter_kwargs.to_json()) == splitter_kwargs
    assert dataset.parser_kwargs_type().targets == ["y"]


def test_dataset_stage_in_custom_graph(pkg):
    graph = pkg.ExecutionGraph("custom")
    graph.add_input("sample_frac", float)
    graph.add_input("random_state", int)
    node = graph.add_node(
        make_dataset(pkg).dataset_task(),
        sample_frac=graph.inputs["sample_frac"], random_state=graph.inputs["random_state"],
    )
    graph.add_output("data", node.outputs["data"])
    assert isinstance(graph(sample_frac=1.0, random_state=0), pd.DataFrame)


def test_from_sqlite_query(pkg, tmp_path):
    import sqlite3

    db = tmp_path / "test.db"
    with sqlite3.connect(db) as conn:
        conn.execute("CREATE TABLE points (x1 REAL, x2 REAL, y INTEGER)")
        rng = np.random.default_rng(3)
        conn.executemany("INSERT INTO points VALUES (?, ?, ?)",
                         [(float(a), float(b), int(a + b > 0)) for a, b in rng.normal(size=(50, 2))])
    dataset = pkg.Dataset.from_sqlite_query(str(db), "SELECT * FROM points", name="sql_dataset", targets=["y"])
    raw = dataset.dataset_task()()
    assert isinstance(raw, pd.DataFrame)
    assert len(dataset.get_data(raw)["train"][0]) == 40


def test_iterator_prefetch(pkg):
    dataset = make_dataset(pkg)
    data = dataset.get_data(dataset.dataset_task()(sample_frac=1.0, random_state=0))
    kwargs = {"device": "cpu"} if pkg.name == "torch" else {}  # the port's entry points default to the card
    batches = list(dataset.iterator(data["train"], batch_size=16, **kwargs))
    assert len(batches) == 5  # 80 // 16
    X, y = batches[0]
    assert X.shape == (16, 2) and y.shape == (16, 1)


def test_feature_transformer(pkg):
    dataset = pkg.Dataset(name="d", targets=["y"])

    @dataset.reader
    def reader() -> pd.DataFrame:
        return pd.DataFrame({"x": [1.0, 2.0], "y": [0, 1]})

    @dataset.feature_transformer
    def feature_transformer(features: pd.DataFrame) -> pd.DataFrame:
        return features * 2

    assert dataset.get_features([{"x": 1.0}])["x"].iloc[0] == 2.0


# ------------------------------------------------------------------ type guards: the same outcome in both


class Splits(NamedTuple):
    train: pd.DataFrame
    test: pd.DataFrame


#: (guard, function source, guard arguments after the function, whether the JAX tests expect it to pass)
GUARD_CASES = {
    "reader-ok": ("guard_reader", "def f() -> pd.DataFrame: ...", (), True),
    "reader-missing-annotation": ("guard_reader", "def f(): ...", (), False),
    "loader-ok": ("guard_loader", "def f(data: pd.DataFrame): ...", (pd.DataFrame,), True),
    "loader-any-actual": ("guard_loader", "def f(data: Any): ...", (pd.DataFrame,), True),
    "loader-any-expected": ("guard_loader", "def f(data: pd.DataFrame): ...", (Any,), True),
    "loader-union": ("guard_loader", "def f(data: Union[pd.DataFrame, str]): ...", (pd.DataFrame,), True),
    "loader-mismatch": ("guard_loader", "def f(data: str): ...", (pd.DataFrame,), False),
    "splitter-ok": ("guard_splitter", "def f(data: pd.DataFrame, test_size: float, shuffle: bool, random_state: int)"
                    " -> Tuple[pd.DataFrame, pd.DataFrame]: ...", (pd.DataFrame, "reader"), True),
    "splitter-namedtuple": ("guard_splitter", "def f(data: pd.DataFrame, test_size: float, shuffle: bool, "
                            "random_state: int) -> Splits: ...", (pd.DataFrame, "reader"), True),
    "splitter-input-type": ("guard_splitter", "def f(data: str, test_size: float, shuffle: bool, random_state: int)"
                            " -> Tuple[str, str]: ...", (pd.DataFrame, "reader"), False),
    "splitter-not-generic": ("guard_splitter", "def f(data: pd.DataFrame, test_size: float, shuffle: bool, "
                             "random_state: int) -> pd.DataFrame: ...", (pd.DataFrame, "reader"), False),
    "splitter-element-type": ("guard_splitter", "def f(data: pd.DataFrame, test_size: float, shuffle: bool, "
                              "random_state: int) -> Tuple[str, str]: ...", (pd.DataFrame, "reader"), False),
    "splitter-missing-kwarg": ("guard_splitter", "def f(data: pd.DataFrame, test_size: float, shuffle: bool)"
                               " -> Tuple[pd.DataFrame, pd.DataFrame]: ...", (pd.DataFrame, "reader"), False),
    "splitter-kwarg-type": ("guard_splitter", "def f(data: pd.DataFrame, test_size: str, shuffle: bool, "
                            "random_state: int) -> Tuple[pd.DataFrame, pd.DataFrame]: ...",
                            (pd.DataFrame, "reader"), False),
    "parser-ok": ("guard_parser", "def f(data: pd.DataFrame, features: Optional[List[str]], targets: List[str])"
                  " -> Tuple[pd.DataFrame, pd.DataFrame]: ...", (pd.DataFrame, "reader"), True),
    "parser-missing-kwarg": ("guard_parser", "def f(data: pd.DataFrame, features: Optional[List[str]])"
                             " -> Tuple[pd.DataFrame, pd.DataFrame]: ...", (pd.DataFrame, "reader"), False),
    "trainer-ok": ("guard_trainer", "def f(model: Estimator, features: pd.DataFrame, target: pd.DataFrame)"
                   " -> Estimator: ...", (Estimator, (pd.DataFrame, pd.DataFrame)), True),
    "trainer-keyword-only": ("guard_trainer", "def f(model: Estimator, features: pd.DataFrame, target: "
                             "pd.DataFrame, *, lr: float = 0.1) -> Estimator: ...",
                             (Estimator, (pd.DataFrame, pd.DataFrame)), True),
    "trainer-model-type": ("guard_trainer", "def f(model: Estimator, features: pd.DataFrame, target: pd.DataFrame)"
                           " -> Estimator: ...", (str, (pd.DataFrame, pd.DataFrame)), False),
    "trainer-arity": ("guard_trainer", "def f(model: Estimator, features: pd.DataFrame, target: pd.DataFrame)"
                      " -> Estimator: ...", (Estimator, (pd.DataFrame,)), False),
    "trainer-data-types": ("guard_trainer", "def f(model: Estimator, features: pd.DataFrame, target: pd.DataFrame)"
                           " -> Estimator: ...", (Estimator, (str, str)), False),
    "trainer-return-type": ("guard_trainer", "def f(model: Estimator, features: pd.DataFrame, target: pd.DataFrame)"
                            " -> str: ...", (Estimator, (pd.DataFrame, pd.DataFrame)), False),
    "evaluator-ok": ("guard_evaluator", "def f(model: Estimator, features: pd.DataFrame, target: pd.DataFrame)"
                     " -> float: ...", (Estimator, (pd.DataFrame, pd.DataFrame)), True),
    "evaluator-data-types": ("guard_evaluator", "def f(model: Estimator, features: int, target: int) -> float: ...",
                             (Estimator, (pd.DataFrame, pd.DataFrame)), False),
    "predictor-ok": ("guard_predictor", "def f(model: Estimator, features: pd.DataFrame) -> List[float]: ...",
                     (Estimator, pd.DataFrame), True),
    "predictor-two-features": ("guard_predictor", "def f(model: Estimator, a: pd.DataFrame, b: pd.DataFrame)"
                               " -> List[float]: ...", (Estimator, pd.DataFrame), False),
    "predictor-missing-return": ("guard_predictor", "def f(model: Estimator, features: pd.DataFrame): ...",
                                 (Estimator, pd.DataFrame), False),
    "feature-loader-arity": ("guard_feature_loader", "def f(a: Any, b: Any) -> pd.DataFrame: ...", (Any,), False),
    "feature-transformer-arity": ("guard_feature_transformer", "def f(a: Any, b: Any) -> pd.DataFrame: ...",
                                  (Any,), False),
    "feature-transformer-ok": ("guard_feature_transformer", "def f(features: pd.DataFrame) -> pd.DataFrame: ...",
                               (pd.DataFrame,), True),
}


def _guard_outcome(pkg, case: str):
    guard, source, args, _ = GUARD_CASES[case]
    namespace = {"pd": pd, "Any": Any, "List": List, "Optional": Optional, "Tuple": Tuple, "Union": Union,
                 "Estimator": Estimator, "Splits": Splits}
    exec(source, namespace)
    try:
        getattr(pkg.type_guards, guard)(namespace["f"], *args)
    except TypeError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_outcomes_equal_the_jax_package(case):
    """Each guard passes or raises in both packages as the JAX tests expect,
    and a raise carries the JAX package's message."""
    outcomes = {name: _guard_outcome(pkg, case) for name, pkg in PACKAGES.items()}
    assert (outcomes["jax"] is None) == GUARD_CASES[case][3]
    assert outcomes["torch"] == outcomes["jax"]


@pytest.mark.parametrize("annotation", [torch.Tensor, Any])
def test_tensor_and_any_annotations_are_wildcards(annotation):
    """The port's one extension: ``torch.Tensor`` is a wildcard like ``Any``
    (the JAX package's is ``Any`` alone)."""
    def loader(data: annotation): ...

    unionml_tpu_torch.type_guards.guard_loader(loader, pd.DataFrame)
    unionml_tpu_torch.type_guards.guard_loader(lambda data: data, annotation)


# ------------------------------------------------------------------ what the protocol derives: equal in both


def _shape(annotation: Any) -> Any:
    """An annotation in a form comparable across packages: synthesized
    dataclasses and NamedTuples by name and fields, generics by origin and
    arguments."""
    if isinstance(annotation, type) and dataclasses.is_dataclass(annotation):
        return ("dataclass", annotation.__name__, [b.__name__ for b in annotation.__mro__[1:]],
                [(f.name, _shape(f.type), repr(f.default),
                  f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
                 for f in dataclasses.fields(annotation)])
    if isinstance(annotation, type) and issubclass(annotation, tuple) and hasattr(annotation, "_fields"):
        hints = getattr(annotation, "__annotations__", {})
        return ("namedtuple", annotation.__name__, [(n, _shape(hints.get(n))) for n in annotation._fields])
    if get_origin(annotation) is not None:
        return ("generic", get_origin(annotation), [_shape(a) for a in get_args(annotation)])
    return annotation


INITS = {
    "typed-defaults": "def init(C: float = 1.0, max_iter: int = 100) -> Estimator: ...",
    "required-and-default": "def init(alpha: float, layers: List[int] = None, name: str = 'x') -> Estimator: ...",
    "untyped": "def init(C=1.0): ...",
    "no-params": "def init() -> Estimator: ...",
}


@pytest.mark.parametrize("case", [*INITS, "hyperparameter-config"])
def test_hyperparameter_type_equals_the_jax_package(case):
    shapes = []
    for pkg in PACKAGES.values():
        if case == "hyperparameter-config":
            model = pkg.Model(name="m", dataset=make_dataset(pkg), hyperparameter_config={"alpha": float, "k": int})
        else:
            namespace = {"Estimator": Estimator, "List": List}
            exec(INITS[case], namespace)
            model = pkg.Model(name="m", init=namespace["init"], dataset=make_dataset(pkg))
        hp_type = model.hyperparameter_type
        shapes.append("dict" if hp_type is dict else _shape(hp_type))
    assert shapes[0] == shapes[1]


def _interfaces(model) -> Dict[str, Any]:
    stages = {
        "dataset_task": model.dataset.dataset_task(), "train_task": model.train_task(),
        "predict_task": model.predict_task(), "predict_from_features_task": model.predict_from_features_task(),
    }
    out = {name: (stage.name, [(k, _shape(v)) for k, v in stage.interface.inputs.items()],
                  [(k, _shape(v)) for k, v in stage.interface.outputs.items()]) for name, stage in stages.items()}
    for name, graph in (("train", model.train_workflow()), ("predict", model.predict_workflow()),
                        ("predict_from_features", model.predict_from_features_workflow())):
        out[f"{name}_workflow"] = (graph.name, [(k, _shape(v)) for k, v in graph.input_types.items()],
                                   graph.output_names)
    out["kwargs_types"] = [_shape(t) for t in (model.dataset.loader_kwargs_type, model.dataset.splitter_kwargs_type,
                                                model.dataset.parser_kwargs_type)]
    out["feature_type"] = _shape(model.dataset.feature_type)
    return out


def test_stage_interfaces_and_workflow_names_equal_the_jax_package():
    jax_side, torch_side = (_interfaces(make_sklearn_model(pkg)) for pkg in PACKAGES.values())
    assert jax_side.keys() == torch_side.keys()
    for key in jax_side:
        assert torch_side[key] == jax_side[key], key
    assert torch_side["train_workflow"][0] == "test_model.train"


def test_step_mode_interfaces_equal_the_jax_package():
    """A step-mode trainer (``config=``) and a keyword-only eager trainer
    parameter shape the train stage the same way in both packages."""
    from sklearn.linear_model import LogisticRegression

    sides = []
    for pkg in PACKAGES.values():
        model = pkg.Model(name="step_model", init=LogisticRegression, dataset=make_dataset(pkg))

        @model.trainer
        def trainer(est: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame, *,
                    epochs: int = 3) -> LogisticRegression:
            return est

        eager = [(k, _shape(v)) for k, v in model.train_task().interface.inputs.items()]
        model.trainer(lambda state, batch: (state, {}), config=object())
        step = [(k, _shape(v)) for k, v in model.train_task().interface.inputs.items()]
        sides.append((eager, step, _shape(model.train_task().interface.outputs["model_object"])))
    assert sides[0] == sides[1]
    assert ("epochs", int) in sides[1][0] and all(name != "epochs" for name, _ in sides[1][1])


@pytest.mark.parametrize(
    "test_size,shuffle,random_state", [(0.2, True, 12345), (0.5, True, 7), (0.2, False, 12345), (0.0, True, 1)]
)
def test_split_rows_equal_the_jax_package(test_size, shuffle, random_state):
    rows = []
    for pkg in PACKAGES.values():
        dataset = make_dataset(pkg)
        raw = dataset.dataset_task()(sample_frac=1.0, random_state=0)
        data = dataset.get_data(
            raw, splitter_kwargs={"test_size": test_size, "shuffle": shuffle, "random_state": random_state}
        )
        rows.append({split: [list(part.index) for part in parts] for split, parts in data.items()})
    assert rows[0] == rows[1]


def test_sklearn_predictions_equal_the_jax_package():
    outputs = []
    for pkg in PACKAGES.values():
        model = make_sklearn_model(pkg)
        _, metrics = model.train(hyperparameters={"max_iter": 500})
        outputs.append((metrics, model.predict(sample_frac=1.0, random_state=0),
                        model.predict(features=[{"x1": 0.3, "x2": -1.0}, {"x1": 2.0, "x2": 0.5}])))
    assert outputs[0] == outputs[1]


# ------------------------------------------------------------------ the port's own


def test_import_needs_no_pandas_sklearn_or_joblib():
    """``import unionml_tpu_torch`` (and an app of arrays through Model.train
    and predict) with pandas, scikit-learn and joblib blocked."""
    script = textwrap.dedent(
        """
        import sys
        for name in ("pandas", "sklearn", "joblib"):
            sys.modules[name] = None
        import numpy as np
        import torch
        from unionml_tpu_torch import Dataset, Model

        dataset = Dataset(name="arrays")
        model = Model(name="m", dataset=dataset)

        @dataset.reader
        def reader(n: int = 8) -> np.ndarray:
            return np.arange(n * 2, dtype=np.float64).reshape(n, 2)

        @model.init
        def init(hyperparameters: dict) -> torch.nn.Module:
            return torch.nn.Linear(2, 1, device="cpu")

        @model.trainer
        def trainer(module: torch.nn.Module, features: np.ndarray) -> torch.nn.Module:
            return module

        @model.predictor
        def predictor(module: torch.nn.Module, features: np.ndarray) -> list:
            return module(torch.as_tensor(features, dtype=torch.float32)).flatten().tolist()

        model.train(n=8)
        assert len(model.predict(n=4)) == 4
        assert len(model.predict(features=np.ones((3, 2)))) == 3
        loaded = [m for m in ("pandas", "sklearn", "joblib") if sys.modules.get(m) is not None]
        assert not loaded, loaded
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]


def _step_app(evaluate_steps: bool):
    from unionml_tpu_torch import Llama, LlamaConfig, TrainerConfig, TrainState, make_train_step
    from unionml_tpu_torch.models import causal_lm_loss

    cfg = LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64, vocab_size=32,
                           dtype=torch.float32, param_dtype=torch.float32)
    dataset = unionml_tpu_torch.Dataset(name="tokens")
    model = unionml_tpu_torch.Model(name="step", dataset=dataset)

    @dataset.reader
    def reader(n: int = 12) -> np.ndarray:
        return np.random.default_rng(0).integers(1, 32, size=(n, 16)).astype(np.int64)

    @model.init
    def init(hyperparameters: dict) -> TrainState:
        module = Llama(cfg, device=hyperparameters.get("device"), seed=0)
        return TrainState(module, torch.optim.SGD(module.parameters(), lr=0.1))

    step = make_train_step(causal_lm_loss)

    @model.trainer(config=TrainerConfig(epochs=1, batch_size=4, shuffle=False, log_every_steps=1))
    def trainer(state: TrainState, batch) -> tuple:
        return step(state, batch)

    if evaluate_steps:
        @model.evaluator(config=TrainerConfig(batch_size=5))
        def evaluator(state: TrainState, batch) -> dict:
            return {"loss": causal_lm_loss(state.model, batch)}

    return model


@pytest.mark.parametrize("evaluate_steps", [False, True], ids=["no-evaluator", "step-evaluator"])
def test_step_mode_trains_on_the_device_init_chose(monkeypatch, evaluate_steps):
    """``init`` asked for the CPU, so ``fit`` and ``evaluate`` run there: no
    CUDA probe (the card is reported missing, and nothing asks for it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _step_app(evaluate_steps)
    state, metrics = model.train(hyperparameters={"device": "cpu"}, n=12)
    assert model.last_fit_result.steps == 3 and len(model.last_fit_result.history) == 3
    assert next(state.model.parameters()).device == torch.device("cpu")
    assert set(metrics) == ({"train"} if evaluate_steps else set())
    if evaluate_steps:
        assert np.isfinite(metrics["train"]["loss"])
    with pytest.raises(RuntimeError, match='device="cpu"'):  # unset device: the card, which is missing
        model.train(hyperparameters={}, n=12)


@pytest.mark.parametrize("call", ["serve", "predictor-jit", "remote", "remote_train"])
def test_unported_parts_raise_naming_the_roadmap(call):
    from unionml_tpu_torch.parallel import MeshSpec

    model = make_sklearn_model(PACKAGES["torch"])
    calls = {
        "serve": (lambda: model.serve(remote=True), "Queue A: the rest"),
        # a MeshSpec runs (tests/test_torch_serving_mesh.py), a pipe axis too (replicated, as in JAX): one
        # process holds no pipe=2 mesh, which raises JAX's ValueError for too few devices, not a refusal
        "predictor-jit": (lambda: model.predictor(model._predictor, config=SimpleNamespace(jit=True, mesh=MeshSpec(
            pipe=2))), None),
        "remote": (lambda: model.remote(backend_store="store"), "Queue A: the rest"),
        "remote_train": (lambda: model.remote_train(hyperparameters={}), "Queue A: the rest"),
    }
    fn, item = calls[call]
    if item is None:  # ported since
        with pytest.raises(ValueError, match="1 devices not divisible by fixed axes product 2"):
            fn()
        return
    with pytest.raises(NotImplementedError, match=item):
        fn()


def test_app_hooks_stay_settable():
    model = make_sklearn_model(PACKAGES["torch"])
    model.generation_batcher, model.generation_warmup, model.__app_module__ = "b", print, "app:model"
    assert (model.generation_batcher, model.generation_warmup, model.__app_module__) == ("b", print, "app:model")
