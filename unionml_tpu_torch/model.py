"""Model: the central spec class binding user functions into train/predict services.

The port's copy of ``unionml_tpu/model.py`` (UnionML's ``Model``, reference
unionml/model.py:55-988): ``Model`` registers user functions
(``init``/``trainer``/``predictor``/``evaluator``/``saver``/``loader``),
synthesizes a typed Hyperparameters dataclass from the ``init`` signature,
compiles three stages and three execution graphs (train, predict,
predict_from_features), runs them in-process and persists model objects.

Two trainer modes, as in the JAX package:

- **eager mode** (default): ``trainer(model_obj, *data, **kw) -> model_obj``,
  executed once on the host — right for sklearn-style estimators.
- **step mode** (``@model.trainer(config=TrainerConfig(...))``): the
  registered function is a ``(state, batch) -> (state, metrics)`` step, run
  over the epoch schedule by :func:`unionml_tpu_torch.train.fit` on the
  device of the state ``init`` builds: an app whose ``init`` asked for the
  CPU trains there, every other on the card. ``TrainerConfig(mesh=...,
  partition_rules=...)`` trains over a mesh, one process a rank, each
  running the same app (the state is cut to the rank's shards).

Serving: :meth:`Model.serve` returns the port's
:class:`~unionml_tpu_torch.serving.ServingApp`, and
``predictor(config=ServingConfig(jit=True))`` routes predictor calls through
a :class:`~unionml_tpu_torch.serving.compile.CompiledPredictor` (bucketed
padding under ``torch.inference_mode()``).

Remote: :meth:`Model.remote` configures the backend
(:mod:`unionml_tpu_torch.remote`), and ``remote_deploy``/``remote_train``/
``remote_predict`` ship the app to a store and run its workflows in
``job_runner`` workers on the card; ``serve(remote=True)`` serves the
registry's latest trained artifact.
"""

from __future__ import annotations

import inspect
import os
from collections import OrderedDict
from dataclasses import field, is_dataclass, make_dataclass
from functools import partial
from inspect import Parameter

from typing import IO, Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Type, Union

from torch import nn

from unionml_tpu_torch import type_guards
from unionml_tpu_torch._device import module_device
from unionml_tpu_torch.artifact import ModelArtifact, load_model_object, save_model_object
from unionml_tpu_torch.dataset import Dataset, _is_frame_type
from unionml_tpu_torch.defaults import DEFAULT_RESOURCES, MODEL_PATH_ENV_VAR
from unionml_tpu_torch.stage import ExecutionGraph, Stage
from unionml_tpu_torch.utils import dataclass_to_dict, json_dataclass
from unionml_tpu_torch.utils import resolved_signature as signature

__all__ = ["BaseHyperparameters", "Model", "ModelArtifact"]

def _state_device(model_object: Any) -> Any:
    """The device a step-mode state lives on: that of its module (a
    ``TrainState``'s ``model``, or the object itself), else None (CUDA)."""
    module = model_object if isinstance(model_object, nn.Module) else getattr(model_object, "model", None)
    return module_device(module) if isinstance(module, nn.Module) else None


class BaseHyperparameters:
    """Marker base class for synthesized hyperparameter dataclasses
    (reference unionml/model.py:31-39)."""


class Model:
    def __init__(
        self,
        name: str = "model",
        init: Union[Type, Callable, None] = None,
        *,
        dataset: Dataset,
        hyperparameter_config: Optional[Dict[str, Type]] = None,
    ):
        """Bind a model spec to a :class:`unionml_tpu_torch.dataset.Dataset`.

        :param name: name of the model app.
        :param init: class or callable producing a fresh model object (an sklearn
            estimator, a :class:`~unionml_tpu_torch.train.TrainState`, ...) from
            hyperparameters.
        :param dataset: the bound Dataset.
        :param hyperparameter_config: explicit ``{name: type}`` map overriding
            hyperparameter synthesis from the ``init`` signature.
        """
        self.name = name
        self._init_callable = init
        self._hyperparameter_config = hyperparameter_config
        self._dataset = dataset
        self._artifact: Optional[ModelArtifact] = None

        # registered component functions (defaults may be overridden by decorators)
        self._init: Callable = self._default_init
        self._trainer: Optional[Callable] = None
        self._predictor: Optional[Callable] = None
        self._stream_predictor: Optional[Callable] = None
        self._evaluator: Optional[Callable] = None
        self._saver: Callable = self._default_saver
        self._loader: Callable = self._default_loader

        # step-mode configs
        self._trainer_mode: str = "eager"
        self._trainer_config: Optional[Any] = None
        self._evaluator_mode: str = "eager"
        self._evaluator_config: Optional[Any] = None
        self._predictor_config: Optional[Any] = None
        self._compiled_predictor: Optional[Any] = None
        self.last_fit_result: Optional[Any] = None
        self._backend_config: Optional[Any] = None
        self.__backend__: Optional[Any] = None

        # stage caches + per-stage exec kwargs
        self._train_stage: Optional[Stage] = None
        self._predict_stage: Optional[Stage] = None
        self._predict_from_features_stage: Optional[Stage] = None
        self._train_stage_kwargs: Optional[Dict[str, Any]] = None
        self._predict_stage_kwargs: Dict[str, Any] = {}

        self._hyperparameter_type: Optional[Type] = None

        if self._dataset.name is None:
            self._dataset.name = f"{self.name}.dataset"

    # ------------------------------------------------------------------ properties

    @property
    def artifact(self) -> Optional[ModelArtifact]:
        return self._artifact

    @artifact.setter
    def artifact(self, value: ModelArtifact) -> None:
        self._artifact = value

    @property
    def dataset(self) -> Dataset:
        return self._dataset

    @property
    def hyperparameter_type(self) -> Type:
        """Synthesize the typed Hyperparameters dataclass (reference model.py:137-161).

        Derived from ``hyperparameter_config`` when given, else from the annotated
        ``init`` signature; falls back to plain ``dict`` when any parameter is
        unannotated.
        """
        if self._hyperparameter_type is not None:
            return self._hyperparameter_type

        fields: List[Any] = []
        if self._hyperparameter_config is not None:
            for hp_name, hp_type in self._hyperparameter_config.items():
                fields.append((hp_name, hp_type))
        else:
            if self._init_callable is None:
                return dict
            init_sig = signature(self._init_callable)
            if any(p.annotation is Parameter.empty for p in init_sig.parameters.values()):
                return dict
            for hp_name, p in init_sig.parameters.items():
                if p.default is Parameter.empty:
                    fields.append((hp_name, p.annotation))
                else:
                    fields.append((hp_name, p.annotation, field(default=p.default)))

        self._hyperparameter_type = json_dataclass(
            make_dataclass("Hyperparameters", fields, bases=(BaseHyperparameters,))
        )
        return self._hyperparameter_type

    @property
    def train_workflow_name(self) -> str:
        return f"{self.name}.train"

    @property
    def predict_workflow_name(self) -> str:
        return f"{self.name}.predict"

    @property
    def predict_from_features_workflow_name(self) -> str:
        return f"{self.name}.predict_from_features"

    @property
    def model_type(self) -> Type:
        """Type of the model object (reference model.py:919-922): the ``init`` class
        itself, or the return annotation of the init callable."""
        init = self._init_callable if self._init == self._default_init else (self._init or self._init_callable)
        if init is None:
            return Any  # type: ignore[return-value]
        if inspect.isclass(init):
            return init
        return signature(init).return_annotation

    @property
    def trainer_params(self) -> Dict[str, Parameter]:
        """Keyword-only params of the trainer — exposed as typed workflow inputs
        (reference model.py:283-290). Empty in step mode (the step signature is fixed)."""
        if self._trainer is None or self._trainer_mode == "step":
            return {}
        return {
            p_name: p
            for p_name, p in signature(self._trainer).parameters.items()
            if p.kind == Parameter.KEYWORD_ONLY
        }

    # ------------------------------------------------------------------ decorators

    def init(self, fn: Callable) -> Callable:
        """Register a function initializing a model object (reference model.py:193-196)."""
        self._init = fn
        return fn

    def _trainer_expected_types(self) -> Tuple[Any, ...]:
        if self._dataset._parser == self._dataset._default_parser:
            data_type = self._dataset.dataset_datatype["data"]
            return (data_type, data_type) if _is_frame_type(data_type) else (data_type,)
        return self._dataset.parser_return_types

    def trainer(self, fn: Optional[Callable] = None, *, config: Optional[Any] = None, **stage_kwargs: Any):
        """Register the training function.

        Eager mode (reference-compatible, unionml/model.py:198-228)::

            @model.trainer
            def trainer(estimator: LogisticRegression, X: pd.DataFrame, y: pd.DataFrame) -> LogisticRegression: ...

        Step mode::

            @model.trainer(config=TrainerConfig(epochs=3, batch_size=512))
            def train_step(state: TrainState, batch) -> tuple[TrainState, dict]: ...

        A step-mode trainer runs :func:`unionml_tpu_torch.train.fit` on the
        device of the state ``init`` builds.
        """
        if fn is None:
            return partial(self.trainer, config=config, **stage_kwargs)

        if config is not None:
            self._trainer_mode = "step"
            self._trainer_config = config
        else:
            self._trainer_mode = "eager"
            type_guards.guard_trainer(fn, self.model_type, self._trainer_expected_types())
        self._trainer = fn
        self._train_stage_kwargs = {"resources": DEFAULT_RESOURCES, **stage_kwargs}
        self._train_stage = None
        return fn

    def evaluator(self, fn: Optional[Callable] = None, *, config: Optional[Any] = None):
        """Register the metrics function (reference model.py:254-271). With ``config``,
        the function is a batched ``(state, batch) -> {metric: value}`` eval step run
        via :func:`unionml_tpu_torch.train.evaluate`, on the device of the state."""
        if fn is None:
            return partial(self.evaluator, config=config)
        if config is not None:
            self._evaluator_mode = "step"
            self._evaluator_config = config
        else:
            self._evaluator_mode = "eager"
            type_guards.guard_evaluator(fn, self.model_type, self._trainer_expected_types())
        self._evaluator = fn
        return fn

    def predictor(self, fn: Optional[Callable] = None, *, config: Optional[Any] = None, **stage_kwargs: Any):
        """Register the prediction function (reference model.py:230-252).
        ``config`` (a :class:`unionml_tpu_torch.serving.ServingConfig`) with
        ``jit`` set opts into bucketed serving through a
        :class:`~unionml_tpu_torch.serving.compile.CompiledPredictor`."""
        if fn is None:
            return partial(self.predictor, config=config, **stage_kwargs)
        type_guards.guard_predictor(fn, self.model_type, self._dataset.feature_type)
        self._predictor = fn
        self._predictor_config = config
        self._compiled_predictor = None
        if config is not None and getattr(config, "jit", False):
            from unionml_tpu_torch.serving.compile import CompiledPredictor

            self._compiled_predictor = CompiledPredictor(fn, config)
        self._predict_stage_kwargs = {"resources": DEFAULT_RESOURCES, **stage_kwargs}
        self._predict_stage = None
        self._predict_from_features_stage = None
        return fn

    def stream_predictor(self, fn: Optional[Callable] = None):
        """Register an incremental predictor for the streaming serving route
        (``POST /predict-stream``): ``fn(model_object, features)`` must return an
        iterator/generator of JSON-serializable chunks, which the server emits as
        newline-delimited JSON over chunked transfer encoding. No reference
        analog — the reference's serve path cannot stream
        (unionml/fastapi.py:50-64); this is the serving face of
        :meth:`unionml_tpu_torch.models.Generator.stream`."""
        if fn is None:
            return self.stream_predictor
        self._stream_predictor = fn
        return fn

    def _call_predictor(self, model_object: Any, features: Any) -> Any:
        """Route a predictor call through the bucketed path when configured,
        else call the user fn eagerly (reference model.py:498-499 semantics)."""
        if self._compiled_predictor is not None:
            return self._compiled_predictor(model_object, features)
        return self._predictor(model_object, features)

    def _predictor_warmup(self, batch_size: Optional[int] = None) -> None:
        """Run the predictor over every configured bucket — called once by
        :meth:`unionml_tpu_torch.serving.app.ServingApp.startup` after the
        artifact loads (``batch_size`` is accepted for per-bucket callers)."""
        if self._compiled_predictor is None or self.artifact is None:
            return
        self._compiled_predictor.warmup(self.artifact.model_object, batch_size)

    def saver(self, fn: Callable) -> Callable:
        """Register a custom model-object serializer (reference model.py:273-276)."""
        self._saver = fn
        return fn

    def loader(self, fn: Callable) -> Callable:
        """Register a custom model-object deserializer (reference model.py:278-281)."""
        self._loader = fn
        return fn

    # ------------------------------------------------------------------ stage compilation

    def train_task(self) -> Stage:
        """Compile the train stage: get_data -> init -> trainer -> evaluator
        (reference model.py:377-443). In step mode the trainer portion hands off to
        :func:`unionml_tpu_torch.train.fit`."""
        if self._train_stage is not None:
            return self._train_stage
        if self._trainer is None:
            raise ValueError(f"model '{self.name}' has no registered @model.trainer function")

        [(data_arg_name, data_arg_type)] = self._dataset.dataset_datatype.items()

        hp_param = Parameter("hyperparameters", kind=Parameter.KEYWORD_ONLY, annotation=self.hyperparameter_type)
        params: "OrderedDict[str, Parameter]" = OrderedDict()
        params["hyperparameters"] = hp_param
        params[data_arg_name] = Parameter(data_arg_name, kind=Parameter.KEYWORD_ONLY, annotation=data_arg_type)
        for kw in ("loader_kwargs", "splitter_kwargs", "parser_kwargs"):
            params[kw] = Parameter(kw, kind=Parameter.KEYWORD_ONLY, annotation=dict, default=None)
        for p_name, p in self.trainer_params.items():
            params[p_name] = p

        if self._trainer_mode == "step":
            model_object_type = Any
        else:
            model_object_type = signature(self._trainer).return_annotation
        evaluator_type = signature(self._evaluator).return_annotation if self._evaluator else Any
        return_annotation = NamedTuple(  # type: ignore[misc]
            "TrainOutputs",
            model_object=model_object_type,
            hyperparameters=self.hyperparameter_type,
            metrics=Dict[str, evaluator_type],  # type: ignore[valid-type]
        )

        def train_task(**kwargs: Any):
            hyperparameters = kwargs["hyperparameters"]
            hp_dict = dataclass_to_dict(hyperparameters) if is_dataclass(hyperparameters) else dict(hyperparameters or {})
            trainer_kwargs = {p: kwargs[p] for p in self.trainer_params if p in kwargs}
            as_dict = lambda v: dataclass_to_dict(v) if is_dataclass(v) else v  # noqa: E731
            training_data = self._dataset.get_data(
                kwargs[data_arg_name],
                loader_kwargs=as_dict(kwargs.get("loader_kwargs")),
                splitter_kwargs=as_dict(kwargs.get("splitter_kwargs")),
                parser_kwargs=as_dict(kwargs.get("parser_kwargs")),
            )
            model_object = self._fit(hp_dict, training_data, trainer_kwargs)
            metrics = self._evaluate_splits(model_object, training_data)
            return model_object, hyperparameters, metrics

        self._train_stage = Stage(
            train_task,
            owner=self,
            input_parameters=params,
            return_annotation=return_annotation,
            **(self._train_stage_kwargs or {}),
        )
        return self._train_stage

    def _fit(self, hp_dict: Dict[str, Any], training_data: Dict[str, Any], trainer_kwargs: Dict[str, Any]) -> Any:
        """Run the trainer in its registered mode."""
        model_object = self._init(hyperparameters=hp_dict)
        if self._trainer_mode == "step":
            from unionml_tpu_torch.train import fit

            result = fit(
                model_object, self._trainer, training_data["train"], self._trainer_config,
                device=_state_device(model_object),
            )
            self.last_fit_result = result
            return result.state
        return self._trainer(model_object, *training_data["train"], **trainer_kwargs)

    def _evaluate_splits(self, model_object: Any, training_data: Dict[str, Any]) -> Dict[str, Any]:
        if self._evaluator is None:
            return {}
        if self._evaluator_mode == "step":
            from unionml_tpu_torch.train import evaluate

            cfg = self._evaluator_config
            return {
                split: evaluate(
                    model_object,
                    self._evaluator,
                    data,
                    batch_size=getattr(cfg, "batch_size", 128),
                    device=_state_device(model_object),
                    mesh=getattr(cfg, "mesh", None),
                    partition_rules=getattr(cfg, "partition_rules", None),
                    fsdp_min_weight_size=getattr(cfg, "fsdp_min_weight_size", 2**14),
                )
                for split, data in training_data.items()
            }
        return {split: self._evaluator(model_object, *data) for split, data in training_data.items()}

    def predict_task(self) -> Stage:
        """Compile the predict-from-reader stage (reference model.py:445-474)."""
        if self._predict_stage is not None:
            return self._predict_stage
        if self._predictor is None:
            raise ValueError(f"model '{self.name}' has no registered @model.predictor function")

        predictor_sig = signature(self._predictor)
        model_param, *_ = predictor_sig.parameters.values()
        [(data_arg_name, data_arg_type)] = self._dataset.dataset_datatype.items()

        params: "OrderedDict[str, Parameter]" = OrderedDict(
            [
                ("model_object", model_param.replace(name="model_object", kind=Parameter.KEYWORD_ONLY)),
                (data_arg_name, Parameter(data_arg_name, kind=Parameter.KEYWORD_ONLY, annotation=data_arg_type)),
            ]
        )

        def predict_task(**kwargs: Any):
            parsed = self._dataset._parser(kwargs[data_arg_name], **self._dataset.parser_kwargs)
            features = self._dataset._feature_transformer(parsed[self._dataset._parser_feature_key])
            return self._call_predictor(kwargs["model_object"], features)

        self._predict_stage = Stage(
            predict_task,
            owner=self,
            input_parameters=params,
            return_annotation=predictor_sig.return_annotation,
            **self._predict_stage_kwargs,
        )
        return self._predict_stage

    def predict_from_features_task(self) -> Stage:
        """Compile the predict-from-raw-features stage (reference model.py:476-502)."""
        if self._predict_from_features_stage is not None:
            return self._predict_from_features_stage
        if self._predictor is None:
            raise ValueError(f"model '{self.name}' has no registered @model.predictor function")

        predictor_sig = signature(self._predictor)
        model_param, *_ = predictor_sig.parameters.values()
        [(_, data_arg_type)] = self._dataset.dataset_datatype.items()

        params: "OrderedDict[str, Parameter]" = OrderedDict(
            [
                ("model_object", model_param.replace(name="model_object", kind=Parameter.KEYWORD_ONLY)),
                ("features", Parameter("features", kind=Parameter.KEYWORD_ONLY, annotation=data_arg_type)),
            ]
        )

        def predict_from_features_task(**kwargs: Any):
            return self._call_predictor(kwargs["model_object"], kwargs["features"])

        self._predict_from_features_stage = Stage(
            predict_from_features_task,
            owner=self,
            input_parameters=params,
            return_annotation=predictor_sig.return_annotation,
            **self._predict_stage_kwargs,
        )
        return self._predict_from_features_stage

    # ------------------------------------------------------------------ graph builders

    def train_workflow(self) -> ExecutionGraph:
        """Build the 2-node training graph: reader -> train (reference model.py:292-338)."""
        dataset_stage = self._dataset.dataset_task()
        train_stage = self.train_task()

        graph = ExecutionGraph(self.train_workflow_name)
        graph.add_input("hyperparameters", self.hyperparameter_type)
        for kw, kw_type in (
            ("loader_kwargs", self._dataset.loader_kwargs_type),
            ("splitter_kwargs", self._dataset.splitter_kwargs_type),
            ("parser_kwargs", self._dataset.parser_kwargs_type),
        ):
            graph.add_input(kw, kw_type, default=None)
        for arg, annotation in dataset_stage.interface.inputs.items():
            default = dataset_stage.parameters[arg].default
            graph.add_input(arg, annotation, default=default)
        for arg, p in self.trainer_params.items():
            graph.add_input(arg, p.annotation, default=p.default)

        reader_node = graph.add_node(
            dataset_stage, **{arg: graph.inputs[arg] for arg in dataset_stage.interface.inputs}
        )
        (_, data_promise), *_ = reader_node.outputs.items()
        [(data_arg_name, _)] = self._dataset.dataset_datatype.items()
        train_node = graph.add_node(
            train_stage,
            hyperparameters=graph.inputs["hyperparameters"],
            **{data_arg_name: data_promise},
            **{kw: graph.inputs[kw] for kw in ("loader_kwargs", "splitter_kwargs", "parser_kwargs")},
            **{arg: graph.inputs[arg] for arg in self.trainer_params},
        )
        for out in ("model_object", "hyperparameters", "metrics"):
            graph.add_output(out, train_node.outputs[out])
        return graph

    def predict_workflow(self) -> ExecutionGraph:
        """Build the predict-from-reader graph (reference model.py:340-361)."""
        dataset_stage = self._dataset.dataset_task()
        predict_stage = self.predict_task()

        graph = ExecutionGraph(self.predict_workflow_name)
        graph.add_input("model_object", predict_stage.interface.inputs["model_object"])
        for arg, annotation in dataset_stage.interface.inputs.items():
            default = dataset_stage.parameters[arg].default
            graph.add_input(arg, annotation, default=default)

        reader_node = graph.add_node(
            dataset_stage, **{arg: graph.inputs[arg] for arg in dataset_stage.interface.inputs}
        )
        (_, data_promise), *_ = reader_node.outputs.items()
        [(data_arg_name, _)] = self._dataset.dataset_datatype.items()
        predict_node = graph.add_node(
            predict_stage, model_object=graph.inputs["model_object"], **{data_arg_name: data_promise}
        )
        (out_name, out_promise), *_ = predict_node.outputs.items()
        graph.add_output(out_name, out_promise)
        return graph

    def predict_from_features_workflow(self) -> ExecutionGraph:
        """Build the predict-from-raw-features graph (reference model.py:363-375)."""
        predict_stage = self.predict_from_features_task()
        graph = ExecutionGraph(self.predict_from_features_workflow_name)
        for arg, annotation in predict_stage.interface.inputs.items():
            graph.add_input(arg, annotation)
        node = graph.add_node(predict_stage, **{arg: graph.inputs[arg] for arg in predict_stage.interface.inputs})
        (out_name, out_promise), *_ = node.outputs.items()
        graph.add_output(out_name, out_promise)
        return graph

    # ------------------------------------------------------------------ local execution

    def train(
        self,
        hyperparameters: Optional[Dict[str, Any]] = None,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
        trainer_kwargs: Optional[Dict[str, Any]] = None,
        **reader_kwargs: Any,
    ) -> Tuple[Any, Any]:
        """Train locally (reference model.py:504-547): executes the reader->train graph
        in-process and stores the resulting :class:`ModelArtifact`."""
        hp_type = self.hyperparameter_type
        model_obj, hp, metrics = self.train_workflow()(
            hyperparameters=hp_type(**(hyperparameters or {})) if hp_type is not dict else (hyperparameters or {}),
            loader_kwargs=self._dataset.loader_kwargs_type(**(loader_kwargs or {})),
            splitter_kwargs=self._dataset.splitter_kwargs_type(**(splitter_kwargs or {})),
            parser_kwargs=self._dataset.parser_kwargs_type(**(parser_kwargs or {})),
            **{**reader_kwargs, **(trainer_kwargs or {})},
        )
        self.artifact = ModelArtifact(model_obj, hp, metrics)
        return model_obj, metrics

    def predict(self, features: Any = None, **reader_kwargs: Any) -> Any:
        """Predict locally from raw features or reader kwargs (reference model.py:549-578)."""
        if features is None and not reader_kwargs:
            raise ValueError("At least one of features or **reader_kwargs needs to be provided")
        if self.artifact is None:
            raise RuntimeError(
                "ModelArtifact not found. You must train a model first with the `train` method before "
                "generating predictions."
            )
        if features is None:
            return self.predict_workflow()(model_object=self.artifact.model_object, **reader_kwargs)
        return self.predict_from_features_workflow()(
            model_object=self.artifact.model_object,
            features=self._dataset.get_features(features),
        )

    # ------------------------------------------------------------------ persistence

    def save(self, file: Union[str, os.PathLike, IO], *args: Any, **kwargs: Any) -> Any:
        """Save the current artifact's model object (reference model.py:580-584)."""
        if self.artifact is None:
            raise AttributeError("`artifact` property is None. Call the `train` method to train a model first")
        return self._saver(self.artifact.model_object, self.artifact.hyperparameters, file, *args, **kwargs)

    def load(self, file: Union[str, os.PathLike, IO], *args: Any, **kwargs: Any) -> Any:
        """Load a model object from disk and bind it as the artifact (reference model.py:586-594)."""
        self.artifact = ModelArtifact(self._loader(file, *args, **kwargs))
        return self.artifact.model_object

    def load_from_env(self, env_var: str = MODEL_PATH_ENV_VAR, *args: Any, **kwargs: Any) -> Any:
        """Load a model object from a path named by an env var (reference model.py:596-608)."""
        model_path = os.getenv(env_var)
        if model_path is None:
            raise ValueError(f"env_var for model path {env_var} doesn't exist.")
        return self.load(model_path, *args, **kwargs)

    # ------------------------------------------------------------------ serving

    def serve(
        self,
        app: Any = None,
        remote: bool = False,
        app_version: Optional[str] = None,
        model_version: str = "latest",
        batcher: Optional[Any] = None,
    ):
        """Bind this model to an HTTP serving app (reference model.py:610-623).

        Returns a :class:`unionml_tpu_torch.serving.ServingApp` exposing
        ``POST /predict``, ``POST /predict-stream``, the ``/v1/*``
        completions surface, ``GET /health``, ``/healthz``, ``/metrics`` and
        the debug routes, with dynamic micro-batching. ``remote=True`` loads the
        latest (or ``model_version``) trained artifact from the remote
        backend's registry at ``startup()``.
        """
        from unionml_tpu_torch.serving import serving_app

        return serving_app(
            self, app, remote=remote, app_version=app_version, model_version=model_version, batcher=batcher
        )

    # ------------------------------------------------------------------ remote backend

    def remote(
        self,
        registry: Optional[str] = None,
        image_name: Optional[str] = None,
        dockerfile: str = "Dockerfile",
        patch_destination_dir: str = "/root",
        config_file: Optional[str] = None,
        project: Optional[str] = None,
        domain: Optional[str] = None,
        backend_store: Optional[str] = None,
        accelerator: Optional[str] = None,
        n_workers: int = 1,
        launcher: Optional[Any] = None,
    ) -> None:
        """Configure the remote backend (reference model.py:625-654 keeps docker/Flyte
        knobs; the substrate adds ``backend_store`` — the job/artifact store root —
        ``accelerator`` — the GPU slice to schedule training onto, counted in
        GPUs (``"h100-16"``: two 8-GPU hosts) — ``n_workers`` — worker processes
        per execution, which join one ``torch.distributed`` group (the
        multi-host slice analog) — and ``launcher`` — a
        :class:`unionml_tpu_torch.launcher.Launcher` deciding where the workers
        run (default: local subprocesses; pass a
        :class:`~unionml_tpu_torch.launcher.GPUVMLauncher` to provision real hosts)."""
        from unionml_tpu_torch.remote import BackendConfig

        self._launcher = launcher
        self._backend_config = BackendConfig(
            registry=registry,
            image_name=image_name,
            dockerfile=dockerfile,
            patch_destination_dir=patch_destination_dir,
            config_file=config_file,
            project=project or "unionml-tpu",
            domain=domain or "development",
            store=backend_store,
            accelerator=accelerator,
            n_workers=n_workers,
        )
        self.__backend__ = None

    @property
    def _backend(self) -> Any:
        if self.__backend__ is not None:
            return self.__backend__
        from unionml_tpu_torch.remote import Backend, BackendConfig

        config = self._backend_config or BackendConfig()
        self.__backend__ = Backend(config, launcher=getattr(self, "_launcher", None))
        return self.__backend__

    def remote_deploy(
        self, app_version: Optional[str] = None, allow_uncommitted: bool = False, patch: bool = False
    ) -> str:
        """Package + register the app's three services (reference model.py:672-730)."""
        return self._backend.deploy(self, app_version=app_version, allow_uncommitted=allow_uncommitted, patch=patch)

    def remote_train(
        self,
        app_version: Optional[str] = None,
        wait: bool = True,
        *,
        retries: int = 0,
        hyperparameters: Optional[Dict[str, Any]] = None,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
        trainer_kwargs: Optional[Dict[str, Any]] = None,
        **reader_kwargs: Any,
    ) -> Any:
        """Submit a training job to the backend (reference model.py:732-796).

        ``retries``: additional launch attempts if the worker fails or its host is
        lost (stale heartbeat); with a ``checkpoint_dir``-configured trainer each
        retry resumes from the last step checkpoint. The reference delegates this
        concern to Flyte; here it is first-class.
        """
        execution = self._backend.submit_train(
            self,
            app_version=app_version,
            hyperparameters=hyperparameters,
            loader_kwargs=loader_kwargs,
            splitter_kwargs=splitter_kwargs,
            parser_kwargs=parser_kwargs,
            trainer_kwargs=trainer_kwargs,
            reader_kwargs=reader_kwargs,
        )
        if not wait:
            return execution
        self.remote_wait(execution, retries=retries)
        self.remote_load(execution)
        return self.artifact

    def remote_predict(
        self,
        app_version: Optional[str] = None,
        model_version: Optional[str] = None,
        wait: bool = True,
        *,
        retries: int = 0,
        features: Any = None,
        **reader_kwargs: Any,
    ) -> Any:
        """Submit a prediction job to the backend (reference model.py:798-864).
        ``retries`` as in :meth:`remote_train`."""
        execution = self._backend.submit_predict(
            self,
            app_version=app_version,
            model_version=model_version,
            features=features,
            reader_kwargs=reader_kwargs,
        )
        if not wait:
            return execution
        execution = self._backend.wait(execution, retries=retries)
        return self._backend.fetch_predictions(execution)

    def remote_wait(self, execution: Any, **kwargs: Any) -> Any:
        return self._backend.wait(execution, **kwargs)

    def remote_load(self, execution: Any) -> None:
        """Load the ModelArtifact produced by a completed training execution
        (reference model.py:872-894)."""
        execution = self._backend.wait(execution)
        self.artifact = self._backend.fetch_artifact(self, execution)

    def remote_list_model_versions(self, app_version: Optional[str] = None, limit: int = 10) -> List[str]:
        """List trained model versions, newest first (reference model.py:896-906)."""
        return self._backend.list_model_versions(self, app_version=app_version, limit=limit)

    def remote_fetch_predictions(self, execution: Any) -> Any:
        execution = self._backend.wait(execution)
        return self._backend.fetch_predictions(execution)

    # ------------------------------------------------------------------ defaults

    def _default_init(self, hyperparameters: dict) -> Any:
        if self._init_callable is None:
            raise ValueError(
                "When using the _default_init method, you must specify the init argument to the Model constructor."
            )
        return self._init_callable(**hyperparameters)

    def _default_saver(
        self, model_obj: Any, hyperparameters: Any, file: Union[str, os.PathLike, IO], *args: Any, **kwargs: Any
    ) -> Any:
        return save_model_object(model_obj, hyperparameters, file, *args, **kwargs)

    def _default_loader(self, file: Union[str, os.PathLike, IO], *args: Any, **kwargs: Any) -> Any:
        def init_from_hparams(hp: Dict[str, Any]) -> Any:
            return self._init(hyperparameters=hp)

        return load_model_object(file, self.model_type, *args, init=init_from_hparams, **kwargs)
