"""Stage + ExecutionGraph: the execution substrate of the app protocol.

A copy of ``unionml_tpu/stage.py`` (pure Python). Every app's graph is a
fixed 2-node DAG (reader -> train | predict):

- :class:`Stage` — a named, typed, keyword-only callable with attached
  :class:`~unionml_tpu_torch.defaults.Resources` and an optional execution
  config, called in-process by the local engine.
- :class:`ExecutionGraph` — a small deterministic DAG runner with named
  inputs, nodes, promises and named outputs.

Heavy numerics never run in this layer: a Stage body that trains on the card
hands off to :func:`unionml_tpu_torch.train.fit`.
"""

from __future__ import annotations

import inspect
from collections import OrderedDict
from inspect import Parameter
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

from unionml_tpu_torch.defaults import DEFAULT_RESOURCES, Resources


def _named_tuple_fields(annotation: Any) -> Optional["OrderedDict[str, Any]"]:
    """If ``annotation`` is a typing.NamedTuple subclass, return its field->type map."""
    if isinstance(annotation, type) and issubclass(annotation, tuple):
        fields = getattr(annotation, "_fields", None)
        if fields is not None:
            hints = getattr(annotation, "__annotations__", {})
            return OrderedDict((name, hints.get(name, Any)) for name in fields)
    return None


class StageInterface(NamedTuple):
    """Typed interface of a stage: keyword-only inputs and named outputs."""

    inputs: "OrderedDict[str, Any]"
    outputs: "OrderedDict[str, Any]"


class Stage:
    """A named, typed pipeline stage (UnionML's flytekit task).

    The wrapped function is normalized to a keyword-only signature derived
    either from the function itself or from explicit
    ``input_parameters``/``return_annotation`` overrides, and the stage is
    named ``{owner.name}.{fn.__name__}``.
    """

    def __init__(
        self,
        fn: Callable,
        *,
        owner: Any = None,
        name: Optional[str] = None,
        input_parameters: Optional[Mapping[str, Parameter]] = None,
        return_annotation: Any = None,
        resources: Resources = DEFAULT_RESOURCES,
        exec_config: Optional[Any] = None,
        **extra_config: Any,
    ):
        self._fn = fn
        self.owner = owner
        fn_sig = inspect.signature(fn)
        params = (
            OrderedDict((p.name, p) for p in fn_sig.parameters.values())
            if input_parameters is None
            else OrderedDict(input_parameters)
        )
        self._accepts_var_kwargs = any(p.kind == Parameter.VAR_KEYWORD for p in params.values())
        self._parameters: "OrderedDict[str, Parameter]" = OrderedDict(
            (pname, p.replace(kind=Parameter.KEYWORD_ONLY))
            for pname, p in params.items()
            if p.kind not in (Parameter.VAR_KEYWORD, Parameter.VAR_POSITIONAL)
        )
        self._return_annotation = fn_sig.return_annotation if return_annotation is None else return_annotation
        base = fn.__name__
        self.name = name or (f"{owner.name}.{base}" if owner is not None and getattr(owner, "name", None) else base)
        self.resources = resources
        self.exec_config = exec_config
        self.extra_config = dict(extra_config)

    @property
    def fn(self) -> Callable:
        return self._fn

    @property
    def parameters(self) -> "OrderedDict[str, Parameter]":
        return self._parameters

    @property
    def interface(self) -> StageInterface:
        inputs = OrderedDict((pname, p.annotation) for pname, p in self._parameters.items())
        nt = _named_tuple_fields(self._return_annotation)
        if nt is not None:
            outputs = nt
        else:
            outputs = OrderedDict([("o0", self._return_annotation)])
        return StageInterface(inputs=inputs, outputs=outputs)

    def __call__(self, **kwargs: Any) -> Any:
        unknown = set(kwargs) - set(self._parameters)
        if unknown and not self._accepts_var_kwargs:
            raise TypeError(f"stage '{self.name}' got unexpected arguments: {sorted(unknown)}")
        missing = [
            pname
            for pname, p in self._parameters.items()
            if pname not in kwargs and p.default is Parameter.empty
        ]
        if missing:
            raise TypeError(f"stage '{self.name}' missing required arguments: {missing}")
        return self._fn(**kwargs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Stage(name={self.name!r}, inputs={list(self._parameters)})"


class Promise(NamedTuple):
    """A reference to a named output of a node, resolved at graph execution time."""

    node: "Node"
    key: str


class GraphInput(NamedTuple):
    """A reference to a named graph input."""

    name: str


class Node:
    """A stage instantiated inside an :class:`ExecutionGraph` with bound inputs."""

    def __init__(self, graph: "ExecutionGraph", stage: Stage, bindings: Dict[str, Any]):
        self.graph = graph
        self.stage = stage
        self.bindings = bindings

    @property
    def outputs(self) -> Dict[str, Promise]:
        return {key: Promise(self, key) for key in self.stage.interface.outputs}


class ExecutionGraph:
    """A deterministic, in-order DAG of stages with named inputs and outputs.

    ``add_input`` ~ flytekit's add_workflow_input, ``add_node`` ~ add_entity,
    ``add_output`` ~ add_workflow_output. Calling the graph executes nodes in
    insertion order (the graphs built here are topologically sorted by
    construction).
    """

    def __init__(self, name: str):
        self.name = name
        self._inputs: "OrderedDict[str, Any]" = OrderedDict()
        self._input_defaults: Dict[str, Any] = {}
        self._nodes: list[Node] = []
        self._outputs: "OrderedDict[str, Promise]" = OrderedDict()

    @property
    def inputs(self) -> Dict[str, GraphInput]:
        return {name: GraphInput(name) for name in self._inputs}

    @property
    def input_types(self) -> "OrderedDict[str, Any]":
        return OrderedDict(self._inputs)

    @property
    def nodes(self) -> list[Node]:
        return list(self._nodes)

    @property
    def output_names(self) -> list[str]:
        return list(self._outputs)

    def add_input(self, name: str, annotation: Any = Any, default: Any = Parameter.empty) -> GraphInput:
        if name in self._inputs:
            raise ValueError(f"graph '{self.name}' already has an input named '{name}'")
        self._inputs[name] = annotation
        if default is not Parameter.empty:
            self._input_defaults[name] = default
        return GraphInput(name)

    def add_node(self, stage: Stage, **bindings: Any) -> Node:
        node = Node(self, stage, bindings)
        self._nodes.append(node)
        return node

    def add_output(self, name: str, promise: Promise) -> None:
        self._outputs[name] = promise

    def _resolve(self, binding: Any, inputs: Dict[str, Any], results: Dict[int, Dict[str, Any]]) -> Any:
        if isinstance(binding, GraphInput):
            return inputs[binding.name]
        if isinstance(binding, Promise):
            return results[id(binding.node)][binding.key]
        return binding

    def __call__(self, **inputs: Any) -> Any:
        unknown = set(inputs) - set(self._inputs)
        if unknown:
            raise TypeError(f"graph '{self.name}' got unexpected inputs: {sorted(unknown)}")
        merged = {**self._input_defaults, **inputs}
        missing = set(self._inputs) - set(merged)
        if missing:
            raise TypeError(f"graph '{self.name}' missing required inputs: {sorted(missing)}")

        results: Dict[int, Dict[str, Any]] = {}
        for node in self._nodes:
            kwargs = {k: self._resolve(v, merged, results) for k, v in node.bindings.items()}
            raw = node.stage(**kwargs)
            out_keys = list(node.stage.interface.outputs)
            if len(out_keys) == 1:
                results[id(node)] = {out_keys[0]: raw}
            else:
                if not isinstance(raw, tuple) or len(raw) != len(out_keys):
                    raise RuntimeError(
                        f"stage '{node.stage.name}' declared outputs {out_keys} but returned {type(raw)}"
                    )
                results[id(node)] = dict(zip(out_keys, raw))

        values = tuple(results[id(p.node)][p.key] for p in self._outputs.values())
        if not values:
            return None
        if len(values) == 1:
            return values[0]
        return values


def stage(fn: Optional[Callable] = None, **kwargs: Any) -> Any:
    """Decorator form: turn a free function into a :class:`Stage`.

    Lets users embed their own stages alongside generated ones in a custom
    :class:`ExecutionGraph`.
    """
    if fn is None:
        return lambda f: stage(f, **kwargs)
    return Stage(fn, **kwargs)

