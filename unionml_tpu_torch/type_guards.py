"""Decoration-time signature contracts for user functions.

A copy of ``unionml_tpu/type_guards.py``: every ``@dataset.*`` /
``@model.*`` decorator validates the user function's signature at decoration
time, so that type errors surface when the app module is imported, not
mid-training. The guards, their messages and their semantics are the JAX
package's.

The one extension of UnionML's contract is the port's own: ``Any`` and
``torch.Tensor`` annotations are wildcards, compatible with any type, since
step functions are written over tensors whose static type carries no
container information (the JAX package's docstring names ``jax.Array``).
"""

from __future__ import annotations

from inspect import Parameter
from typing import Any, Callable, Dict, Iterable, List, Optional, Type, get_args, get_origin

import torch

from unionml_tpu_torch.utils import resolved_signature as signature

#: Canonical splitter keyword contract.
SPLITTER_KWTYPES: Dict[str, object] = {
    "test_size": float,
    "shuffle": bool,
    "random_state": int,
}

#: Canonical parser keyword contract.
PARSER_KWTYPES: Dict[str, object] = {
    "features": Optional[List[str]],
    "targets": List[str],
}

#: annotations compatible with any type
WILDCARDS = (Any, torch.Tensor)

_POSITIONAL_KINDS = {Parameter.POSITIONAL_OR_KEYWORD, Parameter.POSITIONAL_ONLY}


def _positional_annotations(fn: Callable) -> List[Any]:
    """Annotations of all positional params after the first (the data/model slot)."""
    params = list(signature(fn).parameters.values())
    return [p.annotation for p in params[1:] if p.kind in _POSITIONAL_KINDS]


def _first_annotation(fn: Callable) -> Any:
    return next(iter(signature(fn).parameters.values())).annotation


def _is_splits_container(annotation: Any) -> bool:
    """True if the annotation is a List/Tuple/NamedTuple generic holding data splits."""
    if get_origin(annotation) in {tuple, list}:
        return True
    return getattr(annotation, "__bases__", None) == (tuple,)


def _types_compatible(actual: Any, expected: Any) -> bool:
    """Loose compatibility: exact match, a wildcard, or membership in a Union."""
    if any(actual is w or expected is w for w in WILDCARDS):
        return True
    if actual == expected:
        return True
    if expected in get_args(actual) or actual in get_args(expected):
        return True
    return False


def _check_input_data_type(fn_name: str, actual: Any, expected: Any) -> None:
    if not _types_compatible(actual, expected):
        raise TypeError(
            f"The type of the first argument of the '{fn_name}' function must be compatible "
            f"with the expected output type: {expected}. Found {actual}"
        )


def _check_positional_data_types(fn_name: str, actual_types: List[Any], expected_types: Iterable[Any]) -> None:
    expected = list(expected_types)
    if len(actual_types) != len(expected):
        raise TypeError(
            f"Length of positional data arguments are expected to match {expected}. Found {actual_types}."
        )
    for actual_t, expected_t in zip(actual_types, expected):
        _check_input_data_type(fn_name, actual_t, expected_t)


def _check_kw_contract(fn_name: str, fn: Callable, kwtypes: Dict[str, object]) -> None:
    parameters = signature(fn).parameters
    for i, (argname, argtype) in enumerate(kwtypes.items()):
        param = parameters.get(argname)
        if param is None:
            raise TypeError(
                f"The '{fn_name}' function is expected to accept an argument '{argname}' of type "
                f"{argtype} at the {i + 1}th position. Found a function with the following "
                f"signature: {parameters}"
            )
        if param.annotation != argtype:
            raise TypeError(f"The argument '{argname}' expected to be of type {argtype}, found {param.annotation}")


def guard_reader(reader: Callable) -> None:
    """Reader must declare its return type — it defines the dataset datatype."""
    if signature(reader).return_annotation is Parameter.empty:
        raise TypeError(
            "The dataset.reader function return annotation cannot be empty. You need to specify a return type."
        )


def guard_loader(loader: Callable, expected_data_type: Type) -> None:
    """Loader's first argument must accept the reader output type."""
    _check_input_data_type("loader", _first_annotation(loader), expected_data_type)


def guard_splitter(splitter: Callable, expected_data_type: Type, expected_type_source: str) -> None:
    """Splitter: first arg matches data type; returns a tuple/list of same-typed splits;
    accepts the canonical ``test_size/shuffle/random_state`` keywords."""
    sig = signature(splitter)
    _check_input_data_type("splitter", _first_annotation(splitter), expected_data_type)

    out = sig.return_annotation
    if not _is_splits_container(out):
        raise TypeError(
            f"The output of 'splitter' must be a List, Tuple, or NamedTuple type containing data splits. Found {out}"
        )
    for subtype in get_args(out):
        if subtype != expected_data_type:
            raise TypeError(
                f"The type arguments to the output generic type of 'splitter' the function must match "
                f"the '{expected_type_source}' output type: {expected_data_type}. Found {out}"
            )
    _check_kw_contract("splitter", splitter, SPLITTER_KWTYPES)


def guard_parser(parser: Callable, expected_data_type: Type, expected_type_source: str) -> None:
    """Parser: first arg matches data type; returns a tuple/list of features/targets;
    accepts the canonical ``features/targets`` keywords."""
    sig = signature(parser)
    _check_input_data_type("parser", _first_annotation(parser), expected_data_type)
    out = sig.return_annotation
    if not _is_splits_container(out):
        raise TypeError(
            f"The output of 'parser' must be a List, Tuple, or NamedTuple type containing data splits. Found {out}"
        )
    _check_kw_contract("parser", parser, PARSER_KWTYPES)


def guard_trainer(trainer: Callable, expected_model_type: Type, expected_data_types: Iterable[Type]) -> None:
    """Trainer: (model, *data, **hyperparams) -> model, with model/data types matching."""
    sig = signature(trainer)
    _check_input_data_type("trainer", _first_annotation(trainer), expected_model_type)
    _check_input_data_type("trainer", sig.return_annotation, expected_model_type)
    _check_positional_data_types("trainer", _positional_annotations(trainer), expected_data_types)


def guard_evaluator(evaluator: Callable, expected_model_type: Type, expected_data_types: Iterable[Type]) -> None:
    """Evaluator: (model, *data) -> metric, with model/data types matching."""
    _check_input_data_type("evaluator", _first_annotation(evaluator), expected_model_type)
    _check_positional_data_types("evaluator", _positional_annotations(evaluator), expected_data_types)


def guard_predictor(predictor: Callable, expected_model_type: Type, expected_data_type: Type) -> None:
    """Predictor: (model, features) -> predictions, with an explicit return annotation."""
    sig = signature(predictor)
    data_types = _positional_annotations(predictor)
    if len(data_types) != 1:
        raise TypeError(f"The 'predictor' function must take a single 'features' argument, found {data_types}")
    _check_input_data_type("predictor", _first_annotation(predictor), expected_model_type)
    _check_input_data_type("predictor", data_types[0], expected_data_type)
    if sig.return_annotation is Parameter.empty:
        raise TypeError("The 'predictor' function needs a return type annotation.")


def guard_feature_loader(feature_loader: Callable, expected_data_type: Type) -> None:
    """Feature loader: exactly one argument (raw features or a reference to them)."""
    sig = signature(feature_loader)
    if len(sig.parameters) != 1:
        raise TypeError(
            "The 'feature_loader' must take a single argument representing raw features or a reference to raw features."
        )
    _check_input_data_type("feature_loader", _first_annotation(feature_loader), expected_data_type)


def guard_feature_transformer(feature_transformer: Callable, expected_data_type: Type) -> None:
    """Feature transformer: exactly one argument (the loaded features)."""
    sig = signature(feature_transformer)
    if len(sig.parameters) != 1:
        raise TypeError("The 'feature_transformer' must take a single argument representing the loaded features.")
    _check_input_data_type("feature_transformer", _first_annotation(feature_transformer), expected_data_type)
