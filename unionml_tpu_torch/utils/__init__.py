"""Shared utilities: JSON-able dataclass synthesis and model-framework sniffing.

A copy of ``unionml_tpu/utils/__init__.py`` (the port never imports the JAX
package), without ``is_flax_module``: no flax object reaches the port.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, Type

__all__ = [
    "resolved_signature",
    "json_dataclass",
    "dataclass_to_dict",
    "dataclass_from_dict",
    "is_sklearn_model",
    "is_pytorch_model",
    "is_keras_model",
]


def dataclass_to_dict(obj: Any) -> Dict[str, Any]:
    """Convert a dataclass instance to a plain dict (shallow for non-dataclass leaves)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return obj
    raise TypeError(f"expected a dataclass instance or dict, got {type(obj)}")


def dataclass_from_dict(cls: Type, data: Dict[str, Any]):
    """Instantiate ``cls`` from a dict, ignoring unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in names})


def json_dataclass(cls: Type) -> Type:
    """Attach ``to_dict``/``from_dict``/``to_json``/``from_json`` methods to a
    dataclass: the synthesized Hyperparameters and ``*Kwargs`` types
    round-trip through JSON."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclass_to_dict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(kls, data: Dict[str, Any]):
        return dataclass_from_dict(kls, data)

    @classmethod
    def from_json(kls, payload: str):
        return kls.from_dict(json.loads(payload))

    cls.to_dict = to_dict
    cls.to_json = to_json
    cls.from_dict = from_dict
    cls.from_json = from_json
    return cls


def _base_module(model_type: type) -> str:
    bases = getattr(model_type, "__bases__", None)
    if bases:
        return bases[0].__module__
    return ""


def _module_test(model_type: Any, prefix: str) -> bool:
    if not isinstance(model_type, type):
        return False
    return model_type.__module__.startswith(prefix) or _base_module(model_type).startswith(prefix)


def is_sklearn_model(model_type: Any) -> bool:
    """An sklearn estimator class. Looked up in ``sys.modules`` rather than
    imported: no class can be an estimator unless sklearn is imported."""
    base = sys.modules.get("sklearn.base")
    return base is not None and isinstance(model_type, type) and issubclass(model_type, base.BaseEstimator)


def is_pytorch_model(model_type: Any) -> bool:
    """A class from torch, or whose first base is (an ``nn.Module`` subclass)."""
    return _module_test(model_type, "torch")


def is_keras_model(model_type: Any) -> bool:
    return _module_test(model_type, "keras")


def resolved_signature(fn):
    """``inspect.signature`` with PEP 563 string annotations resolved when possible.

    Functions defined under ``from __future__ import annotations`` carry
    *string* annotations; signature-derived typing needs the real objects.
    Falls back to the raw signature when resolution fails (e.g. local classes
    defined in function scope).
    """
    import inspect as _inspect

    try:
        return _inspect.signature(fn, eval_str=True)
    except Exception:
        return _inspect.signature(fn)
