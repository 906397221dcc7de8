"""Model artifact container + framework-dispatched save/load.

The port's copy of ``unionml_tpu/artifact.py``. The dispatch order is the JAX
package's: sklearn (joblib) -> ``nn.Module`` (state_dict) -> keras -> a state
-> the pickle fallback. ``joblib`` and ``sklearn`` are imported only inside
their branch.

The state branch is the torch meaning of the JAX package's pytree branch. It
takes any object with ``state_dict()`` and ``load_state_dict()`` (the port's
:class:`~unionml_tpu_torch.train.TrainState`, an optimizer) and any nested
dict/list/tuple of tensors, and writes ``{"format", "model_obj",
"hyperparameters"}`` with ``torch.save``: tensors, str, int, float, bool,
None, dicts, lists and tuples only, so ``torch.load(weights_only=True)`` reads
it back; the hyperparameters ride along as JSON.

Loading goes through ``init(hyperparameters)``, as the JAX branch goes
through its ``template``: the file is read onto the host (memory-mapped when
it is a path), the object ``init`` builds receives it with
``load_state_dict``, and every tensor lands where ``init`` put that
object's: a state built on the card reloads onto the card, one built on the
CPU onto the CPU. ``hyperparameters=`` overrides saved values for ``init``
(``{"device": "cpu"}`` where the app's ``init`` takes a device). A flax
msgpack artifact of the JAX package does not load here; convert its
parameters with :func:`unionml_tpu_torch.models.llama_params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
from pathlib import Path
from typing import IO, Any, Dict, NamedTuple, Optional, Union

import torch

from unionml_tpu_torch.utils import dataclass_to_dict, is_keras_model, is_pytorch_model, is_sklearn_model

FileLike = Union[str, os.PathLike, IO]

#: the state branch's format tag
STATE_FORMAT = "unionml-tpu-torch/state/v1"
#: the JAX package's pytree branch, which does not load here
_JAX_PYTREE_FORMAT = "unionml-tpu/pytree-msgpack"
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's archive


class ModelArtifact(NamedTuple):
    """A trained model object plus the hyperparameters and metrics that produced it."""

    model_object: Any
    hyperparameters: Optional[Any] = None
    metrics: Optional[Dict[str, Any]] = None


def _has_state_dict(obj: Any) -> bool:
    return callable(getattr(obj, "state_dict", None)) and callable(getattr(obj, "load_state_dict", None))


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    if isinstance(tree, (list, tuple)):
        return [leaf for value in tree for leaf in _leaves(value)]
    return [tree]


def _is_state(obj: Any) -> bool:
    """An object with a state dict, or a nested dict/list/tuple of tensors."""
    if _has_state_dict(obj):
        return True
    leaves = _leaves(obj)
    return isinstance(obj, (dict, list, tuple)) and bool(leaves) and all(isinstance(x, torch.Tensor) for x in leaves)


def _normalize_hparams(hyperparameters: Any) -> Any:
    if hyperparameters is not None and dataclasses.is_dataclass(hyperparameters):
        return dataclass_to_dict(hyperparameters)
    return hyperparameters


def _hparams_json(hyperparameters: Any) -> Optional[str]:
    hyperparameters = _normalize_hparams(hyperparameters)
    return json.dumps(hyperparameters, default=str) if hyperparameters is not None else None


def _hparams_dict(raw: Any, overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    saved = json.loads(raw) if isinstance(raw, str) else dict(raw or {})
    return {**saved, **(overrides or {})}


def _torch_load(file: Any) -> Any:
    """Read a ``torch.save`` file onto the host: tensors only, memory-mapped
    when ``file`` is a path."""
    mmap = isinstance(file, (str, os.PathLike))
    return torch.load(file, map_location="cpu", weights_only=True, mmap=mmap)


def _place_like(tree: Any, like: Any) -> Any:
    """``tree`` with each tensor moved to the device of the tensor at the
    same place in ``like``; the structures must match."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError("the saved state's structure does not match the object init builds")
        return type(like)((k, _place_like(tree[k], like[k])) for k in like)
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError("the saved state's structure does not match the object init builds")
        return type(like)(_place_like(t, l) for t, l in zip(tree, like))
    if isinstance(like, torch.Tensor) and isinstance(tree, torch.Tensor):
        return tree.to(like.device)
    return tree


def _restore(state: Any, template: Any) -> Any:
    if _has_state_dict(template):
        template.load_state_dict(state)
        return template
    return _place_like(state, template)


def save_model_object(model_obj: Any, hyperparameters: Any, file: FileLike, *args: Any, **kwargs: Any) -> Any:
    """Serialize a model object of any supported framework to a single file.

    Dispatch order: sklearn (joblib) -> ``nn.Module`` (state_dict) -> keras
    (SavedModel) -> a state (``torch.save``, :data:`STATE_FORMAT`) -> pickle
    fallback.
    """
    model_type = type(model_obj)

    if is_sklearn_model(model_type):
        import joblib

        payload = {"model_obj": model_obj, "hyperparameters": _normalize_hparams(hyperparameters)}
        return joblib.dump(payload, file, *args, **kwargs)

    if is_pytorch_model(model_type):
        payload = {"model_obj": model_obj.state_dict(), "hyperparameters": _hparams_json(hyperparameters)}
        torch.save(payload, file, *args, **kwargs)
        return file

    if is_keras_model(model_type):
        model_obj.save(file, *args, **kwargs)
        return file

    if _is_state(model_obj):
        payload = {
            "format": STATE_FORMAT,
            "model_obj": model_obj.state_dict() if _has_state_dict(model_obj) else model_obj,
            "hyperparameters": _hparams_json(hyperparameters),
        }
        torch.save(payload, file, *args, **kwargs)
        return file

    # last resort: opaque host object
    blob = pickle.dumps({"model_obj": model_obj, "hyperparameters": _normalize_hparams(hyperparameters)})
    if hasattr(file, "write"):
        file.write(blob)
    else:
        Path(file).write_bytes(blob)
    return file


def load_model_object(
    file: FileLike,
    model_type: Any,
    *args: Any,
    init: Any = None,
    template: Any = None,
    hyperparameters: Optional[Dict[str, Any]] = None,
    **kwargs: Any,
) -> Any:
    """Deserialize a model object saved by :func:`save_model_object`.

    :param model_type: the expected type (used for framework dispatch).
    :param init: callable building a fresh model object from hyperparameters
        (the ``nn.Module`` and state branches load into it).
    :param template: an object to load a state into instead of ``init``'s.
    :param hyperparameters: values that override the saved hyperparameters
        before ``init`` is called.
    """
    if is_sklearn_model(model_type):
        import joblib

        return joblib.load(file, *args, **kwargs)["model_obj"]

    if is_pytorch_model(model_type):
        payload = _torch_load(file)
        hp = _hparams_dict(payload["hyperparameters"], hyperparameters)
        model = init(hp) if init is not None else model_type(**hp)
        model.load_state_dict(payload["model_obj"])
        return model

    if is_keras_model(model_type):
        try:
            from tensorflow import keras  # pragma: no cover - tf not in image
        except ImportError as exc:
            raise RuntimeError(
                "Loading a keras model artifact requires tensorflow, which is not "
                "installed. Install tensorflow or register a custom @model.loader."
            ) from exc

        return keras.models.load_model(file)  # pragma: no cover - tf not in image

    if hasattr(file, "read"):
        blob = file.read()
        source: Any = io.BytesIO(blob)
    else:
        with open(file, "rb") as handle:
            blob = handle.read(len(_ZIP_MAGIC))
        source = file
    if blob[: len(_ZIP_MAGIC)] == _ZIP_MAGIC:
        payload = _torch_load(source)
        if not (isinstance(payload, dict) and payload.get("format") == STATE_FORMAT):
            raise ValueError(f"{file!r} is a torch.save file but not a {STATE_FORMAT} artifact")
        hp = _hparams_dict(payload["hyperparameters"], hyperparameters)
        if template is None and init is not None:
            template = init(hp)
        if template is None:
            raise ValueError(
                "Loading a state artifact requires a 'template' object or an 'init' callable "
                "to build the object the state loads into."
            )
        return _restore(payload["model_obj"], template)

    if not hasattr(file, "read"):
        blob = Path(file).read_bytes()
    payload = pickle.loads(blob)
    if isinstance(payload, dict) and str(payload.get("format", "")).startswith(_JAX_PYTREE_FORMAT):
        raise ValueError(
            f"{file!r} is a flax msgpack artifact of the JAX package, which the port does not load; "
            "convert its parameters with unionml_tpu_torch.models.llama_params_from_jax (from "
            "jax.tree_util.tree_map(numpy.asarray, params)) and load the state dict into the model"
        )
    return payload["model_obj"]


def save_artifact_checkpoint(artifact: ModelArtifact, directory: Union[str, os.PathLike]) -> None:
    """Directory form of an artifact: ``model_object.pt`` (``torch.save`` of
    the model object's state dict, or of its tensor tree) and
    ``artifact.json`` (hyperparameters and metrics)."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    obj = artifact.model_object
    tmp = directory / f"model_object.pt.{os.getpid()}.tmp"
    torch.save(obj.state_dict() if _has_state_dict(obj) else obj, tmp)
    os.replace(tmp, directory / "model_object.pt")
    meta = {
        "hyperparameters": _normalize_hparams(artifact.hyperparameters),
        "metrics": artifact.metrics,
    }
    (directory / "artifact.json").write_text(json.dumps(meta, default=str))


def load_artifact_checkpoint(directory: Union[str, os.PathLike], template: Any) -> ModelArtifact:
    """Restore an artifact saved by :func:`save_artifact_checkpoint` into
    ``template`` (an object with ``load_state_dict``, or a tensor tree whose
    devices the loaded tensors take)."""
    directory = Path(directory).absolute()
    model_object = _restore(_torch_load(directory / "model_object.pt"), template)
    meta = json.loads((directory / "artifact.json").read_text())
    return ModelArtifact(model_object, meta.get("hyperparameters"), meta.get("metrics"))
