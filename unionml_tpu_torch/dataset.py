"""Dataset: declarative data source + split/parse/feature pipeline.

The port's copy of ``unionml_tpu/dataset.py``: the ``Dataset`` class
registers a required ``reader`` and optional ``loader``/``splitter``/
``parser``/``feature_loader``/``feature_transformer`` functions, understands
``pandas.DataFrame`` out of the box, synthesizes typed kwargs dataclasses
from the registered function signatures, and exposes
``get_data``/``get_features`` as the canonical raw->model-ready pipelines.
The default splitter's numpy permutation is the JAX package's, so both
packages split one frame into the same rows.

pandas is imported only where a DataFrame is made or read: the DataFrame
tests look the class up in ``sys.modules``, so a dataset of arrays never
imports it (a machine without pandas runs such an app).

Beside UnionML's protocol: :meth:`Dataset.iterator` (a host-to-device
prefetch iterator, :class:`unionml_tpu_torch.data.PrefetchIterator`),
:meth:`Dataset.from_sqlite_query`, :meth:`Dataset.from_sqlalchemy_query`,
:meth:`Dataset.from_torch_dataset` and :meth:`Dataset.from_hf_dataset`.
"""

from __future__ import annotations

import copy
import json
from dataclasses import MISSING, field, make_dataclass
from enum import Enum
from functools import partial
from inspect import Parameter, Signature

import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Type, TypeVar, Union, cast, get_args

import numpy as np

from unionml_tpu_torch import type_guards
from unionml_tpu_torch.defaults import DEFAULT_RESOURCES
from unionml_tpu_torch.stage import Stage
from unionml_tpu_torch.utils import json_dataclass
from unionml_tpu_torch.utils import resolved_signature as signature

R = TypeVar("R")  # raw data (reader/loader output)
D = TypeVar("D")  # model-ready data


def _pandas():
    import pandas as pd

    return pd


def _is_frame_type(data_type: Any) -> bool:
    """``data_type is pandas.DataFrame``, without importing pandas: a type
    cannot be the DataFrame class unless pandas is already imported."""
    pd = sys.modules.get("pandas")
    return pd is not None and data_type is pd.DataFrame


def _is_frame(data: Any) -> bool:
    """``isinstance(data, pandas.DataFrame)``, without importing pandas."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


class ReaderReturnTypeSource(Enum):
    """Which registered function defines the dataset datatype (reference dataset.py:30-32)."""

    READER = "reader"
    LOADER = "loader"


class Dataset:
    """Specification of the data pipeline feeding a :class:`unionml_tpu_torch.model.Model`.

    Only :meth:`reader` is required; every other pipeline function has a
    ``pandas.DataFrame``-aware default. Constructor parameters mirror the reference
    (unionml/dataset.py:36-93).
    """

    def __init__(
        self,
        name: str = "dataset",
        *,
        features: Optional[List[str]] = None,
        targets: Optional[List[str]] = None,
        test_size: float = 0.2,
        shuffle: bool = True,
        random_state: int = 12345,
    ):
        self.name = name
        self._features = list(features) if features else []
        self._targets = targets
        self._test_size = test_size
        self._shuffle = shuffle
        self._random_state = random_state

        # registered pipeline functions (defaults understand DataFrames)
        self._reader: Optional[Callable] = None
        self._loader: Callable = self._default_loader
        self._splitter: Callable = self._default_splitter
        self._parser: Callable = self._default_parser
        self._feature_loader: Callable = self._default_feature_loader
        self._feature_transformer: Callable = self._default_feature_transformer
        self._parser_feature_key: int = 0

        #: native fast path: resolved (Index, numpy selection) per wire column
        #: tuple — see get_features_from_bytes
        self._native_schema_cache: Dict[tuple, tuple] = {}

        self._reader_stage_kwargs: Dict[str, Any] = {}
        self._reader_input_types: Optional[List[Parameter]] = None
        self._dataset_datatype: Optional[Dict[str, Type]] = None
        self._dataset_stage: Optional[Stage] = None

        # lazily synthesized kwargs dataclasses
        self._kwargs_types: Dict[str, Type] = {}

    # ------------------------------------------------------------------ decorators

    def reader(self, fn: Optional[Callable] = None, **reader_stage_kwargs: Any) -> Callable:
        """Register the function that fetches raw data from an external source.

        Parity: reference unionml/dataset.py:95-108. Extra keyword arguments become
        stage execution config (e.g. ``resources=Resources(cpu="4")``).
        """
        if fn is None:
            return partial(self.reader, **reader_stage_kwargs)
        type_guards.guard_reader(fn)
        self._reader = fn
        self._reader_stage_kwargs = {"resources": DEFAULT_RESOURCES, **reader_stage_kwargs}
        return fn

    def loader(self, fn: Callable) -> Callable:
        """Register an optional function converting reader output into in-memory training data.

        Parity: reference unionml/dataset.py:110-123 — if present, its return type
        overrides the reader's as the dataset datatype.
        """
        type_guards.guard_loader(fn, self.dataset_datatype["data"])
        self._loader = fn
        self._kwargs_types.pop("loader", None)
        return fn

    def splitter(self, fn: Callable) -> Callable:
        """Register an optional train/test splitting function (reference dataset.py:125-148)."""
        type_guards.guard_splitter(fn, self.dataset_datatype["data"], self.dataset_datatype_source.value)
        self._splitter = fn
        self._kwargs_types.pop("splitter", None)
        return fn

    def parser(self, fn: Optional[Callable] = None, feature_key: int = 0) -> Callable:
        """Register an optional (features, targets) parsing function (reference dataset.py:150-174).

        :param feature_key: index of the features entry in the parser's output tuple.
        """
        if fn is None:
            return partial(self.parser, feature_key=feature_key)
        type_guards.guard_parser(fn, self.dataset_datatype["data"], self.dataset_datatype_source.value)
        self._parser = fn
        self._parser_feature_key = feature_key
        self._kwargs_types.pop("parser", None)
        return fn

    def feature_loader(self, fn: Callable) -> Callable:
        """Register an optional function loading serialized/raw features for prediction
        (reference dataset.py:176-190; used by the CLI ``--features`` flag and the
        serving ``/predict`` endpoint)."""
        type_guards.guard_feature_loader(fn, Any)
        self._feature_loader = fn
        return fn

    def feature_transformer(self, fn: Callable) -> Callable:
        """Register an optional pre-prediction feature transformation
        (reference dataset.py:192-204)."""
        type_guards.guard_feature_transformer(fn, signature(self._feature_loader).return_annotation)
        self._feature_transformer = fn
        return fn

    # ------------------------------------------------------------------ kwargs plumbing

    @property
    def splitter_kwargs(self) -> Dict[str, Any]:
        """Default keyword arguments forwarded to the splitter (reference dataset.py:206-213)."""
        return {"test_size": self._test_size, "shuffle": self._shuffle, "random_state": self._random_state}

    @property
    def parser_kwargs(self) -> Dict[str, Any]:
        """Default keyword arguments forwarded to the parser (reference dataset.py:215-221)."""
        return {"features": self._features, "targets": self._targets}

    def _synthesize_kwargs_type(self, key: str, fn: Callable, defaults: Dict[str, Any]) -> Type:
        """Build a JSON-able dataclass from ``fn``'s post-data keyword signature.

        This signature-derived-config trick is the soul of the reference API
        (unionml/dataset.py:232-272): every pipeline stage's knobs become typed,
        serializable workflow inputs.
        """
        if key in self._kwargs_types:
            return self._kwargs_types[key]
        fields = []
        for i, p in enumerate(signature(fn).parameters.values()):
            if i == 0:  # first parameter is the data itself
                continue
            default = defaults.get(p.name, MISSING if p.default is Parameter.empty else p.default)
            if isinstance(default, (list, dict, set)):
                # deep-copy per instance: sharing the Dataset's own container would let
                # kwargs-instance mutation corrupt the dataset config
                f = field(default_factory=partial(copy.deepcopy, default))
            elif default is MISSING:
                f = field()
            else:
                f = field(default=default)
            fields.append((p.name, p.annotation, f))
        cls = json_dataclass(make_dataclass(f"{key.capitalize()}Kwargs", fields))
        self._kwargs_types[key] = cls
        return cls

    @property
    def loader_kwargs_type(self) -> Type:
        return self._synthesize_kwargs_type("loader", self._loader, {})

    @property
    def splitter_kwargs_type(self) -> Type:
        return self._synthesize_kwargs_type("splitter", self._splitter, self.splitter_kwargs)

    @property
    def parser_kwargs_type(self) -> Type:
        return self._synthesize_kwargs_type("parser", self._parser, self.parser_kwargs)

    # ------------------------------------------------------------------ stage compilation

    def dataset_task(self) -> Stage:
        """Compile the reader into a :class:`~unionml_tpu_torch.stage.Stage`.

        Name kept for parity with the reference (unionml/dataset.py:274-292); in our
        substrate the result is a schedulable Stage, not a flytekit task.
        """
        if self._dataset_stage is not None:
            return self._dataset_stage
        if self._reader is None:
            raise ValueError(f"dataset '{self.name}' has no registered @dataset.reader function")

        reader_sig = signature(self._reader)
        reader = self._reader

        def dataset_task(**kwargs: Any):
            return reader(**kwargs)

        self._dataset_stage = Stage(
            dataset_task,
            owner=self,
            input_parameters=reader_sig.parameters,
            return_annotation=NamedTuple("ReaderOutput", data=reader_sig.return_annotation),  # type: ignore[misc]
            **self._reader_stage_kwargs,
        )
        return self._dataset_stage

    # alias with a descriptive name
    reader_stage = dataset_task

    # ------------------------------------------------------------------ pipelines

    def get_data(
        self,
        raw_data: Any,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Run raw data through loader -> splitter -> parser -> feature_transformer.

        Returns ``{"train": [features, targets, ...], "test": [...]}`` (the test entry
        is omitted when the splitter yields a single split). Parity: reference
        unionml/dataset.py:294-340.
        """
        effective_splitter_kwargs = {**self.splitter_kwargs, **(splitter_kwargs or {})}
        effective_parser_kwargs = {**self.parser_kwargs, **(parser_kwargs or {})}

        data = self._loader(raw_data, **(loader_kwargs or {}))
        splits = self._splitter(data, **effective_splitter_kwargs)

        split_names = ("train", "test", "validation")
        out: Dict[str, Any] = {}
        for split_name, split in zip(split_names, splits):
            parsed = list(self._parser(split, **effective_parser_kwargs))
            parsed[self._parser_feature_key] = self._feature_transformer(parsed[self._parser_feature_key])
            out[split_name] = parsed
        return out

    def get_features(self, features: Any) -> Any:
        """Run raw features through feature_loader -> feature_transformer
        (reference unionml/dataset.py:342-351)."""
        return self._feature_transformer(self._feature_loader(features))

    def get_features_from_bytes(self, payload: bytes, allow_trailing: bool = False) -> Optional[Any]:
        """Native fast path: raw JSON record bytes -> feature DataFrame without the
        json -> list-of-dicts -> DataFrame detour (serving hot loop).

        Only engages when the feature pipeline is the default (a custom
        ``@dataset.feature_loader``/``feature_transformer`` must see the raw
        records) and the dataset type is a DataFrame. Returns ``(features,
        bytes_consumed)`` or ``None`` — callers fall back to :meth:`get_features`.
        """
        # bound-method comparison must use == (never `is`)
        if self._feature_loader != self._default_feature_loader:
            return None
        if self._feature_transformer != self._default_feature_transformer:
            return None
        [(_, data_type)] = self.dataset_datatype.items()
        if not _is_frame_type(data_type):
            return None
        from unionml_tpu_torch.native import parse_records

        pd = _pandas()

        parsed = parse_records(payload, allow_trailing=allow_trailing)
        if parsed is None:
            return None
        matrix, columns, consumed = parsed
        # Serving hot loop: requests overwhelmingly repeat one column set, and
        # re-validating + re-selecting through pandas per request (Index
        # construction, per-name __contains__, frame[names]) measurably
        # dominates the request. Cache the resolved schema per column tuple:
        # a cached Index makes DataFrame construction a thin block wrap, and
        # the selection happens on the numpy side (or not at all, the common
        # clients-send-exactly-the-features case).
        key = tuple(columns)
        cached = self._native_schema_cache.get(key)
        if cached is None:
            feature_names = self._feature_column_names_for(columns)
            if feature_names:
                position = {c: i for i, c in enumerate(columns)}
                if any(name not in position for name in feature_names):
                    return None  # missing feature columns: let the Python path raise its error
                sel = [position[n] for n in feature_names]
                if sel == list(range(len(columns))):
                    sel = None  # identity: feature_names == columns element-wise
                cached = (pd.Index(feature_names), sel)
            else:
                cached = (pd.Index(columns), None)
            # hostile clients must not grow the cache unboundedly (entry count)
            # nor pin gigabytes of column-name strings (entry size: a 64 MB
            # body can carry ~1M distinct names — serve it, don't retain it)
            if len(columns) <= 4096:
                if len(self._native_schema_cache) >= 64:
                    self._native_schema_cache.clear()
                self._native_schema_cache[key] = cached
        index, sel = cached
        if sel is not None:
            matrix = matrix[:, sel]
        return pd.DataFrame(matrix, columns=index, copy=False), consumed

    def _feature_column_names(self, frame: Any) -> "Optional[List[str]]":
        """Feature columns for a frame: explicit ``features`` list, else everything
        minus the targets. Single source of truth for both the Python default
        feature loader and the native fast path."""
        return self._feature_column_names_for(frame.columns)

    def _feature_column_names_for(self, columns) -> "Optional[List[str]]":
        feature_names = self._features
        if not feature_names and self._targets is not None:
            feature_names = [col for col in columns if col not in self._targets]
        return feature_names

    def iterator(
        self,
        data: Any,
        batch_size: int,
        *,
        device: Any = None,
        drop_remainder: bool = True,
        shuffle: bool = False,
        seed: int = 0,
        prefetch: int = 2,
    ):
        """A host-to-device prefetch iterator over parsed data.

        ``data`` is the ``[features, targets, ...]`` list produced by
        :meth:`get_data` for one split. ``device=None`` is CUDA, as for every
        entry point of the port; the JAX package's ``sharding=`` is the
        one-card device here. See
        :class:`unionml_tpu_torch.data.PrefetchIterator`.
        """
        from unionml_tpu_torch.data.pipeline import PrefetchIterator

        return PrefetchIterator(
            data,
            batch_size=batch_size,
            device=device,
            drop_remainder=drop_remainder,
            shuffle=shuffle,
            seed=seed,
            prefetch=prefetch,
        )

    # ------------------------------------------------------------------ type introspection

    @property
    def reader_input_types(self) -> Optional[List[Parameter]]:
        """Input parameters of the reader (reference dataset.py:353-358)."""
        if self._reader is not None and self._reader_input_types is None:
            return list(signature(self._reader).parameters.values())
        return self._reader_input_types

    @property
    def dataset_datatype(self) -> Dict[str, Type]:
        """Output type of the reader, overridden by a user loader if present
        (reference dataset.py:360-374)."""
        if self._loader != self._default_loader:
            return {"data": signature(self._loader).return_annotation}
        if self._dataset_datatype is not None:
            return self._dataset_datatype
        if self._reader is not None:
            return {"data": signature(self._reader).return_annotation}
        raise ValueError(
            "dataset_datatype is not defined. Please define a @dataset.reader function with an output annotation."
        )

    @property
    def dataset_datatype_source(self) -> ReaderReturnTypeSource:
        if self._loader != self._default_loader:
            return ReaderReturnTypeSource.LOADER
        return ReaderReturnTypeSource.READER

    @property
    def parser_return_types(self) -> Tuple[Any, ...]:
        """Types produced by the parser (reference dataset.py:384-388)."""
        return get_args(signature(self._parser).return_annotation)

    @property
    def feature_type(self) -> Type:
        """Type of model-ready features (reference dataset.py:390-413): the
        feature_transformer's output, falling back through feature_loader/parser."""
        if self._parser == self._default_parser:
            parser_type = self.dataset_datatype["data"]
        else:
            parser_type = self.parser_return_types[self._parser_feature_key]

        if self._feature_transformer == self._default_feature_transformer:
            ft_type = signature(self._feature_loader).return_annotation
        else:
            ft_type = signature(self._feature_transformer).return_annotation

        if parser_type != ft_type:
            return cast(Type, Union[ft_type, parser_type])
        return parser_type

    # ------------------------------------------------------------------ constructors from external sources

    @classmethod
    def _from_stage(cls, stage_obj: Stage, *args: Any, **kwargs: Any) -> "Dataset":
        """Adopt an existing Stage as this dataset's reader stage
        (analog of reference dataset.py:415-429)."""
        dataset = cls(*args, **kwargs)
        dataset._dataset_stage = stage_obj
        (_, dtype), *_ = stage_obj.interface.outputs.items()
        dataset._dataset_datatype = {"data": dtype}
        dataset._reader_input_types = [
            Parameter(k, Parameter.KEYWORD_ONLY, annotation=v) for k, v in stage_obj.interface.inputs.items()
        ]
        return dataset

    @classmethod
    def _from_query(
        cls, query: str, execute: Callable[[str], Any], reader_name: str, *args: Any, **kwargs: Any
    ) -> "Dataset":
        """Shared scaffolding for SQL-backed datasets: each ``{placeholder}`` in the
        query becomes a typed keyword parameter of the synthesized reader (a typed
        workflow input — Stage drops bare ``**kwargs`` from its interface)."""
        import re

        pd = _pandas()
        dataset = cls(*args, **kwargs)
        placeholders = list(dict.fromkeys(re.findall(r"{(\w+)}", query)))

        def reader(**query_kwargs: Any):
            return execute(query.format(**query_kwargs) if query_kwargs else query)

        reader.__name__ = reader_name
        reader.__annotations__ = {"return": pd.DataFrame}
        reader.__signature__ = Signature(  # type: ignore[attr-defined]
            parameters=[Parameter(name, Parameter.KEYWORD_ONLY, annotation=Any) for name in placeholders],
            return_annotation=pd.DataFrame,
        )
        dataset.reader(reader)
        return dataset

    @classmethod
    def from_sqlite_query(cls, db_path: str, query: str, *args: Any, **kwargs: Any) -> "Dataset":
        """Create a Dataset whose reader executes a SQLite query into a DataFrame.

        Replaces the reference's flytekit ``SQLite3Task`` integration
        (unionml/dataset.py:431-444) with a direct ``sqlite3`` reader. The query may
        contain ``{limit}``-style placeholders filled from reader kwargs.
        """

        def execute(sql: str):
            import contextlib
            import sqlite3

            pd = _pandas()

            # sqlite3's context manager only commits; closing() actually releases the handle
            with contextlib.closing(sqlite3.connect(db_path)) as conn:
                return pd.read_sql_query(sql, conn)

        return cls._from_query(query, execute, "sqlite_reader", *args, **kwargs)

    @classmethod
    def from_sqlalchemy_query(cls, connect_url: str, query: str, *args: Any, **kwargs: Any) -> "Dataset":
        """Create a Dataset whose reader executes a SQL query over a SQLAlchemy URL.

        Replaces the reference's flytekit ``SQLAlchemyTask`` integration
        (unionml/dataset.py:446-459). Requires ``sqlalchemy`` (optional dependency);
        ``{placeholder}``-style query params become typed reader kwargs like
        :meth:`from_sqlite_query`.
        """
        try:
            import sqlalchemy  # noqa: F401
        except ImportError as exc:  # pragma: no cover - import gate
            raise ImportError(
                "Dataset.from_sqlalchemy_query requires sqlalchemy; pip install sqlalchemy "
                "or use Dataset.from_sqlite_query for sqlite databases"
            ) from exc

        def execute(sql: str):
            from sqlalchemy import create_engine

            pd = _pandas()

            engine = create_engine(connect_url)
            try:
                return pd.read_sql_query(sql, engine)
            finally:
                engine.dispose()

        return cls._from_query(query, execute, "sqlalchemy_reader", *args, **kwargs)

    @classmethod
    def from_torch_dataset(cls, torch_dataset: Any, *args: Any, **kwargs: Any) -> "Dataset":
        """Create a Dataset reading a ``torch.utils.data.Dataset`` into host numpy arrays."""
        dataset = cls(*args, **kwargs)

        def reader() -> List[Any]:
            return [torch_dataset[i] for i in range(len(torch_dataset))]

        reader.__name__ = "torch_dataset_reader"
        dataset.reader(reader)
        return dataset

    @classmethod
    def from_hf_dataset(cls, hf_dataset: Any, *args: Any, **kwargs: Any) -> "Dataset":
        """Create a Dataset reading a HuggingFace ``datasets.Dataset`` into a DataFrame."""
        pd = _pandas()
        dataset = cls(*args, **kwargs)

        def reader():
            return hf_dataset.to_pandas()

        reader.__name__ = "hf_dataset_reader"
        reader.__annotations__ = {"return": pd.DataFrame}
        dataset.reader(reader)
        return dataset

    # ------------------------------------------------------------------ default pipeline functions

    def _default_loader(self, data: R) -> R:
        """Pass-through; coerces to DataFrame when the declared datatype is DataFrame
        (reference dataset.py:461-465)."""
        [(_, data_type)] = self.dataset_datatype.items()
        if _is_frame_type(data_type) and not _is_frame(data):
            return _pandas().DataFrame(data)  # type: ignore[return-value]
        return data

    def _default_splitter(self, data: D, test_size: float, shuffle: bool, random_state: int) -> Tuple[D, ...]:
        """DataFrame-aware train/test split (reference dataset.py:467-476).

        Implemented with a numpy permutation rather than sklearn so that the core
        package stays dependency-light; non-DataFrame data passes through unsplit.
        """
        if not _is_frame(data):
            return (data,)
        n = len(data)
        n_test = int(np.ceil(n * test_size))  # ceil, matching sklearn's convention
        if n_test == 0:
            return (data,)
        indices = np.arange(n)
        if shuffle:
            indices = np.random.default_rng(random_state).permutation(n)
        # test split comes from the tail so that unshuffled sequential data trains on
        # the chronological past and evaluates on the future
        train_idx, test_idx = indices[:-n_test], indices[-n_test:]
        return data.iloc[train_idx], data.iloc[test_idx]  # type: ignore[return-value]

    def _default_parser(self, data: D, features: Optional[List[str]], targets: Optional[List[str]]) -> Tuple[D, D]:
        """DataFrame-aware (features, targets) projection (reference dataset.py:478-493)."""
        if not _is_frame(data):
            return (data,)  # type: ignore[return-value]
        pd = _pandas()
        targets = targets or []
        feature_names = features or [col for col in data.columns if col not in targets]
        target_cols = [t for t in targets if t in data.columns]
        target_data = data[target_cols] if target_cols else pd.DataFrame()
        return data[feature_names], target_data  # type: ignore[return-value]

    def _default_feature_loader(self, features: Any) -> Any:
        """Load features from a JSON file path / records / dict into the dataset datatype
        (reference dataset.py:495-509)."""
        if isinstance(features, Path):
            # Path contents are always parsed as JSON, never re-resolved as a path
            payload = features.read_text().strip()
        elif isinstance(features, str):
            payload = features.strip()
            if payload[:1] not in ("[", "{"):  # maybe a path, not inline JSON
                try:
                    is_file = Path(payload).exists()
                except OSError:
                    is_file = False
                if is_file:
                    payload = Path(payload).read_text().strip()
        else:
            payload = None
        if payload is not None:
            if payload[:1] == "[":
                # native fast path for record arrays (no-op unless defaults apply —
                # we ARE the default loader here, so only the dtype gate matters)
                fast = self.get_features_from_bytes(payload.encode())
                if fast is not None:
                    return fast[0]
            features = json.loads(payload)

        [(_, data_type)] = self.dataset_datatype.items()
        if _is_frame_type(data_type):
            frame = _pandas().DataFrame(features)
            feature_names = self._feature_column_names(frame)
            return frame[feature_names] if feature_names else frame
        return features

    def _default_feature_transformer(self, features: R) -> D:
        """Identity (reference dataset.py:511-516); override with @dataset.feature_transformer."""
        return cast(D, features)
