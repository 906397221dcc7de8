"""The port's native records parser against the JAX package's, payload by payload.

Both compile the same ``records.cpp`` with ``g++`` (the port into its ignored
``_build/``) and bind it with ``ctypes``; for every payload the two return
the same matrix, columns and bytes consumed, or both ``None`` (input outside
the parser's subset: the caller keeps the Python path). The dataset's fast
path then gives the frame the Python path gives.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from unionml_tpu.native import parse_records as jax_parse_records
from unionml_tpu_torch import Dataset
from unionml_tpu_torch.native import BUILD_DIR, library_path, native_available, parse_records

ROOT = Path(__file__).resolve().parents[1]

PAYLOADS = {
    "values": (b'[{"x": 1, "y": 2.5, "flag": true}, {"x": -3e2, "y": null, "flag": false}]', False),
    "empty": (b"  [ ]  ", False),
    "float64-exact": (b'[{"a": 0.1, "b": 1e-310, "c": 12345678901234567890}]', False),
    "empty-column-name": (b'[{"": 1}]', False),
    "string": (b'[{"a": "string"}]', False),
    "nested": (b'[{"a": [1]}]', False),
    "ragged-keys": (b'[{"a": 1}, {"b": 1}]', False),
    "duplicate-keys": (b'[{"a": 1, "a": 2}]', False),
    "column-count": (b'[{"a": 1}, {"a": 1, "b": 2}]', False),
    "not-an-array": (b'{"a": 1}', False),
    "trailing-strict": (b'[{"a": 1}] trailing', False),
    "trailing-allowed": (b'[{"a": 7}] , "other": 1}', True),
    "nan-literal": (b'[{"a": NaN}]', False),
    "blank": (b"", False),
}


@pytest.mark.parametrize("case", list(PAYLOADS))
def test_parse_records_equals_the_jax_package(case):
    payload, allow_trailing = PAYLOADS[case]
    ours, theirs = parse_records(payload, allow_trailing), jax_parse_records(payload, allow_trailing)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[0].dtype == np.float64 and ours[1:] == theirs[1:]


def test_library_builds_under_the_package_build_dir():
    assert native_available()
    assert library_path().parent == BUILD_DIR == ROOT / "unionml_tpu_torch" / "_build"
    assert library_path().exists()


def _dataset() -> Dataset:
    dataset = Dataset(name="native_ds", targets=["y"])

    @dataset.reader
    def reader(n: int = 8) -> pd.DataFrame:
        rng = np.random.default_rng(3)
        return pd.DataFrame({"x1": rng.normal(size=n), "x2": rng.normal(size=n), "y": np.arange(n) % 2})

    return dataset


@pytest.mark.parametrize("columns", [["x1", "x2"], ["x2", "x1", "y"]], ids=["features", "reordered-with-target"])
def test_dataset_fast_path_matches_python_path(columns):
    dataset = _dataset()
    records = dataset._reader()[columns].to_dict(orient="records")
    payload = pd.DataFrame(records).to_json(orient="records").encode()
    fast, consumed = dataset.get_features_from_bytes(payload)
    assert consumed == len(payload)
    pd.testing.assert_frame_equal(fast, dataset.get_features(records), check_dtype=False)
    assert list(fast.columns) == [c for c in columns if c != "y"]  # everything but the targets


def test_fast_path_declines_a_custom_pipeline_and_non_frames():
    dataset = _dataset()

    @dataset.feature_loader
    def feature_loader(raw) -> pd.DataFrame:
        return pd.DataFrame(raw)

    assert dataset.get_features_from_bytes(b'[{"x1": 1, "x2": 2}]') is None
    arrays = Dataset(name="arrays")

    @arrays.reader
    def reader() -> np.ndarray:
        return np.zeros((2, 2))

    assert arrays.get_features_from_bytes(b'[{"x1": 1}]') is None
