"""The JAX package's serving unit cases, run against the port.

Each ``tests/test_torch_serving_*.py`` file reads one file of
``tests/unit/`` (here ``test_timeseries.py``), points its imports of
``unionml_tpu`` at ``unionml_tpu_torch`` and runs its cases unchanged: the
JAX package's case runs in ``tests/unit/``, the port's here, one case per
package. Fixtures that build JAX models or the JAX app are replaced after
the cases load by port builds of the same shape; cases of parts the port
does not have yet are dropped, each with its reason beside it.

This file also holds the helpers the other files import: :func:`port_cases`
and the sklearn app of ``tests/conftest.py`` built on the port's
``Dataset``/``Model``.
"""

import re
from pathlib import Path
from typing import Any, Iterable, List, Tuple

import numpy as np
import pandas as pd
import torch
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

UNIT = Path(__file__).resolve().parent / "unit"


def port_cases(namespace: dict, name: str, drop_lines: Iterable[str] = (),
               subs: Iterable[Tuple[str, str]] = ()) -> None:
    """Exec ``tests/unit/<name>`` into ``namespace`` with every import of the
    JAX package (``from unionml_tpu...``/``import unionml_tpu...``, in code
    and in subprocess code strings) pointed at the port. Lines containing
    any of ``drop_lines`` (imports of modules the port does not have) are
    left out; each ``(pattern, replacement)`` of ``subs`` is then applied
    with :func:`re.sub` (a call shape that differs in the port)."""
    path = UNIT / name
    lines = [line for line in path.read_text().splitlines(keepends=True)
             if not any(drop in line for drop in drop_lines)]
    source = re.sub(r"\b(from|import) unionml_tpu\b", r"\1 unionml_tpu_torch", "".join(lines))
    for pattern, replacement in subs:
        source = re.sub(pattern, replacement, source)
    exec(compile(source, f"{path} [unionml_tpu_torch]", "exec"), namespace)


def torch_sklearn_model() -> Any:
    """``tests/conftest.py``'s ``sklearn_model`` on the port's Dataset/Model."""
    from sklearn.linear_model import LogisticRegression

    from unionml_tpu_torch import Dataset, Model

    dataset = Dataset(name="test_dataset", targets=["y"], test_size=0.2)

    @dataset.reader
    def reader(sample_frac: float = 1.0, random_state: int = 42) -> pd.DataFrame:
        rng = np.random.default_rng(17)
        frame = pd.DataFrame({"x1": rng.normal(size=100), "x2": rng.normal(size=100)})
        frame["y"] = (frame["x1"] + frame["x2"] > 0).astype(int)
        return frame.sample(frac=sample_frac, random_state=random_state)

    model = Model(name="test_model", init=LogisticRegression, dataset=dataset)

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


def tiny_llama(vocab_size: int, seed: int) -> Any:
    """The unit files' tiny f32 Llama (dim 64, 2 layers), on the CPU."""
    from unionml_tpu_torch.models import Llama, LlamaConfig

    config = LlamaConfig.tiny(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
                              dtype=torch.float32, param_dtype=torch.float32)
    return Llama(config, device="cpu", seed=seed)


def generator(module: Any, params: Any, config: Any) -> Any:
    """The JAX package's ``Generator(module, params, config)`` call shape over
    the port's ``Generator(model, config, device=...)``; ``params`` is unused
    (the port's module holds its weights)."""
    from unionml_tpu_torch.models import Generator

    return Generator(module, config, device="cpu")


port_cases(globals(), "test_timeseries.py")
