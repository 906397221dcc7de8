"""unionml-tpu's PyTorch/CUDA port for NVIDIA Hopper (H100).

A package beside the JAX package ``unionml_tpu`` that mirrors its module names
(``models/llama.py``, ``serving/continuous.py``, ...). It imports ``torch``
and never JAX or anything of the JAX package. Its entry points (``Llama``,
``Generator``, ``ContinuousBatcher``, and the trainer's ``fit`` and
``evaluate``) run on the card unless the caller passes ``device="cpu"``.
Kernels live in ``csrc/`` and build at first use into ``_build/``.

The app protocol is UnionML's: a ``Dataset`` and a ``Model`` whose decorated
user functions become train and predict graphs (``model.train()``,
``predict()``, ``save()``, ``load()``). Importing the package imports
neither pandas, scikit-learn nor joblib.
"""

from unionml_tpu_torch.artifact import ModelArtifact
from unionml_tpu_torch.dataset import Dataset
from unionml_tpu_torch.model import BaseHyperparameters, Model
from unionml_tpu_torch.models import DraftSpec, GenerationConfig, Generator, Llama, LlamaConfig
from unionml_tpu_torch.serving import ContinuousBatcher
from unionml_tpu_torch.stage import ExecutionGraph, Stage, stage
from unionml_tpu_torch.train import FitResult, TrainerConfig, TrainState, evaluate, fit, make_train_step

__all__ = [
    "BaseHyperparameters",
    "ContinuousBatcher",
    "Dataset",
    "DraftSpec",
    "ExecutionGraph",
    "FitResult",
    "GenerationConfig",
    "Generator",
    "Llama",
    "LlamaConfig",
    "Model",
    "ModelArtifact",
    "Stage",
    "TrainState",
    "TrainerConfig",
    "evaluate",
    "fit",
    "make_train_step",
    "stage",
]
