"""unionml-tpu's PyTorch/CUDA port for NVIDIA Hopper (H100).

A package beside the JAX package ``unionml_tpu`` that mirrors its module names
(``models/llama.py``, ``serving/continuous.py``, ...). It imports ``torch``
and never JAX or anything of the JAX package. Its entry points (``Llama``,
``Generator``, ``ContinuousBatcher``, and the trainer's ``fit`` and
``evaluate``) run on the card unless the caller passes ``device="cpu"``.
Kernels live in ``csrc/`` and build at first use into ``_build/``.
"""

from unionml_tpu_torch.models import GenerationConfig, Generator, Llama, LlamaConfig
from unionml_tpu_torch.serving import ContinuousBatcher
from unionml_tpu_torch.train import FitResult, TrainerConfig, TrainState, evaluate, fit, make_train_step

__all__ = [
    "ContinuousBatcher",
    "FitResult",
    "GenerationConfig",
    "Generator",
    "Llama",
    "LlamaConfig",
    "TrainState",
    "TrainerConfig",
    "evaluate",
    "fit",
    "make_train_step",
]
