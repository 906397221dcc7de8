"""{{app_name}}: an image classifier trained with PyTorch by the step trainer.

The port's copy of the JAX package's ``image-classification`` template: a
small CNN over scikit-learn's 8x8 digits, trained one Adam step at a time by
``model.train`` (a ``(state, batch) -> (state, metrics)`` step over the
port's ``TrainState``), with the same dataset, schedule, feature transformer
and predictor.

The CNN keeps the JAX template's layers and names (``Conv_0``, ``Conv_1``,
``Dense_0``, ``Dense_1``) and flax's layouts: the images are ``[B, H, W,
C]``, the convolution kernels ``[kh, kw, in, out]``, and the flatten before
``Dense_0`` runs over ``(h, w, c)``. So the JAX template's parameters load
as they are. ``init`` builds the module on the ``device`` hyperparameter:
unset means the card, and the CPU is asked for with ``{"device": "cpu"}``.
Swap ``MeshSpec`` into the TrainerConfig to shard across cards (one
process a rank).
"""

from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F
from sklearn.datasets import load_digits
from torch import nn

from unionml_tpu_torch import Dataset, Model, TrainerConfig, TrainState, make_train_step
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models.layers import Conv, LoRADense, init_weights

IMAGE_SIZE = 8
NUM_CLASSES = 10

dataset = Dataset(name="digits_images", test_size=0.2, shuffle=True, targets=["target"])
model = Model(name="{{app_name}}", dataset=dataset)
model.__app_module__ = "app:model"


class CNN(nn.Module):
    """Two SAME 3x3 convolutions (a 2x2 average pool between them), then two
    dense layers. As in the JAX template, the pixels are rounded to bf16 and
    the layers compute in f32. ``device=None`` builds on the card, and raises
    where there is none."""

    def __init__(self, device=None):
        super().__init__()
        common = dict(dtype=torch.float32, param_dtype=torch.float32, device=resolve_device(device))
        self.Conv_0 = Conv(1, 32, (3, 3), **common)
        self.Conv_1 = Conv(32, 64, (3, 3), **common)
        self.Dense_0 = LoRADense(64 * (IMAGE_SIZE // 2) ** 2, 128, use_bias=True, **common)
        self.Dense_1 = LoRADense(128, NUM_CLASSES, use_bias=True, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], IMAGE_SIZE, IMAGE_SIZE, 1).to(torch.bfloat16)
        x = F.relu(self.Conv_0(x))  # [B, 8, 8, 32]
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))  # 2x2 average pool, stride 2
        x = F.relu(self.Conv_1(x))  # [B, 4, 4, 64]
        x = x.reshape(x.shape[0], -1)  # (h, w, c) order, as flax flattens
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x).float()


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


@dataset.reader
def reader() -> pd.DataFrame:
    return load_digits(as_frame=True).frame


@model.init
def init(hyperparameters: dict) -> TrainState:
    """The CNN on ``hyperparameters["device"]`` (unset: the card), seeded
    weights, Adam with optax.adam's defaults."""
    device = hyperparameters.get("device")
    module = CNN(device=device)
    init_weights(module, torch.Generator(device=next(module.parameters()).device).manual_seed(0))
    optimizer = torch.optim.Adam(module.parameters(), lr=hyperparameters.get("learning_rate", 1e-3),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(module, optimizer)


def _loss(module: CNN, batch) -> torch.Tensor:
    features, target = batch
    return F.cross_entropy(module(features), target.long())


_step = make_train_step(_loss)


# swap in ``mesh=MeshSpec(data=-1)`` (``unionml_tpu_torch.parallel``) to train data-parallel over
# every rank of a ``torchrun`` world: each rank takes its rows of every batch
@model.trainer(config=TrainerConfig(epochs=10, batch_size=64, shuffle=True))
def trainer(state: TrainState, batch) -> tuple:
    return _step(state, batch)


@dataset.feature_transformer
def feature_transformer(features) -> np.ndarray:
    arr = np.asarray(features, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    return arr / 16.0  # digits pixels are 0..16


@dataset.parser
def parser(
    data: pd.DataFrame, features: Optional[List[str]], targets: List[str]
) -> Tuple[np.ndarray, np.ndarray]:
    target_cols = targets or ["target"]
    feature_frame = data.drop(columns=[c for c in target_cols if c in data.columns])
    if target_cols[0] in data.columns:
        target_arr = data[target_cols[0]].to_numpy(dtype=np.int32)
    else:
        target_arr = np.zeros(len(data), np.int32)
    return feature_frame.to_numpy(dtype=np.float32), target_arr


def _logits(state: TrainState, features: np.ndarray) -> torch.Tensor:
    with torch.no_grad():
        return state.model(torch.as_tensor(np.asarray(features, np.float32), device=_device(state)))


@model.predictor
def predictor(state: TrainState, features: np.ndarray) -> List[int]:
    return [int(i) for i in _logits(state, features).argmax(dim=-1)]


@model.evaluator
def evaluator(state: TrainState, features: np.ndarray, target: np.ndarray) -> float:
    predicted = _logits(state, features).argmax(dim=-1).cpu().numpy()
    return float((predicted == np.asarray(target)).mean())


if __name__ == "__main__":
    model_object, metrics = model.train(hyperparameters={"learning_rate": 1e-3})
    print(metrics)
    model.save("model_object.ckpt")
