"""The step trainer: ``fit``/``evaluate`` over a ``(state, batch) -> (state, metrics)`` step."""

from unionml_tpu_torch.train.driver import FitResult, TrainerConfig, TrainState, evaluate, fit, make_train_step

__all__ = ["FitResult", "TrainState", "TrainerConfig", "evaluate", "fit", "make_train_step"]
