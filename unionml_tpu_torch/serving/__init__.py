"""Serving: the continuous-batching engine and its overload and latency primitives."""

from unionml_tpu_torch.serving.continuous import ContinuousBatcher
from unionml_tpu_torch.serving.metrics import LatencyWindow
from unionml_tpu_torch.serving.overload import DeadlineExceeded, QueueFullError, expired

__all__ = ["ContinuousBatcher", "DeadlineExceeded", "LatencyWindow", "QueueFullError", "expired"]
