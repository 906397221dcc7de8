"""Serving: the HTTP app, dynamic micro-batching, the bucketed predictor, the
continuous-batching engine and their overload, tenancy and latency primitives.

The port's counterpart of ``unionml_tpu/serving``: ``serving_app`` registers
``POST /predict``, ``POST /predict-stream``, the OpenAI-compatible ``/v1/*``
routes, ``GET /health``, ``/healthz``, ``/metrics`` and the debug routes on a
small stdlib-asyncio HTTP server, with a micro-batching queue between the
socket and the device; the continuous engine admits in chunks and reuses
shared prefixes (a static ``prefix=`` and the radix prefix cache,
``serving/prefix_cache.py``); the in-process replica layer
(``serving/replicas.py``) runs N engines behind one scheduler, with
prefill/decode roles and KV handoff and an elastic fleet. The mesh path of
the replica layer, the multi-host cluster and the AOT program store are not
ported yet (ROADMAP.md, Queue A).
"""

from unionml_tpu_torch.serving.app import ServingApp, serving_app
from unionml_tpu_torch.serving.batcher import MicroBatcher, ServingConfig
from unionml_tpu_torch.serving.compile import CompiledPredictor
from unionml_tpu_torch.serving.continuous import ContinuousBatcher
from unionml_tpu_torch.serving.http import HTTPServer
from unionml_tpu_torch.serving.metrics import LatencyWindow, ServingMetrics
from unionml_tpu_torch.serving.overload import (
    DeadlineExceeded,
    QueueFullError,
    TenantThrottled,
    current_deadline,
    expired,
)
from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache
from unionml_tpu_torch.serving.replicas import ReplicaScheduler, ReplicaSet
from unionml_tpu_torch.serving.tenancy import TenantRegistry, TenantSpec, current_priority, current_tenant

__all__ = [
    "CompiledPredictor",
    "ContinuousBatcher",
    "DeadlineExceeded",
    "HTTPServer",
    "LatencyWindow",
    "MicroBatcher",
    "QueueFullError",
    "RadixPrefixCache",
    "ReplicaScheduler",
    "ReplicaSet",
    "ServingApp",
    "ServingConfig",
    "ServingMetrics",
    "TenantRegistry",
    "TenantSpec",
    "TenantThrottled",
    "current_deadline",
    "current_priority",
    "current_tenant",
    "expired",
    "serving_app",
]
