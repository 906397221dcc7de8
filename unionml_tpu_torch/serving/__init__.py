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
prefill/decode roles and KV handoff and an elastic fleet; one engine serves a
``model``/``sequence``/``expert`` mesh from rank 0 (``serving/mesh.py``); the
AOT program store (``serving/aot.py``) captures an engine's programs as CUDA
graphs and carries their kernels to the next cold process, and
``serving/serverless.py`` wraps a ``ServingApp`` as a function handler; over
a data-parallel mesh the replica layer is process-aware, each rank serving
its host's replica, and ``serving/cluster.py`` runs a multi-host fleet (a
coordinator over worker hosts, with the host lifecycle and the fault
injection of ``serving/faults.py``).
"""

from unionml_tpu_torch.serving.aot import AOTFunction, ProgramStore
from unionml_tpu_torch.serving.app import ServingApp, serving_app
from unionml_tpu_torch.serving.batcher import MicroBatcher, ServingConfig
from unionml_tpu_torch.serving.cluster import FleetCoordinator, LocalHost, RemoteHost, WorkerAgent, connect_fleet
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
from unionml_tpu_torch.serving.replicas import ReplicaScheduler, ReplicaSet, slice_mesh
from unionml_tpu_torch.serving.tenancy import TenantRegistry, TenantSpec, current_priority, current_tenant

__all__ = [
    "AOTFunction",
    "CompiledPredictor",
    "ContinuousBatcher",
    "DeadlineExceeded",
    "FleetCoordinator",
    "HTTPServer",
    "LatencyWindow",
    "LocalHost",
    "MicroBatcher",
    "ProgramStore",
    "QueueFullError",
    "RadixPrefixCache",
    "RemoteHost",
    "ReplicaScheduler",
    "ReplicaSet",
    "ServingApp",
    "ServingConfig",
    "ServingMetrics",
    "TenantRegistry",
    "TenantSpec",
    "TenantThrottled",
    "WorkerAgent",
    "connect_fleet",
    "current_deadline",
    "current_priority",
    "current_tenant",
    "expired",
    "serving_app",
    "slice_mesh",
]
