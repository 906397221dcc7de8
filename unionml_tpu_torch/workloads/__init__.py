"""Traffic capture: the trace record and the live-capture tap (the replayer,
scenarios and verdicts of the JAX package's ``workloads`` are not ported yet)."""

from unionml_tpu_torch.workloads.traces import (  # noqa: F401
    TraceRecorder,
    TraceRequest,
    active_traffic_recorder,
    set_active_traffic_recorder,
)
