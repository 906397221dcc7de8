"""Traffic record/replay: trace schema, scenario library, replayer, verdicts.

The port's copy of the JAX package's ``workloads``: recorded or synthesized
request mixes played arrival-time-faithfully through the real HTTP stack
(``python -m unionml_tpu_torch.cli replay``) and judged by per-tenant SLO
verdicts.
"""

from unionml_tpu_torch.workloads.replayer import replay, replay_async  # noqa: F401
from unionml_tpu_torch.workloads.scenarios import (  # noqa: F401
    SCENARIOS,
    scenario_meta,
    scenario_targets,
    synthesize,
    synthesize_text,
)
from unionml_tpu_torch.workloads.traces import (  # noqa: F401
    TraceRecorder,
    TraceRequest,
    active_traffic_recorder,
    dumps_trace,
    read_trace,
    set_active_traffic_recorder,
    write_trace,
)
from unionml_tpu_torch.workloads.verdicts import (  # noqa: F401
    availability,
    overall_state,
    tenant_verdicts,
)
