"""tpu-lint rule registry.

Each rule lives in its own module; adding a rule is: write the module, import
its class here, add it to :data:`RULES`. The engine instantiates from this
mapping (:func:`unionml_tpu_torch.analysis.engine.all_rules`), so the registry is
the single source of truth for ``--select``/``--ignore`` validation and the
docs rule catalog.
"""

from __future__ import annotations

from unionml_tpu_torch.analysis.rules.tpu001_host_sync import HostSyncInJit
from unionml_tpu_torch.analysis.rules.tpu002_donate import UseAfterDonate
from unionml_tpu_torch.analysis.rules.tpu003_locks import UnlockedSharedMutation
from unionml_tpu_torch.analysis.rules.tpu004_blocking import BlockingCallInServingLoop
from unionml_tpu_torch.analysis.rules.tpu005_env import BareEnvNumericParse
from unionml_tpu_torch.analysis.rules.tpu006_wall_clock import WallClockDuration
from unionml_tpu_torch.analysis.rules.tpu007_locked_callers import UnlockedLockedHelperCall
from unionml_tpu_torch.analysis.rules.tpu008_thread_leak import LeakedEngineThread
from unionml_tpu_torch.analysis.rules.tpu009_registry import UnboundedPerKeyRegistry
from unionml_tpu_torch.analysis.rules.tpu010_lock_order import LockOrderCycle
from unionml_tpu_torch.analysis.rules.tpu011_recompile import RecompileHazard
from unionml_tpu_torch.analysis.rules.tpu012_contextvar import ContextvarExecutorHole
from unionml_tpu_torch.analysis.rules.tpu013_locked_collectives import BlockingCollectiveUnderLock
from unionml_tpu_torch.analysis.rules.tpu014_unseeded_random import UnseededRandomness
from unionml_tpu_torch.analysis.rules.tpu015_unbounded_retry import UnboundedNetworkRetry
from unionml_tpu_torch.analysis.rules.tpu016_resource_leak import ResourceLeakOnException
from unionml_tpu_torch.analysis.rules.tpu017_charge_refund import ChargeWithoutRefund
from unionml_tpu_torch.analysis.rules.tpu018_lock_yield import LockHeldAcrossYield
from unionml_tpu_torch.analysis.rules.tpu019_early_return import UnreleasedOnEarlyReturn

__all__ = ["RULES"]

RULES = {
    cls.id: cls
    for cls in (
        HostSyncInJit,
        UseAfterDonate,
        UnlockedSharedMutation,
        BlockingCallInServingLoop,
        BareEnvNumericParse,
        WallClockDuration,
        UnlockedLockedHelperCall,
        LeakedEngineThread,
        UnboundedPerKeyRegistry,
        LockOrderCycle,
        RecompileHazard,
        ContextvarExecutorHole,
        BlockingCollectiveUnderLock,
        UnseededRandomness,
        UnboundedNetworkRetry,
        ResourceLeakOnException,
        ChargeWithoutRefund,
        LockHeldAcrossYield,
        UnreleasedOnEarlyReturn,
    )
}
