"""Parallelism layer: device meshes, sharding rules and collectives over
``torch.distributed`` (counterpart of ``unionml_tpu/parallel``).

A mesh is one process per rank (see :mod:`unionml_tpu_torch.parallel.mesh`);
each rank keeps its shard of every parameter and the layers run the
collectives their sharding implies; the collectives carry gradients, so
the same layers train (``train/driver.py``). ``pipeline.py`` runs stacked
stages over the ``pipe`` axis.
"""

from unionml_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_to_all,
    allreduce_mean,
    allreduce_sum,
    gather_from,
    reduce_scatter,
    ring_permute,
    split_to,
    sum_gradients,
)
from unionml_tpu_torch.parallel.mesh import Mesh, MeshSpec  # noqa: F401
from unionml_tpu_torch.parallel.pipeline import (  # noqa: F401
    init_stage_params,
    pipeline_apply,
    pipeline_rule_table,
    sequential_stage_apply,
    stage_call,
)
from unionml_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    P,
    PartitionRules,
    PartitionSpec,
    batch_sharding,
    combine_fsdp_tp,
    infer_fsdp_sharding,
    batch_mean,
    named_sharding,
    place_module,
    reduce_scope,
    shard_pytree,
    unbox_partitioned,
)
