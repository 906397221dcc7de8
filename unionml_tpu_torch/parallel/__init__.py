"""Parallelism layer: device meshes, sharding rules and collectives over
``torch.distributed`` (counterpart of ``unionml_tpu/parallel``).

A mesh is one process per rank (see :mod:`unionml_tpu_torch.parallel.mesh`);
each rank keeps its shard of every parameter and the layers run the
collectives their sharding implies. The pipeline-parallel names
(``pipeline.py``) wait for the training slice (ROADMAP.md, Queue A:
parallelism and the replica layer, parallel training).
"""

from unionml_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_to_all,
    allreduce_mean,
    allreduce_sum,
    reduce_scatter,
    ring_permute,
)
from unionml_tpu_torch.parallel.mesh import Mesh, MeshSpec  # noqa: F401
from unionml_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    P,
    PartitionRules,
    PartitionSpec,
    batch_sharding,
    combine_fsdp_tp,
    infer_fsdp_sharding,
    named_sharding,
    shard_pytree,
    unbox_partitioned,
)
