"""The communication runtime: SPMD ranks over ``torch.distributed`` (the
counterpart of ``kornia_tpu/parallel``, where a device mesh and
``shard_map`` play this part), distributed bundle adjustment and pose-graph
optimisation."""

from .mesh import (
    Mesh,
    NamedSharding,
    P,
    data_sharding,
    local_mesh,
    make_mesh,
    replicated,
    shard_batch,
    use_mesh,
)
from .dist_ba import distributed_bundle_adjust
from .dist_posegraph import (PartitionedGraph, distributed_pose_graph,
                             partition_pose_graph)
from .spmd import spawn
