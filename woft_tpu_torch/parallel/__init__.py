"""Scale-out on ``torch.distributed``: the (dp, sp) mesh, sharding helpers,
the rank launcher, and the sharded tracking, training and forward paths
(the twin of ``woft_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    all_reduce_sum, gather_by_sum, launch, make_mesh, mesh_shape,
    process_group, replicate, shard_batch)
from .sharding import (  # noqa: F401
    gather_streams,
    sharded_track_batch,
    sharded_train_step,
    spatial_sharded_correlation,
    spatial_sharded_forward,
)
