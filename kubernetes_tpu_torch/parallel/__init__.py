"""Distribution layer: the node-sharded mesh (mesh.py), the JAX package's
parallel/ in one process — a grid of torch devices, the cluster state cut
along its node axis, and the row-local lap as one launch a card a dispatch,
with both exchanges of a lap on the device."""

from .mesh import (
    NodeMesh,
    Sharded,
    ShardedLap,
    gather,
    make_mesh,
    mesh_shard_count,
    shard_features,
    shard_node_state,
    sharded_lap_schedule,
    sharded_schedule_batch,
)

__all__ = ["NodeMesh", "Sharded", "ShardedLap", "gather", "make_mesh", "mesh_shard_count",
           "shard_features", "shard_node_state", "sharded_lap_schedule",
           "sharded_schedule_batch"]
