from polypolish_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from polypolish_tpu_torch.parallel.shard import (
    bucket_events_for_mesh,
    bucket_lanes_for_mesh,
    sharded_step,
    sharded_step_lanes,
    sharded_vote_consensus,
    sharded_vote_consensus_lanes,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape_for",
    "bucket_events_for_mesh",
    "bucket_lanes_for_mesh",
    "sharded_step",
    "sharded_step_lanes",
    "sharded_vote_consensus",
    "sharded_vote_consensus_lanes",
]
