"""Parallel paths over processes, one per device (JAX ``parallel/``).

``distributed`` starts the process group from the ``ATDN_*`` variables
and holds the collectives; ``mesh`` lays the ranks out as a ("data",
"model") grid and holds the JAX package's tensor-parallel rule
(``model_parallel_sharding``); ``tensor_parallel`` splits the parameters
it picks over "model"; ``flow_sharding`` splits the flow net's image rows
over "model". Training batches, the keyframe map and the pose graph's
edges split over "data" (``training/``, ``slam/``,
``geometry/pose_graph.py``).
"""

from atdn_vslam_torch.parallel.flow_sharding import sharded_flow_infer
from atdn_vslam_torch.parallel.mesh import Mesh, make_mesh, model_parallel_sharding, shard_batch

__all__ = ["Mesh", "make_mesh", "model_parallel_sharding", "shard_batch", "sharded_flow_infer"]
