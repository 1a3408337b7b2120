"""GMA optical-flow network (RAFT + Global Motion Aggregation)."""

from atdn_vslam_torch.models.flow.network import RAFTGMA

__all__ = ["RAFTGMA"]
