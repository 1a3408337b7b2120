"""Optical-flow networks: GMA (RAFT + Global Motion Aggregation) and
GMFlow (global matching after a Swin-style transformer)."""

from atdn_vslam_torch.models.flow.gmflow import GMFlow
from atdn_vslam_torch.models.flow.network import RAFTGMA

__all__ = ["GMFlow", "RAFTGMA"]
