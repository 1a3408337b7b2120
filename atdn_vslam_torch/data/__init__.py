"""KITTI odometry data: poses, cached flows, RGB frames, reverse-time
augmentation and host-side batching (numpy copies of the JAX package's
``data`` modules)."""

from atdn_vslam_torch.data.flow_cache import FlowCache, write_flow_cache
from atdn_vslam_torch.data.kitti import BatchLoader, FlowWindowDataset, KittiSequence, load_poses

__all__ = [
    "FlowWindowDataset",
    "KittiSequence",
    "load_poses",
    "BatchLoader",
    "FlowCache",
    "write_flow_cache",
]
