"""SLAM runtime (odometry, mapping, relocalisation, loop closure) and
keyframe store."""

from atdn_vslam_torch.slam.keyframes import KeyframeStore
from atdn_vslam_torch.slam.runtime import SlamRuntime

__all__ = ["KeyframeStore", "SlamRuntime"]
