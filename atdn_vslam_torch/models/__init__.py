"""ATDNVO odometry regressor and its blocks; the GMA flow network is in
``models.flow``."""

from atdn_vslam_torch.models.odometry import ATDNVO

__all__ = ["ATDNVO"]
