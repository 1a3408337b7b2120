"""ATDNVO odometry regressor, MappingVAE and their blocks; the GMA flow
network is in ``models.flow``."""

from atdn_vslam_torch.models.mapping import MappingVAE
from atdn_vslam_torch.models.odometry import ATDNVO

__all__ = ["ATDNVO", "MappingVAE"]
