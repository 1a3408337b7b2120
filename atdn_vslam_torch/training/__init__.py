"""Training of the odometry network (ATDNVO) and of the map network
(MappingVAE), and their losses."""
