"""Hot-path ops and their CUDA kernels.

The flow upsamplers are plain torch: ``convex_upsample`` (the learned
path) and ``upsample_flow_bilinear`` (its fallback).
"""

from atdn_vslam_torch.ops.upsample import convex_upsample, upsample_flow_bilinear

__all__ = ["convex_upsample", "upsample_flow_bilinear"]
