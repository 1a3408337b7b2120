"""Row-split flow inference (JAX ``parallel/flow_sharding.py``).

The ranks of one mesh axis split the image rows: each builds only its
band's rows of the correlation pyramid and of the attention
probabilities (or attends with its band's queries through K5), the
tensors that outgrow one card first as the resolution grows, and gathers
what its convolutions need from the other bands in every iteration
(``models/flow/network.py`` ``RAFTGMA._forward_rows``). Unlike the JAX
package, where GSPMD splits every tensor, each rank runs the two
encoders on the whole frames.
"""

from __future__ import annotations

import torch


@torch.inference_mode()
def sharded_flow_infer(model, image1: torch.Tensor, image2: torch.Tensor, mesh, axis: str = "model"):
    """RAFTGMA in test mode with the rows split over ``mesh``'s ``axis``.

    Every rank of the axis calls it with the same frames and weights.

    :param image1, image2: (B, H, W, 3) RGB in [0, 255]; H/8 must give
        every rank of the axis at least one row.
    :return: (flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2)), the same
        on every rank.
    """
    return model(image1, image2, mesh=mesh, axis=axis)
