"""Reference PyTorch checkpoints -> port ``state_dict``.

The reference's weights (GMA's ``gma-kitti.pth``, ATDNVO's
``11_1_atdnvo_c.pth``) use the names the port's modules keep, with
three differences that this loader removes, as the JAX package's
converter does before it converts (``convert_torch_checkpoint.py``):

  * GMA was saved through a DataParallel wrapper, so every key carries
    a ``module.`` prefix (ref: neural_slam.py:51);
  * GMA's ``att.pos_emb.*`` belongs to the positional attention modes,
    which the content-only port has no parameter for
    (``models/flow/gma.py``);
  * ATDNVO's ``polar_norm.*`` is never used in its forward
    (ref: odometry/network.py:43).

The result loads into :class:`~atdn_vslam_torch.models.flow.network.RAFTGMA`
or :class:`~atdn_vslam_torch.models.odometry.ATDNVO` with ``strict=True``.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import torch

#: key prefixes of reference entries with no port parameter
UNUSED_PREFIXES = ("att.pos_emb.", "polar_norm.")


def reference_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A reference ``state_dict`` (or a checkpoint dict holding one under
    ``"state_dict"``) without the ``module.`` prefix and the unused
    entries."""
    if isinstance(sd.get("state_dict"), Mapping):
        sd = sd["state_dict"]
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if not key.startswith(UNUSED_PREFIXES):
            out[key] = value
    return out


def load_reference_checkpoint(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Read a reference ``.pth`` on the CPU (tensors only, no pickled
    code) and return its port ``state_dict``."""
    return reference_state_dict(torch.load(path, map_location="cpu", weights_only=True))
