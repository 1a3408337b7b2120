"""Reference PyTorch checkpoints -> port ``state_dict``.

The reference's weights (GMA's ``gma-kitti.pth``, ATDNVO's
``11_1_atdnvo_c.pth``) use the names the port's modules keep, with
three differences that this loader removes, as the JAX package's
converter does before it converts (``convert_torch_checkpoint.py``):

  * GMA was saved through a DataParallel wrapper, so every key carries
    a ``module.`` prefix (ref: neural_slam.py:51);
  * GMA's ``att.pos_emb.*`` belongs to the positional attention modes:
    kept for a model built with one of them (its ``RelPosEmb``,
    ``models/flow/gma.py``), dropped for the content-only model, which
    has no parameter for it;
  * ATDNVO's ``polar_norm.*`` is never used in its forward
    (ref: odometry/network.py:43).

The result loads into :class:`~atdn_vslam_torch.models.flow.network.RAFTGMA`
or :class:`~atdn_vslam_torch.models.odometry.ATDNVO` with ``strict=True``.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import torch
from torch import nn

#: key prefixes of reference entries with no port parameter
UNUSED_PREFIXES = ("att.pos_emb.", "polar_norm.")
POS_EMB_PREFIX = "att.pos_emb."


def reference_state_dict(
    sd: Mapping[str, torch.Tensor], model: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    """A reference ``state_dict`` (or a checkpoint dict holding one under
    ``"state_dict"``) without the ``module.`` prefix and the unused
    entries.

    :param model: the module the result is for. When its own state has
        ``att.pos_emb.*`` entries (a positional GMA), the checkpoint's
        are kept, and one whose shape differs from the model's raises
        ``ValueError`` naming both shapes.
    """
    if isinstance(sd.get("state_dict"), Mapping):
        sd = sd["state_dict"]
    target = {} if model is None else model.state_dict()
    keep_pos = any(key.startswith(POS_EMB_PREFIX) for key in target)
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if keep_pos and key.startswith(POS_EMB_PREFIX):
            want = target.get(key)
            if want is not None and tuple(want.shape) != tuple(value.shape):
                raise ValueError(
                    f"{key}: the checkpoint's shape {tuple(value.shape)} differs from the "
                    f"model's {tuple(want.shape)}"
                )
        elif key.startswith(UNUSED_PREFIXES):
            continue
        out[key] = value
    return out


def load_reference_checkpoint(
    path: str | os.PathLike, model: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    """Read a reference ``.pth`` on the CPU (tensors only, no pickled
    code) and return its port ``state_dict`` for ``model``
    (:func:`reference_state_dict`)."""
    return reference_state_dict(torch.load(path, map_location="cpu", weights_only=True), model)
