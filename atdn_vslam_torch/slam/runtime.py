"""SLAM runtime, odometry mode: the streaming step on the GPU.

Counterpart of ``atdn_vslam_tpu/slam/runtime.py``: the same state
machine (``mode()``, ``start_odometry``, ``__call__``) and the same
per-frame path. One frame in: RAFTGMA against the previous frame (its
feature map cached from the previous step), ATDNVO with the explicit
LSTM carry, ``pose_to_matrix``; then float64 pose chaining and the
rotation/translation keyframe test on the host.

Mapping, relocalisation and loop closure are later slices: their entry
points raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from atdn_vslam_torch.config import Config
from atdn_vslam_torch.geometry.se3 import matrix_to_euler, pose_to_matrix
from atdn_vslam_torch.models.factory import (
    build_flow_model,
    build_odometry_model,
    working_size,
)
from atdn_vslam_torch.ops.bilinear import forward_warp_flow
from atdn_vslam_torch.ops.padding import InputPadder
from atdn_vslam_torch.slam.keyframes import KeyframeStore
from atdn_vslam_torch.utils.helpers import log, resolve_device


class SlamRuntime:
    """:param config: full framework config.
    :param flow_state_dict: RAFTGMA weights (reference ``state_dict``
        names, see ``atdn_vslam_torch.convert``).
    :param odometry_state_dict: ATDNVO weights.
    :param start_mode: None (cold start); the warm starts into mapping
        or relocalisation are not ported yet.
    :param device: where the models run; default ``"cuda"``, which
        raises when no GPU is present.
    """

    def __init__(
        self,
        config: Config,
        flow_state_dict: Mapping[str, Any],
        odometry_state_dict: Mapping[str, Any],
        start_mode: str | None = None,
        device: str | torch.device = "cuda",
    ):
        if start_mode is not None:
            raise NotImplementedError(
                "warm starts into mapping or relocalization need the mapping "
                "slice (ROADMAP M7)"
            )
        self.config = config
        self.device = resolve_device(device)
        cfg = config.slam
        self._hw = (cfg.image_height, cfg.image_width)
        self._rot_threshold = np.deg2rad(cfg.rotation_threshold_deg)
        self._tr_threshold = cfg.translation_threshold

        self.flow_model = build_flow_model(config, self.device)
        self.flow_model.load_state_dict(flow_state_dict)
        self.odometry_model = build_odometry_model(config, self.device)
        self.odometry_model.load_state_dict(odometry_state_dict)

        self.keyframes = KeyframeStore(config.keyframes_path, cfg.max_keyframes)
        self.keyframes.initialize_cold()
        self._mode = "idle"

        self._carry = self.odometry_model.init_carry(1)
        self._image_buffer: torch.Tensor | None = None
        self._stream_fmap: torch.Tensor | None = None
        self._warm_start = bool(cfg.flow_warm_start)
        self._stream_flow: torch.Tensor | None = None
        self._current_pose = np.eye(4, dtype=np.float64)
        self._propagation = np.eye(4, dtype=np.float64)

    # -- device step ----------------------------------------------------

    @torch.inference_mode()
    def _odometry_step(self, im1, im2, carry, fmap1=None, flow_init=None):
        """(frame pair, carry) -> (relative pose 4x4 float32, flow,
        low-res flow, new carry, im2's feature map)."""
        if flow_init is not None:
            flow_init = forward_warp_flow(flow_init)
        (flow_low, flow), fmap2 = self.flow_model(
            im1[None], im2[None], fmap1=fmap1, return_features=True, flow_init=flow_init
        )
        (rot, tr), carry = self.odometry_model(flow[:, None], carry)
        mat = pose_to_matrix(rot[0, 0], tr[0, 0])
        return mat, flow[0], flow_low, carry, fmap2

    @torch.inference_mode()
    def _fnet(self, image: torch.Tensor) -> torch.Tensor:
        """Feature-encode one frame (bootstraps the streaming cache)."""
        return self.flow_model(image[None], encode_only=True)

    # -- public API -----------------------------------------------------

    def mode(self) -> str:
        return self._mode

    def start_odometry(self) -> None:
        if self._mode == "idle":
            self._mode = "odometry"
            log("Starting odometry, accepting input image pairs")
        else:
            log("Odometry cannot be performed in current SLAM stage")

    def __len__(self) -> int:
        return len(self.keyframes)

    def get_keyframe(self, index: int):
        return self.keyframes.read_rgb(index), self.keyframes.poses[index]

    def __getitem__(self, index: int):
        return self.get_keyframe(index)

    def _prepare(self, image: np.ndarray) -> torch.Tensor:
        """uint8 (H, W, 3) -> float32 image on the device at the working
        size: a bilinear resize with antialiasing when downscaling (the
        semantics of ``jax.image.resize(..., "bilinear")``), then
        replicate padding to /8 (kitti mode)."""
        im = torch.from_numpy(np.ascontiguousarray(image)).to(self.device).float()
        if tuple(im.shape[:2]) != self._hw:
            im = F.interpolate(
                im.permute(2, 0, 1)[None], size=self._hw, mode="bilinear",
                align_corners=False, antialias=True,
            )[0].permute(1, 2, 0)
        if im.shape[0] % 8 or im.shape[1] % 8:
            im = InputPadder(im.shape, mode="kitti").pad(im)[0]
        return im

    def __call__(self, image: np.ndarray) -> np.ndarray:
        if self._mode == "odometry":
            return self._odometry_call(image)
        raise RuntimeError("SLAM called in invalid state!")

    def _odometry_call(self, image: np.ndarray) -> np.ndarray:
        im = self._prepare(image)
        if self._image_buffer is None:
            self._image_buffer = im
            self._stream_fmap = self._fnet(im)
            if self._warm_start:
                h8, w8 = working_size(self.config)
                self._stream_flow = torch.zeros(
                    (1, h8 // 8, w8 // 8, 2), device=self.device
                )
            self.keyframes.append(_to_uint8(im), self._current_pose)
            return self._current_pose.copy()

        mat, _flow, flow_low, self._carry, self._stream_fmap = self._odometry_step(
            self._image_buffer, im, self._carry, self._stream_fmap,
            self._stream_flow if self._warm_start else None,
        )
        if self._warm_start:
            self._stream_flow = flow_low
        pred = mat.double().cpu().numpy()
        self._current_pose = self._current_pose @ pred
        if self._decide_keyframe(pred):
            self.keyframes.append(_to_uint8(im), self._current_pose)
        self._image_buffer = im
        return self._current_pose.copy()

    def _decide_keyframe(self, pred: np.ndarray) -> bool:
        """Threshold test on the motion accumulated since the last
        keyframe (ref: neural_slam.py:288-302)."""
        self._propagation = self._propagation @ pred
        rot = matrix_to_euler(torch.from_numpy(self._propagation[:3, :3])).numpy()
        tr = self._propagation[:3, 3]
        if (
            np.linalg.norm(rot) > self._rot_threshold
            or np.linalg.norm(tr) > self._tr_threshold
        ):
            self._propagation = np.eye(4, dtype=np.float64)
            return True
        return False

    def run_odometry_sequence(self, frames: np.ndarray) -> np.ndarray:
        """Odometry over a frame stack, the same per-frame path as
        ``__call__`` in a loop.

        :param frames: (N, H, W, 3) uint8 RGB stack, N >= 2.
        :return: (N, 4, 4) float64 global poses.
        """
        if self._mode != "odometry":
            raise RuntimeError("run_odometry_sequence requires odometry mode")
        if self._image_buffer is not None:
            raise RuntimeError("run_odometry_sequence must start a fresh sequence")
        return np.stack([self._odometry_call(f) for f in frames])

    def end_odometry(self) -> None:
        raise NotImplementedError("mapping is not ported yet (ROADMAP M7)")

    def refine_trajectory(self, *args, **kwargs):
        raise NotImplementedError("the pose-graph backend is not ported yet (ROADMAP M10)")

    def close_loops(self, *args, **kwargs):
        raise NotImplementedError("loop closure is not ported yet (ROADMAP M10)")


def _to_uint8(im: torch.Tensor) -> np.ndarray:
    """The keyframe copy of a prepared frame (values in [0, 255],
    truncated like numpy's cast)."""
    return im.to(torch.uint8).cpu().numpy()
