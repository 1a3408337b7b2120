"""SLAM runtime: the streaming step on the GPU, the map and
relocalisation.

Counterpart of ``atdn_vslam_tpu/slam/runtime.py``: the same state
machine (idle -> odometry -> mapping -> relocalization, with ``mode()``,
``start_odometry``, ``__call__``, ``end_odometry`` and the warm starts)
and the same per-frame path. One frame in: RAFTGMA against the previous
frame (its feature map cached from the previous step), ATDNVO with the
explicit LSTM carry, ``pose_to_matrix``; then float64 pose chaining and
the rotation/translation keyframe test on the host. ``end_odometry``
trains MappingVAE on the keyframes, saves it and embeds every keyframe;
a query is then encoded, matched to the nearest keyframe code and
refined by one flow + odometry step from that keyframe.

The pose graph and loop closure are a later slice: their entry points
raise ``NotImplementedError`` naming the ROADMAP item (M10).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from atdn_vslam_torch.config import Config
from atdn_vslam_torch.geometry.se3 import matrix_to_euler, pose_to_matrix
from atdn_vslam_torch.models.factory import (
    build_flow_model,
    build_mapping_model,
    build_odometry_model,
    working_size,
)
from atdn_vslam_torch.models.mapping import MappingVAE
from atdn_vslam_torch.ops.bilinear import forward_warp_flow
from atdn_vslam_torch.ops.padding import InputPadder
from atdn_vslam_torch.slam.keyframes import KeyframeStore
from atdn_vslam_torch.training.mapping import train_mapping
from atdn_vslam_torch.utils.helpers import log, resolve_device

#: the trained map's weights inside the keyframe store, written by the
#: runtime and by ``cli/train_mapping.py``, read by the warm start
MAP_FILE = "mapping_variables.pt"

#: keyframe feature maps kept for relocalisation (3.7 MB each at KITTI, bf16)
KEYFRAME_FMAP_CACHE = 32


def save_map(model: MappingVAE, keyframes_path: str) -> str:
    """Write the map's ``state_dict`` into the store, atomically (a
    ``.tmp`` file, then ``os.replace``); returns the path."""
    os.makedirs(keyframes_path, exist_ok=True)
    path = os.path.join(keyframes_path, MAP_FILE)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, tmp)
    os.replace(tmp, path)
    return path


@torch.inference_mode()
def embed_keyframes(model: MappingVAE, store: KeyframeStore, device: torch.device,
                    batch: int = 8) -> np.ndarray:
    """Every keyframe's code, flattened in HWC order: (N, h * w * C)
    float32. The last batch is padded by repeating its last keyframe, so
    every call has one shape."""
    codes = []
    n = len(store)
    for start in range(0, n, batch):
        count = min(start + batch, n) - start
        imgs = np.stack([store.read_rgb(start + min(i, count - 1)) for i in range(batch)])
        code = model.get_code(torch.from_numpy(imgs).to(device).float())
        codes.append(code.cpu().numpy().reshape(batch, -1)[:count])
    return np.concatenate(codes, axis=0)


class SlamRuntime:
    """:param config: full framework config.
    :param flow_state_dict: RAFTGMA weights (reference ``state_dict``
        names, see ``atdn_vslam_torch.convert``).
    :param odometry_state_dict: ATDNVO weights.
    :param mapping_state_dict: optional trained MappingVAE weights (for
        the ``"relocalization"`` warm start; without them it reads the
        map that ``end_odometry`` saved into the store).
    :param start_mode: None (cold start: the store is wiped),
        ``"mapping"`` (load the store's keyframes and build the map) or
        ``"relocalization"`` (load the store with its embeddings)
        (ref: neural_slam.py:77-125).
    :param device: where the models run; default ``"cuda"``, which
        raises when no GPU is present.
    """

    def __init__(
        self,
        config: Config,
        flow_state_dict: Mapping[str, Any],
        odometry_state_dict: Mapping[str, Any],
        mapping_state_dict: Mapping[str, Any] | None = None,
        start_mode: str | None = None,
        device: str | torch.device = "cuda",
    ):
        if start_mode not in (None, "mapping", "relocalization"):
            raise ValueError(f"unknown start_mode {start_mode!r}")
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
        self.mapping_model = build_mapping_model(config, self.device)
        if mapping_state_dict is not None:
            self.mapping_model.load_state_dict(mapping_state_dict)

        self.keyframes = KeyframeStore(config.keyframes_path, cfg.max_keyframes)
        # relocalisation and closure steps re-encode their keyframe side
        # otherwise; keyframe RGBs never change, so entries never go stale
        self._kf_fmap_cache: OrderedDict[int, torch.Tensor] = OrderedDict()

        self._carry = self.odometry_model.init_carry(1)
        self._image_buffer: torch.Tensor | None = None
        self._stream_fmap: torch.Tensor | None = None
        self._warm_start = bool(cfg.flow_warm_start)
        self._stream_flow: torch.Tensor | None = None
        self._current_pose = np.eye(4, dtype=np.float64)
        self._propagation = np.eye(4, dtype=np.float64)

        if start_mode == "mapping":
            self.keyframes.load(with_embeddings=False)
            self._mode = "odometry"
            self.end_odometry()
        elif start_mode == "relocalization":
            if mapping_state_dict is None:
                path = os.path.join(config.keyframes_path, MAP_FILE)
                if not os.path.exists(path):
                    raise ValueError(
                        f"relocalization warm start needs mapping_state_dict or a saved map at {path}"
                    )
                self.mapping_model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
            self.keyframes.load(with_embeddings=True)
            self._mode = "relocalization"
        else:
            self.keyframes.initialize_cold()
            self._mode = "idle"

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

    def __call__(self, image: np.ndarray):
        """Odometry mode: the frame's global 4x4 pose. Relocalization
        mode: (initial pose, refined pose, code distances to every
        keyframe)."""
        if self._mode == "odometry":
            return self._odometry_call(image)
        if self._mode == "relocalization":
            return self._relocalize(image)
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
        """Finish odometry -> train the map -> embed the keyframes ->
        relocalization mode (ref: neural_slam.py:141-177)."""
        if self._mode != "odometry":
            log("Current state is not odometry")
            return
        if len(self.keyframes) == 0:
            log("There is no explored environment yet!")
            return
        self.keyframes.save()
        log("Odometry ended, starting mapping process...")
        self._mode = "mapping"
        self._create_map()
        self.keyframes.set_embeddings(embed_keyframes(self.mapping_model, self.keyframes, self.device))
        self.keyframes.save()
        log("Mapping finished, changing to relocalization mode.")
        self._mode = "relocalization"

    def _create_map(self) -> None:
        images = np.stack([self.keyframes.read_rgb(i) for i in range(len(self.keyframes))])
        # the map is saved after every epoch, as the reference saves its
        # weights (neural_slam.py:347-348), and once more at the end
        train_mapping(
            self.mapping_model, self.config.mapping_train, images,
            save_fn=lambda m: save_map(m, self.config.keyframes_path),
        )
        save_map(self.mapping_model, self.config.keyframes_path)

    def _keyframe_fmap(self, idx: int, im: torch.Tensor) -> torch.Tensor:
        """The flow feature map of keyframe ``idx``, kept in an LRU of
        ``KEYFRAME_FMAP_CACHE`` entries on the device."""
        fmap = self._kf_fmap_cache.get(idx)
        if fmap is not None:
            self._kf_fmap_cache.move_to_end(idx)
            return fmap
        fmap = self._fnet(im)
        self._kf_fmap_cache[idx] = fmap
        while len(self._kf_fmap_cache) > KEYFRAME_FMAP_CACHE:
            self._kf_fmap_cache.popitem(last=False)
        return fmap

    def _relocalize(self, image: np.ndarray):
        """Query -> (initial pose, refined pose, distances)
        (ref: neural_slam.py:355-399): the nearest keyframe by code
        distance gives the initial pose; one flow + odometry step from
        that keyframe to the query, with a fresh LSTM carry and the
        keyframe's cached feature map, refines it."""
        im = self._prepare(image)
        with torch.inference_mode():
            code = self.mapping_model.get_code(im[None]).cpu().numpy()
        idx, distances = self.keyframes.nearest(code)
        initial = self.keyframes.poses[idx].copy()
        key_rgb = self._prepare(self.keyframes.read_rgb(idx))
        carry = self.odometry_model.init_carry(1)
        mat, _flow, _low, _carry, _fmap = self._odometry_step(
            key_rgb, im, carry, self._keyframe_fmap(idx, key_rgb)
        )
        refined = initial @ mat.double().cpu().numpy()
        return initial, refined, distances

    def refine_trajectory(self, *args, **kwargs):
        raise NotImplementedError("the pose-graph backend is not ported yet (ROADMAP M10)")

    def close_loops(self, *args, **kwargs):
        raise NotImplementedError("loop closure is not ported yet (ROADMAP M10)")


def _to_uint8(im: torch.Tensor) -> np.ndarray:
    """The keyframe copy of a prepared frame (values in [0, 255],
    truncated like numpy's cast)."""
    return im.to(torch.uint8).cpu().numpy()
