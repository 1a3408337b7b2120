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
refined by one flow + odometry step from that keyframe. Loop closure
finds revisits among the keyframe codes, measures each with the same
step, gates them geometrically and refines the keyframe trajectory with
the pose-graph solve (``geometry/pose_graph.py``).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from atdn_vslam_torch.config import Config
from atdn_vslam_torch.geometry.pose_graph import odometry_edges, optimize_pose_graph
from atdn_vslam_torch.geometry.se3 import matrix_to_euler, pose_to_matrix, se3_inverse
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
from atdn_vslam_torch.utils.helpers import full_float32, log, resolve_device

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

    # -- the pose graph and loop closure ----------------------------------
    #
    # Place recognition is the map's embeddings (a nearest-code search);
    # the relative pose of a candidate pair is measured by the same flow +
    # odometry step as a relocalisation query; the keyframe chain and the
    # accepted closures then go through the pose-graph solve.

    def closure_graph(self, closures: list[tuple[int, int, np.ndarray]], closure_weight: float = 1.0):
        """The keyframe pose graph on the runtime's device, float32:
        (poses (K, 4, 4), edges_i, edges_j, measurements (E, 4, 4),
        weights (E,)). Consecutive keyframes' relative poses are the
        odometry edges (weight 1), each closure ``(i, j, T_ij)`` (T_ij the
        4x4 measured pose of keyframe j in keyframe i's frame) an edge of
        weight ``closure_weight``."""
        n = len(self.keyframes)
        if n < 2:
            raise RuntimeError("trajectory refinement needs >= 2 keyframes")
        if not closures:
            raise ValueError(
                "refine_trajectory needs at least one closure edge: "
                "odometry edges alone are already consistent"
            )
        for i, j, _ in closures:
            # checked on the host: an index past the end would constrain
            # the wrong keyframes (or fail on the device) otherwise
            if not (0 <= i < n and 0 <= j < n):
                raise ValueError(f"closure ({i}, {j}) out of range for {n} keyframes")
        dev = self.device
        with full_float32():
            poses = torch.as_tensor(self.keyframes.poses[:n], dtype=torch.float32, device=dev)
            ei, ej = odometry_edges(n, dev)
            meas = se3_inverse(poses[ei]) @ poses[ej]
        cm = torch.as_tensor(np.stack([c[2] for c in closures]), dtype=torch.float32, device=dev)
        weights = torch.cat([
            torch.ones(n - 1, device=dev), torch.full((len(closures),), float(closure_weight), device=dev)
        ])
        return (
            poses,
            torch.cat([ei, torch.tensor([c[0] for c in closures], device=dev)]),
            torch.cat([ej, torch.tensor([c[1] for c in closures], device=dev)]),
            torch.cat([meas, cm]),
            weights,
        )

    def refine_trajectory(
        self,
        closures: list[tuple[int, int, np.ndarray]],
        iterations: int = 10,
        closure_weight: float = 1.0,
    ) -> tuple[np.ndarray, float]:
        """Pose-graph refinement of the keyframe trajectory: a damped
        Gauss-Newton solve of :meth:`closure_graph` in float32 on the
        runtime's device spreads the closure error along the chain. The
        keyframe poses are updated in place (float64) and saved.

        :return: (optimised (K, 4, 4) poses, final mean squared residual).
        """
        opt, mse = optimize_pose_graph(*self.closure_graph(closures, closure_weight), iterations=iterations)
        opt = opt.double().cpu().numpy()
        self.keyframes.poses[: len(opt)] = opt
        self.keyframes.save()
        return opt, float(mse)

    def detect_closure_pairs(
        self, min_gap: int = 10, max_dist: float | None = None, max_candidates: int = 5
    ) -> list[tuple[int, int, float]]:
        """Embedding-space loop-closure candidates ``(i, j, dist)`` with
        ``j <= i - min_gap`` (revisits of an earlier place).

        :param min_gap: least keyframe-index separation: nearby frames
            always look alike and are chained by odometry edges already.
        :param max_dist: the embedding-distance acceptance threshold;
            ``None`` takes the median distance of consecutive keyframes.
        :param max_candidates: cap, best first; a pair within
            ``min_gap // 2`` of an already selected one on both ends is
            suppressed.
        """
        emb = self.keyframes.embeddings
        if emb is None:
            raise RuntimeError("no embeddings: run end_odometry (mapping) first")
        n = len(self.keyframes)
        emb = emb[:n].reshape(n, -1)
        if n < min_gap + 2:
            return []
        if max_dist is None:
            max_dist = float(np.median(np.linalg.norm(emb[1:] - emb[:-1], axis=1)))

        candidates: list[tuple[int, int, float]] = []
        for i in range(min_gap, n):
            d = np.linalg.norm(emb[: i - min_gap + 1] - emb[i], axis=1)
            j = int(np.argmin(d))
            if d[j] <= max_dist:
                candidates.append((i, j, float(d[j])))
        candidates.sort(key=lambda c: c[2])

        selected: list[tuple[int, int, float]] = []
        for i, j, dist in candidates:
            if any(abs(i - si) <= min_gap // 2 and abs(j - sj) <= min_gap // 2 for si, sj, _ in selected):
                continue
            selected.append((i, j, dist))
            if len(selected) >= max_candidates:
                break
        return selected

    def measure_closure(self, i: int, j: int) -> np.ndarray:
        """Keyframe j's pose in keyframe i's frame, measured by one flow +
        odometry step from i to j with a fresh LSTM carry and keyframe
        i's cached feature map (the relocalisation regime); float64."""
        im_i = self._prepare(self.keyframes.read_rgb(i))
        im_j = self._prepare(self.keyframes.read_rgb(j))
        carry = self.odometry_model.init_carry(1)
        mat, _flow, _low, _carry, _fmap = self._odometry_step(
            im_i, im_j, carry, self._keyframe_fmap(i, im_i)
        )
        return mat.double().cpu().numpy()

    def detect_closures(
        self,
        min_gap: int = 10,
        max_dist: float | None = None,
        max_candidates: int = 5,
        max_translation: float | None = None,
        max_rotation_deg: float | None = None,
    ) -> list[tuple[int, int, np.ndarray]]:
        """Closure edges ``(i, j, T_ij)`` for :meth:`refine_trajectory`,
        T_ij = P_i^-1 P_j as its odometry edges.

        A geometric gate follows the embedding search: a true revisit
        measures a small relative motion, so a candidate whose measured
        translation or rotation exceeds the bound is rejected before a
        false edge can pull the whole trajectory.

        :param max_translation: bound on the measured translation's norm;
            ``None`` takes the keyframe translation threshold, and 0
            turns the test off (as thresholds of 0 register every frame).
        :param max_rotation_deg: bound on the measured rotation's euler
            norm; ``None`` takes the keyframe rotation threshold, 0 off.
        """
        max_tr = self._tr_threshold if max_translation is None else max_translation
        max_rot = self._rot_threshold if max_rotation_deg is None else np.deg2rad(max_rotation_deg)
        edges = []
        for i, j, _ in self.detect_closure_pairs(min_gap, max_dist, max_candidates):
            t = self.measure_closure(i, j)
            if max_tr > 0 and np.linalg.norm(t[:3, 3]) > max_tr:
                log(f"closure ({i}, {j}) rejected: inconsistent translation")
                continue
            if max_rot > 0:
                angle = np.linalg.norm(matrix_to_euler(torch.from_numpy(t[:3, :3])).numpy())
                if angle > max_rot:
                    log(f"closure ({i}, {j}) rejected: inconsistent rotation")
                    continue
            edges.append((i, j, t))
        return edges

    def close_loops(
        self,
        min_gap: int = 10,
        max_dist: float | None = None,
        max_candidates: int = 5,
        iterations: int = 10,
        closure_weight: float = 1.0,
        max_translation: float | None = None,
        max_rotation_deg: float | None = None,
    ) -> tuple[np.ndarray, float] | None:
        """Detect loop closures and refine the trajectory with them.

        :return: (optimised poses, mean squared residual), or None when no
            candidate passes the distance threshold and the geometric
            gate (the poses are then untouched)."""
        closures = self.detect_closures(
            min_gap, max_dist, max_candidates, max_translation, max_rotation_deg
        )
        if not closures:
            return None
        return self.refine_trajectory(closures, iterations=iterations, closure_weight=closure_weight)


def _to_uint8(im: torch.Tensor) -> np.ndarray:
    """The keyframe copy of a prepared frame (values in [0, 255],
    truncated like numpy's cast)."""
    return im.to(torch.uint8).cpu().numpy()
