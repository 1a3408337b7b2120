"""Localization (mapping) datasets, the port's numpy copy of
``atdn_vslam_tpu/data/localization.py`` (ref:
atdn_vslam/localization/datasets.py:8-190):

  * ``ColorDataset`` — keyframe RGB from png files or the keyframe
    store's npy dumps, with frame ``division`` subsampling
    (datasets.py:8-57);
  * ``DoubleColorDataset`` — (HLS, RGB) pairs (datasets.py:60-99);
  * ``DepthDataset`` / ``ColorDepthDataset`` — depth-map variants
    (datasets.py:103-190). The latter three are experiment leftovers
    in the reference (unused by main paths); provided for capability
    parity.

All return NHWC float32 numpy arrays.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def _read_rgb(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32)


class ColorDataset:
    """Keyframe RGB dataset with frame subsampling."""

    def __init__(
        self,
        base_path: str,
        use_store: bool = False,
        division: int = 1,
    ):
        if use_store:
            pattern = os.path.join(base_path, "rgb", "*.npy")
        else:
            pattern = os.path.join(base_path, "image_2", "*.png")
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"No images match {pattern}")
        self.files = files[::division]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> np.ndarray:
        return _read_rgb(self.files[index])


class DoubleColorDataset(ColorDataset):
    """(HLS, RGB) image pairs (ref datasets.py:60-99)."""

    def __getitem__(self, index: int):
        import cv2

        rgb = super().__getitem__(index)
        hls = cv2.cvtColor(rgb.astype(np.uint8), cv2.COLOR_RGB2HLS)
        return hls.astype(np.float32), rgb


class DepthDataset:
    """16-bit depth pngs -> metric depth (H, W) float32
    (ref datasets.py:103-136)."""

    def __init__(self, depth_path: str, division: int = 1, scale: float = 256.0):
        files = sorted(glob.glob(os.path.join(depth_path, "*.png")))
        if not files:
            raise FileNotFoundError(f"No depth maps under {depth_path}")
        self.files = files[::division]
        self.scale = scale

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> np.ndarray:
        import cv2

        raw = cv2.imread(self.files[index], cv2.IMREAD_ANYDEPTH)
        if raw is None:
            raise FileNotFoundError(self.files[index])
        return raw.astype(np.float32) / self.scale


class ColorDepthDataset:
    """Paired (RGB, depth) samples (ref datasets.py:139-190)."""

    def __init__(self, color_path: str, depth_path: str, division: int = 1):
        self.color = ColorDataset(color_path, division=division)
        self.depth = DepthDataset(depth_path, division=division)
        if len(self.color) != len(self.depth):
            raise ValueError(
                f"color/depth count mismatch: {len(self.color)} vs "
                f"{len(self.depth)}"
            )

    def __len__(self) -> int:
        return len(self.color)

    def __getitem__(self, index: int):
        return self.color[index], self.depth[index]
