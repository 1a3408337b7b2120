"""fp16 optical-flow cache (the port's copy of
``atdn_vslam_tpu/data/flow_cache.py``: numpy only, the same formats).

The reference trains odometry from *precomputed* GMA flows stored as
one torch ``.pt`` file per frame pair under ``dataset/flows2/<seq>/``
(ref: odometry/datasets.py:42-44,113-118); the precompute tool itself
was never shipped (gitignored — SURVEY.md 2.14). This module defines
our cache format and readers:

  * native format: ONE memory-mapped ``.npy`` per sequence with shape
    (N, H, W, 2) float16, NHWC — a single sequential file instead of
    thousands of tiny files, mmap-friendly for random window reads;
  * compatibility reader for the reference's per-frame ``.pt`` layout
    (read on the CPU);
  * ``write_flow_cache`` and ``FlowCacheWriter`` write the native
    format.

Width handling matches the reference: cached flows wider than 1232 are
center-cropped (ref: odometry/datasets.py:120-123).
"""

from __future__ import annotations

import glob
import os

import numpy as np

TARGET_WIDTH = 1232


def _center_crop_width(flow: np.ndarray, width: int = TARGET_WIDTH) -> np.ndarray:
    if flow.shape[-2] > width:  # NHWC: axis -2 is W
        diff = flow.shape[-2] - width
        flow = flow[..., diff // 2 : flow.shape[-2] - (diff - diff // 2), :]
    return flow


class FlowCache:
    """Random access to a sequence's cached flows as (H, W, 2) float arrays."""

    def __init__(self, path: str, sequence: str):
        self.sequence = sequence
        native = os.path.join(path, "flows2", sequence + ".npy")
        legacy_dir = os.path.join(path, "flows2", sequence)
        if os.path.exists(native):
            self._mode = "native"
            self._data = np.load(native, mmap_mode="r")
            if self._data.ndim != 4 or self._data.shape[-1] != 2:
                raise ValueError(
                    f"Flow cache {native} must be (N, H, W, 2), got "
                    f"{self._data.shape}"
                )
        elif os.path.isdir(legacy_dir):
            self._mode = "legacy"
            self._files = sorted(glob.glob(os.path.join(legacy_dir, "*.pt")))
            if not self._files:
                self._files = sorted(
                    glob.glob(os.path.join(legacy_dir, "*.npy"))
                )
            if not self._files:
                raise FileNotFoundError(
                    f"No flow files in legacy cache dir {legacy_dir}"
                )
        else:
            raise FileNotFoundError(
                f"No flow cache for sequence {sequence} under {path} "
                f"(looked for {native} and {legacy_dir}/)"
            )

    def __len__(self) -> int:
        if self._mode == "native":
            return self._data.shape[0]
        return len(self._files)

    def read(self, start: int, count: int) -> np.ndarray:
        """Read ``count`` consecutive flows -> (count, H, W, 2) float32."""
        if self._mode == "native":
            out = np.asarray(self._data[start : start + count], np.float32)
        else:
            out = np.stack(
                [self._read_legacy(i) for i in range(start, start + count)]
            )
        return _center_crop_width(out)

    def _read_legacy(self, index: int) -> np.ndarray:
        file = self._files[index]
        if file.endswith(".pt"):
            import torch

            arr = torch.load(file, map_location="cpu").float().numpy()
        else:
            arr = np.asarray(np.load(file), np.float32)
        arr = np.squeeze(arr)
        if arr.shape[0] == 2:  # reference stores CHW; we use HWC
            arr = np.transpose(arr, (1, 2, 0))
        return arr.astype(np.float32)


def write_flow_cache(
    path: str, sequence: str, flows: np.ndarray
) -> str:
    """Write a (N, H, W, 2) array as the native fp16 cache file."""
    os.makedirs(os.path.join(path, "flows2"), exist_ok=True)
    out = os.path.join(path, "flows2", sequence + ".npy")
    np.save(out, np.asarray(flows, np.float16))
    return out


class FlowCacheWriter:
    """Incremental writer: appends (H, W, 2) flow frames, then finalizes
    into the native cache layout via np.lib.format open_memmap."""

    def __init__(self, path: str, sequence: str, n: int, h: int, w: int):
        os.makedirs(os.path.join(path, "flows2"), exist_ok=True)
        self.out_path = os.path.join(path, "flows2", sequence + ".npy")
        self._mm = np.lib.format.open_memmap(
            self.out_path, mode="w+", dtype=np.float16, shape=(n, h, w, 2)
        )
        self._i = 0

    def append(self, flow: np.ndarray):
        self._mm[self._i] = np.asarray(flow, np.float16)
        self._i += 1

    def close(self):
        self._mm.flush()
        del self._mm
