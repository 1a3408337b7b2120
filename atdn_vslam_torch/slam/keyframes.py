"""Array-backed keyframe store: poses in one float64 array, RGB frames
as ``.npy`` files under ``<base>/rgb`` (written on a background thread)
and optional embeddings; the port's own copy of
``atdn_vslam_tpu/slam/keyframes.py`` without the sharded search.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np


class KeyframeStore:
    """:param async_writes: spill keyframe RGB to disk on a background
    thread (at most ``max_pending`` outstanding writes) so the hot loop
    does not wait on file IO. Reads and ``save()`` drain pending writes
    first; worker errors re-raise on the caller's thread."""

    def __init__(self, base_path: str, capacity: int = 4096,
                 async_writes: bool = True, max_pending: int = 8):
        self.base_path = base_path
        self.rgb_dir = os.path.join(base_path, "rgb")
        self.capacity = capacity
        self.count = 0
        self.poses = np.zeros((capacity, 4, 4), np.float64)
        self.embeddings: np.ndarray | None = None
        self._pool = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="kf-io")
            if async_writes else None
        )
        self._pending: list[Future] = []
        self._max_pending = max_pending

    def _drain(self) -> None:
        try:
            for f in self._pending:
                f.result()
        finally:
            self._pending.clear()

    def flush(self) -> None:
        """Wait for pending writes and surface their errors."""
        self._drain()

    def __del__(self):
        try:
            self._drain()
        except Exception:
            pass

    def initialize_cold(self) -> None:
        """Create or wipe the on-disk store."""
        self._drain()
        os.makedirs(self.rgb_dir, exist_ok=True)
        for f in glob.glob(os.path.join(self.rgb_dir, "*.npy")):
            os.remove(f)
        for name in ("poses.npy", "embeddings.npy"):
            p = os.path.join(self.base_path, name)
            if os.path.exists(p):
                os.remove(p)
        self.count = 0
        self.embeddings = None

    def load(self, with_embeddings: bool = False) -> None:
        poses = np.load(os.path.join(self.base_path, "poses.npy"))
        n = len(poses)
        if n > self.capacity:
            self.capacity = n
            self.poses = np.zeros((self.capacity, 4, 4), np.float64)
        self.poses[:n] = poses
        self.count = n
        if with_embeddings:
            self.embeddings = np.load(os.path.join(self.base_path, "embeddings.npy"))

    def save(self) -> None:
        self._drain()
        np.save(os.path.join(self.base_path, "poses.npy"), self.poses[: self.count])
        if self.embeddings is not None:
            np.save(
                os.path.join(self.base_path, "embeddings.npy"),
                self.embeddings[: self.count],
            )

    def rgb_path(self, index: int) -> str:
        return os.path.join(self.rgb_dir, f"{index:06d}.npy")

    def append(self, rgb: np.ndarray, pose: np.ndarray) -> int:
        """Register a keyframe: RGB (H, W, 3) uint8 to disk, the pose to
        the array."""
        if self.count >= self.capacity:
            grown = np.zeros((self.capacity * 2, 4, 4), np.float64)
            grown[: self.count] = self.poses[: self.count]
            self.poses = grown
            self.capacity *= 2
        idx = self.count
        os.makedirs(self.rgb_dir, exist_ok=True)
        if self._pool is not None:
            # copy: the write may run several appends later, and a
            # reused caller buffer would be saved with the wrong frame
            rgb = np.array(rgb, np.uint8, copy=True)
            if len(self._pending) >= self._max_pending:
                self._pending.pop(0).result()
            self._pending.append(self._pool.submit(np.save, self.rgb_path(idx), rgb))
        else:
            np.save(self.rgb_path(idx), np.asarray(rgb, np.uint8))
        self.poses[idx] = pose
        self.count += 1
        return idx

    def read_rgb(self, index: int) -> np.ndarray:
        self._drain()
        return np.load(self.rgb_path(index))

    def set_embeddings(self, embeddings: np.ndarray) -> None:
        if len(embeddings) != self.count:
            raise ValueError(f"{len(embeddings)} embeddings for {self.count} keyframes")
        self.embeddings = np.asarray(embeddings)

    def nearest(self, code: np.ndarray) -> tuple[int, np.ndarray]:
        """Nearest keyframe by L2 embedding distance: (index, distances)."""
        if self.embeddings is None:
            raise RuntimeError("Store has no embeddings; run mapping first")
        emb = self.embeddings[: self.count].reshape(self.count, -1)
        d = np.linalg.norm(emb - code.reshape(1, -1), axis=1)
        return int(np.argmin(d)), d

    def __len__(self) -> int:
        return self.count
