"""KITTI odometry datasets and host-side batching (the port's copy of
``atdn_vslam_tpu/data/kitti.py``: numpy only; ``cv2`` is imported only
by ``KittiSequence.read_image``).

Re-design of the reference data layer (ref: atdn_vslam/odometry/
datasets.py:12-226):

  * ``KittiSequence`` — one sequence's poses + image paths
    (ref KittiOdometryDataset, datasets.py:12-39);
  * ``FlowWindowDataset`` — windows of N cached flows + N delta poses
    over multiple concatenated sequences, with the reference's
    50%-probability reverse-time augmentation (negate flow, flip the
    window, reverse poses — datasets.py:90,106-128). Delta poses are
    precomputed *vectorized* per sequence at init (the reference
    recomputes abs2rel per item, datasets.py:108);
  * ``BatchLoader`` — shuffled, drop-last host batching with optional
    background prefetch (replaces torch DataLoader,
    train_odometry.py:78-85).

Directory layout (same as the reference, datasets.py:23-24,74,113):
  <data_path>/dataset/poses/<seq>.txt
  <data_path>/dataset/sequences/<seq>/image_2/*.png
  <data_path>/dataset/flows2/<seq>.npy  (native cache; see flow_cache)
"""

from __future__ import annotations

import glob
import os
import queue
import threading

import numpy as np

from atdn_vslam_torch.data.flow_cache import FlowCache


def load_poses(data_path: str, sequence: str) -> np.ndarray:
    """Load a KITTI poses file -> (N, 12) float64."""
    path = os.path.join(data_path, "dataset", "poses", sequence + ".txt")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Sequence {sequence} doesn't exist: {path}")
    return np.loadtxt(path, dtype=np.float64)


def _lines_to_matrices(lines: np.ndarray) -> np.ndarray:
    n = lines.shape[0]
    mats = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    mats[:, :3, :] = lines.reshape(n, 3, 4)
    return mats


def _matrices_to_euler_yxz(R: np.ndarray) -> np.ndarray:
    """Batched yxz euler extraction (float64 host path; semantics match
    geometry.se3.matrix_to_euler / ref transforms.py:41-44)."""
    alpha = np.arctan2(R[..., 0, 2], R[..., 2, 2])
    beta = np.arctan2(
        -R[..., 1, 2], np.sqrt(np.clip(1.0 - R[..., 1, 2] ** 2, 0.0, None))
    )
    gamma = np.arctan2(R[..., 1, 0], R[..., 1, 1])
    return np.stack([alpha, beta, gamma], axis=-1)


def relative_poses_np(lines: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 12) absolute KITTI lines -> ((N-1, 3) euler, (N-1, 3) tr)
    relative steps, in float64 (host-precision version of
    geometry.absolute_to_relative; ref datasets.py:108 / transforms
    abs2rel)."""
    mats = _lines_to_matrices(lines)
    R = mats[:, :3, :3]
    t = mats[:, :3, 3]
    Rt = np.swapaxes(R[:-1], -1, -2)
    delta_R = Rt @ R[1:]
    delta_t = (Rt @ (t[1:] - t[:-1])[..., None])[..., 0]
    return _matrices_to_euler_yxz(delta_R), delta_t


class KittiSequence:
    """One KITTI odometry sequence: poses, image files, flow cache."""

    def __init__(self, data_path: str, sequence: str, need_flows: bool = True):
        self.sequence = sequence
        self.data_path = data_path
        self.poses = load_poses(data_path, sequence)
        im_dir = os.path.join(
            data_path, "dataset", "sequences", sequence, "image_2"
        )
        self.image_files = sorted(glob.glob(os.path.join(im_dir, "*.png")))
        self.flows: FlowCache | None = None
        if need_flows:
            self.flows = FlowCache(
                os.path.join(data_path, "dataset"), sequence
            )

    def __len__(self) -> int:
        return len(self.poses)

    def read_image(self, index: int) -> np.ndarray:
        """RGB uint8 (H, W, 3)."""
        import cv2

        bgr = cv2.imread(self.image_files[index], cv2.IMREAD_COLOR)
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


class FlowWindowDataset:
    """Windows of ``sequence_length`` flows + delta poses over multiple
    sequences (ref FlowKittiDataset2/3, datasets.py:42-226).

    ``augment`` semantics match the reference (datasets.py:56-59,90):
    True -> reverse each window with p=0.5; False -> never reverse;
    a float a is the reference's offset form: reverse iff a + U[0,1) < 0.5
    (so a=1 forward always, a=-1 backward always — used by eval,
    evaluate_odometry.py:50-58).
    """

    def __init__(
        self,
        data_path: str,
        sequences: list[str],
        augment: bool | float = False,
        sequence_length: int = 4,
        seed: int = 0,
    ):
        if not isinstance(sequences, (list, tuple)):
            raise TypeError("sequences must be a list of strings")
        self.N = sequence_length
        if isinstance(augment, bool):
            self.augment_offset = 0.0 if augment else 1.0
        else:
            self.augment_offset = float(augment)
        self._rng = np.random.default_rng(seed)

        self.sequences = []
        self.rel_rot: list[np.ndarray] = []
        self.rel_tr: list[np.ndarray] = []
        self.offsets = [0]
        for seq in sequences:
            ks = KittiSequence(data_path, seq, need_flows=True)
            n_windows = len(ks.flows) - self.N + 1
            if n_windows <= 0:
                raise ValueError(
                    f"Sequence {seq} too short for window {self.N}"
                )
            rot, tr = relative_poses_np(ks.poses)
            self.sequences.append(ks)
            self.rel_rot.append(rot.astype(np.float32))
            self.rel_tr.append(tr.astype(np.float32))
            self.offsets.append(self.offsets[-1] + n_windows)

    def __len__(self) -> int:
        return self.offsets[-1]

    def _locate(self, index: int) -> tuple[int, int]:
        seq_idx = int(np.searchsorted(self.offsets, index, "right") - 1)
        return seq_idx, index - self.offsets[seq_idx]

    def __getitem__(self, index: int):
        """-> (flows (N, H, W, 2) f32, rot (N, 3) f32, tr (N, 3) f32)."""
        seq_idx, local = self._locate(index)
        reverse = (self.augment_offset + self._rng.random()) < 0.5

        flows = self.sequences[seq_idx].flows.read(local, self.N)
        if reverse:
            # reversed-time window: poses of frames local+N .. local,
            # flows negated and time-flipped (ref datasets.py:106-128)
            lines = self.sequences[seq_idx].poses[
                local : local + self.N + 1
            ][::-1]
            rot, tr = relative_poses_np(np.ascontiguousarray(lines))
            rot, tr = rot.astype(np.float32), tr.astype(np.float32)
            flows = -flows[::-1] if self.N > 1 else -flows
        else:
            rot = self.rel_rot[seq_idx][local : local + self.N]
            tr = self.rel_tr[seq_idx][local : local + self.N]
        return np.ascontiguousarray(flows), rot, tr


class BatchLoader:
    """Shuffled drop-last batching over an indexable dataset with an
    optional background prefetch thread (host-side; the train loop moves
    each batch to the device)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in idx]
            yield tuple(np.stack(cols) for cols in zip(*items))

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as e:  # propagate to the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error:
            raise error[0]
