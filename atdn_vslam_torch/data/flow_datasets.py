"""Flow-training datasets + augmentation: a numpy copy of the JAX
package's ``data/flow_datasets.py`` (OpenCV imported inside the
functions that read, resize or convert images).

Parity with the GMA wheel's training data layer (ref: GMA/core/
datasets.py:18-305 — FlyingChairs/FlyingThings3D/Sintel/KITTI/HD1K and
the C(+T+S+K+H) stage recipes — and GMA/core/utils/augmentor.py:15-246).
A host-side re-design: every dataset yields ``(im1, im2, flow, valid)``
NHWC float32 numpy arrays; ``FlowAugmentor``/``SparseFlowAugmentor``
reproduce the reference augmentation pipeline (asymmetric photometric
jitter, occlusion eraser, scale/stretch, flips, sparse-flow-aware
resampling) with a seedable numpy generator instead of global
``np.random`` state.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from atdn_vslam_torch.data.flow_io import (
    read_flo,
    read_kitti_png_flow,
    read_pfm,
)


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32)


class FlowPairDataset:
    """Base: lists of (im1, im2, flow file) triples."""

    #: sparse GT (KITTI/HD1K png flow) -> SparseFlowAugmentor semantics
    sparse: bool = False

    def __init__(self):
        self.image_pairs: list[tuple[str, str]] = []
        self.flow_files: list[str | None] = []
        #: optional per-dataset augmentor applied in __getitem__ — the
        #: reference attaches aug_params per dataset so mixtures combine
        #: different recipes (ref: datasets.py:18-30,286-291)
        self.augmentor = None
        #: per-pair metadata for submission writers
        #: (ref: datasets.py:34,131 extra_info — sintel (scene, frame),
        #: kitti frame id)
        self.extra_info: list = []

    def __len__(self) -> int:
        return len(self.image_pairs)

    def _read_flow(self, path: str):
        if path.endswith(".flo"):
            return read_flo(path), None
        if path.endswith(".png"):
            return read_kitti_png_flow(path)
        if path.endswith(".pfm"):
            # PFM flow carries a third (disparity-change) channel —
            # dropped, matching the reference
            # (GMA/core/utils/frame_utils.py:131-135)
            return np.asarray(read_pfm(path))[:, :, :2], None
        raise ValueError(f"Unknown flow format: {path}")

    def __getitem__(self, index: int):
        p1, p2 = self.image_pairs[index]
        im1, im2 = _read_rgb(p1), _read_rgb(p2)
        fpath = self.flow_files[index]
        if fpath is None:
            flow = np.zeros((*im1.shape[:2], 2), np.float32)
            valid = np.zeros(im1.shape[:2], np.float32)
        else:
            flow, valid = self._read_flow(fpath)
            if valid is None:
                mag = np.abs(flow).max(-1)
                valid = (mag < 1000).astype(np.float32)
        flow = np.asarray(flow, np.float32)
        if self.augmentor is not None:
            im1, im2, flow, valid = self.augmentor(im1, im2, flow, valid)
        return im1, im2, flow, valid


class FlyingChairsDataset(FlowPairDataset):
    """<root>/data/NNNNN_img{1,2}.ppm + NNNNN_flow.flo
    (ref: datasets.py:166-179). The train/val split file
    (``FlyingChairs_train_val.txt``) is auto-discovered in ``root`` or
    its parent (the reference hardcodes that location); without it the
    split filter CANNOT be applied and every pair is used —
    ``split_applied`` records which happened so callers can refuse to
    mislabel the result (cli/evaluate_flow.validate_chairs)."""

    def __init__(self, root: str, split: str = "training",
                 split_file: str | None = None):
        super().__init__()
        flows = sorted(glob.glob(os.path.join(root, "data", "*_flow.flo")))
        if split_file is None:
            for cand in (
                os.path.join(root, "FlyingChairs_train_val.txt"),
                os.path.join(os.path.dirname(root.rstrip("/")),
                             "FlyingChairs_train_val.txt"),
            ):
                if os.path.exists(cand):
                    split_file = cand
                    break
        labels = None
        if split_file is not None and os.path.exists(split_file):
            labels = np.loadtxt(split_file, dtype=np.int32)
        self.split_applied = labels is not None
        want = 1 if split == "training" else 2
        for f in flows:
            stem = f[: -len("_flow.flo")]
            if labels is not None:
                # look the label up by the pair's NNNNN id, not the
                # glob position — a partial data/ directory would
                # otherwise silently shift every membership after the
                # first gap
                pair_id = int(os.path.basename(stem)) - 1
                if pair_id >= len(labels) or labels[pair_id] != want:
                    continue
            self.image_pairs.append((stem + "_img1.ppm", stem + "_img2.ppm"))
            self.flow_files.append(f)


class FlyingThingsDataset(FlowPairDataset):
    """FlyingThings3D: <root>/<dstype>/TRAIN/<abc>/<seq>/left/*.png +
    <root>/optical_flow/TRAIN/<abc>/<seq>/<direction>/left/*.pfm, both
    time directions over the left camera (ref: datasets.py:182-226).
    into_past pairs are (frame i+1, frame i) with the backward flow."""

    def __init__(self, root: str, split: str = "training",
                 dstype: str = "frames_cleanpass"):
        super().__init__()
        part = "TRAIN" if split == "training" else "TEST"
        for direction in ("into_future", "into_past"):
            image_dirs = sorted(
                glob.glob(os.path.join(root, dstype, part, "*", "*"))
            )
            image_dirs = [os.path.join(d, "left") for d in image_dirs]
            flow_dirs = sorted(
                glob.glob(os.path.join(root, "optical_flow", part, "*", "*"))
            )
            flow_dirs = [
                os.path.join(d, direction, "left") for d in flow_dirs
            ]
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(glob.glob(os.path.join(idir, "*.png")))
                flows = sorted(glob.glob(os.path.join(fdir, "*.pfm")))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        self.image_pairs.append((images[i], images[i + 1]))
                        self.flow_files.append(flows[i])
                    else:
                        self.image_pairs.append((images[i + 1], images[i]))
                        self.flow_files.append(flows[i + 1])


class SintelDataset(FlowPairDataset):
    """<root>/<pass>/<scene>/frame_NNNN.png + flow/<scene>/*.flo
    (ref: datasets.py:137-163)."""

    def __init__(self, root: str, split: str = "training",
                 dstype: str = "clean"):
        super().__init__()
        img_root = os.path.join(root, split, dstype)
        flow_root = os.path.join(root, split, "flow")
        for scene in sorted(os.listdir(img_root)):
            frames = sorted(
                glob.glob(os.path.join(img_root, scene, "*.png"))
            )
            for i in range(len(frames) - 1):
                self.image_pairs.append((frames[i], frames[i + 1]))
                self.extra_info.append((scene, i))
                flow = os.path.join(
                    flow_root, scene,
                    os.path.basename(frames[i]).replace(".png", ".flo"),
                )
                self.flow_files.append(flow if os.path.exists(flow) else None)


class KittiFlowDataset(FlowPairDataset):
    """KITTI 2015 flow: image_2/NNNNNN_1{0,1}.png + flow_occ
    (ref: datasets.py:233-249); sparse GT."""

    sparse = True

    def __init__(self, root: str, split: str = "training"):
        super().__init__()
        base = os.path.join(root, split)
        im1s = sorted(glob.glob(os.path.join(base, "image_2", "*_10.png")))
        for p1 in im1s:
            p2 = p1.replace("_10.png", "_11.png")
            self.image_pairs.append((p1, p2))
            self.extra_info.append(os.path.basename(p1))
            flow = os.path.join(
                base, "flow_occ", os.path.basename(p1)
            )
            self.flow_files.append(flow if os.path.exists(flow) else None)


class HD1KDataset(FlowPairDataset):
    """HD1K: hd1k_input/image_2/SSSSSS_NNNN.png +
    hd1k_flow_gt/flow_occ/SSSSSS_NNNN.png per sequence, consecutive
    pairs (ref: datasets.py:252-269); sparse KITTI-png GT."""

    sparse = True

    def __init__(self, root: str):
        super().__init__()
        seq = 0
        while True:
            flows = sorted(glob.glob(os.path.join(
                root, "hd1k_flow_gt", "flow_occ", f"{seq:06d}_*.png"
            )))
            images = sorted(glob.glob(os.path.join(
                root, "hd1k_input", "image_2", f"{seq:06d}_*.png"
            )))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.image_pairs.append((images[i], images[i + 1]))
                self.flow_files.append(flows[i])
            seq += 1


class MixedFlowDataset:
    """Weighted concatenation of datasets — expresses the reference's
    ``100*sintel_clean + 100*sintel_final + 200*kitti + 5*hd1k + things``
    stage mixtures (ref: datasets.py:291) without materializing the
    repeats: index k maps to (dataset, k % len) through a repeat table."""

    def __init__(self, parts: list[tuple[object, int]]):
        self._parts = []
        self._offsets = [0]
        for ds, repeat in parts:
            if len(ds) == 0:
                # silently dropping a part would train a DIFFERENT
                # mixture than requested (e.g. the 200x-weighted KITTI
                # component of the sintel stage vanishing because of a
                # mistyped root)
                raise ValueError(
                    f"empty dataset in mixture: {type(ds).__name__} — "
                    "check its root path"
                )
            self._parts.append(ds)
            self._offsets.append(self._offsets[-1] + repeat * len(ds))

    def __len__(self) -> int:
        return self._offsets[-1]

    def __getitem__(self, index: int):
        for i, ds in enumerate(self._parts):
            if index < self._offsets[i + 1]:
                return ds[(index - self._offsets[i]) % len(ds)]
        raise IndexError(index)


#: per-stage augmentation scale ranges + mixtures
#: (ref: datasets.py:272-299 fetch_dataloader; the hd1k entry is its
#: per-part recipe inside the sintel-stage mixture, datasets.py:290 —
#: the reference has no standalone hd1k stage)
STAGE_RECIPES = {
    "chairs": dict(min_scale=-0.1, max_scale=1.0, do_flip=True),
    "things": dict(min_scale=-0.4, max_scale=0.8, do_flip=True),
    "sintel": dict(min_scale=-0.2, max_scale=0.6, do_flip=True),
    "kitti": dict(min_scale=-0.2, max_scale=0.4, do_flip=False),
    "hd1k": dict(min_scale=-0.5, max_scale=0.2, do_flip=True),
}


def _attach_aug(ds, crop_size, seed, **recipe):
    if crop_size is None:
        return ds
    cls = SparseFlowAugmentor if ds.sparse else FlowAugmentor
    ds.augmentor = cls(crop_size, seed=seed, **recipe)
    return ds


def fetch_train_dataset(
    stage: str,
    roots: dict[str, str],
    crop_size: tuple[int, int] | None = None,
    seed: int = 0,
):
    """Build the training mixture for a curriculum stage, with
    per-dataset augmentors attached (ref: datasets.py:272-299 —
    the sintel stage mixes sub-datasets with DIFFERENT scale ranges
    and sparse/dense augmentor types). ``roots`` maps dataset name
    ('chairs'/'things'/'sintel'/'kitti'/'hd1k') to its directory; the
    sintel stage uses every root present (C+T+S+K+H when kitti/hd1k
    are given, C+T+S otherwise). ``crop_size=None`` attaches no
    augmentation (raw samples).
    """
    recipe = STAGE_RECIPES[stage]
    if stage == "chairs":
        return _attach_aug(
            FlyingChairsDataset(roots["chairs"]), crop_size, seed, **recipe
        )
    if stage == "things":
        parts = [
            (_attach_aug(
                FlyingThingsDataset(roots["things"], dstype=d),
                crop_size, seed, **recipe), 1)
            for d in ("frames_cleanpass", "frames_finalpass")
        ]
        return MixedFlowDataset(parts)
    if stage == "kitti":
        return _attach_aug(
            KittiFlowDataset(roots["kitti"]), crop_size, seed, **recipe
        )
    if stage == "sintel":
        parts = [
            (_attach_aug(SintelDataset(roots["sintel"], dstype=d),
                         crop_size, seed, **recipe), 100)
            for d in ("clean", "final")
        ]
        if "kitti" in roots:  # ref: datasets.py:289
            parts.append((_attach_aug(
                KittiFlowDataset(roots["kitti"]), crop_size, seed,
                min_scale=-0.3, max_scale=0.5, do_flip=True), 200))
        if "hd1k" in roots:  # ref: datasets.py:290
            parts.append((_attach_aug(
                HD1KDataset(roots["hd1k"]), crop_size, seed,
                **STAGE_RECIPES["hd1k"]), 5))
        if "things" in roots:
            parts.append((_attach_aug(
                FlyingThingsDataset(roots["things"],
                                    dstype="frames_cleanpass"),
                crop_size, seed, **recipe), 1))
        return MixedFlowDataset(parts)
    raise ValueError(f"Unknown stage: {stage!r}")


def _rgb_to_hsv(im: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(im.astype(np.float32) / 255.0, cv2.COLOR_RGB2HSV)


def _hsv_to_rgb(im: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(im, cv2.COLOR_HSV2RGB) * 255.0


class FlowAugmentor:
    """Photometric + spatial augmentation with dense GT
    (ref: augmentor.py:15-121):

      * color jitter (brightness/contrast/saturation/hue), applied
        asymmetrically to the two frames with prob 0.2, else with one
        shared draw (augmentor.py:36-50);
      * occlusion eraser: with prob 0.5, 1-2 random rectangles of
        img2 replaced by its mean color (augmentor.py:52-65);
      * spatial: scale 2^U(min,max) with per-axis stretch
        2^U(-0.2, 0.2) at prob 0.8, floored so the crop fits
        (augmentor.py:67-89); h/v flips with flow sign fixes; random
        crop (augmentor.py:91-107).
    """

    def __init__(
        self,
        crop_size: tuple[int, int],
        min_scale: float = -0.2,
        max_scale: float = 0.5,
        do_flip: bool = True,
        h_flip_prob: float = 0.5,
        v_flip_prob: float = 0.1,
        photometric: bool = True,
        spatial_aug_prob: float = 0.8,
        stretch_prob: float = 0.8,
        max_stretch: float = 0.2,
        asymmetric_color_aug_prob: float = 0.2,
        eraser_aug_prob: float = 0.5,
        brightness: float = 0.4,
        contrast: float = 0.4,
        saturation: float = 0.4,
        hue: float = 0.5 / 3.14,
        seed: int = 0,
    ):
        self.crop = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.photometric = photometric
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.asymmetric_color_aug_prob = asymmetric_color_aug_prob
        self.eraser_aug_prob = eraser_aug_prob
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = np.random.default_rng(seed)

    # -- photometric ------------------------------------------------

    def _jitter_once(self, im: np.ndarray, draws) -> np.ndarray:
        """Apply brightness/contrast/saturation/hue in the drawn random
        ORDER — torchvision ColorJitter permutes the four ops per draw
        (ref: GMA/core/utils/augmentor.py:32 uses ColorJitter), so a
        fixed order would be a small distributional deviation."""
        b, c, s, h, order = draws
        for op in order:
            if op == 0:
                im = im * b
            elif op == 1:
                mean = im.mean(axis=(0, 1), keepdims=True)
                im = (im - mean) * c + mean
            elif op == 2:
                gray = im.mean(axis=-1, keepdims=True)
                im = gray + s * (im - gray)
            elif abs(h) > 1e-8:
                hsv = _rgb_to_hsv(np.clip(im, 0, 255))
                hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
                im = _hsv_to_rgb(hsv)
            im = np.clip(im, 0, 255)
        return im

    def _color_draws(self):
        return (
            self.rng.uniform(1 - self.brightness, 1 + self.brightness),
            self.rng.uniform(1 - self.contrast, 1 + self.contrast),
            self.rng.uniform(1 - self.saturation, 1 + self.saturation),
            self.rng.uniform(-self.hue, self.hue),
            self.rng.permutation(4),
        )

    def color_transform(self, im1, im2):
        if not self.photometric:
            return im1, im2
        if self.rng.random() < self.asymmetric_color_aug_prob:
            im1 = self._jitter_once(im1, self._color_draws())
            im2 = self._jitter_once(im2, self._color_draws())
        else:
            draws = self._color_draws()
            im1 = self._jitter_once(im1, draws)
            im2 = self._jitter_once(im2, draws)
        return im1, im2

    def eraser_transform(self, im1, im2, bounds=(50, 100)):
        ht, wd = im1.shape[:2]
        if self.rng.random() < self.eraser_aug_prob:
            mean_color = im2.reshape(-1, 3).mean(axis=0)
            for _ in range(int(self.rng.integers(1, 3))):
                x0 = int(self.rng.integers(0, wd))
                y0 = int(self.rng.integers(0, ht))
                dx = int(self.rng.integers(bounds[0], bounds[1]))
                dy = int(self.rng.integers(bounds[0], bounds[1]))
                im2 = im2.copy()
                im2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return im1, im2

    # -- spatial ------------------------------------------------------

    def _resize(self, im, fx, fy):
        import cv2

        return cv2.resize(
            im, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR
        )

    def _sample_scales(self, ht, wd, pad=8):
        min_scale = max(
            (self.crop[0] + pad) / float(ht),
            (self.crop[1] + pad) / float(wd),
        )
        scale = 2.0 ** self.rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if self.rng.random() < self.stretch_prob:
            sx *= 2.0 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, min_scale), max(sy, min_scale)

    def spatial_transform(self, im1, im2, flow):
        ht, wd = im1.shape[:2]
        sx, sy = self._sample_scales(ht, wd)
        if self.rng.random() < self.spatial_aug_prob:
            im1 = self._resize(im1, sx, sy)
            im2 = self._resize(im2, sx, sy)
            flow = self._resize(flow, sx, sy)
            flow = flow * np.asarray([sx, sy], np.float32)

        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                im1, im2 = im1[:, ::-1], im2[:, ::-1]
                flow = flow[:, ::-1] * np.asarray([-1.0, 1.0], np.float32)
            if self.rng.random() < self.v_flip_prob:
                im1, im2 = im1[::-1], im2[::-1]
                flow = flow[::-1] * np.asarray([1.0, -1.0], np.float32)

        ch, cw = self.crop
        y0 = int(self.rng.integers(0, im1.shape[0] - ch + 1))
        x0 = int(self.rng.integers(0, im1.shape[1] - cw + 1))
        im1 = im1[y0 : y0 + ch, x0 : x0 + cw]
        im2 = im2[y0 : y0 + ch, x0 : x0 + cw]
        flow = flow[y0 : y0 + ch, x0 : x0 + cw]
        return im1, im2, flow

    def __call__(self, im1, im2, flow, valid=None):
        im1, im2 = self.color_transform(im1, im2)
        im1, im2 = self.eraser_transform(im1, im2)
        im1, im2, flow = self.spatial_transform(im1, im2, flow)
        valid = np.ones(im1.shape[:2], np.float32)
        return (
            np.ascontiguousarray(im1), np.ascontiguousarray(im2),
            np.ascontiguousarray(flow), valid,
        )


class SparseFlowAugmentor(FlowAugmentor):
    """Sparse-GT variant (KITTI/HD1K; ref: augmentor.py:123-246):
    symmetric-only color jitter at reduced amplitude, nearest-pixel
    flow-map resampling that preserves the valid mask, no stretch,
    no v-flip, margin-biased crop placement."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=False, seed: int = 0, **kw):
        kw.setdefault("brightness", 0.3)
        kw.setdefault("contrast", 0.3)
        kw.setdefault("saturation", 0.3)
        kw.setdefault("hue", 0.3 / 3.14)
        kw.setdefault("asymmetric_color_aug_prob", 0.0)
        kw.setdefault("stretch_prob", 0.0)
        super().__init__(
            crop_size, min_scale=min_scale, max_scale=max_scale,
            do_flip=do_flip, seed=seed, **kw,
        )

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Forward-scatter valid flow samples to the resized grid
        (ref: augmentor.py:162-194); bilinear resampling would blur
        valid/invalid boundaries."""
        ht, wd = flow.shape[:2]
        coords = np.stack(
            np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1
        ).reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        valid_flat = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid_flat >= 1]
        flow0 = flow_flat[valid_flat >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.float32)
        flow_img[yy[keep], xx[keep]] = flow1[keep]
        valid_img[yy[keep], xx[keep]] = 1.0
        return flow_img, valid_img

    def spatial_transform_sparse(self, im1, im2, flow, valid):
        ht, wd = im1.shape[:2]
        min_scale = max(
            (self.crop[0] + 1) / float(ht), (self.crop[1] + 1) / float(wd)
        )
        scale = 2.0 ** self.rng.uniform(self.min_scale, self.max_scale)
        sx = sy = max(scale, min_scale)
        if self.rng.random() < self.spatial_aug_prob:
            im1 = self._resize(im1, sx, sy)
            im2 = self._resize(im2, sx, sy)
            flow, valid = self.resize_sparse_flow_map(flow, valid, sx, sy)

        if self.do_flip and self.rng.random() < 0.5:
            im1, im2 = im1[:, ::-1], im2[:, ::-1]
            flow = flow[:, ::-1] * np.asarray([-1.0, 1.0], np.float32)
            valid = valid[:, ::-1]

        # margin-biased crop: KITTI GT concentrates in the lower image
        # (ref: augmentor.py:221-228)
        margin_y, margin_x = 20, 50
        ch, cw = self.crop
        y0 = int(self.rng.integers(0, im1.shape[0] - ch + margin_y))
        x0 = int(self.rng.integers(-margin_x, im1.shape[1] - cw + margin_x))
        y0 = int(np.clip(y0, 0, im1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, im1.shape[1] - cw))
        im1 = im1[y0 : y0 + ch, x0 : x0 + cw]
        im2 = im2[y0 : y0 + ch, x0 : x0 + cw]
        flow = flow[y0 : y0 + ch, x0 : x0 + cw]
        valid = valid[y0 : y0 + ch, x0 : x0 + cw]
        return im1, im2, flow, valid

    def __call__(self, im1, im2, flow, valid):
        im1, im2 = self.color_transform(im1, im2)
        im1, im2 = self.eraser_transform(im1, im2)
        im1, im2, flow, valid = self.spatial_transform_sparse(
            im1, im2, flow, valid
        )
        return (
            np.ascontiguousarray(im1), np.ascontiguousarray(im2),
            np.ascontiguousarray(flow), np.ascontiguousarray(valid),
        )
