"""Optical-flow file IO + visualization (the port's copy of
``atdn_vslam_tpu/data/flow_io.py``; ``cv2`` and ``scipy`` are imported
only inside the functions that need them).

Parity with the GMA wheel's IO helpers (ref: GMA/core/utils/
frame_utils.py:12-102 — .flo / PFM / KITTI-png formats — and
GMA/core/utils/flow_viz.py:20-109 — flow -> RGB wheel coloring).
All NHWC float32; flows are (H, W, 2) in (u, v) = (x, y) order.
"""

from __future__ import annotations

import re

import numpy as np

_FLO_MAGIC = 202021.25  # standard Middlebury sanity tag


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo reader (ref: frame_utils.py:12-32)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> str:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)
    return path


def read_pfm(path: str) -> np.ndarray:
    """PFM reader (ref: frame_utils.py:33-69)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape))


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> str:
    image = np.flipud(np.asarray(image, np.float32))
    color = image.ndim == 3 and image.shape[2] == 3
    if not color and image.ndim not in (2, 3):
        raise ValueError("PFM supports (H, W) or (H, W, 3)")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)
    return path


def read_kitti_png_flow(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit png flow: (flow (H, W, 2), valid (H, W))
    (ref: frame_utils.py:70-79)."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise FileNotFoundError(path)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR -> RGB channel order
    flow = (raw[:, :, :2] - 2**15) / 64.0
    valid = raw[:, :, 2]
    return flow, valid


def write_kitti_png_flow(path: str, flow: np.ndarray, valid=None) -> str:
    import cv2

    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3), np.uint16)
    out[:, :, :2] = np.clip(
        np.asarray(flow) * 64.0 + 2**15, 0, 2**16 - 1
    ).astype(np.uint16)
    out[:, :, 2] = 1 if valid is None else np.asarray(valid, np.uint16)
    cv2.imwrite(path, out[:, :, ::-1])
    return path


# ---------------------------------------------------------------------
# Flow -> RGB visualization (color wheel, ref: flow_viz.py:20-109)
# ---------------------------------------------------------------------

def _color_wheel() -> np.ndarray:
    """55-color Middlebury wheel (ref: flow_viz.py:20-67)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_to_rgb(flow: np.ndarray, clip: float | None = None) -> np.ndarray:
    """Flow field -> RGB uint8 visualization (ref: flow_viz.py:70-109)."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0], flow[..., 1]
    if clip is not None:
        u = np.clip(u, -clip, clip)
        v = np.clip(v, -clip, clip)
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    wheel = _color_wheel()
    ncols = len(wheel)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*flow.shape[:-1], 3), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)
        img[..., c] = np.floor(255 * col)
    return img


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Warm-start flow propagation: scatter each pixel's flow to where
    it lands in the next frame, filling holes by nearest-neighbor
    (ref: GMA/core/utils/utils.py:33-57; used by the Sintel submission
    warm start, GMA/evaluate.py:39-40).

    :param flow: (H, W, 2) low-res flow of the previous pair.
    :return: (H, W, 2) initialization for the next pair.
    """
    from scipy import interpolate

    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf, dyf = dx.reshape(-1), dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    if valid.sum() == 0:
        return np.zeros_like(flow)
    flow_x = interpolate.griddata(
        (x1[valid], y1[valid]), dxf[valid], (x0, y0),
        method="nearest", fill_value=0,
    )
    flow_y = interpolate.griddata(
        (x1[valid], y1[valid]), dyf[valid], (x0, y0),
        method="nearest", fill_value=0,
    )
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)
