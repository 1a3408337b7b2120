"""The correlation pyramid with its small levels stored queries-innermost,
and the window lookup over it (``RAFTGMA(corr_nlanes=True)``).

Counterpart of ``atdn_vslam_tpu/ops/corr_lookup_nlanes.py``. Level 0
keeps the port's (B, N, H0, W0) layout and its lookup (kernel K2);
levels 1-3 are stored (B, Hl, Wl, N) and looked up by kernel K2n
(``csrc/corr_lookup_nlanes.cu``), which replaces the TPU kernel
``nlanes_lookup_level`` and follows its rounding: the hat weights and
the row sums are rounded through the volume's type (bf16 on the GPU),
where K2 lerps in float32. Windows are flattened dx-major per level,
like K2's (the JAX package flattens dy-major). K2n launches only
through its custom op ``atdn::corr_lookup_nlanes``.
"""

from __future__ import annotations

import torch

from atdn_vslam_torch.ops import _kernels
from atdn_vslam_torch.ops.corr_lookup import build_corr_pyramid, lookup_corr_pyramid, pool_features


def build_corr_pyramid_nlanes(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, dtype: torch.dtype | None = None
) -> list[torch.Tensor]:
    """Level 0 as :func:`build_corr_pyramid` gives it, (B, N, H0, W0);
    levels l >= 1 as (B, Hl, Wl, N), the ``bnc,bhwc->bhwn`` product
    against the 2^l-pooled features. Every level is one plain matrix
    product in the features' type with f1 scaled by 1/sqrt(C) first
    (exact for C = 256), stored in ``dtype`` (default: the features'
    type).

    :param fmap1: (B, H1, W1, C); fmap2: (B, H2, W2, C).
    """
    b, h1, w1, c = fmap1.shape
    dtype = dtype or fmap1.dtype
    f1 = fmap1.reshape(b, h1 * w1, c) * (1.0 / float(c) ** 0.5)
    pyramid = build_corr_pyramid(fmap1, fmap2, 1, dtype)
    f2l = fmap2
    for _ in range(1, num_levels):
        f2l = pool_features(f2l)
        hl, wl = f2l.shape[1:3]
        corr = torch.matmul(f2l.reshape(b, hl * wl, c).to(f1.dtype), f1.transpose(1, 2))
        pyramid.append(corr.to(dtype).reshape(b, hl, wl, h1 * w1))
    return pyramid


def _round_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t.abs(), min=0.0)


def nlanes_lookup_level_plain(
    vol: torch.Tensor, coords: torch.Tensor, level: int, radius: int = 4
) -> torch.Tensor:
    """Plain PyTorch version of K2n for one level: the (2r+2)^2 taps
    around each centre, contracted over rows then columns with hat
    weights, rounding as the TPU kernel does (module doc).

    :param vol: (B, Hl, Wl, N) level ``level`` of the pyramid.
    :param coords: (B, N, 2) level-0 pixel coords (x, y).
    :return: (B, N, (2r+1)^2) float32, dx-major; NaN for a non-finite
        coordinate, zeros for a level with no rows or columns.
    """
    b, hl, wl, n = vol.shape
    span = 2 * radius + 1
    flat = coords.reshape(b, n, 2).float()
    finite = torch.isfinite(flat).all(dim=-1)
    if hl == 0 or wl == 0:
        out = torch.zeros((b, n, span * span), device=vol.device)
    else:
        flat = torch.where(finite[..., None], flat, torch.zeros_like(flat))
        xc, yc = (flat / 2.0**level).unbind(-1)  # (b, n)
        taps = torch.arange(span + 1, device=vol.device, dtype=torch.float32) - radius
        offs = taps[:-1]  # a - r and c - r
        hs = torch.floor(yc)[..., None] + taps  # (b, n, span+1) rows
        ws = torch.floor(xc)[..., None] + taps  # columns
        ty = (yc[..., None] - hs[..., :-1]) + offs, (yc[..., None] - hs[..., 1:]) + offs
        wy0, wy1 = (_round_like(_hat(t), vol.dtype) for t in ty)
        tx = xc[..., None] + offs
        wx0, wx1 = (_round_like(_hat(tx - w), vol.dtype) for w in (ws[..., :-1], ws[..., 1:]))
        ok = ((hs >= 0) & (hs < hl))[..., :, None] & ((ws >= 0) & (ws < wl))[..., None, :]
        idx = hs.clamp(0, hl - 1).long()[..., :, None] * wl + ws.clamp(0, wl - 1).long()[..., None, :]
        idx = idx.reshape(b, n, -1).transpose(1, 2)  # (b, (span+1)^2, n)
        patch = torch.gather(vol.reshape(b, hl * wl, n), 1, idx).transpose(1, 2)
        patch = patch.reshape(ok.shape).float() * ok  # (b, n, row, col)
        rows = patch[..., :-1, :] * wy0[..., None] + patch[..., 1:, :] * wy1[..., None]
        rows = _round_like(rows, vol.dtype)  # (b, n, a, col)
        win = rows[..., :-1] * wx0[..., None, :] + rows[..., 1:] * wx1[..., None, :]
        out = win.transpose(-1, -2).reshape(b, n, span * span)
    return torch.where(finite[..., None], out, torch.full_like(out, float("nan")))


def nlanes_lookup_levels_plain(
    vols: list[torch.Tensor], coords: torch.Tensor, first_level: int = 1, radius: int = 4
) -> torch.Tensor:
    """Plain PyTorch version of K2n over consecutive levels:
    :func:`nlanes_lookup_level_plain` per level, concatenated."""
    return torch.cat(
        [nlanes_lookup_level_plain(v, coords, first_level + i, radius) for i, v in enumerate(vols)],
        dim=-1,
    )


def nlanes_lookup_levels(
    vols: list[torch.Tensor], coords: torch.Tensor, first_level: int = 1, radius: int = 4
) -> torch.Tensor:
    """K2n: the window lookup over consecutive (B, Hl, Wl, N) levels,
    ``vols[i]`` being level ``first_level + i``.

    On CPU tensors this is :func:`nlanes_lookup_levels_plain`; on CUDA
    tensors it launches the CUDA kernel through
    ``atdn::corr_lookup_nlanes``, once for all levels (bf16 or float32
    volumes, radius 4, at most 4 levels), and counts one launch, or
    raises. The kernel has no backward (the JAX flow net uses it in test
    mode only): under grad mode a CUDA input that requires grad raises.

    :param coords: (B, N, 2) level-0 pixel coords (x, y).
    :return: (B, N, len(vols) * (2r+1)^2) float32, dx-major per level.
    """
    if coords.device.type == "cpu":
        return nlanes_lookup_levels_plain(vols, coords, first_level, radius)
    _kernels.require_cuda("nlanes_lookup_levels", coords)
    _kernels.refuse_autograd("nlanes_lookup_levels (K2n)", coords, *vols)
    return torch.ops.atdn.corr_lookup_nlanes(list(vols), coords, first_level, radius)


nlanes_lookup_levels.launches = 0


def _nlanes_cuda(vols: list[torch.Tensor], coords: torch.Tensor, first_level: int, radius: int) -> torch.Tensor:
    levels = len(vols)
    if not 1 <= levels <= 4 or radius != 4 or not 0 <= first_level <= 26:
        raise ValueError(
            f"the kernel takes 1-4 levels from level 0-26 and radius 4, got {levels} "
            f"from {first_level}, radius {radius}"
        )
    b, n = coords.shape[0], coords.shape[1]
    if coords.shape != (b, n, 2):
        raise ValueError(f"coords {tuple(coords.shape)} must be (B, N, 2)")
    dtype = vols[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nlanes_lookup_levels takes bf16 or float32 volumes, got {dtype}")
    for v in vols:
        if (v.dtype != dtype or v.device != coords.device or v.ndim != 4
                or (v.shape[0], v.shape[3]) != (b, n)):
            raise ValueError(
                f"level {tuple(v.shape)} {v.dtype} on {v.device} does not match coords "
                f"{tuple(coords.shape)} (levels are (B, Hl, Wl, N), one type)"
            )
    vols = [v.contiguous() for v in vols]
    flat = coords.reshape(b * n, 2).float().contiguous()
    span = 2 * radius + 1
    out = torch.empty((b, n, levels * span * span), dtype=torch.float32, device=coords.device)
    ptrs = [v.data_ptr() for v in vols] + [0] * (4 - levels)
    hs = [v.shape[1] for v in vols] + [0] * (4 - levels)
    ws = [v.shape[2] for v in vols] + [0] * (4 - levels)
    status = _kernels.library("corr_lookup_nlanes").atdn_corr_lookup_nlanes(
        *ptrs, flat.data_ptr(), out.data_ptr(), *hs, *ws, b, n, levels, first_level, radius,
        int(dtype == torch.bfloat16), coords.device.index or 0,
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _kernels.check(status, "corr_lookup_nlanes kernel")
    nlanes_lookup_levels.launches += 1
    return out


def _nlanes_fake(vols: list[torch.Tensor], coords: torch.Tensor, first_level: int, radius: int) -> torch.Tensor:
    return coords.new_empty((*coords.shape[:2], len(vols) * (2 * radius + 1) ** 2), dtype=torch.float32)


_kernels.define_op(
    "corr_lookup_nlanes", "(Tensor[] vols, Tensor coords, int first_level, int radius) -> Tensor",
    nlanes_lookup_levels_plain, _nlanes_fake, _nlanes_cuda,
)


def lookup_corr_pyramid_nlanes(
    pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """The window lookup over a :func:`build_corr_pyramid_nlanes`
    pyramid: level 0 through :func:`lookup_corr_pyramid` (K2, one
    launch), levels 1-3 through :func:`nlanes_lookup_levels` (K2n, one
    launch), concatenated per query.

    :param coords: (B, H1, W1, 2) level-0 pixel coords (x, y).
    :return: (B, H1, W1, L * (2r+1)^2) float32, dx-major per level.
    """
    b, h1, w1, _ = coords.shape
    level0 = lookup_corr_pyramid(pyramid[:1], coords, radius)
    if len(pyramid) == 1:
        return level0
    rest = nlanes_lookup_levels(pyramid[1:], coords.reshape(b, h1 * w1, 2), 1, radius)
    return torch.cat([level0, rest.reshape(b, h1, w1, -1)], dim=-1)
