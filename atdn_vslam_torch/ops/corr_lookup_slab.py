"""The window lookup over a pyramid whose levels are row-padded once at
build time.

Counterpart of ``atdn_vslam_tpu/ops/corr_lookup_slab.py``. Kernel K2s
(``csrc/corr_lookup_slab.cu``) replaces the TPU kernel
``lookup_corr_pyramid_slab``: the same function as K2 (grid_sample's
zero padding at every level), with the rows contracted before the
columns in float32 and no rounding, all levels in one launch. Levels
are the port's (B, N, Hl, Wl), here with Hl zero-padded by
:func:`pad_pyramid_for_slab`; windows are flattened dx-major per level
(the JAX package flattens dy-major). K2s launches only through its
custom op ``atdn::corr_lookup_slab``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from atdn_vslam_torch.ops import _kernels

_ALIGN = 8   # the TPU's sublane alignment of a dynamic slice start
_SLAB = 24   # aligned rows the TPU kernel loads per query


def _padded_rows(hl: int, span: int) -> int:
    """The rows a level of ``hl`` rows is zero-padded to (the JAX
    package's rule, so that any aligned 24-row slab lies in bounds)."""
    rows = span + 1
    if hl <= _SLAB:
        return hl
    return max(hl, ((hl - rows) // _ALIGN) * _ALIGN + _SLAB)


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t.abs(), min=0.0)


def pad_pyramid_for_slab(
    pyramid: list[torch.Tensor], radius: int = 4
) -> tuple[list[torch.Tensor], tuple[int, ...]]:
    """Zero-pad the rows of each (B, N, Hl, Wl) level to
    :func:`_padded_rows`, once per pyramid.

    :return: (padded levels, the levels' own row counts ``orig_rows``).
    """
    span = 2 * radius + 1
    out, orig = [], []
    for corr in pyramid:
        hl = corr.shape[2]
        hp = _padded_rows(hl, span)
        orig.append(hl)
        out.append(F.pad(corr, (0, 0, 0, hp - hl)) if hp != hl else corr)
    return out, tuple(orig)


def lookup_corr_pyramid_slab_plain(
    pyramid: list[torch.Tensor],
    coords: torch.Tensor,
    radius: int = 4,
    q_blk: int = 16,
    orig_rows: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2s: per window row, the two volume rows
    it lies between weighted by their hat weights, then per window
    column the two columns, in float32.

    :param pyramid: (B, N, Hp, Wl) levels, padded by
        :func:`pad_pyramid_for_slab` with ``orig_rows`` passed on; with
        ``orig_rows=None`` the levels are taken as unpadded and padded
        here, on every call.
    :param coords: (B, H1, W1, 2) level-0 pixel coords (x, y).
    :param q_blk: the TPU kernel's query block; accepted and ignored.
    :return: (B, H1, W1, L * (2r+1)^2) float32, dx-major per level; NaN
        for a non-finite coordinate.
    """
    if orig_rows is None:
        pyramid, orig_rows = pad_pyramid_for_slab(pyramid, radius)
    b, h1, w1, _ = coords.shape
    bn = b * h1 * w1
    span = 2 * radius + 1
    flat = coords.reshape(bn, 2).float()
    finite = torch.isfinite(flat).all(dim=-1)
    flat = torch.where(finite[:, None], flat, torch.zeros_like(flat))
    taps = torch.arange(span + 1, device=coords.device, dtype=torch.float32) - radius
    window = torch.arange(span, device=coords.device, dtype=torch.float32)
    out = []
    for level, corr in enumerate(pyramid):
        hp, wl = corr.shape[-2:]
        xc, yc = (flat / 2.0**level).unbind(-1)
        hs = torch.floor(yc)[:, None] + taps  # (bn, span+1)
        ws = torch.floor(xc)[:, None] + taps
        ty = (yc[:, None] - radius) + window  # window row a at y - r + a
        wy0, wy1 = _hat(ty - hs[:, :-1]), _hat(ty - hs[:, 1:])
        tx = xc[:, None] + (window - radius)  # window column c at x + c - r
        wx0, wx1 = _hat(tx - ws[:, :-1]), _hat(tx - ws[:, 1:])
        ok = ((hs >= 0) & (hs < hp))[:, :, None] & ((ws >= 0) & (ws < wl))[:, None, :]
        if hp * wl == 0:
            patch = torch.zeros(ok.shape, device=coords.device)
        else:
            idx = hs.clamp(0, hp - 1).long()[:, :, None] * wl + ws.clamp(0, wl - 1).long()[:, None, :]
            vol = corr.reshape(bn, hp * wl)
            patch = torch.gather(vol, 1, idx.reshape(bn, -1)).reshape(ok.shape).float() * ok
        rows = wy0[:, :, None] * patch[:, :-1] + wy1[:, :, None] * patch[:, 1:]  # (bn, a, col)
        win = rows[:, :, :-1] * wx0[:, None] + rows[:, :, 1:] * wx1[:, None]  # (bn, a, c)
        out.append(win.transpose(1, 2).reshape(bn, span * span))
    tokens = torch.cat(out, dim=-1)
    tokens = torch.where(finite[:, None], tokens, torch.full_like(tokens, float("nan")))
    return tokens.reshape(b, h1, w1, -1)


def lookup_corr_pyramid_slab(
    pyramid: list[torch.Tensor],
    coords: torch.Tensor,
    radius: int = 4,
    q_blk: int = 16,
    orig_rows: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """K2s: the windowed lookup over every level of a row-padded pyramid
    (:func:`lookup_corr_pyramid_slab_plain` gives the contract).

    On CPU tensors this is the plain version; on CUDA tensors it
    launches the CUDA kernel through ``atdn::corr_lookup_slab``, once
    for all levels (bf16 or float32 volumes, radius 4, at most 4
    levels), and counts one launch, or raises; the kernel has no
    backward, so under grad mode a CUDA input that requires grad raises.
    ``q_blk`` is a TPU tiling parameter: accepted and ignored.
    """
    if coords.device.type == "cpu":
        return lookup_corr_pyramid_slab_plain(pyramid, coords, radius, q_blk, orig_rows)
    _kernels.require_cuda("lookup_corr_pyramid_slab", coords)
    _kernels.refuse_autograd("lookup_corr_pyramid_slab (K2s)", coords, *pyramid)
    if orig_rows is None:
        pyramid, orig_rows = pad_pyramid_for_slab(pyramid, radius)
    return torch.ops.atdn.corr_lookup_slab(list(pyramid), coords, radius, list(orig_rows))


lookup_corr_pyramid_slab.launches = 0


def _slab_plain(pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int, orig_rows: list[int]) -> torch.Tensor:
    return lookup_corr_pyramid_slab_plain(pyramid, coords, radius, orig_rows=tuple(orig_rows))


def _slab_fake(pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int, orig_rows: list[int]) -> torch.Tensor:
    return coords.new_empty((*coords.shape[:3], len(pyramid) * (2 * radius + 1) ** 2), dtype=torch.float32)


def _slab_cuda(pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int, orig_rows: list[int]) -> torch.Tensor:
    b, h1, w1, _ = coords.shape
    n = h1 * w1
    levels = len(pyramid)
    if not 1 <= levels <= 4 or radius != 4 or len(orig_rows) != levels:
        raise ValueError(
            f"the kernel takes 1-4 levels, one row count each, and radius 4; got "
            f"{levels} levels, {len(orig_rows)} row counts, radius {radius}"
        )
    span = 2 * radius + 1
    dtype = pyramid[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lookup_corr_pyramid_slab takes bf16 or float32 volumes, got {dtype}")
    vols = []
    for corr, hl in zip(pyramid, orig_rows):
        if (corr.dtype != dtype or corr.device != coords.device or corr.ndim != 4
                or corr.shape[:2] != (b, n)):
            raise ValueError(
                f"level {tuple(corr.shape)} {corr.dtype} on {corr.device} does not match "
                f"coords {tuple(coords.shape)}"
            )
        if corr.shape[2] not in (hl, _padded_rows(hl, span)):
            raise ValueError(f"a level of {hl} rows is stored unpadded or padded to "
                             f"{_padded_rows(hl, span)} rows, not {corr.shape[2]}")
        vols.append(corr.contiguous())
    flat = coords.reshape(b * n, 2).float().contiguous()
    out = torch.empty((b, h1, w1, levels * span * span), dtype=torch.float32, device=coords.device)
    ptrs = [v.data_ptr() for v in vols] + [0] * (4 - levels)
    hs = [v.shape[2] for v in vols] + [0] * (4 - levels)
    ws = [v.shape[3] for v in vols] + [0] * (4 - levels)
    status = _kernels.library("corr_lookup_slab").atdn_corr_lookup_slab(
        *ptrs, flat.data_ptr(), out.data_ptr(), *hs, *ws, b, n, levels, radius,
        int(dtype == torch.bfloat16), coords.device.index or 0,
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _kernels.check(status, "corr_lookup_slab kernel")
    lookup_corr_pyramid_slab.launches += 1
    return out


_kernels.define_op(
    "corr_lookup_slab", "(Tensor[] pyramid, Tensor coords, int radius, int[] orig_rows) -> Tensor",
    _slab_plain, _slab_fake, _slab_cuda,
)
