"""All-pairs correlation pyramid and the windowed bilinear lookup
(ref: GMA/core/corr.py:15-63).

Kernel K2 (``csrc/corr_lookup.cu``) replaces the TPU kernel
``atdn_vslam_tpu/ops/corr_lookup_pallas.py:lookup_level_pallas`` and
carries the port's per-iteration lookup, all levels in one launch.
Kernel K3 (``csrc/corr_dot.cu``) replaces the TPU kernel
``atdn_vslam_tpu/ops/corr_lookup.py:corr_dot_rowmajor`` and builds the
pyramid's levels when the flow net asks for its kernels
(``use_pallas=True``).

Layouts: level ``l`` of the pyramid is (B, N1, H_l, W_l) (the JAX
package keeps a trailing unit axis); the lookup returns (B, H1, W1,
L * (2r+1)^2) float32 with the window flattened dx-major per level, the
reference CorrBlock's order, so a reference checkpoint's
``update_block.encoder.convc1`` loads without a permutation. The JAX
package flattens dy-major.
"""

from __future__ import annotations

import torch

from atdn_vslam_torch.ops import _kernels


def corr_dot_rowmajor_plain(
    f1: torch.Tensor, f2: torch.Tensor, inv_sqrt_c: float, out_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Plain PyTorch version of K3: ``inv_sqrt_c * f1 @ f2^T`` summed and
    scaled in float32, cast once to ``out_dtype``.

    :param f1: (B, N, C); f2: (B, M, C).
    :return: (B, N, M) row-major volume.
    """
    out = torch.matmul(f1.float(), f2.float().transpose(1, 2)) * inv_sqrt_c
    return out.to(out_dtype)


def corr_dot_rowmajor(
    f1: torch.Tensor, f2: torch.Tensor, inv_sqrt_c: float, out_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """K3: one level of the correlation volume, ``inv_sqrt_c * f1 @
    f2^T`` with the scale applied to the float32 sum and one cast.

    On CPU tensors this is :func:`corr_dot_rowmajor_plain`; on CUDA
    tensors it launches the CUDA kernel (f1 and f2 both bf16 or both
    float32, C a multiple of 8; bf16 or float32 out) and counts one
    launch, or raises.
    """
    if f1.device.type == "cpu":
        return corr_dot_rowmajor_plain(f1, f2, inv_sqrt_c, out_dtype)
    if f1.device.type != "cuda":
        raise RuntimeError(f"corr_dot_rowmajor: no kernel for {f1.device}")
    b, n, c = f1.shape
    m = f2.shape[1]
    if f2.ndim != 3 or f2.shape[0] != b or f2.shape[2] != c or f2.device != f1.device:
        raise ValueError(f"f2 {tuple(f2.shape)} on {f2.device} does not match f1 {tuple(f1.shape)}")
    if f1.dtype not in (torch.bfloat16, torch.float32) or f2.dtype != f1.dtype:
        raise TypeError(f"corr_dot_rowmajor takes bf16 or float32 features, got {f1.dtype}/{f2.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"corr_dot_rowmajor writes bf16 or float32, not {out_dtype}")
    if c % 8 or n < 1 or m < 1:
        raise ValueError(f"channels {c} must be a multiple of 8, rows {n}, {m} at least 1")
    # the level-0 f2 arrives as an NHWC view of an NCHW conv output: copied here
    f1, f2 = _kernels.aligned(f1), _kernels.aligned(f2)
    out = torch.empty((b, n, m), dtype=out_dtype, device=f1.device)
    status = _kernels.library("corr_dot").atdn_corr_dot(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, n, m, c, float(inv_sqrt_c),
        int(f1.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        f1.device.index or 0, torch.cuda.current_stream(f1.device).cuda_stream,
    )
    _kernels.check(status, "corr_dot kernel")
    corr_dot_rowmajor.launches += 1
    return out


corr_dot_rowmajor.launches = 0


def build_corr_pyramid(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    num_levels: int = 4,
    dtype: torch.dtype | None = None,
    use_pallas: bool | None = None,
) -> list[torch.Tensor]:
    """All-pairs correlation at ``num_levels`` scales.

    Correlation is linear in fmap2, so the reference's average pooling
    of the volume equals pooling the *features* first
    (avgpool(f1 . f2^T) == f1 . avgpool(f2)^T): each level is one
    product against the 2^l-pooled feature map, accumulated in float32
    and stored in ``dtype`` (default: the features' type).

    ``use_pallas=True`` builds every level with kernel K3
    (:func:`corr_dot_rowmajor`), which scales the float32 sum by
    1/sqrt(C) before its one cast, as the JAX package's Pallas path
    does. ``None`` and ``False`` take the JAX package's default path, a
    plain matrix product outside any kernel: ``torch.matmul`` in the
    features' type with f1 scaled by 1/sqrt(C) first (exact for C = 256),
    then cast to ``dtype``.

    :param fmap1: (B, H1, W1, C); fmap2: (B, H2, W2, C).
    :return: list of (B, H1*W1, H_l, W_l) volumes, the layout the lookup
        (kernel K2) reads.
    """
    b, h1, w1, c = fmap1.shape
    h2, w2 = fmap2.shape[1:3]
    dtype = dtype or fmap1.dtype
    inv_sqrt_c = 1.0 / float(c) ** 0.5
    f1 = fmap1.reshape(b, h1 * w1, c)
    if not use_pallas:
        f1 = f1 * inv_sqrt_c
    pyramid = []
    f2l, hl, wl = fmap2, h2, w2
    for level in range(num_levels):
        f2 = f2l.reshape(b, hl * wl, c)
        if use_pallas:
            corr = corr_dot_rowmajor(f1, f2, inv_sqrt_c, dtype)
        else:
            corr = torch.matmul(f1, f2.transpose(1, 2).to(f1.dtype)).to(dtype)
        pyramid.append(corr.reshape(b, h1 * w1, hl, wl))
        if level < num_levels - 1:
            h2_, w2_ = hl // 2, wl // 2
            f2l = f2l[:, : h2_ * 2, : w2_ * 2].reshape(b, h2_, 2, w2_, 2, c)
            f2l = f2l.float().mean(dim=(2, 4)).to(fmap2.dtype)
            hl, wl = h2_, w2_
    return pyramid


def lookup_corr_pyramid_plain(
    pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """Plain PyTorch version of K2: gather the (2r+2)^2 tap patch of
    each window and lerp it in float32.

    :param coords: (B, H1, W1, 2) pixel coords (x, y) at level 0.
    :return: (B, H1, W1, L*(2r+1)^2) float32, dx-major per level.
    """
    b, h1, w1, _ = coords.shape
    bn = b * h1 * w1
    span = 2 * radius + 1
    flat = coords.reshape(bn, 2).float()
    finite = torch.isfinite(flat).all(dim=-1)
    flat = torch.where(finite[:, None], flat, torch.zeros_like(flat))
    taps = torch.arange(span + 1, device=coords.device, dtype=torch.float32) - radius
    out = []
    for level, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        c = flat / (2.0**level)
        x0, y0 = torch.floor(c[:, 0]), torch.floor(c[:, 1])
        fx, fy = (c[:, 0] - x0)[:, None, None], (c[:, 1] - y0)[:, None, None]
        xs, ys = x0[:, None] + taps, y0[:, None] + taps  # (bn, span+1)
        ok = ((ys >= 0) & (ys < hl))[:, :, None] & ((xs >= 0) & (xs < wl))[:, None, :]
        if hl * wl == 0:
            patch = torch.zeros(ok.shape, device=coords.device)
        else:
            idx = (
                ys.clamp(0, hl - 1).long()[:, :, None] * wl
                + xs.clamp(0, wl - 1).long()[:, None, :]
            )
            vol = corr.reshape(bn, hl * wl)
            patch = torch.gather(vol, 1, idx.reshape(bn, -1)).reshape(ok.shape).float()
            patch = patch * ok
        top = (1.0 - fx) * patch[:, :, :-1] + fx * patch[:, :, 1:]  # (bn, y, x)
        win = (1.0 - fy) * top[:, :-1] + fy * top[:, 1:]
        out.append(win.transpose(1, 2).reshape(bn, span * span))
    tokens = torch.cat(out, dim=-1)
    tokens = torch.where(finite[:, None], tokens, torch.full_like(tokens, float("nan")))
    return tokens.reshape(b, h1, w1, -1)


def lookup_corr_pyramid(
    pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """K2: the windowed lookup over every level.

    On CPU tensors this is :func:`lookup_corr_pyramid_plain`; on CUDA
    tensors it launches the CUDA kernel once for all levels (bf16 or
    float32 volumes, radius 4, at most 4 levels) and counts one launch,
    or raises.
    """
    if coords.device.type == "cpu":
        return lookup_corr_pyramid_plain(pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise RuntimeError(f"lookup_corr_pyramid: no kernel for {coords.device}")
    b, h1, w1, _ = coords.shape
    n = h1 * w1
    levels = len(pyramid)
    if not 1 <= levels <= 4 or radius != 4:
        raise ValueError(f"the kernel takes 1-4 levels and radius 4, got {levels}, {radius}")
    dtype = pyramid[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lookup_corr_pyramid takes bf16 or float32 volumes, got {dtype}")
    vols = []
    for corr in pyramid:
        if corr.dtype != dtype or corr.device != coords.device or corr.shape[:2] != (b, n):
            raise ValueError(
                f"level {tuple(corr.shape)} {corr.dtype} on {corr.device} does not "
                f"match coords {tuple(coords.shape)}"
            )
        vols.append(corr.contiguous())
    flat = coords.reshape(b * n, 2).float().contiguous()
    span = 2 * radius + 1
    out = torch.empty((b, h1, w1, levels * span * span), dtype=torch.float32, device=coords.device)
    ptrs = [v.data_ptr() for v in vols] + [0] * (4 - levels)
    hs = [v.shape[2] for v in vols] + [0] * (4 - levels)
    ws = [v.shape[3] for v in vols] + [0] * (4 - levels)
    status = _kernels.library("corr_lookup").atdn_corr_lookup(
        *ptrs, flat.data_ptr(), out.data_ptr(), *hs, *ws, b, n, levels, radius,
        int(dtype == torch.bfloat16), coords.device.index or 0,
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _kernels.check(status, "corr_lookup kernel")
    lookup_corr_pyramid.launches += 1
    return out


lookup_corr_pyramid.launches = 0
