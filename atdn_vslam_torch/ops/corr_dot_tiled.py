"""The correlation pyramid built level by level from a 4-D feature map.

Counterpart of the experiment ``tools/profiling/exp_r5_tileddot.py``
(``corr_dot_tiled``, ``build_pyramid_tiled``, :36-97). Kernel K3t
(``csrc/corr_dot_tiled.cu``) replaces its TPU kernel: the function of
K3 (``ops/corr_lookup.py`` ``corr_dot_rowmajor``), one level of the
volume scaled by 1/sqrt(C) after the float32 sum and cast once, taking
f2 as a (B, Hl, Wl, C) map with any strides and writing (B, N, Hl, Wl).
bf16 features go through the TMA + wgmma core that K3 uses; an f2 that
is not contiguous channels-last (the NHWC view of an NCHW feature map)
is first staged K-major into a scratch buffer that the wrapper
allocates, because a tensor map needs 16-byte strides.
"""

from __future__ import annotations

import torch

from atdn_vslam_torch.ops import _kernels
from atdn_vslam_torch.ops.corr_lookup import pool_features


def corr_dot_tiled_plain(
    f1: torch.Tensor, f2: torch.Tensor, inv_sqrt_c: float, out_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Plain PyTorch version of K3t: ``inv_sqrt_c * f1 @ f2^T`` summed
    and scaled in float32, cast once to ``out_dtype``.

    :param f1: (B, N, C); f2: (B, Hl, Wl, C).
    :return: (B, N, Hl, Wl).
    """
    b, hl, wl, c = f2.shape
    out = torch.matmul(f1.float(), f2.reshape(b, hl * wl, c).float().transpose(1, 2)) * inv_sqrt_c
    return out.to(out_dtype).reshape(b, f1.shape[1], hl, wl)


def corr_dot_tiled(
    f1: torch.Tensor, f2: torch.Tensor, inv_sqrt_c: float, out_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """K3t: one level of the correlation volume as (B, N, Hl, Wl).

    On CPU tensors this is :func:`corr_dot_tiled_plain`; on CUDA tensors
    it launches the CUDA kernel (f1 and f2 both bf16 or both float32, C a
    multiple of 8, f2 with any strides; bf16 or float32 out) and counts
    one launch, or raises. A bf16 f2 that is not contiguous with a
    16-byte aligned start is staged into a (B, Hl*Wl, C) scratch buffer
    by the kernel's own transposing pass first (one launch all the same).
    """
    if f1.device.type == "cpu":
        return corr_dot_tiled_plain(f1, f2, inv_sqrt_c, out_dtype)
    if f1.device.type != "cuda":
        raise RuntimeError(f"corr_dot_tiled: no kernel for {f1.device}")
    if f1.ndim != 3 or f2.ndim != 4:
        raise ValueError(f"f1 {tuple(f1.shape)} must be (B, N, C), f2 {tuple(f2.shape)} (B, Hl, Wl, C)")
    b, n, c = f1.shape
    hl, wl = f2.shape[1:3]
    if f2.shape[0] != b or f2.shape[3] != c or f2.device != f1.device:
        raise ValueError(f"f2 {tuple(f2.shape)} on {f2.device} does not match f1 {tuple(f1.shape)}")
    if f1.dtype not in (torch.bfloat16, torch.float32) or f2.dtype != f1.dtype:
        raise TypeError(f"corr_dot_tiled takes bf16 or float32 features, got {f1.dtype}/{f2.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"corr_dot_tiled writes bf16 or float32, not {out_dtype}")
    if c % 8 or n < 1 or hl < 1 or wl < 1:
        raise ValueError(f"channels {c} must be a multiple of 8, rows {n}, {hl} x {wl} at least 1")
    f1 = _kernels.aligned(f1)
    scratch = None
    if f1.dtype == torch.bfloat16 and not (f2.is_contiguous() and f2.data_ptr() % 16 == 0):
        scratch = torch.empty((b, hl * wl, c), dtype=f2.dtype, device=f2.device)
    out = torch.empty((b, n, hl, wl), dtype=out_dtype, device=f1.device)
    status = _kernels.library("corr_dot_tiled").atdn_corr_dot_tiled(
        f1.data_ptr(), f2.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), b, n, hl, wl, c, *f2.stride(),
        float(inv_sqrt_c), int(f1.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        f1.device.index or 0, torch.cuda.current_stream(f1.device).cuda_stream,
    )
    _kernels.check(status, "corr_dot_tiled kernel")
    corr_dot_tiled.launches += 1
    return out


corr_dot_tiled.launches = 0


def build_pyramid_tiled(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, dtype: torch.dtype = torch.bfloat16
) -> list[torch.Tensor]:
    """The correlation pyramid with every level through K3t
    (:func:`corr_dot_tiled`), f2 pooled 2x2 between levels as
    ``build_corr_pyramid`` pools it.

    :param fmap1: (B, H1, W1, C); fmap2: (B, H2, W2, C), any strides.
    :return: list of (B, H1*W1, H_l, W_l) volumes in ``dtype``.
    """
    b, h1, w1, c = fmap1.shape
    f1 = fmap1.reshape(b, h1 * w1, c)
    inv_sqrt_c = 1.0 / float(c) ** 0.5
    pyramid = [corr_dot_tiled(f1, fmap2, inv_sqrt_c, dtype)]
    f2l = fmap2
    for _ in range(1, num_levels):
        f2l = pool_features(f2l)
        pyramid.append(corr_dot_tiled(f1, f2l, inv_sqrt_c, dtype))
    return pyramid
