"""Peaks of one H100 SXM and the least time of each kernel's work.

Published peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W):
989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s
of HBM. A kernel's bound is the larger of its operations over the peak
of its type and its bytes over the HBM rate, each input byte read once
and each output byte written once, whatever implements it. The
arithmetic is that of the port's ``chip_smoke.py`` (``bound`` and the
kernel lines of K1, K2 and K5), frozen here.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SIZE = {"bfloat16": 2, "float32": 4}


def bound_s(bytes_moved: float, flops: float, dtype: str) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def attention_probs(n: int, d: int, dtype: str) -> tuple[float, float]:
    """K1, ``atdn::attention_probs`` on (1, n, d) q and k: (bytes, flops).
    Reads q and k, writes the (n, n padded to 128) probabilities."""
    return 2 * n * d * SIZE[dtype] + n * _round_up(n, 128) * SIZE[dtype], 2.0 * n * n * d


def flash_attend(nq: int, nk: int, d: int, dv: int, dtype: str) -> tuple[float, float]:
    """K5, ``atdn::flash_attend``: reads q, k and v, writes the output;
    q k^T and p v."""
    return (nq * d + nk * d + nk * dv + nq * dv) * SIZE[dtype], 2.0 * nq * nk * (d + dv)


def level_shapes(hw8: tuple[int, int], levels: int) -> list[tuple[int, int]]:
    shapes, (h, w) = [], hw8
    for _ in range(levels):
        shapes.append((h, w))
        h, w = h // 2, w // 2
    return shapes


def in_bound_taps(shapes, coords: torch.Tensor, radius: int) -> int:
    """Taps of the (2r+2)^2 patches that lie inside their level for these
    level-0 (x, y) coordinates: what a gather must read."""
    flat = coords.reshape(-1, 2).float()
    taps = torch.arange(2 * radius + 2, device=coords.device) - radius
    total = 0
    for level, (hl, wl) in enumerate(shapes):
        c = torch.floor(flat / 2.0**level)
        rows = ((c[:, 1:2] + taps >= 0) & (c[:, 1:2] + taps < hl)).sum(1)
        cols = ((c[:, 0:1] + taps >= 0) & (c[:, 0:1] + taps < wl)).sum(1)
        total += int((rows * cols).sum())
    return total


def corr_lookup(hw8: tuple[int, int], levels: int, radius: int, dtype: str,
                coords: torch.Tensor | None = None) -> tuple[float, float]:
    """K2, ``atdn::corr_lookup`` of one batch-1 pyramid: the in-bound taps
    of the volume, the float32 coordinates read, the float32 windows
    written; no operations counted. ``coords`` default to the identity
    grid."""
    h, w = hw8
    if coords is None:
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        coords = torch.stack([xs, ys], -1).float()
    n = h * w
    taps = in_bound_taps(level_shapes(hw8, levels), coords, radius)
    return taps * SIZE[dtype] + n * 2 * 4 + n * levels * (2 * radius + 1) ** 2 * 4, 0.0
