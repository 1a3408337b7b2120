"""GMA attention: the probabilities softmax(q k^T), materialised once
per frame pair in the spatial layout, and their per-iteration product
with the values.

Kernel K1 (``csrc/attention_probs.cu``) replaces the TPU kernel
``atdn_vslam_tpu/ops/attention.py:flash_probs_spatial``. Its contract
(the JAX ``keep_padded`` one): probabilities of shape (B, H, W, N_pad)
in q's type, N_pad = N rounded up to a multiple of 128, the pad columns
exact zeros, so the P @ V read contracts them against zero-extended
values and never slices the large matrix.

The JAX package switches to per-iteration flash attention (its kernel
K5) above 8192 tokens; the port materialises the probabilities at every
size until K5 is ported (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from atdn_vslam_torch.ops import _kernels


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels load 16 bytes
    per thread)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def attention_probs_spatial_plain(
    q: torch.Tensor, k: torch.Tensor, h: int, w: int, scale: float | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K1: float32 scores, softmax, cast to
    q's type, zero columns up to N_pad.

    :param q: (B, N, D) queries, N = h * w; k: (B, N_kv, D) keys.
    :return: (B, h, w, N_pad) probabilities in q's type.
    """
    b, n, d = q.shape
    n_kv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p = F.pad(p, (0, _round_up(n_kv, 128) - n_kv))
    return p.reshape(b, h, w, -1)


def attention_probs_spatial(
    q: torch.Tensor, k: torch.Tensor, h: int, w: int, scale: float | None = None
) -> torch.Tensor:
    """K1: softmax(scale * q k^T) as (B, h, w, N_pad).

    On a CPU tensor this is :func:`attention_probs_spatial_plain`; on a
    CUDA tensor it launches the CUDA kernel (bf16 or float32 inputs,
    float32 accumulation) and counts one launch, or raises.
    """
    if q.device.type == "cpu":
        return attention_probs_spatial_plain(q, k, h, w, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_probs_spatial: no kernel for {q.device}")
    b, n, d = q.shape
    n_kv = k.shape[1]
    if n != h * w:
        raise ValueError(f"q has {n} rows, expected h * w = {h * w}")
    if k.shape[0] != b or k.shape[2] != d or k.device != q.device:
        raise ValueError(f"k {tuple(k.shape)} on {k.device} does not match q {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype:
        raise TypeError(f"attention_probs_spatial takes bf16 or float32, got {q.dtype}/{k.dtype}")
    if d % 16 or d > 256:
        raise ValueError(f"head width {d} must be a multiple of 16 and at most 256")
    scale = d**-0.5 if scale is None else scale
    q, k = _aligned(q), _aligned(k)
    n_pad = _round_up(n_kv, 128)
    out = torch.empty((b, n, n_pad), dtype=q.dtype, device=q.device)
    m = torch.empty((b, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    status = _kernels.library("attention_probs").atdn_attention_probs(
        q.data_ptr(), k.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        b, n, n_kv, n_pad, d, float(scale), int(q.dtype == torch.bfloat16),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(status, "attention_probs kernel")
    attention_probs_spatial.launches += 1
    return out.reshape(b, h, w, n_pad)


attention_probs_spatial.launches = 0


def apply_attention_probs(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out = probs @ v, float32 accumulation, the per-iteration read of
    the materialised probabilities (``torch.matmul``; the JAX package
    leaves it to XLA).

    :param probs: (B, H, W, N_pad) spatial probabilities whose columns
        past v's token count are zero padding, or (B, N, N).
    :param v: (B, N, D) values, zero-extended here to N_pad.
    :return: (B, H, W, D) or (B, N, D) in v's type.
    """
    if probs.ndim == 4:
        b, h, w, n = probs.shape
        if n != v.shape[1]:
            v = F.pad(v, (0, 0, 0, n - v.shape[1]))
        out = torch.matmul(probs.reshape(b, h * w, n).to(v.dtype), v)
        return out.reshape(b, h, w, -1)
    return torch.matmul(probs.to(v.dtype), v)
