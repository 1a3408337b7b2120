"""GMA attention, on the JAX package's schedule by token count N
(``atdn_vslam_tpu/ops/attention.py:198,206``, ``network.py:349-364``),
which :func:`gma_attention` applies once per frame pair for the flow net:

- N <= :data:`_MATERIALIZE_MAX_TOKENS`: the probabilities softmax(q k^T)
  are materialised once per frame pair in the spatial layout (kernel K1)
  and multiplied with the new values in every iteration
  (:func:`apply_attention_probs`);
- above it, every iteration attends anew (:func:`attend`): through the
  online-softmax kernel K5 at N >= :data:`_FLASH_MIN_TOKENS`, through
  :func:`attend_reference` in between.

Kernel K1 (``csrc/attention_probs.cu``) replaces the TPU kernel
``atdn_vslam_tpu/ops/attention.py:flash_probs_spatial``. Its contract
(the JAX ``keep_padded`` one): probabilities of shape (B, H, W, N_pad)
in q's type, N_pad = N rounded up to a multiple of 128, the pad columns
exact zeros, so the P @ V read contracts them against zero-extended
values and never slices the large matrix. Its bf16 kernel runs the
row statistics split over the keys (:func:`_probs_splits`), then K3's
TMA + wgmma core with a softmax epilogue that merges them.

Kernel K5 (``csrc/flash_attend.cu``) replaces the TPU kernel
``atdn_vslam_tpu/ops/attention.py:flash_attend``: out = softmax(scale
q k^T) v in one pass over the keys, the scores never stored. float32
values 1 to 4 wide (GMFlow's matching and propagation) take its narrow
kernel, which splits the keys into parts (:func:`_narrow_parts`) and
merges them in a second kernel of the same op.

Kernel K5r (``csrc/flash_attend.cu``, :func:`flash_attend_regions`) is
K5 restricted to regions: each token carries an int32 region id and a
key counts for a query only where the two ids agree. GMFlow's shifted
windows take it (``models/flow/gmflow.py``); it has no TPU counterpart.

Kernel K4 (``csrc/apply_probs.cu``) replaces the TPU kernel
``atdn_vslam_tpu/ops/attention.py:flash_apply_probs``: the P @ V read of
K1's probabilities, reached through ``apply_attention_probs(...,
use_pallas=True)`` as in the JAX package; the default read stays a
``torch.matmul``.

Row-split versions of K1, K5 and K4 (:func:`sharded_flash_probs_spatial`,
:func:`sharded_flash_attend`, :func:`sharded_flash_apply_probs`; JAX
``attention.py:543-679``) take this rank's band of the query rows (or
probability rows) and the whole k and v: the softmax runs over keys, so
a band needs nothing from the other ranks, and each launches its kernel
once on its band.

Each kernel launches only through its custom op (``atdn::attention_probs``,
``atdn::flash_attend``, ``atdn::flash_attend_regions``, ``atdn::apply_probs``;
``_kernels.define_op``),
whose CUDA implementation counts the launch.

The positional modes of GMA (a relative-position ``bias`` added to the
scores, or the bias alone with ``position_only``) take the torch path,
scores plus bias and a float32 softmax, never K1 or K5, as the JAX
package takes XLA's (``attention.py:682-748,954-955``).
"""

from __future__ import annotations

import functools
from collections.abc import Callable

import torch
import torch.nn.functional as F

from atdn_vslam_torch.ops import _kernels
from atdn_vslam_torch.parallel.distributed import band_bounds, group_rank, group_size


#: at most this many tokens materialise the probabilities once per frame
#: pair (the JAX package's constant: a 128 MB bf16 matrix at 8192)
_MATERIALIZE_MAX_TOKENS = 8192
#: at least this many tokens attend through the flash kernel K5 when
#: the caller leaves the choice to :func:`attend`
_FLASH_MIN_TOKENS = 16384


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


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


#: K1's bf16 kernels: query rows and keys per tile
_PROBS_TILE = 128
_LOG2E = 1.4426950408889634


def _probs_splits(b: int, n: int, n_kv: int, sms: int) -> int:
    """Key splits S of K1's bf16 statistics pass for q (b, n, D) and k
    (b, n_kv, D) on a card with ``sms`` SMs: its grid is (128-row query
    tiles) x S x b blocks, two of which stay resident per SM, so S is
    the most that keeps the grid within 2 * sms blocks, at least 1 and
    at most the number of 128-key tiles, so that every split holds one
    (split s takes tiles [s T // S, (s + 1) T // S) of the T)."""
    q_tiles = b * -(-n // _PROBS_TILE)
    k_tiles = -(-n_kv // _PROBS_TILE)
    return max(1, min(k_tiles, 2 * sms // q_tiles))


def attention_probs_split_plain(
    q: torch.Tensor, k: torch.Tensor, h: int, w: int, scale: float | None = None, splits: int = 1
) -> torch.Tensor:
    """Plain PyTorch version of K1's bf16 arithmetic, split statistics
    and their merge, in float32 (the tests hold it against the JAX
    kernel; no path runs it). With x = scale log2(e) q k^T, split s of
    ``splits`` takes key tiles [s T // splits, (s + 1) T // splits) of
    the T tiles of 128 keys and keeps m_s = max x and l_s = sum 2^(x -
    m_s) per row (-inf and 0 for a split with no key); the merge takes m
    = max m_s and l = sum of l_s 2^(m_s - m) over the splits with a key;
    p = 2^(x - m) / l in q's type, zero columns up to N_pad.

    :return: (B, h, w, N_pad) as :func:`attention_probs_spatial_plain`.
    """
    b, n, d = q.shape
    n_kv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    x = torch.matmul(q.float(), k.float().transpose(1, 2)) * (scale * _LOG2E)
    tiles = -(-n_kv // _PROBS_TILE)
    ms, ls = [], []
    for s in range(splits):
        lo = s * tiles // splits * _PROBS_TILE
        hi = min((s + 1) * tiles // splits * _PROBS_TILE, n_kv)
        if lo >= hi:
            ms.append(x.new_full((b, n), -torch.inf))
            ls.append(x.new_zeros((b, n)))
            continue
        xs = x[..., lo:hi]
        ms.append(xs.amax(dim=-1))
        ls.append(torch.exp2(xs - ms[-1][..., None]).sum(dim=-1))
    m = torch.stack(ms).amax(dim=0)
    l = sum(torch.where(m_s == -torch.inf, 0.0, l_s * torch.exp2(m_s - m)) for m_s, l_s in zip(ms, ls))
    p = (torch.exp2(x - m[..., None]) / l[..., None]).to(q.dtype)
    p = F.pad(p, (0, _round_up(n_kv, _PROBS_TILE) - n_kv))
    return p.reshape(b, h, w, -1)


def _attention_probs_cuda(q: torch.Tensor, k: torch.Tensor, h: int, w: int, scale: float) -> torch.Tensor:
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
    q, k = _kernels.aligned(q), _kernels.aligned(k)
    n_pad = _round_up(n_kv, _PROBS_TILE)
    out = torch.empty((b, n, n_pad), dtype=q.dtype, device=q.device)
    is_bf16 = q.dtype == torch.bfloat16
    splits = 1
    if is_bf16:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = _probs_splits(b, n, n_kv, sms)
    # bf16: the statistics pass's (B, S, N) partial (m, l); float32: m, l
    ws = torch.empty((b, splits, n, 2), dtype=torch.float32, device=q.device)
    status = _kernels.library("attention_probs").atdn_attention_probs(
        q.data_ptr(), k.data_ptr(), ws.data_ptr(), out.data_ptr(),
        b, n, n_kv, n_pad, d, splits, float(scale), int(is_bf16),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(status, "attention_probs kernel")
    attention_probs_spatial.launches += 1
    return out.reshape(b, h, w, n_pad)


def _attention_probs_fake(q: torch.Tensor, k: torch.Tensor, h: int, w: int, scale: float) -> torch.Tensor:
    # N_pad by the kernel's rule; the key split is a workspace of the launch
    return q.new_empty((q.shape[0], h, w, _round_up(k.shape[1], _PROBS_TILE)))


_kernels.define_op(
    "attention_probs", "(Tensor q, Tensor k, int h, int w, float scale) -> Tensor",
    attention_probs_spatial_plain, _attention_probs_fake, _attention_probs_cuda,
)


def attention_probs_backward(
    q: torch.Tensor, k: torch.Tensor, p: torch.Tensor, dp: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's VJP, the JAX package's ``_flash_probs_bwd``
    (``attention.py:505-521``) in float32 products: P and dP without
    their pad columns, dS = P * (dP - sum(dP * P)), dq = dS k * scale,
    dk = dS^T q * scale, each cast to its input's type.

    :param q: (B, N, D); k: (B, N_kv, D); p, dp: (B, h, w, N_pad).
    """
    b, n, _ = q.shape
    n_kv = k.shape[1]
    pf = p.reshape(b, n, -1)[..., :n_kv].float()
    dpf = dp.reshape(b, n, -1)[..., :n_kv].float()
    ds = pf * (dpf - (dpf * pf).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype)


class _AttentionProbs(torch.autograd.Function):
    """K1 forward; the backward is :func:`attention_probs_backward`."""

    @staticmethod
    def forward(ctx, q, k, h, w, scale):
        p = torch.ops.atdn.attention_probs(q, k, h, w, scale)
        ctx.save_for_backward(q, k, p)
        ctx.scale = scale
        return p

    @staticmethod
    def backward(ctx, dp):
        q, k, p = ctx.saved_tensors
        dq, dk = attention_probs_backward(q, k, p, dp, ctx.scale)
        return dq, dk, None, None, None


def _scores(
    q: torch.Tensor, k: torch.Tensor, scale: float, bias: torch.Tensor | None, position_only: bool
) -> torch.Tensor:
    """float32 scale q k^T [+ bias], or the bias alone with
    ``position_only`` (ref: GMA gma.py:62-71)."""
    if position_only:
        if bias is None:
            raise ValueError("position_only attention requires a bias")
        return bias.float()
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    return s if bias is None else s + bias.float()


def attention_probs_biased(
    q: torch.Tensor,
    k: torch.Tensor,
    h: int,
    w: int,
    scale: float,
    bias: torch.Tensor | None,
    position_only: bool = False,
) -> torch.Tensor:
    """softmax(scale q k^T + bias), or softmax(bias) with
    ``position_only``, in float32, cast to q's type, as (B, h, w, N)
    with no pad columns: the JAX package's XLA path of
    ``attention_probs_spatial`` (``attention.py:729-748``)."""
    p = torch.softmax(_scores(q, k, scale, bias, position_only), dim=-1)
    return p.to(q.dtype).reshape(q.shape[0], h, w, -1)


def attention_probs_spatial(
    q: torch.Tensor, k: torch.Tensor, h: int, w: int, scale: float | None = None
) -> torch.Tensor:
    """K1: softmax(scale * q k^T) as (B, h, w, N_pad), differentiable in
    q and k.

    On a CPU tensor this is :func:`attention_probs_spatial_plain`, which
    autograd differentiates; on a CUDA tensor it launches the CUDA kernel
    through ``atdn::attention_probs`` (bf16 or float32 inputs, float32
    accumulation) and counts one launch, or raises. The CUDA forward goes
    through :class:`_AttentionProbs`, whose backward is the JAX package's
    VJP. A positional bias takes :func:`attention_probs_biased` instead.
    """
    if q.device.type == "cpu":
        return attention_probs_spatial_plain(q, k, h, w, scale)
    _kernels.require_cuda("attention_probs_spatial", q)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _AttentionProbs.apply(q, k, h, w, scale)


attention_probs_spatial.launches = 0




def flash_apply_probs_plain(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: out = probs @ v in float32, v
    zero-extended to probs' key count, cast once to v's type.

    :param probs: (B, H, W, K) spatial probabilities whose columns past
        v's token count are zero padding (K1's ``keep_padded`` output).
    :param v: (B, N_v, Dv), N_v <= K.
    :return: (B, H, W, Dv) in v's type.
    """
    b, h, w, n = probs.shape
    vf = F.pad(v.float(), (0, 0, 0, n - v.shape[1]))
    out = torch.matmul(probs.reshape(b, h * w, n).float(), vf)
    return out.to(v.dtype).reshape(b, h, w, -1)


#: K4's bf16 kernel: rows of P per tile, keys per pipeline stage, and the
#: floats of one block's partial sums (two tiles it may share with other
#: blocks, two warpgroups of 64 rows x 128 values each)
_APPLY_ROWS, _APPLY_KEYS, _APPLY_PARTIALS = 128, 64, 4 * 64 * 128


def _apply_probs_split(b: int, m: int, k: int, sms: int) -> tuple[int, int]:
    """(blocks, tiles) of K4's bf16 kernel for P of shape (b, m, k) on a
    card with ``sms`` SMs. Its units of work are the (128-row tile,
    64-key step) pairs, ``tiles * ceil(k / 64)`` of them; block i of
    ``blocks`` takes units [i * units // blocks, (i + 1) * units //
    blocks), so each SM gets one block however few tiles there are, and
    a tile may be split between blocks (the kernel adds the segments in
    the order of their keys)."""
    tiles = b * -(-m // _APPLY_ROWS)
    units = tiles * -(-k // _APPLY_KEYS)
    return min(sms, units), tiles


#: K4's per-tile counters, by (device, stream): zero between launches
#: (the kernel zeroes each counter it used), so launches on one stream
#: share them without a memset
_apply_probs_counters: dict[tuple[int, int], torch.Tensor] = {}


def _apply_probs_counters_for(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    key = (device.index or 0, stream)
    counters = _apply_probs_counters.get(key)
    if counters is None or counters.shape[0] < tiles:
        counters = torch.zeros((tiles, 2), dtype=torch.int32, device=device)
        _apply_probs_counters[key] = counters
    return counters


def _apply_probs_cuda(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if probs.ndim != 4 or v.ndim != 3 or v.shape[0] != probs.shape[0] or v.device != probs.device:
        raise ValueError(
            f"probs {tuple(probs.shape)} on {probs.device} must be (B, H, W, K) and v "
            f"{tuple(v.shape)} on {v.device} (B, N_v, Dv)"
        )
    b, h, w, n = probs.shape
    n_v, dv = v.shape[1:]
    if probs.dtype not in (torch.bfloat16, torch.float32) or v.dtype != probs.dtype:
        raise TypeError(f"flash_apply_probs takes bf16 or float32, got {probs.dtype}/{v.dtype}")
    if n % 8 or not 1 <= n_v <= n or dv % 16 or not 16 <= dv <= 128 or h * w < 1:
        raise ValueError(
            f"keys {n} must be a multiple of 8 and at least N_v = {n_v} >= 1, value width "
            f"{dv} a multiple of 16 in [16, 128], rows {h} x {w} at least 1"
        )
    probs, v = _kernels.aligned(probs), _kernels.aligned(v)
    out = torch.empty((b, h, w, dv), dtype=v.dtype, device=v.device)
    is_bf16 = v.dtype == torch.bfloat16
    stream = torch.cuda.current_stream(v.device).cuda_stream
    grid, ws, counters = 0, None, None
    if is_bf16:  # the key split's partial sums and per-tile counters
        sms = torch.cuda.get_device_properties(v.device).multi_processor_count
        grid, tiles = _apply_probs_split(b, h * w, n, sms)
        ws = torch.empty((grid, _APPLY_PARTIALS), dtype=torch.float32, device=v.device)
        counters = _apply_probs_counters_for(v.device, stream, tiles)
    status = _kernels.library("apply_probs").atdn_apply_probs(
        probs.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (ws, counters)),
        b, h * w, n, n_v, dv, grid, int(is_bf16), v.device.index or 0, stream,
    )
    _kernels.check(status, "apply_probs kernel")
    flash_apply_probs.launches += 1
    return out


def _apply_probs_fake(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.new_empty((*probs.shape[:3], v.shape[2]))


def _apply_probs_cpu(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_apply_probs_plain(probs, v)  # looked up per call, so a test can wrap it


_kernels.define_op(
    "apply_probs", "(Tensor probs, Tensor v) -> Tensor", _apply_probs_cpu, _apply_probs_fake, _apply_probs_cuda
)


class _FlashApplyProbs(torch.autograd.Function):
    """K4 forward; the backward is the JAX package's custom VJP
    (``attention.py:872-886``), two plain float32 products: dv = P^T
    dout in v's type, dP = dout v^T in P's type, zero on P's pad
    columns (constants)."""

    @staticmethod
    def forward(ctx, probs, v):
        ctx.save_for_backward(probs, v)
        return torch.ops.atdn.apply_probs(probs, v)

    @staticmethod
    def backward(ctx, dout):
        probs, v = ctx.saved_tensors
        b, h, w, n = probs.shape
        n_v = v.shape[1]
        df = dout.float().reshape(b, h * w, -1)
        dp = dv = None
        if ctx.needs_input_grad[0]:
            dp = torch.matmul(df, v.float().transpose(1, 2)).to(probs.dtype)
            dp = F.pad(dp, (0, n - n_v)).reshape(b, h, w, n)
        if ctx.needs_input_grad[1]:
            p = probs.reshape(b, h * w, n)[..., :n_v].float()
            dv = torch.matmul(p.transpose(1, 2), df).to(v.dtype)
        return dp, dv


def flash_apply_probs(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: out = probs @ v over spatial probabilities (contract of
    :func:`flash_apply_probs_plain`), differentiable in both.

    The forward is ``atdn::apply_probs``: on a CPU tensor the plain
    version; on a CUDA tensor it launches the CUDA kernel (probs and v
    both bf16 or both float32, K a multiple of 8, Dv a multiple of 16 up
    to 128, float32 accumulation) and counts one launch, or raises.
    """
    if probs.device.type != "cpu":
        _kernels.require_cuda("flash_apply_probs", probs)
    return _FlashApplyProbs.apply(probs, v)


flash_apply_probs.launches = 0


def apply_attention_probs(
    probs: torch.Tensor, v: torch.Tensor, use_pallas: bool | None = None
) -> torch.Tensor:
    """out = probs @ v, float32 accumulation, the per-iteration read of
    the materialised probabilities (``torch.matmul``; the JAX package
    leaves it to XLA). ``use_pallas=True`` takes kernel K4
    (:func:`flash_apply_probs`) for spatial probabilities, with v cast
    to the probabilities' type, as the JAX package does (``:918-919``).

    :param probs: (B, H, W, N_pad) spatial probabilities whose columns
        past v's token count are zero padding, or (B, N, N).
    :param v: (B, N, D) values, zero-extended here to N_pad.
    :return: (B, H, W, D) or (B, N, D) in v's type (probs' type under
        ``use_pallas=True``).
    """
    if probs.ndim == 4:
        if use_pallas is True:
            return flash_apply_probs(probs, v.to(probs.dtype))
        b, h, w, n = probs.shape
        if n != v.shape[1]:
            v = F.pad(v, (0, 0, 0, n - v.shape[1]))
        out = torch.matmul(probs.reshape(b, h * w, n).to(v.dtype), v)
        return out.reshape(b, h, w, -1)
    return torch.matmul(probs.to(v.dtype), v)


def attend_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    bias: torch.Tensor | None = None,
    position_only: bool = False,
) -> torch.Tensor:
    """out = softmax(scale * q k^T [+ bias]) v, the JAX package's
    ``attend_reference``: float32 scores, softmax, the probabilities cast
    to v's type, the product with v accumulated in float32.

    :param q: (B, Nq, D); k: (B, Nk, D); v: (B, Nk, Dv).
    :param bias: optional (B, Nq, Nk) additive scores (GMA's relative
        positions); ``position_only`` takes the bias alone as the scores.
    :return: (B, Nq, Dv) in v's type.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = torch.softmax(_scores(q, k, scale, bias, position_only), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def flash_attend_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K5, the online kernel's arithmetic with
    the whole key axis as one tile: float32 scores, exp(s - row max)
    cast to v's type, its product with v accumulated in float32, divided
    by the float32 row sum. The (B, Nq, Nk) float32 scores are
    materialised."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(e.to(v.dtype).float(), v.float()) / e.sum(dim=-1, keepdim=True)
    return out.to(v.dtype)


def flash_attend(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """K5: softmax(scale * q k^T) v, online, the scores never stored.

    On a CPU tensor this is :func:`flash_attend_plain`; on a CUDA tensor
    it launches the CUDA kernel through ``atdn::flash_attend`` (q, k and
    v all bf16 or all float32, D and Dv multiples of 16 up to 128, or
    float32 with Dv of 1 to 4, float32 accumulation) and counts one
    launch, the narrow float32 values in ``narrow_launches`` too, or
    raises. The kernel has no backward, as the JAX package's has no VJP:
    under grad mode a CUDA input that requires grad raises.

    :param q: (B, Nq, D); k: (B, Nk, D); v: (B, Nk, Dv).
    :return: (B, Nq, Dv) in v's type.
    """
    if q.device.type == "cpu":
        return flash_attend_plain(q, k, v, scale)
    _kernels.require_cuda("flash_attend", q)
    _kernels.refuse_autograd("flash_attend (K5)", q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return torch.ops.atdn.flash_attend(q, k, v, scale)


flash_attend.launches = 0
flash_attend.narrow_launches = 0

#: K5's narrow kernel: query rows per block and keys per tile, and the
#: widest float32 values it takes
_NARROW_TILE = 128
_NARROW_MAX_DV = 4


def _flash_is_narrow(dtype: torch.dtype, d: int, dv: int) -> bool:
    """Whether K5 takes its narrow kernel for these widths (float32 values
    1 to 4 wide); raises on widths no K5 kernel takes."""
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head width {d} must be a multiple of 16 in [16, 128]")
    if dtype == torch.float32 and 1 <= dv <= _NARROW_MAX_DV:
        return True
    if dv % 16 or not 16 <= dv <= 128:
        raise ValueError(f"value width {dv} must be a multiple of 16 in [16, 128], or 1 to 4 in float32")
    return False


@functools.lru_cache(maxsize=64)
def _narrow_parts(b: int, nq: int, nk: int, sms: int) -> int:
    """Parts S of the key axis for K5's narrow kernel on a card with
    ``sms`` SMs: its grid is (128-row query tiles) x S x b blocks, one
    resident per SM, each walking its part's 128-key tiles (part s takes
    tiles [s T // S, (s + 1) T // S) of the T). S minimises the waves of
    blocks times the tiles of the longest part, plus a quarter tile per
    block for loading its q tile and first k tile; ties go to fewer parts."""
    rows = b * -(-nq // _NARROW_TILE)
    tiles = -(-nk // _NARROW_TILE)
    return min(range(1, min(tiles, 65535) + 1), key=lambda s: (-(-rows * s // sms) * (-(-tiles // s) + 0.25), s))


def _flash_attend_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    b, nq, d = q.shape
    nk, dv = v.shape[1], v.shape[2]
    if k.shape != (b, nk, d) or v.shape[0] != b:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} do not match"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v lie on {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attend takes bf16 or float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    narrow = _flash_is_narrow(q.dtype, d, dv)
    if nq < 1 or nk < 1:
        raise ValueError(f"flash_attend needs at least one query and one key, got {nq}, {nk}")
    q, k, v = _kernels.aligned(q), _kernels.aligned(k), _kernels.aligned(v)
    out = torch.empty((b, nq, dv), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if narrow:
        parts = _narrow_parts(b, nq, nk, torch.cuda.get_device_properties(q.device).multi_processor_count)
        ws = torch.empty((b, nq, parts, 2 + dv), dtype=torch.float32, device=q.device)  # (m, l, o) per part
        status = _kernels.library("flash_attend").atdn_flash_attend_narrow(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(), out.data_ptr(), b, nq, nk, d, dv,
            parts, float(scale), q.device.index or 0, stream,
        )
    else:
        status = _kernels.library("flash_attend").atdn_flash_attend(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk, d, dv,
            float(scale), int(q.dtype == torch.bfloat16), q.device.index or 0, stream,
        )
    _kernels.check(status, "flash_attend kernel")
    flash_attend.launches += 1
    flash_attend.narrow_launches += narrow
    return out


def _flash_attend_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return v.new_empty((q.shape[0], q.shape[1], v.shape[2]))


_kernels.define_op(
    "flash_attend", "(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    flash_attend_plain, _flash_attend_fake, _flash_attend_cuda,
)


def flash_attend_regions_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, regions: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K5r: :func:`flash_attend_plain`'s
    arithmetic with the scores of every pair whose region ids differ left
    out (weight exactly 0).

    :param q, k: (B, N, D); v: (B, N, Dv); regions: (B, N) int32 ids of
        the tokens, queries and keys alike.
    :return: (B, N, Dv) in v's type.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    s = s.masked_fill(regions[:, :, None] != regions[:, None, :], -torch.inf)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(e.to(v.dtype).float(), v.float()) / e.sum(dim=-1, keepdim=True)
    return out.to(v.dtype)


def flash_attend_regions(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, regions: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """K5r: softmax(scale * q k^T) v over the keys of each query's own
    region, online, the scores never stored.

    On a CPU tensor this is :func:`flash_attend_regions_plain`; on a
    CUDA tensor it launches K5r through ``atdn::flash_attend_regions`` (q,
    k and v all bf16 or all float32 with K5's widths, ``regions`` int32)
    and counts one launch, or raises. No backward, as K5.

    :param q, k: (B, N, D); v: (B, N, Dv); regions: (B, N) int32.
    :return: (B, N, Dv) in v's type.
    """
    if q.device.type == "cpu":
        return flash_attend_regions_plain(q, k, v, regions, scale)
    _kernels.require_cuda("flash_attend_regions", q)
    _kernels.refuse_autograd("flash_attend_regions (K5r)", q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return torch.ops.atdn.flash_attend_regions(q, k, v, regions, scale)


flash_attend_regions.launches = 0


def _flash_attend_regions_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, regions: torch.Tensor, scale: float
) -> torch.Tensor:
    b, n, d = q.shape
    dv = v.shape[2]
    if k.shape != (b, n, d) or v.shape[:2] != (b, n) or regions.shape != (b, n):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} and regions "
            f"{tuple(regions.shape)} do not match (B, N, D), (B, N, Dv), (B, N)"
        )
    if len({q.device, k.device, v.device, regions.device}) != 1:
        raise ValueError(f"q, k, v and regions lie on {q.device}, {k.device}, {v.device}, {regions.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attend_regions takes bf16 or float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if regions.dtype != torch.int32:
        raise TypeError(f"flash_attend_regions takes int32 region ids, got {regions.dtype}")
    for name, width in (("head width", d), ("value width", dv)):
        if width % 16 or not 16 <= width <= 128:
            raise ValueError(f"{name} {width} must be a multiple of 16 in [16, 128]")
    if n < 1:
        raise ValueError("flash_attend_regions needs at least one token")
    q, k, v = _kernels.aligned(q), _kernels.aligned(k), _kernels.aligned(v)
    regions = regions.contiguous()
    out = torch.empty((b, n, dv), dtype=v.dtype, device=q.device)
    status = _kernels.library("flash_attend").atdn_flash_attend_regions(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), regions.data_ptr(), out.data_ptr(), b, n, d, dv,
        float(scale), int(q.dtype == torch.bfloat16), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(status, "flash_attend_regions kernel")
    flash_attend_regions.launches += 1
    return out


def _flash_attend_regions_fake(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, regions: torch.Tensor, scale: float
) -> torch.Tensor:
    return v.new_empty((q.shape[0], q.shape[1], v.shape[2]))


_kernels.define_op(
    "flash_attend_regions", "(Tensor q, Tensor k, Tensor v, Tensor regions, float scale) -> Tensor",
    flash_attend_regions_plain, _flash_attend_regions_fake, _flash_attend_regions_cuda,
)


def _own_band(mesh, axis: str, n_rows: int, got_rows: int, what: str) -> int:
    """The row count of this rank's band of ``n_rows`` rows over the mesh
    axis (:func:`band_bounds`), checked against the ``got_rows`` passed."""
    group = None if mesh is None else mesh.group(axis)
    lo, hi = band_bounds(n_rows, group_size(group), group_rank(group))
    if got_rows != hi - lo:
        raise ValueError(f"{what} holds {got_rows} rows; this rank's band of {n_rows} is [{lo}, {hi})")
    return hi - lo


def sharded_flash_probs_spatial(
    q: torch.Tensor, k: torch.Tensor, h: int, w: int, scale: float | None = None, *, mesh, axis: str = "model"
) -> torch.Tensor:
    """K1 on this rank's band of the h query rows (JAX
    ``sharded_flash_probs_spatial``): q holds the band's rows x w tokens,
    (B, rows * w, D), k all keys; returns the band's probabilities (B,
    rows, w, N_pad) from one K1 launch (:func:`attention_probs_spatial`).
    The band is :func:`band_bounds` of h over ``mesh``'s ``axis``."""
    rows = _own_band(mesh, axis, h, q.shape[1] // w if q.shape[1] % w == 0 else -1, "q")
    return attention_probs_spatial(q, k, rows, w, scale)


def sharded_flash_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    *,
    mesh,
    axis: str = "model",
    n_rows: int,
    row_len: int = 1,
) -> torch.Tensor:
    """K5 on this rank's band of the queries (JAX ``sharded_flash_attend``):
    the queries are ``n_rows`` rows of ``row_len`` tokens, q holds this
    rank's band of rows, (B, rows * row_len, D), k and v all keys; one K5
    launch (:func:`flash_attend`) gives the band's (B, rows * row_len,
    Dv). ``row_len=1`` splits the tokens themselves."""
    tokens = q.shape[1]
    _own_band(mesh, axis, n_rows, tokens // row_len if tokens % row_len == 0 else -1, "q")
    return flash_attend(q, k, v, scale)


def sharded_flash_apply_probs(
    probs: torch.Tensor, v: torch.Tensor, *, mesh, axis: str = "model", h: int
) -> torch.Tensor:
    """K4 on this rank's band of the h probability rows (JAX
    ``sharded_flash_apply_probs``): probs (B, rows, W, K) of the band, v
    (B, N_v, Dv) whole, cast to the probabilities' type as the JAX
    package does; one K4 launch (:func:`flash_apply_probs`) gives the
    band's (B, rows, W, Dv)."""
    _own_band(mesh, axis, h, probs.shape[1], "probs")
    return flash_apply_probs(probs, v.to(probs.dtype))


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    use_pallas: bool | None = None,
    bias: torch.Tensor | None = None,
    position_only: bool = False,
) -> torch.Tensor:
    """softmax(scale * q k^T) v, the JAX package's ``attend`` dispatch.

    ``use_pallas=None`` takes kernel K5 (:func:`flash_attend`) at
    ``_FLASH_MIN_TOKENS`` query tokens or more and
    :func:`attend_reference` below; ``True`` always takes K5 and
    ``False`` never does. On CPU tensors the K5 wrapper is its plain
    version, so the CPU follows the same token-count schedule. A
    positional ``bias`` or ``position_only`` always takes
    :func:`attend_reference` (K5 carries no bias, as in the JAX
    package)."""
    if bias is not None or position_only:
        return attend_reference(q, k, v, scale, bias, position_only)
    if use_pallas is None:
        use_pallas = q.shape[-2] >= _FLASH_MIN_TOKENS
    if use_pallas:
        return flash_attend(q, k, v, scale)
    return attend_reference(q, k, v, scale)


def gma_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    bias: torch.Tensor | None,
    h: int,
    w: int,
    *,
    use_pallas: bool | None = None,
    position_only: bool = False,
    band: tuple[int, int] | None = None,
    mesh=None,
    axis: str = "model",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """GMA's attention for one frame pair, its kernel chosen here once:
    returns ``attn(v) -> out``, which the update block calls in every
    iteration with that iteration's values v (B, N, D).

    :param q, k: (B, N, D) of the h x w tokens, q pre-scaled (scale 1).
    :param bias: the positional (B, N, N) bias, or None.
    :param use_pallas: ``True`` attends anew in every iteration through K5
        at any N (the positional modes through :func:`attend_reference`);
        ``None`` or ``False`` follow the schedule by token count above.
    :param band: rows [lo, hi) of the h: this rank's band of the queries
        over ``mesh``'s ``axis`` (content-only); out is the band's.
    :return: out (B, h, w, D) or (B, N, D), of the band's rows with ``band``.
    """
    n = h * w
    forced = use_pallas is True
    if bias is not None or position_only:
        if band is not None:
            raise ValueError("the row-split attention is content-only")
        if n > _MATERIALIZE_MAX_TOKENS:
            raise ValueError(
                f"positional attention at {n} tokens would materialize a dense (N, N) "
                f"bias (limit {_MATERIALIZE_MAX_TOKENS}); use content-only "
                "attention at this resolution"
            )
        if forced:
            return lambda v: attend_reference(q, k, v, 1.0, bias, position_only)
        probs = attention_probs_biased(q, k, h, w, 1.0, bias, position_only)
        return lambda v: apply_attention_probs(probs, v)
    if band is not None:
        q = q[:, band[0] * w : band[1] * w]
    if not forced and n <= _MATERIALIZE_MAX_TOKENS:
        if band is None:
            probs = attention_probs_spatial(q, k, h, w, 1.0)
        else:
            probs = sharded_flash_probs_spatial(q, k, h, w, 1.0, mesh=mesh, axis=axis)
        return lambda v: apply_attention_probs(probs, v)
    flash = forced or n >= _FLASH_MIN_TOKENS  # by the whole frame's tokens, band or not
    if band is not None and flash:
        return lambda v: sharded_flash_attend(q, k, v, 1.0, mesh=mesh, axis=axis, n_rows=h, row_len=w)
    return lambda v: attend(q, k, v, 1.0, use_pallas=flash)
