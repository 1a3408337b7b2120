#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out results.json] [--profile N]

Phases, each printing one JSON line; any failure exits non-zero:

  1. device: the ``nvidia-smi`` name and power limit, torch and CUDA
     versions;
  2. build: compiles every CUDA kernel of the port with ``nvcc``;
  3. kernels: each kernel against its plain PyTorch version at the
     shapes its path gives it (K1, K2: KITTI 376x1232 -> 47x154 = 7238
     tokens, K2 also at 2x KITTI; K5, K3: 2x KITTI 752x2464 -> 94x308 =
     28952 tokens), with its time, the plain version's, one library
     call's and the least time the card could take (the bound); K5 and
     K4 also on a ragged batch of two; the Hopper designs (K1, K2, K5,
     K4, K3, K3t) with the registers and spills that ptxas reported,
     and K1, K2, K3 and K3t with their blocks per SM (K1 also its key
     split, and in the kernels line the device time of each pass,
     profiled after the last phase);
  4. agreement: the streaming runtime on the GPU (float32, kernels) and
     on the CPU (float32, plain versions) give the same poses on a
     small input, and ``RAFTGMA(use_pallas=True)`` (K3, K5) the same
     flows; the bf16 flow net (default and ``use_pallas=True``) on the
     GPU stays within a bound of its float32 flow;
  5. slice: the streaming odometry step through ``SlamRuntime`` at
     376x1232, 12 GMA iterations, bf16 flow compute, seeded random
     weights with a non-zero GMA gamma, with the kernels' launch counts
     read around the run (K1 once and K2 12 times per frame pair);
  6. slice_2x: the same at 752x2464, where the attention runs through
     K5 in every iteration (K5 and K2 12 times per pair, no K1);
  7. forced_streaming: the flow net built with ``use_pallas=True`` on
     the same weights and frames at 752x2464 (K3 4 times and K5 12
     times per pair), its flows against slice_2x's default path, and
     both builds' ms per pair;
  8. nlanes: the flow net built with ``corr_nlanes=True`` on the same
     weights and frames at 376x1232, streamed with the frame cache (K1
     once, K2 and K2n 12 times per pair), its flows against the default
     build's, and both builds' ms per pair;
  9. entry_points: the entry points of K3t (``build_pyramid_tiled``),
     K2s (``lookup_corr_pyramid_slab``) and K4
     (``apply_attention_probs(use_pallas=True)``) on the flow net's own
     feature maps, coordinates and probabilities at 376x1232, each
     against the default path's result;
  10. apply_probs_backward: K4's backward through its autograd.Function
      at the KITTI shape against the plain products;
  11. the ``kernels`` line, the card, and last the ``ok`` line.

The kernel lines of phase 3 also cover K2n (the three small KITTI
levels), K4 (K1's KITTI output), K2s (the row-padded KITTI pyramid) and
K3t (the KITTI pyramid).

``--profile N`` adds N more streaming steps under ``torch.profiler`` to
each slice's line and to both builds of the nlanes phase: device time
by kernel and the device's idle share.

Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (the bound of each kernel uses these)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FULL_HW = (376, 1232)
HW_2X = (752, 2464)  # 2x KITTI: 94 x 308 = 28952 attention tokens
K1_TOL = {"rtol": 2.0**-7, "atol": 1e-8}  # one bf16 ulp: both round a float32 softmax
K2_TOL = {"rtol": 1e-5, "atol": 1e-5}  # both lerp the same bf16 taps in float32
# bf16: both round exp(s - max) to bf16 (the kernel against its running
# max) and the float32 result once; outputs are ~0.01-1
K5_TOL = {"rtol": 2.0**-7, "atol": 2.0**-8}
K5_F32_TOL = {"rtol": 1e-5, "atol": 1e-5}  # float32 on both sides, summation order
K3_TOL = {"rtol": 2.0**-7, "atol": 1e-5}  # both round one float32 sum: one bf16 ulp
# K2n: the same two-term float32 sums and bf16 roundings on both sides
K2N_TOL = {"rtol": 1e-5, "atol": 1e-5}
K2S_TOL = {"rtol": 1e-5, "atol": 1e-5}  # both contract the same bf16 taps in float32
# K4: bf16 out of float32 sums taken in another order: one bf16 ulp
K4_TOL = {"rtol": 2.0**-7, "atol": 1e-5}
K4_GRAD_TOL = {"rtol": 1e-5, "atol": 1e-5}  # the same float32 products on both sides
FLOW_F32_TOL = 1e-3  # px, float32 flow on the GPU (TF32 off) against the CPU
# px at 1/8 resolution: forced and default 2x paths differ only where
# the float32 volume sums, taken in another order, round to another bf16
# (0.0034-0.0044 px measured on flows of ~0.9 px, seeded weights)
FLOW_FORCED_TOL = 0.02
# px at 1/8 resolution: the nlanes build rounds the hat weights and row
# sums of levels 1-3 through bf16 where the default K2 lerps in float32,
# a relative difference of up to 2^-8 in those lookups, carried through
# 12 iterations on seeded random weights (flows of ~1 px)
FLOW_NLANES_TOL = 0.05
# bf16 against float32 flows, as a share of the largest float32 flow: the
# JAX package's own bf16 flow differs from its float32 one by 1.0% (1/8
# resolution) and 0.71% (full) of it on the CPU test's input
# (tests/test_torch_models.py::test_raftgma_bf16_matches_jax_bf16), and
# the port's bf16 flow lies closer than that to the JAX bf16 flow. On
# this check's own input the port's plain versions on the CPU put bf16
# 0.91% and 0.45% away from float32. 2% allows about twice either gap
FLOW_BF16_REL = 0.02


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, device: torch.device, reps: int = 20) -> float:
    """Mean device time of one call: CUDA events around ``reps`` calls
    after a warm-up (host clock on the CPU).

    A call whose kernels run shorter than the host takes to launch them
    would be timed at its launch rate, so the device first spins for
    longer than the host needs to enqueue all ``reps`` calls: the
    events then bracket the calls' kernels back to back."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2.0 * enqueue_s + 1e-3)))  # cycles, at most 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(source: str, kernel: str) -> dict:
    """What ``nvcc -Xptxas -v`` reported for the kernel of ``source``
    whose (mangled) name contains ``kernel``: registers, stack, spill
    stores and loads, and any warning that names wgmma or setmaxnreg."""
    from atdn_vslam_torch.ops import _kernels

    path = _kernels.BUILD_DIR / f"{source}.ptxas.txt"
    if not path.exists():  # nothing built here (a rehearsal on the CPU)
        return {}
    out, current = {"warnings": []}, None
    log = path.read_text().splitlines()
    for line in log:
        if "Compiling entry function" in line:
            current = kernel in line
        elif ("wgmma" in line or "setmaxnreg" in line) and "Function properties" not in line:
            out["warnings"].append(line.strip())
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out["stack_bytes"], out["spill_store_bytes"], out["spill_load_bytes"] = nums[:3]
        elif current and "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> float:
    err = (got.float() - ref.float()).abs()
    if not torch.equal(torch.isfinite(got), torch.isfinite(ref)):
        raise AssertionError(f"{name}: non-finite values differ from the plain version")
    ok = (err <= atol + rtol * ref.float().abs()) | (got.float().isnan() & ref.float().isnan())
    max_err = float(torch.nan_to_num(err, nan=0.0).max())
    if not bool(ok.all()):
        raise AssertionError(
            f"{name}: {int((~ok).sum())} values outside rtol {rtol} atol {atol} "
            f"(max abs err {max_err})"
        )
    return max_err


K1_DESIGN = ("bf16: pass 1 split-KV statistics (q tile resident by TMA, 128-key k tiles in a "
             "2-stage mbarrier ring, 2 WG x wgmma m64n128k16, online max/sum in registers, "
             "(B, S, N) partials); pass 2 the K3 core (corr_dot_wgmma.cuh) with a softmax "
             "epilogue merging the S partials per block, 16-byte streaming row stores")


def kernel_ms(fn, device, kernels: dict, reps: int = 20) -> dict:
    """Mean device time per call of ``fn`` of each kernel it launches,
    under the label of ``kernels`` (label -> substring of the kernel's
    name), from ``torch.profiler`` over ``reps`` calls after a warm-up."""
    if device.type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    out = {label: 0.0 for label in kernels}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        for label, sub in kernels.items():
            if sub in e.key:
                out[label] += us / 1e3 / reps
    return out


def check_ptxas(name: str, reports: dict) -> dict:
    """Fail when ptxas reported spills or serialised wgmma (C7512) for any
    of ``reports`` (empty on the CPU, where nothing is built)."""
    for label, rep in reports.items():
        if rep and (rep.get("spill_store_bytes", 0) or rep.get("spill_load_bytes", 0)
                    or any("serialized" in w for w in rep["warnings"])):
            raise AssertionError(f"{name} {label}: ptxas reported spills or serialised wgmma: {rep}")
    return reports


def k1_inputs(device, hw8, d, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    n = hw8[0] * hw8[1]
    # GMA's q arrives pre-scaled by d**-0.5; scores come out with std ~1
    q = (torch.randn((1, n, d), generator=g, device=device) * d**-0.5).to(dtype)
    k = torch.randn((1, n, d), generator=g, device=device).to(dtype)
    return q, k


def k1_pass_ms(device, hw8=(47, 154), d=128, seed=0) -> dict:
    """Device ms of each pass of K1's bf16 kernel on the kernel line's
    inputs, from ``torch.profiler``: run after every timed phase, since
    the profiler leaves its hooks on every later launch of the process."""
    from atdn_vslam_torch.ops.attention import attention_probs_spatial

    q, k = k1_inputs(device, hw8, d, torch.bfloat16, seed)
    return kernel_ms(lambda: attention_probs_spatial(q, k, *hw8, 1.0), device,
                     {"stats": "probs_stats_wgmma_kernel", "write": "SoftmaxProbs"})


def k1_attention_probs(device, hw8=(47, 154), d=128, dtype=torch.bfloat16, seed=0) -> dict:
    from atdn_vslam_torch.ops import _kernels
    from atdn_vslam_torch.ops.attention import (
        _probs_splits,
        attention_probs_spatial,
        attention_probs_spatial_plain,
    )

    h, w = hw8
    n = h * w
    q, k = k1_inputs(device, hw8, d, dtype, seed)
    got = attention_probs_spatial(q, k, h, w, 1.0)
    ref = attention_probs_spatial_plain(q, k, h, w, 1.0)
    n_pad = got.shape[-1]
    if got.shape != ref.shape or n_pad % 128 or n_pad < n:
        raise AssertionError(f"attention_probs: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if bool((got[..., n:] != 0).any()):
        raise AssertionError("attention_probs: pad columns are not exact zeros")
    max_err = check_close("attention_probs", got, ref, **K1_TOL)

    def library():
        p = torch.softmax((q @ k.mT).float(), -1).to(q.dtype)
        return F.pad(p, (0, n_pad - n))

    bytes_moved = 2 * q.numel() * q.element_size() + got.numel() * got.element_size()
    bound_ms, bound_by = bound(bytes_moved, 2.0 * n * n * d, dtype)
    out = {
        "name": "attention_probs",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/attention_probs.cu",
        "replaces": "atdn_vslam_tpu/ops/attention.py:461",
        "shape": [1, n, d], "dtype": str(dtype), "tolerance": K1_TOL,
        "max_abs_err": max_err,
        "ms": time_ms(lambda: attention_probs_spatial(q, k, h, w, 1.0), device),
        "plain_ms": time_ms(lambda: attention_probs_spatial_plain(q, k, h, w, 1.0), device),
        "library_ms": time_ms(library, device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if device.type == "cuda" and dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = {"stats": _kernels.blocks_per_sm("attention_probs", device, 1, d),
                  "write": _kernels.blocks_per_sm("attention_probs", device, 2, d)}
        if blocks["write"] != 2:
            raise AssertionError(f"attention_probs: {blocks['write']} write blocks per SM, not 2")
        out.update({
            "design": K1_DESIGN, "splits": _probs_splits(1, n, n, sms),
            "ptxas": check_ptxas("attention_probs", {
                "stats": ptxas_report("attention_probs", f"probs_stats_wgmma_kernelILi{-(-d // 64)}E"),
                "write": ptxas_report("attention_probs", "SoftmaxProbs"),
            }),
            "blocks_per_sm": blocks,
        })
    return out


def _in_bound_taps(shapes, coords, radius: int, first_level: int = 0) -> int:
    """Taps of the (2r+2)^2 patches that lie inside their level (levels
    ``first_level``, ... of the given (rows, columns)): what a gather
    must read for these coordinates."""
    flat = coords.reshape(-1, 2).float()
    taps = torch.arange(2 * radius + 2, device=coords.device) - radius
    total = 0
    for level, (hl, wl) in enumerate(shapes, start=first_level):
        c = torch.floor(flat / 2.0**level)
        rows = ((c[:, 1:2] + taps >= 0) & (c[:, 1:2] + taps < hl)).sum(1)
        cols = ((c[:, 0:1] + taps >= 0) & (c[:, 0:1] + taps < wl)).sum(1)
        total += int((rows * cols).sum())
    return total


def lookup_inputs(device, hw8, c, dtype, seed):
    """Random bf16 feature maps and coordinates around the identity, 5%
    of them partly or wholly outside every level."""
    from atdn_vslam_torch.ops.bilinear import coords_grid

    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw8
    f1 = torch.randn((1, h, w, c), generator=g, device=device).to(dtype)
    f2 = torch.randn((1, h, w, c), generator=g, device=device).to(dtype)
    coords = coords_grid(h, w, device=device)[None]
    coords = coords + 6.0 * torch.randn(coords.shape, generator=g, device=device)
    far = torch.rand(coords.shape[:-1], generator=g, device=device) < 0.05
    coords[far] = coords[far] * 40.0 - 1000.0
    coords[0, 0, :3] = torch.tensor([[-3.5, -2.25], [w - 1.5, h + 0.75], [-20.0, 5.0]], device=device)
    return f1, f2, coords


def grid_sample_windows(levels, coords, radius: int, first_level: int = 0):
    """The reference CorrBlock's lookup, one ``grid_sample`` per level:
    ``levels`` are (N, 1, Hl, Wl) views, level ``first_level`` first."""
    span = 2 * radius + 1
    n = levels[0].shape[0]
    d = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).reshape(1, span, span, 2)
    outs = []
    for level, corr in enumerate(levels, start=first_level):
        hl, wl = corr.shape[-2:]
        xy = coords.reshape(n, 1, 1, 2) / 2**level + delta
        grid = torch.stack([2 * xy[..., 0] / (wl - 1) - 1, 2 * xy[..., 1] / (hl - 1) - 1], -1)
        outs.append(F.grid_sample(
            corr, grid.to(corr.dtype), mode="bilinear", padding_mode="zeros", align_corners=True,
        ))
    return outs


K2_DESIGN = ("one warp per query, all levels: a level's 100 taps over 32 lanes, all loads "
             "issued first, staged in shared memory as (tap, right neighbour) pairs; per "
             "level, outputs i, i + 32, ... per lane as consecutive floats")


def _k2_case(device, hw8, c, dtype, seed, radius):
    """K2 on the pyramid of random feature maps at ``hw8`` against its
    plain version: (pyramid, coords, max abs err, bytes the lookup must
    move)."""
    from atdn_vslam_torch.ops.corr_lookup import (
        build_corr_pyramid,
        lookup_corr_pyramid,
        lookup_corr_pyramid_plain,
    )

    f1, f2, coords = lookup_inputs(device, hw8, c, dtype, seed)
    pyramid = build_corr_pyramid(f1, f2, 4, dtype=dtype)
    got = lookup_corr_pyramid(pyramid, coords, radius)
    ref = lookup_corr_pyramid_plain(pyramid, coords, radius)
    if got.shape != ref.shape:
        raise AssertionError(f"corr_lookup: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    max_err = check_close(f"corr_lookup {hw8}", got, ref, **K2_TOL)
    bytes_moved = (
        _in_bound_taps([c.shape[-2:] for c in pyramid], coords, radius) * pyramid[0].element_size()
        + coords.numel() * 4 + got.numel() * got.element_size()
    )
    return pyramid, coords, max_err, bytes_moved


def k2_corr_lookup(device, hw8=(47, 154), c=256, dtype=torch.bfloat16, seed=1, radius=4,
                   hw8_2x=(94, 308)) -> dict:
    """K2 at KITTI (the kernel line's numbers) and at 2x KITTI
    (``*_2x``: 28952 queries, levels 94x308 ... 11x38)."""
    from atdn_vslam_torch.ops import _kernels
    from atdn_vslam_torch.ops.corr_lookup import lookup_corr_pyramid, lookup_corr_pyramid_plain

    pyramid, coords, max_err, bytes_moved = _k2_case(device, hw8, c, dtype, seed, radius)
    span = 2 * radius + 1
    n = hw8[0] * hw8[1]
    views = [corr.reshape(n, 1, *corr.shape[-2:]) for corr in pyramid]

    def library():
        return grid_sample_windows(views, coords, radius)

    bound_ms, bound_by = bound(bytes_moved, 0.0, dtype)
    out = {
        "name": "corr_lookup",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/corr_lookup.cu",
        "replaces": "atdn_vslam_tpu/ops/corr_lookup_pallas.py:84",
        "shape": [1, n, len(pyramid), span * span], "dtype": str(dtype), "tolerance": K2_TOL,
        "max_abs_err": max_err,
        "ms": time_ms(lambda: lookup_corr_pyramid(pyramid, coords, radius), device),
        "plain_ms": time_ms(lambda: lookup_corr_pyramid_plain(pyramid, coords, radius), device),
        "library_ms": time_ms(library, device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    pyramid, coords, max_err, bytes_moved = _k2_case(device, hw8_2x, c, dtype, seed, radius)
    out.update({
        "shape_2x": [1, hw8_2x[0] * hw8_2x[1], len(pyramid), span * span],
        "max_abs_err_2x": max_err,
        "ms_2x": time_ms(lambda: lookup_corr_pyramid(pyramid, coords, radius), device),
        "bound_ms_2x": bound(bytes_moved, 0.0, dtype)[0],
    })
    if device.type == "cuda":
        out.update({
            "design": K2_DESIGN,
            "ptxas": check_ptxas("corr_lookup", {
                "lookup": ptxas_report("corr_lookup", "corr_lookup_kernelI13__nv_bfloat16"),
            }),
            "blocks_per_sm": {"lookup": _kernels.blocks_per_sm("corr_lookup", device, 1)},
        })
    return out


def k5_flash_attend(device, n=94 * 308, d=128, seed=5) -> dict:
    from atdn_vslam_torch.ops.attention import flash_attend, flash_attend_plain

    g = torch.Generator(device=device).manual_seed(seed)
    # GMA's q arrives pre-scaled by d**-0.5; scores come out with std ~1
    q = (torch.randn((1, n, d), generator=g, device=device) * d**-0.5).to(torch.bfloat16)
    k = torch.randn((1, n, d), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((1, n, d), generator=g, device=device).to(torch.bfloat16)
    got = flash_attend(q, k, v, 1.0)
    max_err = check_close("flash_attend", got, flash_attend_plain(q, k, v, 1.0), **K5_TOL)
    # rectangular and ragged: Nq != Nk, neither a multiple of a tile
    nq, nk = 5003, n - 37
    rect = check_close(
        "flash_attend (rectangular)", flash_attend(q[:, :nq], k[:, :nk], v[:, :nk], 1.0),
        flash_attend_plain(q[:, :nq], k[:, :nk], v[:, :nk], 1.0), **K5_TOL,
    )
    # batch 2, ragged: 3001 queries and 4097 keys each (a last key tile
    # of one key); a box reaching past a batch's rows would read the next
    nq2, nk2 = min(3001, n // 2), min(4097, n // 2)
    q2, k2, v2 = (x[0, : 2 * r].reshape(2, r, d) for x, r in ((q, nq2), (k, nk2), (v, nk2)))
    batch2 = check_close(
        "flash_attend (batch 2)", flash_attend(q2, k2, v2, 1.0), flash_attend_plain(q2, k2, v2, 1.0), **K5_TOL,
    )
    qf, kf, vf = (x[:, :7238].float() for x in (q, k, v))
    f32 = check_close(
        "flash_attend (float32)", flash_attend(qf, kf, vf, 1.0),
        flash_attend_plain(qf, kf, vf, 1.0), **K5_F32_TOL,
    )
    bytes_moved = 4 * q.numel() * q.element_size()  # q, k, v read, out written
    bound_ms, bound_by = bound(bytes_moved, 2.0 * n * n * (d + d), torch.bfloat16)
    return {
        "name": "flash_attend",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/flash_attend.cu",
        "replaces": "atdn_vslam_tpu/ops/attention.py:125",
        "shape": [1, n, d], "dtype": "torch.bfloat16", "tolerance": K5_TOL,
        "max_abs_err": max_err,
        "rectangular": {"nq": nq, "nk": nk, "max_abs_err": rect},
        "batch2": {"nq": nq2, "nk": nk2, "max_abs_err": batch2},
        "float32": {"n": 7238, "max_abs_err": f32, "tolerance": K5_F32_TOL},
        "design": "tma+wgmma, 2 consumer WG x 64 rows + producer WG (setmaxnreg 24/240), "
                  "128-key k/v tiles in 2 stages, ping-pong",
        "ptxas": ptxas_report("flash_attend", "flash_bf16_kernel"),
        "ms": time_ms(lambda: flash_attend(q, k, v, 1.0), device),
        "plain_ms": time_ms(lambda: flash_attend_plain(q, k, v, 1.0), device, reps=5),
        # the yardstick only, the port never calls it; (B, heads, N, D)
        # views, the layout its fused kernels take
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=1.0),
            device,
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


K3_DESIGN = ("tma+wgmma core (corr_dot_wgmma.cuh): 128x128 tile per block of 2 consumer WG, "
             "3-stage ring of 64-channel boxes, 2 blocks per SM, shifted-row staging and "
             "16-byte streaming row-body stores")


def corr_dot_occupancy(source: str, device) -> dict:
    """Blocks per SM of the bf16-input kernel of ``source`` for bf16 and
    float32 output; the design keeps two for bf16 output."""
    from atdn_vslam_torch.ops import _kernels

    if device.type != "cuda":
        return {}
    blocks = {str(dt).split(".")[-1]: _kernels.blocks_per_sm(source, device, int(dt == torch.bfloat16))
              for dt in (torch.bfloat16, torch.float32)}
    if blocks["bfloat16"] != 2:
        raise AssertionError(f"{source}: {blocks['bfloat16']} blocks per SM for bf16 output, not 2")
    return blocks


def k3_corr_dot(device, n=94 * 308, c=256, seed=6) -> dict:
    from atdn_vslam_torch.ops.corr_lookup import corr_dot_rowmajor, corr_dot_rowmajor_plain

    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn((1, n, c), generator=g, device=device).to(torch.bfloat16)
    f2 = torch.randn((1, n, c), generator=g, device=device).to(torch.bfloat16)
    inv = c**-0.5
    got = corr_dot_rowmajor(f1, f2, inv, torch.bfloat16)
    max_err = check_close("corr_dot", got, corr_dot_rowmajor_plain(f1, f2, inv, torch.bfloat16), **K3_TOL)
    del got
    ragged = {}
    # 2x KITTI levels 1-3 and KITTI level 3: rows start at 4, 8, 4 and 8
    # alignments modulo 16 bytes
    for m in (7238, 1771, 418, 95):
        ragged[m] = check_close(
            f"corr_dot (M = {m})", corr_dot_rowmajor(f1, f2[:, :m], inv, torch.bfloat16),
            corr_dot_rowmajor_plain(f1, f2[:, :m], inv, torch.bfloat16), **K3_TOL,
        )
    f1s = f1 * inv  # exact: 1/16
    bytes_moved = 2 * f1.numel() * 2 + n * n * 2
    bound_ms, bound_by = bound(bytes_moved, 2.0 * n * n * c, torch.bfloat16)
    return {
        "name": "corr_dot",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/corr_dot.cu",
        "replaces": "atdn_vslam_tpu/ops/corr_lookup.py:44",
        "shape": [1, n, n, c], "dtype": "torch.bfloat16", "tolerance": K3_TOL,
        "max_abs_err": max_err, "ragged_max_abs_err": ragged,
        "design": K3_DESIGN,
        "ptxas": ptxas_report("corr_dot", "ScaleCastI13__nv_bfloat16"),
        "blocks_per_sm": corr_dot_occupancy("corr_dot", device),
        "ms": time_ms(lambda: corr_dot_rowmajor(f1, f2, inv, torch.bfloat16), device),
        "plain_ms": time_ms(lambda: corr_dot_rowmajor_plain(f1, f2, inv, torch.bfloat16), device, reps=5),
        "library_ms": time_ms(lambda: torch.matmul(f1s, f2.mT), device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def k2n_nlanes(device, hw8=(47, 154), c=256, dtype=torch.bfloat16, seed=7, radius=4) -> dict:
    """K2n over the three small levels of the KITTI nlanes pyramid, one
    launch, against its plain version; the library yardstick is
    ``grid_sample`` per level on (N, 1, Hl, Wl) views of the same
    volumes."""
    from atdn_vslam_torch.ops.corr_lookup_nlanes import (
        build_corr_pyramid_nlanes,
        nlanes_lookup_level_plain,
        nlanes_lookup_levels,
    )

    f1, f2, coords = lookup_inputs(device, hw8, c, dtype, seed)
    n = hw8[0] * hw8[1]
    vols = build_corr_pyramid_nlanes(f1, f2, 4, dtype)[1:]
    flat = coords.reshape(1, n, 2)

    def plain():
        return torch.cat([nlanes_lookup_level_plain(v, flat, i + 1, radius) for i, v in enumerate(vols)], -1)

    got = nlanes_lookup_levels(vols, flat, 1, radius)
    max_err = check_close("corr_lookup_nlanes", got, plain(), **K2N_TOL)
    views = [v.permute(0, 3, 1, 2).reshape(n, 1, *v.shape[1:3]) for v in vols]
    bytes_moved = (
        _in_bound_taps([v.shape[1:3] for v in vols], coords, radius, 1) * vols[0].element_size()
        + coords.numel() * 4 + got.numel() * got.element_size()
    )
    bound_ms, bound_by = bound(bytes_moved, 0.0, dtype)
    return {
        "name": "corr_lookup_nlanes",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/corr_lookup_nlanes.cu",
        "replaces": "atdn_vslam_tpu/ops/corr_lookup_nlanes.py:97",
        "shape": [1, n, len(vols), (2 * radius + 1) ** 2],
        "levels": [list(v.shape[1:3]) for v in vols], "dtype": str(dtype), "tolerance": K2N_TOL,
        "max_abs_err": max_err,
        "ms": time_ms(lambda: nlanes_lookup_levels(vols, flat, 1, radius), device),
        "plain_ms": time_ms(plain, device),
        "library_ms": time_ms(lambda: grid_sample_windows(views, coords, radius, 1), device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def k4_inputs(device, hw8, d, seed):
    """K1's probabilities of random q, k at ``hw8`` (bf16) and random
    values."""
    from atdn_vslam_torch.ops.attention import attention_probs_spatial

    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw8
    n = h * w
    q = (torch.randn((1, n, d), generator=g, device=device) * d**-0.5).to(torch.bfloat16)
    k = torch.randn((1, n, d), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((1, n, d), generator=g, device=device).to(torch.bfloat16)
    return attention_probs_spatial(q, k, h, w, 1.0), v, g


def k4_apply_probs(device, hw8=(47, 154), d=128, seed=8) -> dict:
    """K4 on K1's KITTI output (bf16 probabilities, 7238 x 7296) against
    random values, against its plain version."""
    from atdn_vslam_torch.ops.attention import flash_apply_probs, flash_apply_probs_plain

    probs, v, _ = k4_inputs(device, hw8, d, seed)
    n, n_pad = v.shape[1], probs.shape[-1]
    got = flash_apply_probs(probs, v)
    max_err = check_close("apply_probs", got, flash_apply_probs_plain(probs, v), **K4_TOL)
    # batch 2, ragged: 3001 rows of P and 3500 rows of v each; a box
    # reaching past a batch's rows would read the next batch's
    rows2, nv2 = min(3001, n // 2), min(3500, n // 2)
    p_b2 = probs.reshape(n, n_pad)[: 2 * rows2].reshape(2, 1, rows2, n_pad)
    v_b2 = v[0, : 2 * nv2].reshape(2, nv2, d)
    batch2 = check_close(
        "apply_probs (batch 2)", flash_apply_probs(p_b2, v_b2), flash_apply_probs_plain(p_b2, v_b2), **K4_TOL,
    )
    p2 = probs.reshape(1, n, n_pad)
    v_pad = F.pad(v, (0, 0, 0, n_pad - n))
    bytes_moved = probs.numel() * 2 + v.numel() * 2 + got.numel() * 2
    bound_ms, bound_by = bound(bytes_moved, 2.0 * n * n_pad * d, torch.bfloat16)
    return {
        "name": "apply_probs",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/apply_probs.cu",
        "replaces": "atdn_vslam_tpu/ops/attention.py:851",
        "shape": [1, n, n_pad, d], "dtype": "torch.bfloat16", "tolerance": K4_TOL,
        "max_abs_err": max_err,
        "batch2": {"rows": rows2, "values": nv2, "max_abs_err": batch2},
        "design": "tma+wgmma, 2 consumer WG x 64 rows + producer warp, 6 stages of 64 keys, "
                  "key split over the SMs, fixed-order fixup",
        "ptxas": ptxas_report("apply_probs", "apply_probs_bf16_kernel"),
        "ms": time_ms(lambda: flash_apply_probs(probs, v), device),
        "plain_ms": time_ms(lambda: flash_apply_probs_plain(probs, v), device),
        "library_ms": time_ms(lambda: torch.matmul(p2, v_pad), device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def k4_backward(device, hw8=(47, 154), d=128, seed=8) -> dict:
    """K4's backward on the card: gradients through its autograd.Function
    (K4 forward, then the two float32 products of the JAX package's VJP)
    on the kernel line's inputs, against the same products written out,
    and the pad columns of P getting exactly zero. Run after the slices:
    autograd's device thread keeps a cuBLAS workspace of its own, which
    would otherwise count in the slices' peak memory."""
    from atdn_vslam_torch.ops.attention import flash_apply_probs

    probs, v, g = k4_inputs(device, hw8, d, seed)
    n, n_pad = v.shape[1], probs.shape[-1]
    p_t, v_t = probs.clone().requires_grad_(), v.clone().requires_grad_()
    cot = torch.randn((1, *hw8, d), generator=g, device=device).to(torch.bfloat16)
    (flash_apply_probs(p_t, v_t) * cot).sum().backward()  # dout = cot, exactly
    df = cot.float().reshape(1, n, d)
    want_dv = torch.matmul(probs.reshape(1, n, n_pad)[..., :n].float().mT, df).to(v.dtype)
    want_dp = F.pad(torch.matmul(df, v.float().mT).to(probs.dtype), (0, n_pad - n))
    errs = {
        "dv": check_close("apply_probs dv", v_t.grad, want_dv, **K4_GRAD_TOL),
        "dp": check_close("apply_probs dP", p_t.grad.reshape(1, n, n_pad), want_dp, **K4_GRAD_TOL),
    }
    if bool((p_t.grad[..., n:] != 0).any()):
        raise AssertionError("apply_probs: the pad columns of P have a non-zero gradient")
    return {"shape": [1, n, n_pad, d], "max_abs_err": errs, "tolerance": K4_GRAD_TOL,
            "pad_columns_zero": True}


def k2s_slab(device, hw8=(47, 154), c=256, dtype=torch.bfloat16, seed=9, radius=4) -> dict:
    """K2s over the KITTI pyramid, rows padded once (level 0: 47 -> 56),
    against its plain version; the library yardstick is ``grid_sample``
    per level on the unpadded levels."""
    from atdn_vslam_torch.ops.corr_lookup import build_corr_pyramid
    from atdn_vslam_torch.ops.corr_lookup_slab import (
        lookup_corr_pyramid_slab,
        lookup_corr_pyramid_slab_plain,
        pad_pyramid_for_slab,
    )

    f1, f2, coords = lookup_inputs(device, hw8, c, dtype, seed)
    n = hw8[0] * hw8[1]
    pyramid = build_corr_pyramid(f1, f2, 4, dtype=dtype)
    padded, rows = pad_pyramid_for_slab(pyramid, radius)
    got = lookup_corr_pyramid_slab(padded, coords, radius, orig_rows=rows)
    ref = lookup_corr_pyramid_slab_plain(padded, coords, radius, orig_rows=rows)
    max_err = check_close("corr_lookup_slab", got, ref, **K2S_TOL)
    views = [corr.reshape(n, 1, *corr.shape[-2:]) for corr in pyramid]
    bytes_moved = (
        _in_bound_taps([c.shape[-2:] for c in pyramid], coords, radius) * pyramid[0].element_size()
        + coords.numel() * 4 + got.numel() * got.element_size()
    )
    bound_ms, bound_by = bound(bytes_moved, 0.0, dtype)
    return {
        "name": "corr_lookup_slab",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/corr_lookup_slab.cu",
        "replaces": "atdn_vslam_tpu/ops/corr_lookup_slab.py:154",
        "shape": [1, n, len(padded), (2 * radius + 1) ** 2],
        "padded_rows": [p.shape[2] for p in padded], "rows": list(rows),
        "dtype": str(dtype), "tolerance": K2S_TOL, "max_abs_err": max_err,
        "ms": time_ms(lambda: lookup_corr_pyramid_slab(padded, coords, radius, orig_rows=rows), device),
        "plain_ms": time_ms(lambda: lookup_corr_pyramid_slab_plain(padded, coords, radius, orig_rows=rows), device),
        "library_ms": time_ms(lambda: grid_sample_windows(views, coords, radius), device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def k3t_inputs(device, hw8, c, seed):
    """Random bf16 queries (1, N, C) and the four pyramid levels of a
    random map, level 0 the NHWC view of a channels-first (NCHW) map as
    the feature encoder gives it, levels 1-3 pooled from it."""
    from atdn_vslam_torch.ops.corr_lookup import pool_features

    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw8
    f1 = torch.randn((1, h * w, c), generator=g, device=device).to(torch.bfloat16)
    f2 = torch.randn((1, c, h, w), generator=g, device=device).to(torch.bfloat16).permute(0, 2, 3, 1)
    levels = [f2]
    for _ in range(3):
        levels.append(pool_features(levels[-1]))
    return f1, levels


def k3t_corr_dot_tiled(device, hw8=(47, 154), c=256, seed=10) -> dict:
    """K3t over the KITTI pyramid, four launches (level 0's f2 the NHWC
    view of a channels-first map, staged K-major by the kernel's own
    transposing pass), against its plain version; the library yardstick
    is one ``torch.matmul`` per level."""
    from atdn_vslam_torch.ops.corr_dot_tiled import corr_dot_tiled, corr_dot_tiled_plain

    f1, levels = k3t_inputs(device, hw8, c, seed)
    n = f1.shape[1]
    inv = c**-0.5
    max_err = max(
        check_close(f"corr_dot_tiled (level {i})", corr_dot_tiled(f1, f2l, inv),
                    corr_dot_tiled_plain(f1, f2l, inv), **K3_TOL)
        for i, f2l in enumerate(levels)
    )
    f1s = f1 * inv  # exact: 1/16
    mats = [f2l.flatten(1, 2).mT for f2l in levels]  # views, level 0's included
    m = sum(f2l.shape[1] * f2l.shape[2] for f2l in levels)
    bytes_moved = (f1.numel() + m * c) * 2 + n * m * 2
    bound_ms, bound_by = bound(bytes_moved, 2.0 * n * m * c, torch.bfloat16)
    return {
        "name": "corr_dot_tiled",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/corr_dot_tiled.cu",
        "replaces": "tools/profiling/exp_r5_tileddot.py:47",
        "shape": [1, n, m, c], "levels": [list(f2l.shape[1:3]) for f2l in levels],
        "staged_levels": [i for i, f2l in enumerate(levels)
                          if not (f2l.is_contiguous() and f2l.data_ptr() % 16 == 0)],
        "calls": len(levels), "dtype": "torch.bfloat16", "tolerance": K3_TOL, "max_abs_err": max_err,
        "design": K3_DESIGN + "; a non-contiguous f2 staged K-major by a shared-memory transpose",
        "ptxas": ptxas_report("corr_dot_tiled", "ScaleCastI13__nv_bfloat16"),
        "blocks_per_sm": corr_dot_occupancy("corr_dot_tiled", device),
        "ms": time_ms(lambda: [corr_dot_tiled(f1, f2l, inv) for f2l in levels], device),
        "plain_ms": time_ms(lambda: [corr_dot_tiled_plain(f1, f2l, inv) for f2l in levels], device),
        "library_ms": time_ms(lambda: [torch.matmul(f1s, x) for x in mats], device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def seeded_weights(cfg, seed: int, gamma: float = 0.5):
    """Random flow and odometry weights from ``seed`` (CPU float32
    state dicts), with GMA's gamma set non-zero so the attention path
    contributes."""
    from atdn_vslam_torch.models.factory import (
        build_flow_model,
        build_odometry_model,
        init_params,
    )

    flow = init_params(build_flow_model(cfg, "cpu"), seed)
    with torch.no_grad():
        flow.update_block.aggregator.gamma.fill_(gamma)
    odo = init_params(build_odometry_model(cfg, "cpu"), seed + 1)
    return flow.state_dict(), odo.state_dict()


def synthetic_frames(n: int, hw: tuple[int, int], seed: int) -> list[np.ndarray]:
    """A smooth random texture seen by a camera panning 3 px right and
    1 px down per frame."""
    h, w = hw
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // 4 + n, w // 4 + n)).astype(np.float32))
    big = F.interpolate(coarse, scale_factor=4, mode="bilinear", align_corners=False)[0]
    big = big.permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
    return [np.ascontiguousarray(big[i : i + h, 3 * i : 3 * i + w]) for i in range(n)]


def run_stream(rt, frames) -> tuple[np.ndarray, list[float]]:
    """Stream ``frames`` through a runtime in odometry mode; poses and
    per-frame wall times (each call ends in a host copy of the pose)."""
    poses, times = [], []
    for f in frames:
        t0 = time.perf_counter()
        poses.append(rt(f))
        times.append((time.perf_counter() - t0) * 1e3)
    rt.keyframes.flush()
    return np.stack(poses), times


def new_runtime(cfg, weights, device):
    from atdn_vslam_torch.slam import SlamRuntime

    rt = SlamRuntime(cfg, *weights, device=device)
    rt.start_odometry()
    return rt


def profile_frames(step, frames, top: int = 25) -> dict:
    """Device time by kernel over ``step(f)`` for each of ``frames``
    (more streaming steps, under ``torch.profiler``), and the share of
    the wall time the device was busy (one stream, so kernel times do
    not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            step(f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3 / len(frames), e.count // len(frames)))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    per_frame = wall_ms / len(frames)
    return {
        "frames": len(frames), "wall_ms_per_frame": per_frame,
        "device_busy_ms_per_frame": busy, "device_idle_share": 1.0 - busy / per_frame,
        "kernel_launches_per_frame": sum(r[2] for r in rows),
        "top": [{"kernel": k[:90], "ms_per_frame": ms, "calls_per_frame": c}
                for k, ms, c in rows[:top]],
    }


def _counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from atdn_vslam_torch.ops.attention import attention_probs_spatial, flash_apply_probs, flash_attend
    from atdn_vslam_torch.ops.corr_dot_tiled import corr_dot_tiled
    from atdn_vslam_torch.ops.corr_lookup import corr_dot_rowmajor, lookup_corr_pyramid
    from atdn_vslam_torch.ops.corr_lookup_nlanes import nlanes_lookup_levels
    from atdn_vslam_torch.ops.corr_lookup_slab import lookup_corr_pyramid_slab

    return {
        "attention_probs": attention_probs_spatial, "corr_lookup": lookup_corr_pyramid,
        "corr_dot": corr_dot_rowmajor, "flash_attend": flash_attend,
        "corr_lookup_nlanes": nlanes_lookup_levels, "apply_probs": flash_apply_probs,
        "corr_lookup_slab": lookup_corr_pyramid_slab, "corr_dot_tiled": corr_dot_tiled,
    }


def launches_of(**counts) -> dict:
    """Every kernel's launch count: the given ones, zero for the rest."""
    return {name: counts.get(name, 0) for name in _counters()}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def flow_config(keyframes_path: str, hw, iters: int, bf16: bool):
    from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig

    return Config(
        keyframes_path=keyframes_path,
        flow=FlowNetConfig(iters=iters, mixed_precision=bf16),
        slam=SlamConfig(image_height=hw[0], image_width=hw[1]),
    )


def agreement(device, keyframes_path: str, hw=(96, 192), iters=2, frames=4) -> dict:
    """Poses of the runtime on ``device`` (float32) against the CPU's
    plain versions, same weights and frames; then the flows of
    ``RAFTGMA(use_pallas=True)`` (K3 and K5 on the GPU) and of
    ``RAFTGMA(corr_nlanes=True)`` (K1, K2 and K2n) against the CPU's, on
    the first pair; last the bf16 flows of the default and the
    ``use_pallas=True`` build against their float32 flows on the card
    (``FLOW_BF16_REL``)."""
    from atdn_vslam_torch.models.factory import build_flow_model

    cfg = flow_config(keyframes_path, hw, iters, bf16=False)
    weights = seeded_weights(cfg, seed=3)
    clip = synthetic_frames(frames, hw, seed=4)
    got, _ = run_stream(new_runtime(cfg, weights, device), clip)
    ref, _ = run_stream(new_runtime(cfg, weights, torch.device("cpu")), clip)
    err = float(np.abs(got - ref).max())
    tol = 1e-4  # float32 on both sides, TF32 off; summation order differs
    if not np.isfinite(got).all() or err > tol:
        raise AssertionError(f"agreement: max pose difference {err} > {tol}")

    out = {"hw": list(hw), "iters": iters, "frames": frames, "max_abs_pose_diff": err, "tol": tol}
    variants = {
        "use_pallas_true": ({"use_pallas": True},
                            launches_of(corr_lookup=iters, corr_dot=4, flash_attend=iters)),
        "corr_nlanes": ({"corr_nlanes": True},
                        launches_of(attention_probs=1, corr_lookup=iters, corr_lookup_nlanes=iters)),
    }
    for name, (switch, want) in variants.items():
        flows, launches = {}, None
        for dev in (device, torch.device("cpu")):
            model = build_flow_model(cfg, dev, **switch)
            model.load_state_dict(weights[0])
            im1, im2 = (torch.from_numpy(f).to(dev).float()[None] for f in clip[:2])
            reset_launches()
            with torch.inference_mode():
                flows[dev.type] = [f.cpu() for f in model(im1, im2)]
            if dev.type == "cuda":
                launches = read_launches()
                if launches != want:
                    raise AssertionError(f"agreement: {name} launched {launches}, not {want}")
        flow_err = max(
            float((a - b).abs().max()) for a, b in zip(flows[device.type], flows["cpu"])
        )
        if not all(bool(f.isfinite().all()) for f in flows[device.type]) or flow_err > FLOW_F32_TOL:
            raise AssertionError(f"agreement: {name} flow difference {flow_err} > {FLOW_F32_TOL}")
        out[name] = {"launches": launches, "max_abs_flow_diff_px": flow_err, "tol_px": FLOW_F32_TOL}

    # the bf16 build (the timed slices' type) against the float32 build on
    # the card, same weights and pair: the default build and use_pallas=True
    # (K3's bf16 core builds the pyramid there)
    bf16_cfg = flow_config(keyframes_path, hw, iters, bf16=True)
    im1, im2 = (torch.from_numpy(f).to(device).float()[None] for f in clip[:2])
    for name, switch, want in (
        ("bf16_default", {}, None),
        ("bf16_use_pallas_true", {"use_pallas": True},
         launches_of(corr_lookup=iters, corr_dot=4, flash_attend=iters)),
    ):
        flows = {}
        for c in (cfg, bf16_cfg):
            model = build_flow_model(c, device, **switch)
            model.load_state_dict(weights[0])
            reset_launches()
            with torch.inference_mode():
                flows[c.flow.mixed_precision] = [f.float().cpu() for f in model(im1, im2)]
        launches = read_launches()
        if want is not None and device.type == "cuda" and launches != want:
            raise AssertionError(f"agreement: {name} launched {launches}, not {want}")
        res = {}
        for key, a, b in zip(("low", "up"), flows[True], flows[False]):
            diff, scale = float((a - b).abs().max()), float(b.abs().max())
            if not bool(a.isfinite().all()) or diff > FLOW_BF16_REL * scale:
                raise AssertionError(
                    f"agreement: {name} {key} flow differs from float32 by {diff} px "
                    f"> {FLOW_BF16_REL} x {scale} px"
                )
            res[key] = {"max_abs_diff_px": diff, "max_abs_flow_px": scale}
        out[name] = {**res, "launches": launches, "rel_tol": FLOW_BF16_REL}
    return out


def expected_launches(hw, iters: int, pairs: int) -> dict:
    """The default path's launches: K2 every iteration; K1 once per pair
    up to 8192 tokens, K5 every iteration from 16384 on; no K3."""
    n = (hw[0] // 8) * (hw[1] // 8)
    return launches_of(
        attention_probs=pairs if n <= 8192 else 0,
        corr_lookup=iters * pairs,
        flash_attend=iters * pairs if n >= 16384 else 0,
    )


def stream_slice(
    device, keyframes_path: str, hw=FULL_HW, iters=12, frames=20, profile: int = 0
) -> dict:
    cfg = flow_config(keyframes_path, hw, iters, bf16=True)
    weights = seeded_weights(cfg, seed=0)
    clip = synthetic_frames(frames + profile, hw, seed=1)
    rt = new_runtime(cfg, weights, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    poses, times = run_stream(rt, clip[:frames])
    launches = read_launches()
    pairs = frames - 1
    if poses.shape != (frames, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError("slice: poses are not finite 4x4 matrices")
    want = expected_launches(hw, iters, pairs)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"slice {hw}: launches {launches} for {pairs} frame pairs, not {want}")
    steady = times[min(3, frames - 1):]  # the first pairs include cuDNN's autotuning
    ms = float(np.mean(steady))
    out = {
        "hw": list(hw), "tokens": (hw[0] // 8) * (hw[1] // 8), "iters": iters,
        "frames": frames, "dtype": "bfloat16",
        "launches": launches, "ms_per_frame": ms, "frames_per_s": 1e3 / ms,
        "ms_per_frame_median": float(np.median(steady)),
        "ms_per_frame_p90": float(np.percentile(steady, 90)),
        "frame_ms": times, "steady_frames": len(steady),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
        "final_translation": poses[-1, :3, 3].tolist(),
    }
    if profile:
        out["profile"] = profile_frames(rt, clip[frames:])
    return out


def forced_streaming(device, hw=HW_2X, iters=12, pairs=5) -> dict:
    """The flow net with ``use_pallas=True`` (K3 builds the pyramid, K5
    attends in every iteration) against the default build, on the
    weights (seed 0) and frames (seed 1) of the slices: launches, flows,
    and each build's ms per pair (host clock around each synchronised
    pair; the first pair is left out)."""
    from atdn_vslam_torch.models.factory import build_flow_model

    cfg = flow_config(os.devnull, hw, iters, bf16=True)
    flow_sd, _ = seeded_weights(cfg, seed=0)
    models = {}
    for use_pallas in (True, None):
        models[use_pallas] = build_flow_model(cfg, device, use_pallas=use_pallas)
        models[use_pallas].load_state_dict(flow_sd)
    ims = [torch.from_numpy(f).to(device).float()[None] for f in synthetic_frames(pairs + 1, hw, seed=1)]
    flows, times, launches = {}, {}, None
    with torch.inference_mode():
        for use_pallas, model in models.items():
            reset_launches()
            flows[use_pallas], times[use_pallas] = [], []
            for i in range(pairs):
                _sync(device)
                t0 = time.perf_counter()
                flows[use_pallas].append(model(ims[i], ims[i + 1])[0])
                _sync(device)
                times[use_pallas].append((time.perf_counter() - t0) * 1e3)
            if use_pallas:
                launches = read_launches()
    want = launches_of(corr_lookup=iters * pairs, corr_dot=4 * pairs, flash_attend=iters * pairs)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"forced_streaming: launches {launches} for {pairs} pairs, not {want}")
    diff = max(float((a - b).abs().max()) for a, b in zip(flows[True], flows[None]))
    scale = max(float(f.abs().max()) for f in flows[None])
    if not all(bool(f.isfinite().all()) for f in flows[True]) or diff > FLOW_FORCED_TOL:
        raise AssertionError(f"forced_streaming: low-res flows differ by {diff} > {FLOW_FORCED_TOL}")
    return {
        "hw": list(hw), "iters": iters, "pairs": pairs, "launches": launches,
        "max_abs_flow_low_diff_px": diff, "max_abs_flow_low_px": scale, "tol_px": FLOW_FORCED_TOL,
        "ms_per_pair": float(np.mean(times[True][1:])),
        "ms_per_pair_default": float(np.mean(times[None][1:])),
        "pair_ms": times[True], "pair_ms_default": times[None],
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nlanes(device, hw=FULL_HW, iters=12, pairs=6, profile: int = 0) -> dict:
    """The flow net built with ``corr_nlanes=True`` and the default
    build, on the slices' weights (seed 0) and frames (seed 1), each
    streamed over ``pairs`` frame pairs with the frame cache (image2's
    feature map comes back as the next pair's ``fmap1``): launches per
    pair, the low-res flows of the two builds against each other, and
    ms per pair (host clock around each synchronised pair; the first
    pair is left out). ``profile`` more pairs of each build run under
    ``torch.profiler``."""
    from atdn_vslam_torch.models.factory import build_flow_model

    cfg = flow_config(os.devnull, hw, iters, bf16=True)
    flow_sd, _ = seeded_weights(cfg, seed=0)
    frames = synthetic_frames(pairs + profile + 1, hw, seed=1)
    ims = [torch.from_numpy(f).to(device).float()[None] for f in frames]
    runs, profiles = {}, {}
    for corr_nlanes in (True, False):
        model = build_flow_model(cfg, device, corr_nlanes=corr_nlanes)
        model.load_state_dict(flow_sd)
        flows, times = [], []
        state = {}

        def step(i):
            (low, _), state["fmap"] = model(ims[i], ims[i + 1], fmap1=state["fmap"], return_features=True)
            return low

        with torch.inference_mode():
            state["fmap"] = model(ims[0], encode_only=True)
            reset_launches()
            for i in range(pairs):
                _sync(device)
                t0 = time.perf_counter()
                flows.append(step(i))
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            runs[corr_nlanes] = (flows, times, read_launches())
            if profile:
                profiles[corr_nlanes] = profile_frames(step, range(pairs, pairs + profile))
    want = {
        True: launches_of(attention_probs=pairs, corr_lookup=iters * pairs,
                          corr_lookup_nlanes=iters * pairs),
        False: expected_launches(hw, iters, pairs),
    }
    for corr_nlanes, (_, _, launches) in runs.items():
        if device.type == "cuda" and launches != want[corr_nlanes]:
            raise AssertionError(
                f"nlanes: corr_nlanes={corr_nlanes} launched {launches} for {pairs} pairs, "
                f"not {want[corr_nlanes]}"
            )
    diff = max(float((a - b).abs().max()) for a, b in zip(runs[True][0], runs[False][0]))
    scale = max(float(f.abs().max()) for f in runs[False][0])
    if not all(bool(f.isfinite().all()) for f in runs[True][0]) or diff > FLOW_NLANES_TOL:
        raise AssertionError(f"nlanes: low-res flows differ from the default build by {diff} > {FLOW_NLANES_TOL}")
    return {
        "hw": list(hw), "iters": iters, "pairs": pairs, "dtype": "bfloat16",
        "launches": runs[True][2], "launches_default": runs[False][2],
        "max_abs_flow_low_diff_px": diff, "max_abs_flow_low_px": scale, "tol_px": FLOW_NLANES_TOL,
        "ms_per_pair": float(np.mean(runs[True][1][1:])),
        "ms_per_pair_default": float(np.mean(runs[False][1][1:])),
        "pair_ms": runs[True][1], "pair_ms_default": runs[False][1],
        **({"profile": profiles[True], "profile_default": profiles[False]} if profile else {}),
    }


def entry_points(device, hw=FULL_HW, iters=12, pairs=3) -> dict:
    """The entry points of K3t, K2s and K4 on the flow net's own tensors
    (the slices' weights and frames, bf16): per frame pair, the pyramid
    of the two feature maps through ``build_pyramid_tiled`` (K3t, four
    launches; level 0's f2 is the NHWC view of the encoder's NCHW
    output) against ``build_corr_pyramid``; its row-padded copy looked
    up through ``lookup_corr_pyramid_slab`` (K2s, one launch) at the
    default flow net's final coordinates, against ``lookup_corr_pyramid``
    (K2); and K1's probabilities of the pair's context read through
    ``apply_attention_probs(use_pallas=True)`` (K4, one launch) with the
    aggregator's values, against the default read."""
    from atdn_vslam_torch.models.factory import build_flow_model
    from atdn_vslam_torch.ops.attention import apply_attention_probs, attention_probs_spatial
    from atdn_vslam_torch.ops.bilinear import coords_grid
    from atdn_vslam_torch.ops.corr_dot_tiled import build_pyramid_tiled
    from atdn_vslam_torch.ops.corr_lookup import build_corr_pyramid, lookup_corr_pyramid
    from atdn_vslam_torch.ops.corr_lookup_slab import lookup_corr_pyramid_slab, pad_pyramid_for_slab

    cfg = flow_config(os.devnull, hw, iters, bf16=True)
    flow_sd, _ = seeded_weights(cfg, seed=0)
    model = build_flow_model(cfg, device)
    model.load_state_dict(flow_sd)
    ims = [torch.from_numpy(f).to(device).float()[None] for f in synthetic_frames(pairs + 1, hw, seed=1)]
    errs = {"corr_dot_tiled": 0.0, "corr_lookup_slab": 0.0, "apply_probs": 0.0}
    counts = launches_of()
    with torch.inference_mode():
        for i in range(pairs):
            low, _ = model(ims[i], ims[i + 1])
            x1, x2 = model._prep(ims[i]), model._prep(ims[i + 1])
            f1, f2 = (model.fnet(x).permute(0, 2, 3, 1) for x in (x1, x2))  # NHWC views
            ctx = model.cnet(x1)
            inp = torch.relu(ctx[:, model.hidden_dim:])
            q, k = model.att(inp)
            b, _, h8, w8 = inp.shape
            v = model.update_block.aggregator.to_v(inp).reshape(b, -1, h8 * w8).transpose(1, 2)
            probs = attention_probs_spatial(q, k, h8, w8, scale=1.0)
            coords = coords_grid(h8, w8, device=device)[None] + low.float()
            default = build_corr_pyramid(f1, f2, 4, dtype=model.dtype)

            reset_launches()
            tiled = build_pyramid_tiled(f1, f2, 4, model.dtype)
            padded, rows = pad_pyramid_for_slab(default)
            slab = lookup_corr_pyramid_slab(padded, coords, orig_rows=rows)
            out = apply_attention_probs(probs, v, use_pallas=True)
            for name, n in read_launches().items():
                counts[name] += n

            errs["corr_dot_tiled"] = max([errs["corr_dot_tiled"]] + [
                check_close(f"entry_points: build_pyramid_tiled level {lv}", a, r, **K3_TOL)
                for lv, (a, r) in enumerate(zip(tiled, default))
            ])
            errs["corr_lookup_slab"] = max(errs["corr_lookup_slab"], check_close(
                "entry_points: lookup_corr_pyramid_slab", slab, lookup_corr_pyramid(default, coords), **K2S_TOL
            ))
            errs["apply_probs"] = max(errs["apply_probs"], check_close(
                "entry_points: apply_attention_probs(use_pallas=True)", out,
                apply_attention_probs(probs, v), **K4_TOL,
            ))
    want = launches_of(corr_dot_tiled=4 * pairs, corr_lookup_slab=pairs, apply_probs=pairs)
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"entry_points: launched {counts} for {pairs} pairs, not {want}")
    return {"hw": list(hw), "pairs": pairs, "launches": counts, "max_abs_err": errs,
            "tolerance": {"corr_dot_tiled": K3_TOL, "corr_lookup_slab": K2S_TOL, "apply_probs": K4_TOL}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write every phase's result to this JSON file")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="after each slice and each build of the nlanes phase, profile N more "
                        "streaming steps with torch.profiler")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from atdn_vslam_torch.ops import _kernels
    except ImportError as e:
        print(f"chip_smoke: the atdn_vslam_torch package is missing ({e})", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    results: dict = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    results["device"] = {
        "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit("device", **results["device"])

    t0 = time.perf_counter()
    logs = _kernels.build_all()
    results["build"] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": {
            name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for name, log in logs.items()
        },
    }
    emit("build", **results["build"])

    kernels = [k1_attention_probs(device), k2_corr_lookup(device)]
    kernels += [k5_flash_attend(device), k3_corr_dot(device)]
    torch.cuda.empty_cache()
    kernels += [k2n_nlanes(device), k4_apply_probs(device), k2s_slab(device), k3t_corr_dot_tiled(device)]
    torch.cuda.empty_cache()
    for k in kernels:
        emit("kernel", card=card, **k)

    work = os.path.join(REPO, "build", "chip_smoke")
    results["agreement"] = agreement(device, os.path.join(work, "agree_keyframes"))
    emit("agreement", **results["agreement"])

    results["slice"] = stream_slice(
        device, os.path.join(work, "keyframes"), profile=args.profile
    )
    emit("slice", card=card, **results["slice"])
    results["slice_2x"] = stream_slice(
        device, os.path.join(work, "keyframes_2x"), hw=HW_2X, frames=10, profile=args.profile
    )
    emit("slice_2x", card=card, **results["slice_2x"])
    results["forced_streaming"] = forced_streaming(device)
    emit("forced_streaming", card=card, **results["forced_streaming"])
    results["nlanes"] = nlanes(device, profile=args.profile)
    emit("nlanes", card=card, **results["nlanes"])
    results["entry_points"] = entry_points(device)
    emit("entry_points", card=card, **results["entry_points"])
    results["apply_probs_backward"] = k4_backward(device)
    emit("apply_probs_backward", card=card, **results["apply_probs_backward"])
    kernels[0]["pass_ms"] = k1_pass_ms(device)

    # each kernel's launches from the run of the path that drives it
    driver = {"attention_probs": "slice", "corr_lookup": "slice",
              "flash_attend": "slice_2x", "corr_dot": "forced_streaming",
              "corr_lookup_nlanes": "nlanes", "apply_probs": "entry_points",
              "corr_lookup_slab": "entry_points", "corr_dot_tiled": "entry_points"}
    for k in kernels:
        k["launches_from"] = driver[k["name"]]
        k["launches"] = results[driver[k["name"]]]["launches"][k["name"]]
    results["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extras = ("design", "ptxas", "blocks_per_sm", "splits", "pass_ms", "ms_2x", "bound_ms_2x",
              "max_abs_err_2x")
    print(json.dumps({"kernels": [{key: k[key] for key in keys + extras if key in k}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
