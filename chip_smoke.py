#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out results.json] [--profile N]

Phases, each printing one JSON line; any failure exits non-zero:

  1. device: the ``nvidia-smi`` name and power limit, torch and CUDA
     versions;
  2. build: compiles every CUDA kernel of the port with ``nvcc``;
  3. kernels: each kernel against its plain PyTorch version at the
     shapes its path gives it (K1, K2: KITTI 376x1232 -> 47x154 = 7238
     tokens, K2 and K2n also at 2x KITTI; K5, K3: 2x KITTI 752x2464 ->
     94x308 = 28952 tokens), with its time, the plain version's, one
     library call's and the least time the card could take (the bound);
     K5 and K4 also on a ragged batch of two; the Hopper designs (K1,
     K2, K5, K4, K3, K2n, K2s, K3t) with the registers and spills that
     ptxas reported, and K1, K2, K3, K2n, K2s and K3t with their blocks
     per SM (K1 also its key split, and in the kernels line the device
     time of each pass, profiled after the last phase);
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
  11. mapping: the map and relocalisation at 376x1232 (full MappingVAE
      widths, bf16, the slices' flow and odometry weights): 32 frames
      streamed as keyframes, ``end_odometry`` trains the map (2 epochs,
      batch 16) and embeds the keyframes, 4 keyframes' own frames are
      queried cold and again warm (self-retrieval; K1 once and K2 12
      times per query), a warm start from the saved map answers a query
      as the runtime that built it; at 96x192, one float32 train step on
      the GPU (TF32 off) against the CPU and the bf16 code against the
      float32 code;
  12. loop_closure: at 376x1232 on the slices' weights (bf16 flow, zero
      keyframe thresholds), 12 frames out and the same 12 positions back,
      streamed; ``end_odometry`` (2 map epochs); the closure pairs from
      the embeddings, each measured with keyframe i's feature map cold,
      then cached (K1 once and K2 12 times per measurement);
      ``close_loops``; the solve of its graph on the card against the
      CPU (``LOOP_POSE_TOL``), its ms and the residual before and after;
  13. pose_graph: seeded drifted chains with closures, dense at 200 and
      1000 poses, CG at 200, 1000 and 5000, 10 Gauss-Newton iterations
      and 100 CG steps: ms after one warm-up, the residual before and
      after, and at 200 poses both solvers' poses against the CPU's;
  14. odometry_train: ATDNVO at the reference training configuration
      (``configs/kitti.yaml``: batch 24, 6 flows per window, 376x1232,
      float32), 5 steps on seeded synthetic flows and poses, each step's
      ms and the peak memory; at 72x96 one float32 step on the card
      against the CPU (loss, gradients, batch statistics);
  15. flow_train_agreement: one float32 flow train step (TF32 off) at
      96x192, batch 2, 3 iterations, on the card (K1, K2 and their
      backward passes) against the CPU: loss, every gradient
      (``FLOW_GRAD_REL``), batch statistics, parameters after the step;
      then the same step in the slice's bf16 compute on the card against
      the float64 step (``TRAIN_BF16_LOSS_RTOL``, ``TRAIN_BF16_REL``);
  16. flow_train: the flow-training configuration (``FLOW_TRAIN``: full
      GMA widths, 288x960 crops, batch 6, 12 iterations, bf16 compute
      with float32 parameters) on shifted synthetic textures: a warm-up
      step, 5 timed steps with finite losses, K1 once and K2 12 times per
      step, peak memory, then 2 steps with ``remat=True`` (K2 24 times
      per step) and their peak memory; K1 and K2 against their plain
      versions at its batch-6 shapes;
  17. serving: the streaming step exported (``atdn_vslam_torch/serving.py``,
      ``torch.export``; every kernel an ``atdn::`` custom op) at
      376x1232, 12 iterations, bf16, with the encoder; a fresh process
      that imports ``atdn_vslam_torch.serving`` alone loads both and
      streams 17 frames (K1 once, K2 12 times per frame, counted there),
      its flows and chained poses against the eager step; the artifact's
      and the eager step's ms per frame, export and load seconds, the
      artifact's bytes; then, float32 at 96x192, the ``use_pallas=True``
      (K3 4, K5 12 per frame) and ``corr_nlanes=True`` (K1 1, K2 12, K2n
      12) artifacts against eager, the default artifact moved to the CPU
      (``move_to_device_pass``) against the CPU eager step, and the
      weights as arguments with a second seed's weights;
  18. positional: GMA's ``position_and_content`` and ``position_only``
      in float32 at 96x192 on the card against the CPU, then
      ``position_and_content`` at 376x1232, bf16, 12 iterations, 6 pairs
      with the frame cache: ms per pair, peak memory, K1 0 and K2 12 per
      pair, bf16 against float32 flows;
  19. the ``kernels`` line (each kernel with its op, ``atdn::<name>``),
      the card, and last the ``ok`` line.

After phase 10, k1_backward, k2_backward and k3_backward: each backward
pass through its autograd.Function at the KITTI shape, float32 against
autograd through the plain version on the card, then its bf16 ms
against the bound of its bytes and products (``backward_*`` in the
kernels line).

The lines of phases 12-18 carry their own ``seconds``.

The kernel lines of phase 3 also cover K2n (the three small KITTI
levels), K4 (K1's KITTI output), K2s (the row-padded KITTI pyramid) and
K3t (the KITTI pyramid).

``--profile N`` adds N more streaming steps under ``torch.profiler`` to
each slice's line and to both builds of the nlanes phase, N map train
steps and N warm queries to the mapping line, N solves to each
pose-graph case and N train steps to the odometry_train and flow_train
lines: device time by kernel and the device's idle share.

Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import Counter

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
# one float32 map train step on the GPU (TF32 off) against the CPU: the
# tolerances the CPU tests hold the port's step to against the JAX
# package (tests/test_torch_mapping_train.py)
MAP_LOSS_RTOL = 1e-6
MAP_GRAD_REL = 1e-3  # of each tensor's largest gradient
MAP_STATS_TOL = {"rtol": 1e-5, "atol": 1e-5}
# the bf16 code against the float32 code, as a share of the largest
# float32 code: the JAX package's own bf16 bound (tests/test_training.py:210)
MAP_BF16_REL = 0.05


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
    from atdn_vslam_torch.ops.corr_lookup import corr_dot_backward, corr_dot_rowmajor, corr_dot_rowmajor_plain

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


K2N_DESIGN = ("lanes on queries: a block of 32 consecutive queries, one warp per (level, three "
              "window rows) task, three levels' 9 tasks at once; each lane issues its four tap "
              "rows' 40 loads first; results staged in a shared [32][243] tile, written as the "
              "block's contiguous output run in 16-byte stores")


def _k2n_case(device, hw8, c, dtype, seed, radius):
    """K2n over levels 1-3 of the nlanes pyramid of random feature maps
    at ``hw8`` against its plain version: (levels, coords (1, N, 2), max
    abs err, bytes the lookup must move)."""
    from atdn_vslam_torch.ops.corr_lookup_nlanes import (
        build_corr_pyramid_nlanes,
        nlanes_lookup_level_plain,
        nlanes_lookup_levels,
    )

    f1, f2, coords = lookup_inputs(device, hw8, c, dtype, seed)
    n = hw8[0] * hw8[1]
    vols = build_corr_pyramid_nlanes(f1, f2, 4, dtype)[1:]
    del f1, f2
    flat = coords.reshape(1, n, 2)
    got = nlanes_lookup_levels(vols, flat, 1, radius)
    ref = torch.cat([nlanes_lookup_level_plain(v, flat, i + 1, radius) for i, v in enumerate(vols)], -1)
    max_err = check_close(f"corr_lookup_nlanes {hw8}", got, ref, **K2N_TOL)
    bytes_moved = (
        _in_bound_taps([v.shape[1:3] for v in vols], coords, radius, 1) * vols[0].element_size()
        + coords.numel() * 4 + got.numel() * got.element_size()
    )
    return vols, flat, max_err, bytes_moved


def k2n_nlanes(device, hw8=(47, 154), c=256, dtype=torch.bfloat16, seed=7, radius=4,
               hw8_2x=(94, 308)) -> dict:
    """K2n over the three small levels of the KITTI nlanes pyramid, one
    launch, against its plain version, and at 2x KITTI (``*_2x``: levels
    47x154, 23x77, 11x38 over 28952 queries, past L2); the library
    yardstick is ``grid_sample`` per level on (N, 1, Hl, Wl) views of the
    same volumes."""
    from atdn_vslam_torch.ops import _kernels
    from atdn_vslam_torch.ops.corr_lookup_nlanes import nlanes_lookup_level_plain, nlanes_lookup_levels

    vols, flat, max_err, bytes_moved = _k2n_case(device, hw8, c, dtype, seed, radius)
    n = hw8[0] * hw8[1]

    def plain():
        return torch.cat([nlanes_lookup_level_plain(v, flat, i + 1, radius) for i, v in enumerate(vols)], -1)

    views = [v.permute(0, 3, 1, 2).reshape(n, 1, *v.shape[1:3]) for v in vols]
    bound_ms, bound_by = bound(bytes_moved, 0.0, dtype)
    out = {
        "name": "corr_lookup_nlanes",
        "route": "cuda",
        "source": "atdn_vslam_torch/csrc/corr_lookup_nlanes.cu",
        "replaces": "atdn_vslam_tpu/ops/corr_lookup_nlanes.py:97",
        "shape": [1, n, len(vols), (2 * radius + 1) ** 2],
        "levels": [list(v.shape[1:3]) for v in vols], "dtype": str(dtype), "tolerance": K2N_TOL,
        "max_abs_err": max_err,
        "ms": time_ms(lambda: nlanes_lookup_levels(vols, flat, 1, radius), device),
        "plain_ms": time_ms(plain, device),
        "library_ms": time_ms(lambda: grid_sample_windows(views, flat, radius, 1), device),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    del vols, views
    vols, flat, max_err, bytes_moved = _k2n_case(device, hw8_2x, c, dtype, seed, radius)
    out.update({
        "shape_2x": [1, hw8_2x[0] * hw8_2x[1], len(vols), (2 * radius + 1) ** 2],
        "levels_2x": [list(v.shape[1:3]) for v in vols],
        "max_abs_err_2x": max_err,
        "ms_2x": time_ms(lambda: nlanes_lookup_levels(vols, flat, 1, radius), device),
        "bound_ms_2x": bound(bytes_moved, 0.0, dtype)[0],
    })
    if device.type == "cuda":
        out.update({
            "design": K2N_DESIGN,
            "ptxas": check_ptxas("corr_lookup_nlanes", {
                "lookup": ptxas_report("corr_lookup_nlanes", "nlanes_kernelI13__nv_bfloat16"),
            }),
            "blocks_per_sm": {"lookup": _kernels.blocks_per_sm("corr_lookup_nlanes", device, 1)},
        })
    return out


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


K2S_DESIGN = ("K2's gather (corr_lookup_gather.cuh): one warp per query, all levels, a level's "
              "100 taps over 32 lanes with the padded Hp as row pitch and bound, all loads issued "
              "first, staged as (tap, right neighbour) pairs; per level, outputs i, i + 32, ... "
              "per lane as consecutive floats, rows then columns with hat weights in float32")


def k2s_slab(device, hw8=(47, 154), c=256, dtype=torch.bfloat16, seed=9, radius=4) -> dict:
    """K2s over the KITTI pyramid, rows padded once (level 0: 47 -> 56),
    against its plain version; the library yardstick is ``grid_sample``
    per level on the unpadded levels."""
    from atdn_vslam_torch.ops import _kernels
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
    out = {
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
    if device.type == "cuda":
        out.update({
            "design": K2S_DESIGN,
            "ptxas": check_ptxas("corr_lookup_slab", {
                "lookup": ptxas_report("corr_lookup_slab", "corr_lookup_kernelI13__nv_bfloat16"),
            }),
            "blocks_per_sm": {"lookup": _kernels.blocks_per_sm("corr_lookup_slab", device, 1)},
        })
    return out


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


def synthetic_frames(n: int, hw: tuple[int, int], seed: int, dx: int = 3, dy: int = 1) -> list[np.ndarray]:
    """A smooth random texture seen by a camera panning ``dx`` px right and
    ``dy`` px down per frame."""
    h, w = hw
    rng = np.random.default_rng(seed)
    pad_h, pad_w = max(n, -(-n * dy // 4)), max(n, -(-n * dx // 4))  # n, n at the default pan
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // 4 + pad_h, w // 4 + pad_w)).astype(np.float32))
    big = F.interpolate(coarse, scale_factor=4, mode="bilinear", align_corners=False)[0]
    big = big.permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
    return [np.ascontiguousarray(big[dy * i : dy * i + h, dx * i : dx * i + w]) for i in range(n)]


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
            q, k, _ = model.att(inp)
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


def map_agreement(device, hw=(96, 192), seed=13) -> dict:
    """One float32 map train step on ``device`` (TF32 off) and on the
    CPU from the same seeded weights, batch and jitter factors: loss,
    gradients and batch-norm statistics; then the bf16 code against the
    float32 code on ``device``, same weights and images."""
    from atdn_vslam_torch.config import MappingTrainConfig
    from atdn_vslam_torch.models.factory import init_params
    from atdn_vslam_torch.models.mapping import MappingVAE
    from atdn_vslam_torch.training import mapping as train
    from atdn_vslam_torch.utils.helpers import full_float32

    images = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (2, *hw, 3), dtype=np.uint8))
    factors = train.jitter_factors(2, torch.Generator().manual_seed(seed))
    cfg = MappingTrainConfig(epochs=1, batch_size=2, seed=seed)
    init = init_params(MappingVAE(), seed).state_dict()
    models, losses = {}, {}
    with full_float32():
        for dev in (device, torch.device("cpu")):
            model = MappingVAE().to(dev)
            model.load_state_dict(init)
            opt, sched = train.make_optimizer(model, cfg, 1)
            losses[dev.type] = float(train.train_step(model, opt, sched, images.to(dev), factors))
            models[dev.type] = model
    got, ref = models[device.type], models["cpu"]
    loss_err = abs(losses[device.type] - losses["cpu"]) / abs(losses["cpu"])
    if not np.isfinite(losses[device.type]) or loss_err > MAP_LOSS_RTOL:
        raise AssertionError(f"mapping: train-step loss {losses[device.type]} against {losses['cpu']}")
    grad_rel = 0.0
    for (name, p), q in zip(got.named_parameters(), ref.parameters()):
        scale = float(q.grad.abs().max())
        err = float((p.grad.cpu() - q.grad).abs().max())
        grad_rel = max(grad_rel, err / scale)
        if not err <= MAP_GRAD_REL * scale:
            raise AssertionError(f"mapping: gradient of {name} differs by {err} > {MAP_GRAD_REL} x {scale}")
    stats_err = 0.0
    for (name, a), b in zip(got.state_dict().items(), ref.state_dict().values()):
        if "running" in name:
            stats_err = max(stats_err, check_close(f"mapping: {name}", a.cpu(), b, **MAP_STATS_TOL))

    bf16 = MappingVAE(dtype=torch.bfloat16).to(device).eval()
    bf16.load_state_dict(init)
    f32 = MappingVAE().to(device).eval()
    f32.load_state_dict(init)
    with torch.inference_mode():
        codes = [m.get_code(images.to(device).float()) for m in (bf16, f32)]
    diff, scale = float((codes[0] - codes[1]).abs().max()), float(codes[1].abs().max())
    if codes[0].dtype != torch.float32 or not bool(codes[0].isfinite().all()) or diff > MAP_BF16_REL * scale:
        raise AssertionError(f"mapping: bf16 code differs from float32 by {diff} > {MAP_BF16_REL} x {scale}")
    return {
        "hw": list(hw), "loss": losses[device.type], "loss_cpu": losses["cpu"], "loss_rel_err": loss_err,
        "max_grad_err_rel": grad_rel, "max_stats_err": stats_err,
        "tolerance": {"loss_rtol": MAP_LOSS_RTOL, "grad_rel": MAP_GRAD_REL, "stats": MAP_STATS_TOL},
        "bf16_code": {"max_abs_diff": diff, "max_abs_code": scale, "rel_tol": MAP_BF16_REL},
    }


def mapping(device, keyframes_path: str, hw=FULL_HW, iters=12, keyframes=32, epochs=2, batch=16,
            queries=(0, 11, 22, 31), profile: int = 0) -> dict:
    """The runtime past odometry, on the slices' flow and odometry weights
    (seed 0) with the default bf16 map: ``keyframes`` frames streamed with
    zero keyframe thresholds, ``end_odometry`` (map training, each train
    step timed on the host clock around its synchronised end, then the
    embedding of every keyframe), each of ``queries``' own frames sent
    twice (the keyframe's feature map cold, then cached), and a warm
    start from the saved map answering the first query again. The first
    train step and the first query include cuDNN's autotuning of their
    shapes and are reported apart. ``profile`` more train steps (on a
    copy of the map) and warm queries run under ``torch.profiler``."""
    from atdn_vslam_torch.config import MappingTrainConfig
    from atdn_vslam_torch.slam import SlamRuntime
    from atdn_vslam_torch.slam import runtime as slam_runtime
    from atdn_vslam_torch.training import mapping as train

    cfg = flow_config(keyframes_path, hw, iters, bf16=True)
    cfg = dataclasses.replace(
        cfg, slam=dataclasses.replace(cfg.slam, rotation_threshold_deg=0.0, translation_threshold=0.0),
        mapping_train=MappingTrainConfig(epochs=epochs, batch_size=batch),
    )
    weights = seeded_weights(cfg, seed=0)
    frames = synthetic_frames(keyframes, hw, seed=12, dx=24, dy=4)  # every frame differs
    rt = new_runtime(cfg, weights, device)
    run_stream(rt, frames)
    if len(rt) != keyframes:
        raise AssertionError(f"mapping: {len(rt)} keyframes from {keyframes} frames")

    step_ms, losses = [], []
    untimed = train.train_step

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        loss = float(untimed(*args, **kwargs))  # the host copy waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        return torch.tensor(loss)

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    train.train_step = timed_step
    try:
        t0 = time.perf_counter()
        rt.end_odometry()
        end_ms = (time.perf_counter() - t0) * 1e3
    finally:
        train.train_step = untimed
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    map_launches = read_launches()
    if rt.mode() != "relocalization" or map_launches != launches_of():
        raise AssertionError(f"mapping: mode {rt.mode()}, kernels launched while mapping: {map_launches}")
    steps = epochs * (keyframes // batch)
    if len(step_ms) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"mapping: {len(step_ms)} train steps, not {steps}, losses {losses}")
    emb = rt.keyframes.embeddings
    if emb.shape != (keyframes, -(-hw[0] // 64) * -(-hw[1] // 64) * 128) or not np.isfinite(emb).all():
        raise AssertionError(f"mapping: embeddings {emb.shape}")
    _sync(device)
    t0 = time.perf_counter()
    again = slam_runtime.embed_keyframes(rt.mapping_model, rt.keyframes, device)
    embed_ms = (time.perf_counter() - t0) * 1e3 / keyframes
    embed_diff = float(np.abs(again - emb).max())

    answers, times = {}, {"cold": [], "warm": []}
    reset_launches()
    for kind in ("cold", "warm"):
        for q in queries:
            t0 = time.perf_counter()
            initial, refined, dist = rt(frames[q])
            times[kind].append((time.perf_counter() - t0) * 1e3)
            nearest = int(np.argmin(dist))
            if nearest != q or not np.isfinite(refined).all():
                raise AssertionError(f"mapping: query {q} ({kind}) found keyframe {nearest}")
            if not np.array_equal(initial, rt.keyframes.poses[q]):
                raise AssertionError(f"mapping: query {q} initial pose is not keyframe {q}'s")
            answers.setdefault(q, (initial, refined, dist))
    query_launches = read_launches()
    n_q = 2 * len(queries)
    want = launches_of(attention_probs=n_q, corr_lookup=iters * n_q)
    if device.type == "cuda" and query_launches != want:
        raise AssertionError(f"mapping: {n_q} queries launched {query_launches}, not {want}")
    self_dist = [float(answers[q][2][q]) for q in queries]
    other_dist = [float(np.min(np.delete(answers[q][2], q))) for q in queries]

    warm = SlamRuntime(cfg, *weights, start_mode="relocalization", device=device)
    warm_diff = max(
        float(np.abs(np.asarray(a) - np.asarray(b)).max())
        for a, b in zip(warm(frames[queries[0]]), answers[queries[0]])
    )
    if warm.mode() != "relocalization" or warm_diff > 1e-5:
        raise AssertionError(f"mapping: the warm start's answer differs by {warm_diff}")
    profiles = {}
    if profile:
        model = copy.deepcopy(rt.mapping_model)
        opt, sched = train.make_optimizer(model, cfg.mapping_train, profile)
        imgs = torch.from_numpy(np.stack([rt.keyframes.read_rgb(i) for i in range(batch)])).to(device)
        gen = torch.Generator().manual_seed(0)
        profiles["profile_train_step"] = profile_frames(
            lambda _: float(train.train_step(model, opt, sched, imgs, train.jitter_factors(batch, gen))),
            range(profile),
        )
        profiles["profile_query_warm"] = profile_frames(
            lambda q: rt(frames[q]), [queries[i % len(queries)] for i in range(profile)]
        )
    return {
        "hw": list(hw), "iters": iters, "keyframes": keyframes, "epochs": epochs, "batch": batch,
        "map_dtype": "bfloat16", "code_floats": int(emb.shape[1]),
        "reduced": ["32 keyframes instead of a sequence's hundreds", "2 epochs instead of 50"],
        "train_step_ms": float(np.mean(step_ms[1:])), "first_step_ms": step_ms[0], "step_ms": step_ms,
        "losses": losses,
        "end_odometry_ms": end_ms, "embed_ms_per_keyframe": embed_ms, "embed_repeat_max_diff": embed_diff,
        "peak_mem_gib": peak_gib, "launches_while_mapping": map_launches,
        "query_ms_cold": float(np.mean(times["cold"][1:])), "query_ms_warm": float(np.mean(times["warm"])),
        "first_query_ms": times["cold"][0], "query_ms": times, "launches": query_launches, "queries": n_q,
        "self_distance": self_dist, "nearest_other_distance": other_dist,
        "warm_start_max_diff": warm_diff,
        "agreement": map_agreement(device), **profiles,
    }


# the pose-graph solve on the card (float32, TF32 off) against the same
# solve on the CPU: the tolerances the CPU tests hold the port's solve to
# against the JAX package (tests/test_torch_pose_graph.py)
GRAPH_POSE_ATOL = 1e-4
GRAPH_MSE_RTOL, GRAPH_MSE_ATOL = 1e-3, 1e-9
# the refined keyframe poses of loop closure, card against CPU: the pose
# tolerance of the runtime parity tests (tests/test_torch_runtime.py)
LOOP_POSE_TOL = {"rtol": 1e-4, "atol": 1e-4}
# one float32 odometry train step on the card (TF32 off) against the CPU:
# the map's step's bounds (MAP_*), which the CPU tests also hold the
# port's odometry step to against the JAX package
# (tests/test_torch_odometry_train.py)
ODO_LOSS_RTOL = 1e-6
ODO_GRAD_REL = 1e-3  # of each tensor's largest gradient
ODO_STATS_TOL = {"rtol": 1e-5, "atol": 1e-5}


def out_and_back(n: int, hw, seed: int) -> list[np.ndarray]:
    """``n`` frames of a texture panning out (24 px right, 4 px down per
    frame), then the same ``n`` positions back: frame n + k is pixel for
    pixel frame n - 1 - k, a revisit for the embeddings to find."""
    out = synthetic_frames(n, hw, seed=seed, dx=24, dy=4)
    return out + out[::-1]


def graph_mse(poses, edges_i, edges_j, meas) -> float:
    from atdn_vslam_torch.geometry.pose_graph import edge_residuals

    with torch.no_grad():
        return float(torch.mean(edge_residuals(poses, edges_i, edges_j, meas) ** 2))


def loop_closure(device, keyframes_path: str, hw=FULL_HW, iters=12, out=12, epochs=2, batch=16,
                 min_gap=4) -> dict:
    """Loop closure at KITTI on the slices' flow and odometry weights
    (seed 0), bf16 flow, zero keyframe thresholds (so the geometric gate
    is off and every frame is a keyframe): an out-and-back sequence
    streamed, ``end_odometry`` (the map, ``epochs`` epochs of ``batch``),
    the closure pairs from the embeddings, each pair measured twice
    (keyframe i's feature map cold, then cached; K1 once and K2
    ``iters`` times per measurement), ``close_loops`` timed whole, and the
    solve of its graph alone on the card and on the CPU."""
    from atdn_vslam_torch.config import MappingTrainConfig
    from atdn_vslam_torch.geometry.pose_graph import optimize_pose_graph

    t_start = time.perf_counter()
    cfg = flow_config(keyframes_path, hw, iters, bf16=True)
    cfg = dataclasses.replace(
        cfg, slam=dataclasses.replace(cfg.slam, rotation_threshold_deg=0.0, translation_threshold=0.0),
        mapping_train=MappingTrainConfig(epochs=epochs, batch_size=batch),
    )
    weights = seeded_weights(cfg, seed=0)
    frames = out_and_back(out, hw, seed=15)
    rt = new_runtime(cfg, weights, device)
    run_stream(rt, frames)
    rt.end_odometry()
    n = len(rt)
    if n != len(frames) or rt.mode() != "relocalization":
        raise AssertionError(f"loop_closure: {n} keyframes, mode {rt.mode()}")
    pairs = rt.detect_closure_pairs(min_gap=min_gap)
    revisits = [(i, j) for i, j, _ in pairs if i + j == len(frames) - 1]
    if not revisits:
        raise AssertionError(f"loop_closure: no pixel-identical revisit among the pairs {pairs}")

    measured, times = {}, {"cold": [], "warm": []}
    per_measure = []
    for kind in ("cold", "warm"):
        for i, j, _ in pairs:
            reset_launches()
            _sync(device)
            t0 = time.perf_counter()
            t = rt.measure_closure(i, j)
            times[kind].append((time.perf_counter() - t0) * 1e3)  # the host copy waits
            per_measure.append(read_launches())
            measured.setdefault((i, j), t)
            if not np.isfinite(t).all():
                raise AssertionError(f"loop_closure: measurement ({i}, {j}) is not finite")
    want = launches_of(attention_probs=1, corr_lookup=iters)
    if device.type == "cuda" and any(c != want for c in per_measure):
        raise AssertionError(f"loop_closure: a measurement launched {per_measure}, not {want} each")

    before = rt.keyframes.poses[:n].copy()
    reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    result = rt.close_loops(min_gap=min_gap)
    close_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    if result is None or not np.isfinite(result[0]).all():
        raise AssertionError("loop_closure: close_loops found no closure or gave non-finite poses")
    refined, mse = result
    n_closures = len(pairs)  # the gate is off: every pair is an edge
    want = launches_of(attention_probs=n_closures, corr_lookup=iters * n_closures)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"loop_closure: close_loops launched {launches}, not {want}")

    # the solve alone, from the streamed poses, on the card and on the CPU
    rt.keyframes.poses[:n] = before
    closures = [(i, j, measured[(i, j)]) for i, j, _ in pairs]
    graph = rt.closure_graph(closures)
    mse_before = graph_mse(*graph[:4])
    optimize_pose_graph(*graph)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    got, got_mse = optimize_pose_graph(*graph)
    got = got.cpu()
    solve_ms = (time.perf_counter() - t0) * 1e3
    ref, ref_mse = optimize_pose_graph(*(x.cpu() for x in graph))
    pose_err = check_close("loop_closure: refined poses", got, ref, **LOOP_POSE_TOL)
    if not abs(float(got_mse) - float(ref_mse)) <= max(GRAPH_MSE_RTOL * float(ref_mse), GRAPH_MSE_ATOL):
        raise AssertionError(f"loop_closure: residual {float(got_mse)} on the card, {float(ref_mse)} on the CPU")
    return {
        "hw": list(hw), "iters": iters, "keyframes": n, "frames_out": out, "map_epochs": epochs,
        "min_gap": min_gap, "pairs": [[i, j, d] for i, j, d in pairs], "revisits": revisits,
        "closures": n_closures, "launches_per_measure": per_measure[0],
        "measure_ms_cold": float(np.mean(times["cold"])), "measure_ms_warm": float(np.mean(times["warm"])),
        "measure_ms": times, "close_loops_ms": close_ms, "close_loops_mse": mse, "launches": launches,
        "solve_ms": solve_ms, "solve_iterations": 10, "mse_before": mse_before, "mse_after": float(got_mse),
        "mse_after_cpu": float(ref_mse), "max_abs_pose_diff_cpu": pose_err, "tolerance": LOOP_POSE_TOL,
        "max_pose_change": float(np.abs(refined - before).max()),
        "reduced": [f"{n} keyframes instead of a sequence's hundreds", f"{epochs} map epochs instead of 50"],
        "seconds": time.perf_counter() - t_start,
    }


def drifted_graph(n: int, seed: int, noise=0.005, loop=63, every=20):
    """A chain of ``n`` poses stepping 1 m forward and turning 0.1 rad (a
    circle of ~63 poses), stored with drifted odometry; closures
    (i, i + ``loop``) every ``every`` poses carry the true relative pose,
    weight 4. CPU float32 (poses, edges_i, edges_j, measurements,
    weights)."""
    from atdn_vslam_torch.geometry.pose_graph import se3_exp
    from atdn_vslam_torch.geometry.se3 import prefix_products, se3_inverse

    g = torch.Generator().manual_seed(seed)
    eye = torch.eye(4, dtype=torch.float64)[None]
    step = se3_exp(torch.tensor([0.0, 0.0, 1.0, 0.0, 0.1, 0.0], dtype=torch.float64))
    gt = torch.cat([eye, prefix_products(step.expand(n - 1, 4, 4).contiguous())])
    drift = se3_exp(torch.randn((n - 1, 6), generator=g, dtype=torch.float64) * noise)
    rel = se3_inverse(gt[:-1]) @ gt[1:] @ drift
    poses = torch.cat([eye, prefix_products(rel)])
    ci = torch.arange(0, n - loop, every)
    cj = ci + loop
    ei = torch.arange(n - 1)
    meas = torch.cat([se3_inverse(poses[:-1]) @ poses[1:], se3_inverse(gt[ci]) @ gt[cj]])
    weights = torch.cat([torch.ones(n - 1), torch.full((len(ci),), 4.0)])
    return poses.float(), torch.cat([ei, ci]), torch.cat([ei + 1, cj]), meas.float(), weights


def pose_graph(device, cases=(("dense", 200), ("dense", 1000), ("cg", 200), ("cg", 1000), ("cg", 5000)),
               iterations=10, cg_iterations=100, check_n=200, reps=3, profile: int = 0) -> dict:
    """The pose-graph solve on seeded drifted chains with closures: ms
    per solve (host clock around ``reps`` synchronised calls after one
    warm-up) and the residual before and after; at ``check_n`` poses the
    card's solution against the CPU's, both solvers. With ``profile``,
    one more solve of each of the dense cases and of CG at 200 poses runs
    under ``torch.profiler`` (the larger CG solves launch too many
    kernels for the profiler's record to stay short)."""
    from atdn_vslam_torch.geometry.pose_graph import optimize_pose_graph

    t_start = time.perf_counter()
    out = []
    for solver, n in cases:
        graph = drifted_graph(n, seed=n)
        dev_graph = [x.to(device) for x in graph]

        def solve():
            return optimize_pose_graph(*dev_graph, iterations=iterations, solver=solver,
                                       cg_iterations=cg_iterations)

        float(solve()[1])  # warm-up
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ms = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            got, mse = solve()
            mse = float(mse)
            ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(got).all()) or not np.isfinite(mse):
            raise AssertionError(f"pose_graph: {solver} solve at N={n} is not finite")
        case = {
            "solver": solver, "poses": n, "edges": int(graph[1].shape[0]), "ms": float(np.mean(ms)),
            "ms_runs": ms, "mse_before": graph_mse(*dev_graph[:4]), "mse_after": mse,
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None,
        }
        if n == check_n:
            ref, ref_mse = optimize_pose_graph(*graph, iterations=iterations, solver=solver,
                                               cg_iterations=cg_iterations)
            case["max_abs_pose_diff_cpu"] = check_close(
                f"pose_graph: {solver} N={n}", got.cpu(), ref, rtol=0.0, atol=GRAPH_POSE_ATOL
            )
            case["mse_after_cpu"] = float(ref_mse)
            if not abs(mse - float(ref_mse)) <= max(GRAPH_MSE_RTOL * float(ref_mse), GRAPH_MSE_ATOL):
                raise AssertionError(f"pose_graph: {solver} N={n} residual {mse}, CPU {float(ref_mse)}")
        if profile and (solver == "dense" or n <= 200):
            case["profile"] = profile_frames(lambda _: float(solve()[1]), range(1), top=12)
        out.append(case)
    return {"iterations": iterations, "cg_iterations": cg_iterations, "cases": out,
            "tolerance": {"pose_atol": GRAPH_POSE_ATOL, "mse_rtol": GRAPH_MSE_RTOL},
            "seconds": time.perf_counter() - t_start}


def odometry_agreement(device, hw=(72, 96), batch=2, steps=3, seed=16) -> dict:
    """One float32 odometry train step on ``device`` (TF32 off) and on the
    CPU from the same seeded weights and batch, alpha 0.5 (both loss
    terms): loss, every gradient, the batch statistics after the step."""
    from atdn_vslam_torch.config import LossConfig, TrainConfig
    from atdn_vslam_torch.models.factory import init_params
    from atdn_vslam_torch.models.odometry import ATDNVO
    from atdn_vslam_torch.training import odometry as train

    g = torch.Generator().manual_seed(seed)
    flows = torch.randn((batch, steps, *hw, 2), generator=g) * 20.0
    rot = torch.randn((batch, steps, 3), generator=g) * 0.02
    tr = torch.randn((batch, steps, 3), generator=g) * 0.5
    init = init_params(ATDNVO(hw), seed).state_dict()
    models, metrics = {}, {}
    for dev in (device, torch.device("cpu")):
        model = ATDNVO(hw).to(dev)
        model.load_state_dict(init)
        opt, sched = train.make_optimizer(model, TrainConfig(), 1)
        state = train.OdometryTrainState(model, opt, sched)
        metrics[dev.type] = train.train_step(state, flows.to(dev), rot.to(dev), tr.to(dev), LossConfig(alpha=0.5))
        models[dev.type] = model
    loss, loss_cpu = float(metrics[device.type]["loss"]), float(metrics["cpu"]["loss"])
    loss_err = abs(loss - loss_cpu) / abs(loss_cpu)
    if not np.isfinite(loss) or loss_err > ODO_LOSS_RTOL:
        raise AssertionError(f"odometry_train: train-step loss {loss} against {loss_cpu}")
    grad_rel = 0.0
    for (name, p), q in zip(models[device.type].named_parameters(), models["cpu"].parameters()):
        scale = float(q.grad.abs().max())
        err = float((p.grad.cpu() - q.grad).abs().max())
        grad_rel = max(grad_rel, err / scale)
        if not err <= ODO_GRAD_REL * scale:
            raise AssertionError(f"odometry_train: gradient of {name} differs by {err} > {ODO_GRAD_REL} x {scale}")
    stats_err = 0.0
    for (name, a), b in zip(models[device.type].state_dict().items(), models["cpu"].state_dict().values()):
        if "running" in name:
            stats_err = max(stats_err, check_close(f"odometry_train: {name}", a.cpu(), b, **ODO_STATS_TOL))
    return {"hw": list(hw), "batch": batch, "steps": steps, "loss": loss, "loss_cpu": loss_cpu,
            "loss_rel_err": loss_err, "max_grad_err_rel": grad_rel, "max_stats_err": stats_err,
            "tolerance": {"loss_rtol": ODO_LOSS_RTOL, "grad_rel": ODO_GRAD_REL, "stats": ODO_STATS_TOL}}


def odometry_train(device, hw=FULL_HW, steps=5, seed=17, profile: int = 0) -> dict:
    """ATDNVO training at the reference configuration (``configs/kitti.yaml``:
    batch 24 windows of 6 flows, lr 1e-2, alpha 1) at KITTI's working
    size, float32 with TF32 off, on seeded synthetic flows and poses made
    on the card: ms of each of ``steps`` steps (host clock around each
    step's synchronised loss; step 1 includes cuDNN's autotuning), peak
    memory; then the small step against the CPU. ``profile`` more steps
    run under ``torch.profiler``."""
    from atdn_vslam_torch.config import load_config
    from atdn_vslam_torch.models.factory import build_odometry_model
    from atdn_vslam_torch.training import odometry as train

    t_start = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "configs", "kitti.yaml"))
    tc = cfg.train
    model = build_odometry_model(cfg, device, image_hw=hw)
    state = train.init_state(model, tc, steps, seed=seed)
    g = torch.Generator(device).manual_seed(seed)
    shape = (tc.batch_size, tc.sequence_length)
    flows = torch.randn((*shape, *hw, 2), generator=g, device=device) * 20.0
    rot = torch.randn((*shape, 3), generator=g, device=device) * 0.02
    tr = torch.randn((*shape, 3), generator=g, device=device) * 0.5
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    step_ms, losses, grad_norms = [], [], []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        metrics = train.train_step(state, flows, rot, tr, cfg.loss)
        losses.append(float(metrics["loss"]))  # the host copy waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grad_norms.append(float(metrics["grad_norm"]))
    launches = read_launches()
    if not (np.isfinite(losses).all() and np.isfinite(grad_norms).all()) or launches != launches_of():
        raise AssertionError(f"odometry_train: losses {losses}, grad norms {grad_norms}, launches {launches}")
    profiles = {}
    if profile:
        profiles["profile"] = profile_frames(
            lambda _: float(train.train_step(state, flows, rot, tr, cfg.loss)["loss"]), range(profile), top=12
        )
    return {
        "hw": list(hw), "batch": tc.batch_size, "sequence_length": tc.sequence_length,
        "flows_per_step": tc.batch_size * tc.sequence_length, "dtype": "float32", "alpha": cfg.loss.alpha,
        "step_ms": step_ms, "first_step_ms": step_ms[0], "steady_step_ms": float(np.mean(step_ms[1:])),
        "losses": losses, "grad_norms": grad_norms,
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None,
        "launches": launches, "reduced": [f"{steps} steps on one synthetic batch instead of KITTI epochs"],
        "agreement": odometry_agreement(device), "seconds": time.perf_counter() - t_start, **profiles,
    }


# ----------------------------------------------------------------------
# Flow training: the backward passes of K1, K2 and K3, the train step on
# the card against the CPU, and the training configuration
# ----------------------------------------------------------------------

# float32 inputs: the same float32 products on both sides, another order
BACKWARD_TOL_REL = 1e-5  # of each gradient's largest entry
# one float32 flow train step, card against CPU: each gradient within this
# share of the largest gradient of its module group. The check's shifts
# (32-40 px) keep every prediction far from the ground truth, so no L1
# sign flips between the two devices' roundings (on 3-12 px shifts a few
# flips moved the update block's gradients by 8e-3 of their largest).
# What is left: the encoders' weight gradients are small differences of
# large terms through their norms, and float32 rounding moves them on
# either device (the CPU's float32 against its float64 on this input and
# seeds + 3, + 4: fnet 3.0e-3 / 5.5e-3 / 1.4e-3, cnet 1.2e-2 / 9.5e-7 /
# 9.1e-3; the attention projections and the update block within 9.1e-6).
# A missing or wrong backward pass moves a group's gradients by ~100%
FLOW_GRAD_REL = {"fnet": 5e-2, "cnet": 5e-2, "att": 1e-3, "update_block": 1e-3}
FLOW_LOSS_RTOL = 1e-5
# bf16 compute against the float64 step (flow_train_agreement): twice the
# largest distance of the CPU's bf16 step from it over seeds 1-7 and 18
# (flow_train_agreement run on the CPU: loss 2.4e-5 relative; gradients
# 0.31, 0.31, 0.051, 0.14 of each group's largest). A zero, a missing or a
# sign-flipped gradient lies 1-2 group maxima away.
TRAIN_BF16_LOSS_RTOL = 5e-5
TRAIN_BF16_REL = {"fnet": 0.6, "cnet": 0.6, "att": 0.1, "update_block": 0.3}
ADAM_EPS = 1e-8  # training/flow.py make_optimizer
FLOW_STATS_TOL = {"rtol": 1e-5, "atol": 1e-5}
# the slice's training configuration (the JAX flow-training CLI's defaults,
# atdn_vslam_tpu/cli/train_flow.py:62-74,141-146)
FLOW_TRAIN = {"hw": (288, 960), "batch": 6, "iters": 12, "gamma": 0.8, "lr": 1.25e-4, "wd": 1e-5,
              "clip": 1.0, "schedule": "warmcos", "steps_total": 50000}


def _rel_grad_err(name: str, got: torch.Tensor, ref: torch.Tensor, rel: float, atol: float = 0.0) -> float:
    """max |got - ref| over max |ref|, checked against ``rel`` (plus
    ``atol`` for a tensor whose exact gradient is zero)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite gradient")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not err <= rel * scale + atol or scale == 0.0:
        raise AssertionError(f"{name}: gradient differs by {err} > {rel} x {scale} + {atol}")
    return err / scale


def k1_backward(device, hw8=(47, 154), d=128, seed=19) -> dict:
    """K1's backward on the card (``_AttentionProbs``: the K1 forward, then
    the JAX VJP's float32 products) at the KITTI shape: float32 inputs
    against autograd through the plain version on the card; then bf16
    inputs (the training type), its ms against the products' bound."""
    from atdn_vslam_torch.ops.attention import (
        attention_probs_backward,
        attention_probs_spatial,
        attention_probs_spatial_plain,
    )

    h, w = hw8
    n = h * w
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k = k1_inputs(device, hw8, d, dtype, seed)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        n_pad = -(-n // 128) * 128
        dp = torch.randn((1, h, w, n_pad), generator=g, device=device).to(dtype)
        qt, kt = q.clone().requires_grad_(), k.clone().requires_grad_()
        p = attention_probs_spatial(qt, kt, h, w, 1.0)
        if p.grad_fn is None and device.type == "cuda":
            raise AssertionError("attention_probs: no autograd node on the card")
        p.backward(dp)
        if dtype == torch.float32:
            qr, kr = q.clone().requires_grad_(), k.clone().requires_grad_()
            attention_probs_spatial_plain(qr, kr, h, w, 1.0).backward(dp)
            errs = {"dq": _rel_grad_err("attention_probs dq", qt.grad, qr.grad, BACKWARD_TOL_REL),
                    "dk": _rel_grad_err("attention_probs dk", kt.grad, kr.grad, BACKWARD_TOL_REL)}
        else:
            if qt.grad.dtype != torch.bfloat16 or not bool(qt.grad.isfinite().all() & kt.grad.isfinite().all()):
                raise AssertionError("attention_probs: bf16 gradients are not finite bf16")
            p = p.detach()
    # P and dP read once (bf16), q and k read, dq and dk written; the two
    # products 2 x 2 n n d in float32 (outside the tensor cores)
    bytes_moved = 2 * p.numel() * 2 + 4 * n * d * 2
    bound_ms, bound_by = bound(bytes_moved, 4.0 * n * n * d, torch.float32)
    return {"shape": [1, n, d], "n_pad": p.shape[-1], "dtype": "torch.bfloat16",
            "max_grad_err_rel_f32": errs, "tolerance_rel": BACKWARD_TOL_REL,
            "ms": time_ms(lambda: attention_probs_backward(q, k, p, dp, 1.0), device),
            "bound_ms": bound_ms, "bound_by": bound_by, "calls_per_train_step": 1}


def k2_backward(device, hw8=(47, 154), c=256, seed=20, radius=4) -> dict:
    """K2's backward on the card (``_LookupCorrPyramid``: the K2 forward,
    then the transpose of the separable lookup) over the KITTI pyramid:
    float32 volumes against autograd through the plain version on the
    card; then bf16 volumes (the training type), its ms against the
    bytes' bound."""
    from atdn_vslam_torch.ops.corr_lookup import (
        build_corr_pyramid,
        lookup_corr_pyramid,
        lookup_corr_pyramid_backward,
        lookup_corr_pyramid_plain,
    )

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        f1, f2, coords = lookup_inputs(device, hw8, c, dtype, seed)
        pyramid = build_corr_pyramid(f1, f2, 4, dtype=dtype)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        d_window = torch.randn((1, *hw8, 4 * (2 * radius + 1) ** 2), generator=g, device=device)
        levels = [v.clone().requires_grad_() for v in pyramid]
        out = lookup_corr_pyramid(levels, coords, radius)
        if out.grad_fn is None and device.type == "cuda":
            raise AssertionError("corr_lookup: no autograd node on the card")
        out.backward(d_window)
        if dtype == torch.float32:
            ref = [v.clone().requires_grad_() for v in pyramid]
            lookup_corr_pyramid_plain(ref, coords, radius).backward(d_window)
            errs = {f"level{i}": _rel_grad_err(f"corr_lookup level {i}", a.grad, b.grad, BACKWARD_TOL_REL)
                    for i, (a, b) in enumerate(zip(levels, ref))}
        elif any(v.grad.dtype != torch.bfloat16 for v in levels):
            raise AssertionError("corr_lookup: a bf16 pyramid got no bf16 gradient")
    shapes = [tuple(v.shape[-2:]) for v in pyramid]
    dtypes = [v.dtype for v in pyramid]
    # d_window and coords read once, every level's cotangent written once
    bytes_moved = d_window.numel() * 4 + coords.numel() * 4 + sum(v.numel() * 2 for v in pyramid)
    bound_ms, bound_by = bound(bytes_moved, 0.0, torch.float32)
    return {"shape": [1, hw8[0] * hw8[1], 4, (2 * radius + 1) ** 2], "dtype": "torch.bfloat16",
            "max_grad_err_rel_f32": errs, "tolerance_rel": BACKWARD_TOL_REL,
            "ms": time_ms(lambda: lookup_corr_pyramid_backward(shapes, dtypes, coords, d_window, radius), device),
            "bound_ms": bound_ms, "bound_by": bound_by, "calls_per_train_step": 12}


def k3_backward(device, n=47 * 154, c=256, seed=21) -> dict:
    """K3's backward on the card (``_CorrDot``: the K3 forward, then the
    JAX VJP's two float32 products) at the KITTI level-0 shape: float32
    features against autograd through the plain version on the card;
    then bf16 (the ``use_pallas=True`` type), its ms against the bound."""
    from atdn_vslam_torch.ops.corr_lookup import corr_dot_backward, corr_dot_rowmajor, corr_dot_rowmajor_plain

    inv = 1.0 / c**0.5
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=device).manual_seed(seed)
        f1 = torch.randn((1, n, c), generator=g, device=device).to(dtype)
        f2 = torch.randn((1, n, c), generator=g, device=device).to(dtype)
        gout = torch.randn((1, n, n), generator=g, device=device).to(dtype)
        a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        out = corr_dot_rowmajor(a, b, inv, dtype)
        if out.grad_fn is None and device.type == "cuda":
            raise AssertionError("corr_dot: no autograd node on the card")
        out.backward(gout)
        if dtype == torch.float32:
            ra, rb = f1.clone().requires_grad_(), f2.clone().requires_grad_()
            corr_dot_rowmajor_plain(ra, rb, inv, dtype).backward(gout)
            errs = {"df1": _rel_grad_err("corr_dot df1", a.grad, ra.grad, BACKWARD_TOL_REL),
                    "df2": _rel_grad_err("corr_dot df2", b.grad, rb.grad, BACKWARD_TOL_REL)}
    # g read once (bf16), f1 and f2 read, df1 and df2 written; the two
    # products 2 x 2 n n c in float32
    bytes_moved = gout.numel() * 2 + 4 * n * c * 2
    bound_ms, bound_by = bound(bytes_moved, 4.0 * n * n * c, torch.float32)
    return {"shape": [1, n, n, c], "dtype": "torch.bfloat16", "max_grad_err_rel_f32": errs,
            "tolerance_rel": BACKWARD_TOL_REL,
            "ms": time_ms(lambda: corr_dot_backward(f1, f2, gout, inv), device),
            "bound_ms": bound_ms, "bound_by": bound_by, "calls_per_train_step": 0}


def shifted_pairs(batch: int, hw, device, seed: int, max_shift: int = 12, min_shift: int = 0):
    """A smooth random texture per sample and the same texture shifted by
    a known whole-pixel offset (dx, dy), each of magnitude ``min_shift``
    to ``max_shift``: images (B, H, W, 3) in [0, 255], the flow (-dx,
    -dy) everywhere and every pixel valid, made on ``device``."""
    h, w = hw
    g = torch.Generator(device=device).manual_seed(seed)
    pad = 2 * max_shift
    coarse = torch.rand((batch, 3, (h + pad) // 4 + 2, (w + pad) // 4 + 2), generator=g, device=device) * 255
    tex = F.interpolate(coarse, scale_factor=4, mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    mags = torch.randint(min_shift, max_shift + 1, (batch, 2), generator=g, device=device)
    shifts = mags * (2 * torch.randint(0, 2, (batch, 2), generator=g, device=device) - 1)
    im1 = tex[:, max_shift : max_shift + h, max_shift : max_shift + w]
    im2 = torch.stack([
        tex[i, max_shift + int(dy) : max_shift + int(dy) + h, max_shift + int(dx) : max_shift + int(dx) + w]
        for i, (dx, dy) in enumerate(shifts.tolist())
    ])
    flow = (-shifts.float())[:, None, None, :].expand(batch, h, w, 2).contiguous()
    return im1.contiguous(), im2.contiguous(), flow, torch.ones((batch, h, w), device=device)


def flow_train_agreement(device, hw=(96, 192), batch=2, iters=3, seed=18) -> dict:
    """One float32 flow train step (TF32 off) on ``device`` (kernels K1
    and K2 and their backward passes) and on the CPU (plain versions),
    same seeded weights and shifted pairs: loss, every gradient (within
    ``FLOW_GRAD_REL`` of its module group's largest gradient), the batch
    statistics and the parameters after the clipped AdamW step. Then the
    slice's own compute on ``device``, bf16 under autocast with float32
    parameters, on the same step: loss and gradients within
    ``TRAIN_BF16_LOSS_RTOL`` and ``TRAIN_BF16_REL``. The same step's
    gradients in float64 on the CPU are the yardstick: each group's
    distance from them is reported for every run, and the CPU's bf16
    step (CPU autocast, the build that
    ``tests/test_torch_flow_train.py`` holds to the JAX package's bf16
    trainer) is reported beside the card's."""
    from atdn_vslam_torch.config import Config, FlowNetConfig
    from atdn_vslam_torch.models.factory import build_flow_train_model
    from atdn_vslam_torch.training import flow as train

    cpu = torch.device("cpu")
    cfg = Config(flow=FlowNetConfig(iters=iters, mixed_precision=False))
    weights = seeded_weights(cfg, seed)[0]
    batch_cpu = shifted_pairs(batch, hw, cpu, seed, max_shift=40, min_shift=32)
    runs = {}  # name: (state, metrics, launches)
    for name, dev, mixed in (("card", device, False), ("cpu", cpu, False), ("card_bf16", device, True),
                             ("cpu_bf16", cpu, True)):
        model = build_flow_train_model(Config(flow=FlowNetConfig(iters=iters, mixed_precision=mixed)), dev)
        model.load_state_dict(weights)
        if mixed:
            model.dtype = torch.bfloat16  # the training build's type on the card, forced on the CPU
        state = train.init_state(model, 1e-4, 10, 1e-5, 1.0, seed=None)
        reset_launches()
        _, metrics = train.train_step(state, *(x.to(dev) for x in batch_cpu))
        runs[name] = (state, metrics, read_launches())
    want = launches_of(attention_probs=1, corr_lookup=iters)
    if device.type == "cuda" and (runs["card"][2] != want or runs["card_bf16"][2] != want):
        raise AssertionError(f"flow_train_agreement: launches {runs['card'][2]}, {runs['card_bf16'][2]}")
    # the float64 yardstick: the same forward and backward, unclipped
    ref = build_flow_train_model(cfg, "cpu")
    ref.load_state_dict(weights)
    ref.double()
    ref.dtype = torch.float64
    preds = ref(batch_cpu[0].double(), batch_cpu[1].double(), test_mode=False)
    loss64 = train.sequence_loss(preds, batch_cpu[2].double(), batch_cpu[3].double())[0]
    loss64.backward()
    loss64 = float(loss64.detach())
    losses = {name: float(m["loss"]) for name, (_, m, _) in runs.items()}
    loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    if not np.isfinite(losses["card"]) or loss_err > FLOW_LOSS_RTOL:
        raise AssertionError(f"flow_train_agreement: loss {losses['card']} against {losses['cpu']}")
    loss_bf16_err = abs(losses["card_bf16"] - loss64) / abs(loss64)
    if not np.isfinite(losses["card_bf16"]) or loss_bf16_err > TRAIN_BF16_LOSS_RTOL:
        raise AssertionError(f"flow_train_agreement: bf16 loss {losses['card_bf16']} against {loss64}")
    # train_step leaves the clipped gradients; unclip them to compare with float64
    grads = {"float64": {n: p.grad for n, p in ref.named_parameters()}}
    for name, (state, m, _) in runs.items():
        unclip = max(1.0, float(m["grad_norm"]))
        grads[name] = {n: p.grad.double().cpu() * unclip for n, p in state.model.named_parameters()}
    errs = {}
    for group in FLOW_GRAD_REL:
        names = [n for n in grads["cpu"] if n.split(".")[0] == group]
        scale = max(float(grads["float64"][n].abs().max()) for n in names)

        def dist(a, b):
            return max(float((grads[a][n] - grads[b][n]).abs().max()) for n in names) / scale  # noqa: B023

        errs[group] = {"card_vs_cpu": dist("card", "cpu"), "cpu_vs_float64": dist("cpu", "float64"),
                       "card_vs_float64": dist("card", "float64"),
                       "card_bf16_vs_float64": dist("card_bf16", "float64"),
                       "cpu_bf16_vs_float64": dist("cpu_bf16", "float64")}
        if not errs[group]["card_vs_cpu"] <= FLOW_GRAD_REL[group]:
            raise AssertionError(f"flow_train_agreement: {group} gradients differ by {errs[group]}")
        if not errs[group]["card_bf16_vs_float64"] <= TRAIN_BF16_REL[group]:
            raise AssertionError(f"flow_train_agreement: {group} bf16 gradients differ by {errs[group]}")
    card, ref_cpu = runs["card"][0].model, runs["cpu"][0].model
    stats_err = 0.0
    cpu_sd = ref_cpu.state_dict()
    for name, a in card.state_dict().items():
        if "running" in name:
            stats_err = max(stats_err, check_close(f"flow_train_agreement {name}", a.cpu(), cpu_sd[name],
                                                   **FLOW_STATS_TOL))
    # Adam's first step moves a weight by lr g / (|g| + eps) and the decay:
    # where both devices' clipped gradients share a sign and exceed 100 eps
    # the two steps agree within lr / 100 (and the weight's float32
    # rounding, 4 ulp); elsewhere the gradient is rounding noise, which may
    # flip the step's sign: 2 lr
    lr_used = train.make_schedule(1e-4, 10)(0)
    params_cpu = dict(ref_cpu.named_parameters())
    param_err = {"tight": 0.0, "loose": 0.0}  # the largest difference, as a share of its bound
    n_tight, n_all = 0, 0
    for n, p in card.named_parameters():
        q, g_card, g_cpu = params_cpu[n].detach(), p.grad.cpu(), params_cpu[n].grad
        tight = (g_card.sign() == g_cpu.sign()) & (torch.minimum(g_card.abs(), g_cpu.abs()) > 100 * ADAM_EPS)
        allowed = torch.where(tight, lr_used / 100, 2.0 * lr_used * 1.001) + 4 * 2.0**-23 * q.abs()
        share = (p.detach().cpu() - q).abs() / allowed
        for key, mask in (("tight", tight), ("loose", ~tight)):
            if bool(mask.any()):
                param_err[key] = max(param_err[key], float(share[mask].max()))
        n_tight, n_all = n_tight + int(tight.sum()), n_all + q.numel()
    if max(param_err.values()) > 1.0:
        raise AssertionError(f"flow_train_agreement: parameters after the step differ by {param_err} of the bound")
    return {"hw": list(hw), "batch": batch, "iters": iters, "dtype": "float32; bf16 compute (card_bf16)",
            "losses": losses, "loss_float64": loss64, "loss_rel_err": loss_err,
            "loss_bf16_rel_err_vs_float64": loss_bf16_err, "grad_err_of_group_max": errs,
            "grad_norm": float(runs["card"][1]["grad_norm"]), "max_stats_err": stats_err,
            "param_err_of_bound_after_step": param_err, "param_share_under_lr_over_100": n_tight / n_all,
            "lr_step": lr_used, "launches": runs["card"][2], "launches_bf16": runs["card_bf16"][2],
            "tolerance": {"loss_rtol": FLOW_LOSS_RTOL, "grad_rel_of_group_max": FLOW_GRAD_REL,
                          "stats": FLOW_STATS_TOL, "bf16_loss_rtol_vs_float64": TRAIN_BF16_LOSS_RTOL,
                          "bf16_grad_rel_of_group_max_vs_float64": TRAIN_BF16_REL,
                          "params": "lr/100 where both gradients share a sign and exceed 100 eps, "
                                    "else 2 lr; plus 4 ulp"}}


def _train_shape_kernels(device, batch: int, hw8, d=128, c=256, seed=22) -> dict:
    """K1 and K2 against their plain versions at the training shapes
    (batch 6, bf16), which no kernel line covers."""
    from atdn_vslam_torch.ops.attention import attention_probs_spatial, attention_probs_spatial_plain
    from atdn_vslam_torch.ops.bilinear import coords_grid
    from atdn_vslam_torch.ops.corr_lookup import (
        build_corr_pyramid,
        lookup_corr_pyramid,
        lookup_corr_pyramid_plain,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    n = hw8[0] * hw8[1]
    q = (torch.randn((batch, n, d), generator=g, device=device) * d**-0.5).to(torch.bfloat16)
    k = torch.randn((batch, n, d), generator=g, device=device).to(torch.bfloat16)
    k1 = check_close("attention_probs (train shape)", attention_probs_spatial(q, k, *hw8, 1.0),
                     attention_probs_spatial_plain(q, k, *hw8, 1.0), **K1_TOL)
    f1 = torch.randn((batch, *hw8, c), generator=g, device=device).to(torch.bfloat16)
    f2 = torch.randn((batch, *hw8, c), generator=g, device=device).to(torch.bfloat16)
    pyramid = build_corr_pyramid(f1, f2, 4, dtype=torch.bfloat16)
    coords = coords_grid(*hw8, device=device)[None] + 4.0 * torch.randn((batch, *hw8, 2), generator=g,
                                                                        device=device)
    k2 = check_close("corr_lookup (train shape)", lookup_corr_pyramid(pyramid, coords),
                     lookup_corr_pyramid_plain(pyramid, coords), **K2_TOL)
    return {"attention_probs": k1, "corr_lookup": k2}


def flow_train(device, steps=5, remat_steps=2, seed=23, profile: int = 0, cfg_over: dict | None = None) -> dict:
    """The slice's training configuration (``FLOW_TRAIN``: the reference
    GMA net at full width, 288x960 crops, batch 6, 12 iterations, bf16
    compute with float32 parameters, the kernels) on synthetic shifted
    pairs made on the card: one warm-up step (cuDNN's autotuning), then
    ``steps`` steps timed (host clock around each synchronised step),
    finite losses, K1 once and K2 12 times per step from the counters,
    the peak memory; then ``remat_steps`` steps with ``remat=True`` and
    their peak memory (K2 twice per iteration there). ``profile`` more
    steps run under ``torch.profiler``."""
    from atdn_vslam_torch.config import Config, FlowNetConfig
    from atdn_vslam_torch.models.factory import build_flow_train_model
    from atdn_vslam_torch.training import flow as train

    t_start = time.perf_counter()
    c = {**FLOW_TRAIN, **(cfg_over or {})}
    cfg = Config(flow=FlowNetConfig(iters=c["iters"]))
    model = build_flow_train_model(cfg, device)
    model.load_state_dict(seeded_weights(cfg, seed)[0])
    state = train.init_state(model, c["lr"], c["steps_total"], c["wd"], c["clip"], c["schedule"], seed=None)
    batch = shifted_pairs(c["batch"], c["hw"], device, seed)

    def step() -> dict:
        _sync(device)
        t0 = time.perf_counter()
        _, m = train.train_step(state, *batch, gamma=c["gamma"])
        out = {key: float(v) for key, v in m.items()}  # the host copy waits for the step
        out["ms"] = (time.perf_counter() - t0) * 1e3
        return out

    first = step()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    runs = [step() for _ in range(steps)]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    losses = [first["loss"]] + [r["loss"] for r in runs]
    want = launches_of(attention_probs=steps, corr_lookup=c["iters"] * steps)
    if not np.isfinite(losses).all() or (device.type == "cuda" and launches != want):
        raise AssertionError(f"flow_train: losses {losses}, launches {launches}, not {want}")
    model.remat = True
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    remat_runs = [step() for _ in range(remat_steps)]
    remat_launches = read_launches()
    want = launches_of(attention_probs=remat_steps, corr_lookup=2 * c["iters"] * remat_steps)
    if not all(np.isfinite(r["loss"]) for r in remat_runs) or (device.type == "cuda" and remat_launches != want):
        raise AssertionError(f"flow_train: remat losses {remat_runs}, launches {remat_launches}, not {want}")
    out = {
        **{k: (list(v) if isinstance(v, tuple) else v) for k, v in c.items()},
        "dtype": "bf16 compute, float32 parameters", "first_step_s": first["ms"] / 1e3,
        "step_ms": [r["ms"] for r in runs],
        "step_ms_median": float(np.median([r["ms"] for r in runs])),
        "step_ms_p90": float(np.percentile([r["ms"] for r in runs], 90)),
        "losses": losses, "epe": [r["epe"] for r in runs], "grad_norms": [r["grad_norm"] for r in runs],
        "launches": launches, "peak_mem_gib": peak,
        "remat_step_ms": [r["ms"] for r in remat_runs], "remat_launches": remat_launches,
        "remat_peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None,
        "reduced": [f"{steps} steps (+1 warm-up, +{remat_steps} with remat) on one synthetic batch of shifted "
                    "textures instead of KITTI-2015 epochs; seeded random weights, GMA gamma 0.5"],
        "train_shape_kernels": _train_shape_kernels(device, c["batch"], (c["hw"][0] // 8, c["hw"][1] // 8)),
    }
    model.remat = False
    if profile:
        out["profile"] = profile_frames(lambda _: step(), range(profile), top=15)
    out["seconds"] = time.perf_counter() - t_start
    return out


# the artifact against the eager step, each in a fresh process: the same
# graph and kernels; the flows within 1e-3 of the largest flow, the chained
# poses within 1e-4. This process is no reference: its earlier phases ran
# the same convolution shapes with cudnn.benchmark on, and cuDNN keeps the
# plans it timed then (another algorithm, other bf16 roundings)
SERVE_FLOW_REL = 1e-3
SERVE_POSE_ATOL = 1e-4

# a serving process: loads the two artifacts through atdn_vslam_torch.serving
# alone, streams the frames with the carries chained, and reports
_SERVE_SCRIPT = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from atdn_vslam_torch import serving
from atdn_vslam_torch.ops.attention import attention_probs_spatial
from atdn_vslam_torch.ops.corr_lookup import lookup_corr_pyramid
work, device = sys.argv[2], torch.device(sys.argv[3])
sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
t0 = time.perf_counter()
step = serving.load_exported(work + "/step.pt2")
encoder = serving.load_exported(work + "/encoder.pt2")
load_s = time.perf_counter() - t0
frames = [torch.from_numpy(f).to(device).float() for f in np.load(work + "/frames.npy")]
t0 = time.perf_counter()
fmap = encoder.call(frames[0])
carry = serving.zero_inputs_like(step.exported, 3)
pose = torch.eye(4, device=device)
poses, flows, times = [], [], []
attention_probs_spatial.launches = lookup_corr_pyramid.launches = 0
for im1, im2 in zip(frames[:-1], frames[1:]):
    sync()
    t1 = time.perf_counter()
    pose, fmap, carry, flow = step.call(im1, im2, fmap, carry, pose)
    sync()
    times.append((time.perf_counter() - t1) * 1e3)
    if not poses:
        first_pose_s = time.perf_counter() - t0 + load_s
    poses.append(pose.cpu())
    flows.append(flow.cpu())
torch.save({"poses": torch.stack(poses), "flows": torch.stack(flows)}, work + "/served.pt")
print(json.dumps({
    "models_imported": any(m.startswith("atdn_vslam_torch.models") for m in sys.modules),
    "launches": {"attention_probs": attention_probs_spatial.launches, "corr_lookup": lookup_corr_pyramid.launches},
    "load_s": load_s, "load_to_first_pose_s": first_pose_s, "frame_ms": times,
}))
"""


def _stream_eager(step, encode, frames, device):
    """Frames through an eager or loaded step with the carries chained:
    poses, flows and per-frame ms (host clock around each synchronised
    call)."""
    fmap = encode(frames[0])
    carry = tuple((torch.zeros((1, 512), device=device),) * 2 for _ in range(2))
    pose = torch.eye(4, device=device)
    poses, flows, times = [], [], []
    for im1, im2 in zip(frames[:-1], frames[1:]):
        _sync(device)
        t0 = time.perf_counter()
        pose, fmap, carry, flow = step(im1, im2, fmap, carry, pose)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        poses.append(pose.cpu())
        flows.append(flow.float().cpu())
    return torch.stack(poses), torch.stack(flows), times


def serve_eager_worker(work: str, device: str, height: int, width: int, iters: int) -> None:
    """The eager step of the ``serving`` phase in a fresh process: the
    slice's bf16 build from the state dicts the phase saved, the frames
    streamed with the carries chained; writes ``eager.pt`` and prints
    the frame times."""
    from atdn_vslam_torch import serving
    from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model

    dev = torch.device(device)
    cfg = flow_config(os.devnull, (int(height), int(width)), int(iters), bf16=True)
    flow_sd, odo_sd = torch.load(os.path.join(work, "weights.pt"))
    flow = build_flow_model(cfg, dev)
    flow.load_state_dict(flow_sd)
    odo = build_odometry_model(cfg, dev)
    odo.load_state_dict(odo_sd)
    ims = [torch.from_numpy(f).to(dev).float() for f in np.load(os.path.join(work, "frames.npy"))]
    with torch.no_grad():
        poses, flows, times = _stream_eager(serving.make_stream_step(flow, odo, (None, None)),
                                            lambda im: serving.encode_frame(flow, None, im), ims, dev)
    torch.save({"poses": poses, "flows": flows}, os.path.join(work, "eager.pt"))
    print(json.dumps({"frame_ms": times}))


def _run_worker(args: list[str], what: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", *args], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serving: the {what} process failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _served_build(device, work: str, name: str, hw, iters: int, switch: dict, frames: int, seed: int = 3):
    """A float32 build of the flow net at ``hw`` exported with the
    odometry net, loaded back and streamed over ``frames`` frames, its
    launches per frame and its largest flow and pose difference from the
    eager step on the same weights and frames."""
    from atdn_vslam_torch import serving
    from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model

    cfg = flow_config(os.devnull, hw, iters, bf16=False)
    flow_sd, odo_sd = seeded_weights(cfg, seed=seed)
    flow = build_flow_model(cfg, device, **switch)
    flow.load_state_dict(flow_sd)
    odo = build_odometry_model(cfg, device)
    odo.load_state_dict(odo_sd)
    path = os.path.join(work, f"{name}.pt2")
    serving.save_stream_step(serving.export_stream_step(flow, odo, None, None, *hw), path)
    step = serving.load_exported(path)
    ims = [torch.from_numpy(f).to(device).float() for f in synthetic_frames(frames, hw, seed=4)]
    with torch.no_grad():
        eager = _stream_eager(serving.make_stream_step(flow, odo, (None, None)),
                              lambda im: serving.encode_frame(flow, None, im), ims, device)
        reset_launches()
        got = _stream_eager(step.call, lambda im: serving.encode_frame(flow, None, im), ims, device)
        launches = read_launches()
    pairs = frames - 1
    return {
        "launches_per_frame": {k: v / pairs for k, v in launches.items() if v},
        "max_abs_flow_diff_px": float((got[1] - eager[1]).abs().max()),
        "max_abs_pose_diff": float((got[0] - eager[0]).abs().max()),
        "finite": bool(got[1].isfinite().all()),
    }, (flow, odo, cfg, ims)


def serving_phase(device, work: str, hw=FULL_HW, iters=12, frames=17, small_hw=(96, 192),
                  small_iters=12, profile: int = 0) -> dict:
    """The serving export (``atdn_vslam_torch/serving.py``): the slice's
    bf16 step at ``hw`` (seeded weights, gamma 0.5) and the encoder
    exported on the card, saved, then loaded by a fresh ``python3``
    process that imports ``atdn_vslam_torch.serving`` alone and streams
    ``frames`` frames with the carries chained through
    ``zero_inputs_like``; its flows and chained poses against the eager
    ``make_stream_step`` on the same weights and frames in another fresh
    process (``SERVE_FLOW_REL``, ``SERVE_POSE_ATOL``; the eager step in
    this process is reported beside it), its launches (K1 once, K2
    ``iters`` times per frame), and both processes' ms per frame; then
    the artifact and the eager step in turns in this process (the same
    cuDNN plans), and the artifact's graph by operator (``profile`` more
    pairs of each under ``torch.profiler``). Then, float32 at ``small_hw``: the ``use_pallas=True`` and
    ``corr_nlanes=True`` builds (their launches per frame, outputs
    against eager), and the default build moved to the CPU with
    ``move_to_device_pass`` against the CPU eager step, and exported with
    the weights as arguments and called with a second seed's weights
    against eager on those (the ``agreement`` bounds)."""
    from torch.export.passes import move_to_device_pass

    from atdn_vslam_torch import serving
    from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model

    t_start = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    cfg = flow_config(os.devnull, hw, iters, bf16=True)
    flow_sd, odo_sd = seeded_weights(cfg, seed=0)
    flow = build_flow_model(cfg, device)
    flow.load_state_dict(flow_sd)
    odo = build_odometry_model(cfg, device)
    odo.load_state_dict(odo_sd)
    t0 = time.perf_counter()
    serving.save_stream_step(serving.export_stream_step(flow, odo, None, None, *hw), os.path.join(work, "step.pt2"))
    serving.save_stream_step(serving.export_encoder(flow, None, *hw), os.path.join(work, "encoder.pt2"))
    export_s = time.perf_counter() - t0
    clip = synthetic_frames(frames, hw, seed=1)
    np.save(os.path.join(work, "frames.npy"), np.stack(clip))
    torch.save((flow_sd, odo_sd), os.path.join(work, "weights.pt"))
    ims = [torch.from_numpy(f).to(device).float() for f in clip]
    with torch.no_grad():
        parent = _stream_eager(serving.make_stream_step(flow, odo, (None, None)),
                               lambda im: serving.encode_frame(flow, None, im), ims, device)
    served_info = _run_worker([_SERVE_SCRIPT, REPO, work, str(device)], "serving")
    eager_info = _run_worker([
        f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
        f"chip_smoke.serve_eager_worker({work!r}, {str(device)!r}, {hw[0]}, {hw[1]}, {iters})"
    ], "eager")
    served = torch.load(os.path.join(work, "served.pt"))
    eager = torch.load(os.path.join(work, "eager.pt"))
    poses, flows, eager_ms = eager["poses"], eager["flows"], eager_info["frame_ms"]
    pairs = frames - 1
    if served_info["models_imported"]:
        raise AssertionError("serving: the serving process imported atdn_vslam_torch.models")
    want = {"attention_probs": pairs, "corr_lookup": iters * pairs}
    if device.type == "cuda" and served_info["launches"] != want:
        raise AssertionError(f"serving: the artifact launched {served_info['launches']}, not {want}")
    flow_diff = float((served["flows"] - flows).abs().max())
    flow_scale = float(flows.abs().max())
    pose_diff = float((served["poses"] - poses).abs().max())
    if (not bool(served["flows"].isfinite().all()) or flow_diff > SERVE_FLOW_REL * flow_scale
            or pose_diff > SERVE_POSE_ATOL):
        raise AssertionError(f"serving: artifact against eager: flows {flow_diff} px (of {flow_scale}), "
                             f"poses {pose_diff}")
    steady = slice(3, None)  # the first frames include cuDNN's and the allocator's warm-up
    loaded = serving.load_exported(os.path.join(work, "step.pt2"))
    eager_step = serving.make_stream_step(flow, odo, (None, None))
    turns = {"artifact": [], "eager": []}
    with torch.no_grad():
        for name in ("artifact", "eager", "eager", "artifact"):
            fn = loaded.call if name == "artifact" else eager_step
            turns[name] += _stream_eager(fn, lambda im: serving.encode_frame(flow, None, im), ims, device)[2][3:]
    calls = Counter(  # the graph and the subgraphs of its higher-order ops (autocast regions)
        str(n.target) for gm in loaded.exported.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
        for n in gm.graph.nodes if n.op == "call_function"
    )
    out = {
        "hw": list(hw), "iters": iters, "frames": frames, "dtype": "bfloat16",
        "export_s": export_s, "step_bytes": os.path.getsize(os.path.join(work, "step.pt2")),
        "encoder_bytes": os.path.getsize(os.path.join(work, "encoder.pt2")),
        "load_s": served_info["load_s"], "load_to_first_pose_s": served_info["load_to_first_pose_s"],
        "models_imported": served_info["models_imported"], "launches": served_info["launches"],
        "max_abs_flow_diff_px": flow_diff, "max_abs_flow_px": flow_scale, "max_abs_pose_diff": pose_diff,
        "tol": {"flow_rel": SERVE_FLOW_REL, "pose_atol": SERVE_POSE_ATOL},
        "max_abs_flow_diff_px_this_process": float((served["flows"] - parent[1]).abs().max()),
        "max_abs_pose_diff_this_process": float((served["poses"] - parent[0]).abs().max()),
        "ms_per_frame_median_this_process": float(np.median(parent[2][3:])),
        "ms_per_frame_median": float(np.median(served_info["frame_ms"][steady])),
        "ms_per_frame_median_eager": float(np.median(eager_ms[steady])),
        "frame_ms": served_info["frame_ms"], "frame_ms_eager": eager_ms,
        "this_process_turns_median_ms": {k: float(np.median(v)) for k, v in turns.items()},
        "graph_calls": sum(calls.values()), "graph_calls_top": calls.most_common(10),
    }
    if profile:
        with torch.no_grad():
            fmap = serving.encode_frame(flow, None, ims[0])
            carry = serving.zero_inputs_like(loaded.exported, 3)
            pose = torch.eye(4, device=device)
            for name, fn in (("artifact", loaded.call), ("eager", eager_step)):
                out[f"profile_{name}"] = profile_frames(
                    lambda i, fn=fn: fn(ims[i], ims[i + 1], fmap, carry, pose), range(profile)
                )

    # the kernels of the other builds, float32 at small_hw
    builds = {
        "use_pallas_true": ({"use_pallas": True}, {"corr_dot": 4, "flash_attend": small_iters,
                                                   "corr_lookup": small_iters}),
        "corr_nlanes": ({"corr_nlanes": True}, {"attention_probs": 1, "corr_lookup": small_iters,
                                                "corr_lookup_nlanes": small_iters}),
    }
    for name, (switch, per_frame) in builds.items():
        res, _ = _served_build(device, work, name, small_hw, small_iters, switch, frames=4)
        if (device.type == "cuda" and res["launches_per_frame"] != per_frame) or not res["finite"]:
            raise AssertionError(f"serving: {name} launched {res['launches_per_frame']} per frame, not {per_frame}")
        if res["max_abs_flow_diff_px"] > FLOW_F32_TOL or res["max_abs_pose_diff"] > 1e-4:
            raise AssertionError(f"serving: {name} artifact against eager: {res}")
        out[name] = res
    res, (flow32, odo32, cfg32, small) = _served_build(device, work, "default_f32", small_hw, 2, {}, frames=3)
    if res["max_abs_flow_diff_px"] > FLOW_F32_TOL or res["max_abs_pose_diff"] > 1e-4:
        raise AssertionError(f"serving: default float32 artifact against eager: {res}")
    out["default_f32"] = res

    # the card's artifact on the CPU: each atdn:: op takes its plain version
    cpu = torch.device("cpu")
    moved = serving.Loaded(move_to_device_pass(torch.export.load(os.path.join(work, "default_f32.pt2")), cpu))
    flow_cpu = build_flow_model(cfg32, cpu)
    flow_cpu.load_state_dict(flow32.state_dict())
    odo_cpu = build_odometry_model(cfg32, cpu)
    odo_cpu.load_state_dict(odo32.state_dict())
    ims_cpu = [im.cpu() for im in small]
    with torch.no_grad():
        want = _stream_eager(serving.make_stream_step(flow_cpu, odo_cpu, (None, None)),
                             lambda im: serving.encode_frame(flow_cpu, None, im), ims_cpu, cpu)
        got = _stream_eager(moved.call, lambda im: serving.encode_frame(flow_cpu, None, im), ims_cpu, cpu)
    moved_res = {"max_abs_flow_diff_px": float((got[1] - want[1]).abs().max()),
                 "max_abs_pose_diff": float((got[0] - want[0]).abs().max())}
    if moved_res["max_abs_flow_diff_px"] > FLOW_F32_TOL or moved_res["max_abs_pose_diff"] > 1e-4:
        raise AssertionError(f"serving: the artifact moved to the CPU against the CPU eager step: {moved_res}")
    out["moved_to_cpu"] = moved_res

    # the weights as arguments, called with a second seed's weights
    args_path = os.path.join(work, "step_args.pt2")
    serving.save_stream_step(serving.export_stream_step(flow32, odo32, None, None, *small_hw, bake_weights=False),
                             args_path)
    step_args = serving.load_exported(args_path)
    other = [{k: v.to(device) for k, v in sd.items()} for sd in seeded_weights(cfg32, seed=5)]
    live = serving.make_stream_step(flow32, odo32)
    with torch.no_grad():
        want = _stream_eager(lambda *a: live(*other, *a), lambda im: serving.encode_frame(flow32, other[0], im),
                             small, device)
        got = _stream_eager(lambda *a: step_args.call(*other, *a),
                            lambda im: serving.encode_frame(flow32, other[0], im), small, device)
    args_res = {"max_abs_flow_diff_px": float((got[1] - want[1]).abs().max()),
                "max_abs_pose_diff": float((got[0] - want[0]).abs().max())}
    if args_res["max_abs_flow_diff_px"] > FLOW_F32_TOL or args_res["max_abs_pose_diff"] > 1e-4:
        raise AssertionError(f"serving: the weights as arguments against eager on them: {args_res}")
    out["weights_as_arguments"] = args_res
    out["seconds"] = time.perf_counter() - t_start
    return out


def _positional_model(iters: int, dtype, mode: str | None, seed: int, device):
    from atdn_vslam_torch.models.factory import cast_flow_model, init_params
    from atdn_vslam_torch.models.flow.network import RAFTGMA

    model = init_params(RAFTGMA(iters=iters, **({mode: True} if mode else {})), seed)
    with torch.no_grad():
        model.update_block.aggregator.gamma.fill_(0.5)
    model.dtype = dtype
    return cast_flow_model(model.to(device), dtype).eval()


def positional(device, small_hw=(96, 192), small_iters=2, hw=FULL_HW, iters=12, pairs=6, seed=24,
               profile: int = 0) -> dict:
    """GMA's positional attention (``models/flow/gma.py`` RelPosEmb): in
    float32 at ``small_hw``, ``position_and_content`` and
    ``position_only`` on the card against the CPU (``FLOW_F32_TOL``, no
    K1, K2 every iteration); then ``position_and_content`` at ``hw``,
    bf16, ``iters`` iterations, seeded weights and positional tables,
    ``pairs`` pairs streamed with the frame cache: ms per pair (host
    clock around each synchronised pair, the first left out), peak
    memory, finite flows, K1 0 and K2 ``iters`` launches per pair, and
    the bf16 flows against the float32 build's (``FLOW_BF16_REL``); the
    content-only build on the same seed is timed beside it (``profile``
    more pairs of both bf16 builds under ``torch.profiler``)."""
    t_start = time.perf_counter()
    out = {}
    cpu = torch.device("cpu")
    clip = synthetic_frames(2, small_hw, seed=4)
    for mode in ("position_and_content", "position_only"):
        flows, launches = {}, None
        for dev in (device, cpu):
            model = _positional_model(small_iters, torch.float32, mode, seed, dev)
            im1, im2 = (torch.from_numpy(f).to(dev).float()[None] for f in clip)
            reset_launches()
            with torch.inference_mode():
                flows[dev.type] = [f.cpu() for f in model(im1, im2)]
            if dev.type == "cuda":
                launches = read_launches()
        want = launches_of(corr_lookup=small_iters)
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"positional: {mode} launched {launches}, not {want}")
        diff = max(float((a - b).abs().max()) for a, b in zip(flows[device.type], flows["cpu"]))
        if not all(bool(f.isfinite().all()) for f in flows[device.type]) or diff > FLOW_F32_TOL:
            raise AssertionError(f"positional: {mode} card against CPU {diff} > {FLOW_F32_TOL}")
        out[mode] = {"hw": list(small_hw), "iters": small_iters, "max_abs_flow_diff_px": diff,
                     "tol_px": FLOW_F32_TOL, "launches": launches}

    ims = [torch.from_numpy(f).to(device).float()[None] for f in synthetic_frames(pairs + 1, hw, seed=1)]
    runs, profiles = {}, {}
    for dtype, mode in ((torch.bfloat16, "position_and_content"), (torch.float32, "position_and_content"),
                        (torch.bfloat16, None)):
        model = _positional_model(iters, dtype, mode, seed, device)
        flows, times = [], []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with torch.inference_mode():
            fmap = model(ims[0], encode_only=True)
            reset_launches()
            for i in range(pairs):
                _sync(device)
                t0 = time.perf_counter()
                (low, _), fmap = model(ims[i], ims[i + 1], fmap1=fmap, return_features=True)
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
                flows.append(low.float().cpu())
            key = (dtype, mode)
            runs[key] = (flows, times, read_launches(),
                         torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None)
            if profile and dtype == torch.bfloat16:
                profiles[mode or "content_only"] = profile_frames(
                    lambda i: model(ims[i], ims[i + 1], fmap1=fmap, return_features=True), range(min(profile, pairs))
                )
        del model
    flows, times, launches, peak = runs[(torch.bfloat16, "position_and_content")]
    f32 = runs[(torch.float32, "position_and_content")]
    want = launches_of(corr_lookup=iters * pairs)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"positional: the KITTI build launched {launches} for {pairs} pairs, not {want}")
    diff = max(float((a - b).abs().max()) for a, b in zip(flows, f32[0]))
    scale = max(float(f.abs().max()) for f in f32[0])
    if not all(bool(f.isfinite().all()) for f in flows) or diff > FLOW_BF16_REL * scale:
        raise AssertionError(f"positional: bf16 flows differ from float32 by {diff} px > {FLOW_BF16_REL} x {scale}")
    out.update({
        "hw": list(hw), "iters": iters, "pairs": pairs, "dtype": "bfloat16", "launches": launches,
        "ms_per_pair": float(np.mean(times[1:])), "ms_per_pair_median": float(np.median(times[1:])),
        "pair_ms": times, "peak_mem_gib": peak,
        "ms_per_pair_f32": float(np.mean(f32[1][1:])), "peak_mem_gib_f32": f32[3],
        "ms_per_pair_content_only": float(np.mean(runs[(torch.bfloat16, None)][1][1:])),
        "peak_mem_gib_content_only": runs[(torch.bfloat16, None)][3],
        "bf16_vs_f32_max_abs_flow_low_diff_px": diff, "max_abs_flow_low_px_f32": scale, "rel_tol": FLOW_BF16_REL,
        "seconds": time.perf_counter() - t_start, **({"profile": profiles} if profile else {}),
    })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write every phase's result to this JSON file")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="after each slice and each build of the nlanes phase, profile N more "
                        "streaming steps with torch.profiler; in the mapping phase N train "
                        "steps and N warm queries; N solves of each pose-graph case, N "
                        "odometry train steps and N flow train steps; N steps of the serving "
                        "artifact and of the eager step, N pairs of the positional and the "
                        "content-only build")
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
    for name, fn in (("k1_backward", k1_backward), ("k2_backward", k2_backward), ("k3_backward", k3_backward)):
        results[name] = fn(device)
        emit(name, card=card, **results[name])
    torch.cuda.empty_cache()
    results["mapping"] = mapping(device, os.path.join(work, "map_keyframes"), profile=args.profile)
    emit("mapping", card=card, **results["mapping"])
    results["loop_closure"] = loop_closure(device, os.path.join(work, "loop_keyframes"))
    emit("loop_closure", card=card, **results["loop_closure"])
    results["pose_graph"] = pose_graph(device, profile=args.profile)
    emit("pose_graph", card=card, **results["pose_graph"])
    results["odometry_train"] = odometry_train(device, profile=args.profile)
    emit("odometry_train", card=card, **results["odometry_train"])
    torch.cuda.empty_cache()
    results["flow_train_agreement"] = flow_train_agreement(device)
    emit("flow_train_agreement", card=card, **results["flow_train_agreement"])
    results["flow_train"] = flow_train(device, profile=args.profile)
    emit("flow_train", card=card, **results["flow_train"])
    torch.cuda.empty_cache()
    results["serving"] = serving_phase(device, os.path.join(work, "serving"), profile=args.profile)
    emit("serving", card=card, **results["serving"])
    results["positional"] = positional(device, profile=args.profile)
    emit("positional", card=card, **results["positional"])
    kernels[0]["pass_ms"] = k1_pass_ms(device)

    # each kernel's launches from the run of the path that drives it
    driver = {"attention_probs": "slice", "corr_lookup": "slice",
              "flash_attend": "slice_2x", "corr_dot": "forced_streaming",
              "corr_lookup_nlanes": "nlanes", "apply_probs": "entry_points",
              "corr_lookup_slab": "entry_points", "corr_dot_tiled": "entry_points"}
    for k in kernels:
        k["launches_from"] = driver[k["name"]]
        k["launches"] = results[driver[k["name"]]]["launches"][k["name"]]
        if k["name"] in ("attention_probs", "corr_lookup"):  # the other paths that drive them
            k["launches_loop_closure"] = results["loop_closure"]["launches"][k["name"]]
            k["launches_flow_train"] = results["flow_train"]["launches"][k["name"]]
    # the serving path's launches: K1 and K2 from the KITTI artifact's
    # process, K3, K5 and K2n from the float32 builds' artifacts; K2 from
    # the positional KITTI build
    serve = results["serving"]
    serve_launches = {
        **serve["launches"],
        "corr_dot": serve["use_pallas_true"]["launches_per_frame"]["corr_dot"],
        "flash_attend": serve["use_pallas_true"]["launches_per_frame"]["flash_attend"],
        "corr_lookup_nlanes": serve["corr_nlanes"]["launches_per_frame"]["corr_lookup_nlanes"],
    }
    for k in kernels:
        k["op"] = f"atdn::{k['name']}"
        if k["name"] in serve_launches:
            k["launches_serving"] = serve_launches[k["name"]]
        if k["name"] == "corr_lookup":
            k["launches_positional"] = results["positional"]["launches"]["corr_lookup"]
    backward = {"attention_probs": "k1_backward", "corr_lookup": "k2_backward", "corr_dot": "k3_backward"}
    for k in kernels:
        if k["name"] in backward:
            r = results[backward[k["name"]]]
            k.update(backward_ms=r["ms"], backward_bound_ms=r["bound_ms"], backward_bound_by=r["bound_by"])
    results["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extras = ("op", "launches_loop_closure", "launches_flow_train", "launches_serving", "launches_positional",
              "backward_ms", "backward_bound_ms",
              "backward_bound_by", "design", "ptxas", "blocks_per_sm", "splits", "pass_ms", "ms_2x", "bound_ms_2x",
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
