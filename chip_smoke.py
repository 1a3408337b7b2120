#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out results.json] [--profile N]

Phases, each printing one JSON line; any failure exits non-zero:

  1. device: the ``nvidia-smi`` name and power limit, torch and CUDA
     versions;
  2. build: compiles every CUDA kernel of the port with ``nvcc``;
  3. kernels: each kernel against its plain PyTorch version at the
     KITTI main-path shapes (376x1232 -> 47x154 tokens), with its time,
     the plain version's, one library call's and the least time the
     card could take (the bound);
  4. agreement: the streaming runtime on the GPU (float32, kernels) and
     on the CPU (float32, plain versions) give the same poses on a
     small input;
  5. slice: the streaming odometry step through ``SlamRuntime`` at
     376x1232, 12 GMA iterations, bf16 flow compute, seeded random
     weights with a non-zero GMA gamma, with the kernels' launch counts
     read around the run;
  6. the ``kernels`` line, the card, and last the ``ok`` line.

``--profile N`` adds N more streaming steps under ``torch.profiler`` to
the slice's line: device time by kernel and the device's idle share.

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
K1_TOL = {"rtol": 2.0**-7, "atol": 1e-8}  # one bf16 ulp: both round a float32 softmax
K2_TOL = {"rtol": 1e-5, "atol": 1e-5}  # both lerp the same bf16 taps in float32


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


def k1_attention_probs(device, hw8=(47, 154), d=128, dtype=torch.bfloat16, seed=0) -> dict:
    from atdn_vslam_torch.ops.attention import (
        attention_probs_spatial,
        attention_probs_spatial_plain,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw8
    n = h * w
    # GMA's q arrives pre-scaled by d**-0.5; scores come out with std ~1
    q = (torch.randn((1, n, d), generator=g, device=device) * d**-0.5).to(dtype)
    k = torch.randn((1, n, d), generator=g, device=device).to(dtype)
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
    return {
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


def _in_bound_taps(pyramid, coords, radius: int) -> int:
    """Taps of the (2r+2)^2 patches that lie inside their level: what a
    gather must read for these coordinates."""
    flat = coords.reshape(-1, 2).float()
    taps = torch.arange(2 * radius + 2, device=coords.device) - radius
    total = 0
    for level, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        c = torch.floor(flat / 2.0**level)
        rows = ((c[:, 1:2] + taps >= 0) & (c[:, 1:2] + taps < hl)).sum(1)
        cols = ((c[:, 0:1] + taps >= 0) & (c[:, 0:1] + taps < wl)).sum(1)
        total += int((rows * cols).sum())
    return total


def k2_corr_lookup(device, hw8=(47, 154), c=256, dtype=torch.bfloat16, seed=1, radius=4) -> dict:
    from atdn_vslam_torch.ops.bilinear import coords_grid
    from atdn_vslam_torch.ops.corr_lookup import (
        build_corr_pyramid,
        lookup_corr_pyramid,
        lookup_corr_pyramid_plain,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw8
    f1 = torch.randn((1, h, w, c), generator=g, device=device).to(dtype)
    f2 = torch.randn((1, h, w, c), generator=g, device=device).to(dtype)
    pyramid = build_corr_pyramid(f1, f2, 4, dtype=dtype)
    coords = coords_grid(h, w, device=device)[None]
    coords = coords + 6.0 * torch.randn(coords.shape, generator=g, device=device)
    # some windows partly and wholly outside every level
    far = torch.rand(coords.shape[:-1], generator=g, device=device) < 0.05
    coords[far] = coords[far] * 40.0 - 1000.0
    coords[0, 0, :3] = torch.tensor([[-3.5, -2.25], [w - 1.5, h + 0.75], [-20.0, 5.0]], device=device)
    got = lookup_corr_pyramid(pyramid, coords, radius)
    ref = lookup_corr_pyramid_plain(pyramid, coords, radius)
    if got.shape != ref.shape:
        raise AssertionError(f"corr_lookup: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    max_err = check_close("corr_lookup", got, ref, **K2_TOL)

    span = 2 * radius + 1
    n = h * w

    def library():  # the reference CorrBlock's grid_sample, one call per level
        d = torch.arange(-radius, radius + 1, device=device, dtype=torch.float32)
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).reshape(1, span, span, 2)
        outs = []
        for level, corr in enumerate(pyramid):
            hl, wl = corr.shape[-2:]
            xy = coords.reshape(n, 1, 1, 2) / 2**level + delta
            grid = torch.stack([2 * xy[..., 0] / (wl - 1) - 1, 2 * xy[..., 1] / (hl - 1) - 1], -1)
            outs.append(F.grid_sample(
                corr.reshape(n, 1, hl, wl), grid.to(corr.dtype), mode="bilinear",
                padding_mode="zeros", align_corners=True,
            ))
        return outs

    bytes_moved = (
        _in_bound_taps(pyramid, coords, radius) * pyramid[0].element_size()
        + coords.numel() * 4 + got.numel() * got.element_size()
    )
    bound_ms, bound_by = bound(bytes_moved, 0.0, dtype)
    return {
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


def profile_frames(rt, frames, top: int = 25) -> dict:
    """Device time by kernel over ``frames`` more streaming steps
    (``torch.profiler``), and the share of the wall time the device was
    busy (one stream, so kernel times do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            rt(f)
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


def agreement(device, keyframes_path: str, hw=(96, 192), iters=2, frames=4) -> dict:
    """Poses of the runtime on ``device`` (float32) against the CPU's
    plain versions, same weights and frames."""
    from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig

    cfg = Config(
        keyframes_path=keyframes_path,
        flow=FlowNetConfig(iters=iters, mixed_precision=False),
        slam=SlamConfig(image_height=hw[0], image_width=hw[1]),
    )
    weights = seeded_weights(cfg, seed=3)
    clip = synthetic_frames(frames, hw, seed=4)
    got, _ = run_stream(new_runtime(cfg, weights, device), clip)
    ref, _ = run_stream(new_runtime(cfg, weights, torch.device("cpu")), clip)
    err = float(np.abs(got - ref).max())
    tol = 1e-4  # float32 on both sides, TF32 off; summation order differs
    if not np.isfinite(got).all() or err > tol:
        raise AssertionError(f"agreement: max pose difference {err} > {tol}")
    return {"hw": list(hw), "iters": iters, "frames": frames, "max_abs_pose_diff": err, "tol": tol}


def stream_slice(
    device, keyframes_path: str, hw=FULL_HW, iters=12, frames=20, profile: int = 0
) -> dict:
    from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig
    from atdn_vslam_torch.ops.attention import attention_probs_spatial
    from atdn_vslam_torch.ops.corr_lookup import lookup_corr_pyramid

    cfg = Config(
        keyframes_path=keyframes_path,
        flow=FlowNetConfig(iters=iters, mixed_precision=True),
        slam=SlamConfig(image_height=hw[0], image_width=hw[1]),
    )
    weights = seeded_weights(cfg, seed=0)
    clip = synthetic_frames(frames + profile, hw, seed=1)
    rt = new_runtime(cfg, weights, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    attention_probs_spatial.launches = 0
    lookup_corr_pyramid.launches = 0
    poses, times = run_stream(rt, clip[:frames])
    launches = {
        "attention_probs": attention_probs_spatial.launches,
        "corr_lookup": lookup_corr_pyramid.launches,
    }
    pairs = frames - 1
    if poses.shape != (frames, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError("slice: poses are not finite 4x4 matrices")
    if device.type == "cuda" and launches != {
        "attention_probs": pairs, "corr_lookup": iters * pairs,
    }:
        raise AssertionError(f"slice: launches {launches} for {pairs} frame pairs")
    steady = times[min(3, frames - 1):]  # the first pairs include cuDNN's autotuning
    ms = float(np.mean(steady))
    out = {
        "hw": list(hw), "iters": iters, "frames": frames, "dtype": "bfloat16",
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write every phase's result to this JSON file")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="after the slice, profile N more streaming steps with torch.profiler")
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
    for k in kernels:
        emit("kernel", card=card, **k)

    work = os.path.join(REPO, "build", "chip_smoke")
    results["agreement"] = agreement(device, os.path.join(work, "agree_keyframes"))
    emit("agreement", **results["agreement"])

    results["slice"] = stream_slice(
        device, os.path.join(work, "keyframes"), profile=args.profile
    )
    emit("slice", card=card, **results["slice"])

    for k in kernels:
        k["launches"] = results["slice"]["launches"][k["name"]]
    results["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
