"""Flow-network evaluation suites and benchmark submission writers, the
counterpart of the JAX package's ``cli/evaluate_flow.py`` (ref:
GMA/evaluate.py: validate_chairs/sintel/kitti at :153,211,348,
create_sintel_submission/create_kitti_submission at :21,100).

Protocol notes:
  * Sintel/Chairs validation pools EPE over ALL pixels of all frames and
    reports 1px/3px/5px inlier rates (GMA/evaluate.py:233-240);
  * KITTI validation averages per-image valid-pixel EPE and pools the
    F1-all outlier rate (GMA/evaluate.py:362-376);
  * submissions run 32 iterations; the Sintel writer optionally warm
    starts each sequence's next pair by forward-interpolating the
    previous low-res flow (GMA/evaluate.py:29-48).

The flow net runs in test mode on ``--device`` (default cuda: bf16 with
the kernels; cpu: float32 with their plain versions). ``--flow-checkpoint``
is a reference GMA ``.pth`` or ``train_flow``'s ``--output``, read by
``load_reference_checkpoint``; without one the net has seeded random
weights.

Usage:
  python -m atdn_vslam_torch.cli.evaluate_flow --dataset kitti \\
      --root /data/kitti2015 --flow-checkpoint gma.pth [--iters 24]
  python -m atdn_vslam_torch.cli.evaluate_flow --dataset sintel \\
      --root /data/sintel --submission out_dir [--warm-start]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from atdn_vslam_torch.checkpoint import load_reference_checkpoint
from atdn_vslam_torch.config import Config, FlowNetConfig
from atdn_vslam_torch.models.factory import build_flow_model, init_params
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.ops.padding import InputPadder
from atdn_vslam_torch.utils.helpers import log, resolve_device


def _forward_fn(model: RAFTGMA):
    """run(im1, im2, flow_init=None) on (H, W, 3) numpy frames ->
    (low-res flow, flow) as float32 numpy."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def run(im1, im2, flow_init=None):
        a, b = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)[None] for x in (im1, im2))
        init = None if flow_init is None else torch.from_numpy(np.asarray(flow_init, np.float32)).to(device)
        lo, up = model(a, b, flow_init=init)
        return lo[0].float().cpu().numpy(), up[0].float().cpu().numpy()

    return run


def _padded_run(run, padder: InputPadder, im1, im2, flow_init=None):
    p1, p2 = (t.numpy() for t in padder.pad(torch.from_numpy(im1), torch.from_numpy(im2)))
    lo, up = run(p1, p2, flow_init)
    return lo, padder.unpad(torch.from_numpy(up)).numpy()


def evaluate_dataset(model: RAFTGMA, dataset, limit=None, pad_mode: str = "sintel") -> dict:
    """Pooled EPE/1-3-5px (+ KITTI-style per-image EPE and F1-all) over a
    flow dataset.

    :param pad_mode: InputPadder mode: 'kitti' pads the height at the
        bottom only, 'sintel' centers (ref: GMA/core/utils/utils.py:8-17)."""
    run = _forward_fn(model)
    pixel_epes, image_epes, f1s = [], [], []
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        im1, im2, flow_gt, valid = dataset[i]
        _, up = _padded_run(run, InputPadder(im1.shape, mode=pad_mode), im1, im2)
        err = np.linalg.norm(up - flow_gt, axis=-1)
        mask = valid >= 0.5
        if mask.sum() == 0:
            continue
        pixel_epes.append(err[mask])
        image_epes.append(err[mask].mean())
        mag = np.linalg.norm(flow_gt, axis=-1)
        out = (err > 3.0) & (err / np.maximum(mag, 1e-9) > 0.05)
        f1s.append(out[mask])
    if not pixel_epes:
        # an empty/misconfigured dataset must not report a perfect score
        raise ValueError("no valid frames evaluated — check the dataset root")
    pooled = np.concatenate(pixel_epes)
    return {
        "epe": float(np.mean(image_epes)),
        "epe_all": float(pooled.mean()),
        "1px": float((pooled < 1).mean()),
        "3px": float((pooled < 3).mean()),
        "5px": float((pooled < 5).mean()),
        "f1_all": float(np.concatenate(f1s).mean() * 100.0),
        "frames": len(image_epes),
    }


def validate_chairs(model: RAFTGMA, root, limit=None) -> dict:
    """FlyingChairs validation-split pooled EPE (ref: GMA/evaluate.py:153-171)."""
    from atdn_vslam_torch.data.flow_datasets import FlyingChairsDataset

    ds = FlyingChairsDataset(root, split="validation")
    # without FlyingChairs_train_val.txt the split cannot be applied
    suffix = "" if ds.split_applied else " (NO split file found — EPE over ALL pairs)"
    stats = evaluate_dataset(model, ds, limit)
    log(f"Validation (chairs) EPE: {stats['epe_all']:.3f}{suffix}")
    return {"chairs_epe": stats["epe_all"], "split_applied": ds.split_applied}


def validate_sintel(model: RAFTGMA, root, limit=None) -> dict:
    """Sintel train-split pooled EPE + 1/3/5px per pass
    (ref: GMA/evaluate.py:211-243)."""
    from atdn_vslam_torch.data.flow_datasets import SintelDataset

    results = {}
    for dstype in ("clean", "final"):
        stats = evaluate_dataset(model, SintelDataset(root, dstype=dstype), limit, pad_mode="sintel")
        log(f"Validation ({dstype}) EPE: {stats['epe_all']:.3f}, 1px: {stats['1px']:.3f}, "
            f"3px: {stats['3px']:.3f}, 5px: {stats['5px']:.3f}")
        results[dstype] = stats["epe_all"]
    return results


def validate_kitti(model: RAFTGMA, root, limit=None) -> dict:
    """KITTI-2015 train split: mean per-image EPE + pooled F1-all
    (ref: GMA/evaluate.py:348-378)."""
    from atdn_vslam_torch.data.flow_datasets import KittiFlowDataset

    stats = evaluate_dataset(model, KittiFlowDataset(root), limit, pad_mode="kitti")
    log(f"Validation KITTI: {stats['epe']:.3f}, {stats['f1_all']:.3f}")
    return {"kitti_epe": stats["epe"], "kitti_f1": stats["f1_all"]}


def create_sintel_submission(model: RAFTGMA, root, output_path, warm_start=False, limit=None) -> str:
    """Sintel-leaderboard .flo files for the test split (ref:
    GMA/evaluate.py:21-49); pass a 32-iteration model for the reference
    protocol."""
    from atdn_vslam_torch.data.flow_datasets import SintelDataset
    from atdn_vslam_torch.data.flow_io import forward_interpolate, write_flo

    run = _forward_fn(model)
    for dstype in ("clean", "final"):
        ds = SintelDataset(root, split="test", dstype=dstype)
        flow_prev, seq_prev = None, None
        n = len(ds) if limit is None else min(limit, len(ds))
        for i in range(n):
            im1, im2, _, _ = ds[i]
            scene, frame = ds.extra_info[i]
            if scene != seq_prev:
                flow_prev = None
            lo, flow = _padded_run(run, InputPadder(im1.shape, mode="sintel"), im1, im2, flow_prev)
            if warm_start:
                flow_prev = forward_interpolate(lo)[None]
            out_dir = os.path.join(output_path, dstype, scene)
            os.makedirs(out_dir, exist_ok=True)
            write_flo(os.path.join(out_dir, f"frame{frame + 1:04d}.flo"), flow)
            seq_prev = scene
    return output_path


def create_kitti_submission(model: RAFTGMA, root, output_path, limit=None) -> str:
    """KITTI-leaderboard 16-bit flow pngs for the testing split
    (ref: GMA/evaluate.py:100-118)."""
    from atdn_vslam_torch.data.flow_datasets import KittiFlowDataset
    from atdn_vslam_torch.data.flow_io import write_kitti_png_flow

    ds = KittiFlowDataset(root, split="testing")
    run = _forward_fn(model)
    os.makedirs(output_path, exist_ok=True)
    n = len(ds) if limit is None else min(limit, len(ds))
    for i in range(n):
        im1, im2, _, _ = ds[i]
        _, flow = _padded_run(run, InputPadder(im1.shape, mode="kitti"), im1, im2)
        write_kitti_png_flow(os.path.join(output_path, ds.extra_info[i]), flow)
    return output_path


def load_flow_model(flow: FlowNetConfig, device, checkpoint: str | None) -> RAFTGMA:
    """The test-mode flow net of ``flow``'s widths and compute type, with
    the weights of ``checkpoint`` (seeded random weights without one)."""
    model = build_flow_model(Config(flow=flow), device)
    if checkpoint:
        model.load_state_dict(load_reference_checkpoint(checkpoint))
        log("Loaded flow weights from", checkpoint)
    else:
        init_params(model, 0)
        log("WARNING: random-init flow net")
    return model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Flow network evaluation")
    p.add_argument("--dataset", choices=["kitti", "sintel", "chairs"], required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--dstype", default="clean", help="sintel pass")
    p.add_argument("--flow-checkpoint", default=None)
    p.add_argument("--iters", type=int, default=24,
                   help="refinement iterations (ref GMA/evaluate.py uses 24-32 for eval)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--submission", default=None,
                   help="write leaderboard files to this directory instead of validating")
    p.add_argument("--warm-start", action="store_true",
                   help="sintel submission: warm start each pair from the previous flow")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # before any work: no GPU, no run

    model = load_flow_model(FlowNetConfig(iters=32 if args.submission else args.iters), device,
                            args.flow_checkpoint)
    if args.submission:
        if args.dataset == "kitti":
            create_kitti_submission(model, args.root, args.submission, args.limit)
        elif args.dataset == "sintel":
            create_sintel_submission(model, args.root, args.submission, warm_start=args.warm_start,
                                     limit=args.limit)
        else:
            p.error("submissions exist for kitti/sintel only")
        log("Submission written to", args.submission)
        return 0
    if args.dataset == "kitti":
        validate_kitti(model, args.root, args.limit)
    elif args.dataset == "sintel":
        validate_sintel(model, args.root, args.limit)
    else:
        validate_chairs(model, args.root, args.limit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
