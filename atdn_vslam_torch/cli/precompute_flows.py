"""Flow-cache precompute tool, the counterpart of the JAX package's
``cli/precompute_flows.py``: RAFTGMA over the consecutive frame pairs of
a KITTI sequence, written as the native single-file fp16 cache
(``data/flow_cache.py``) that odometry training reads (the reference
trains from precomputed flows but never shipped the tool that makes them;
SURVEY.md 2.14).

Each frame is decoded and feature-encoded once: a batch of B pairs shares
B + 1 frames, and the previous batch's last frame and feature map are
carried forward. Frames are resized to the config's size as the runtime
resizes them (bilinear, antialiased when downscaling). The flow net runs
in test mode on ``--device`` (default cuda: the config's ``flow`` widths
and compute type, bf16 with ``mixed_precision``, with the kernels).
``--flow-checkpoint`` is a reference GMA ``.pth`` or ``train_flow``'s
``--output``; without one the net has seeded random weights (useful only
to test the pipeline).

Usage:
  python -m atdn_vslam_torch.cli.precompute_flows --data-path data \\
      --sequence 00 [--flow-checkpoint gma.pth] [--batch 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from atdn_vslam_torch.config import load_config
from atdn_vslam_torch.data.flow_cache import FlowCacheWriter
from atdn_vslam_torch.data.kitti import KittiSequence
from atdn_vslam_torch.utils.helpers import log, resolve_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Precompute GMA flow cache")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--sequence", type=str, required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--flow-checkpoint", type=str, default=None,
                   help="a reference GMA .pth or train_flow's --output; random init if absent "
                        "(useful only for pipeline testing)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # before any work: no GPU, no run

    from atdn_vslam_torch.cli.evaluate_flow import load_flow_model

    config = load_config(args.config)
    if args.data_path:
        config = dataclasses.replace(config, data_path=args.data_path)
    seq = KittiSequence(config.data_path, args.sequence, need_flows=False)
    n_pairs = len(seq.image_files) - 1
    if n_pairs <= 0:
        raise SystemExit(f"Sequence {args.sequence} has no frame pairs")
    h, w = config.slam.image_height, config.slam.image_width
    model = load_flow_model(config.flow, device, args.flow_checkpoint)

    def load_resized(i: int) -> torch.Tensor:
        img = torch.from_numpy(np.ascontiguousarray(seq.read_image(i))).to(device).float()
        if tuple(img.shape[:2]) != (h, w):
            img = F.interpolate(
                img.permute(2, 0, 1)[None], size=(h, w), mode="bilinear", align_corners=False, antialias=True
            )[0].permute(1, 2, 0)
        return img

    writer = FlowCacheWriter(os.path.join(config.data_path, "dataset"), args.sequence, n_pairs, h, w)
    t0 = time.time()
    with torch.inference_mode():
        prev_frame = load_resized(0)
        prev_fmap = model(prev_frame[None], encode_only=True)
        for start in range(0, n_pairs, args.batch):
            count = min(args.batch, n_pairs - start)
            frames = [prev_frame] + [load_resized(start + j + 1) for j in range(count)]
            prev_frame = frames[-1]
            im1, im2 = torch.stack(frames[:-1]), torch.stack(frames[1:])
            fmap2 = model(im2, encode_only=True)
            fmap1 = torch.cat([prev_fmap, fmap2[:-1]])
            _, flows = model(im1, im2, fmap1=fmap1, fmap2=fmap2)
            prev_fmap = fmap2[-1:]
            for flow in flows.float().cpu().numpy():
                writer.append(flow)
            done = start + count
            if done % (args.batch * 25) < args.batch:
                log(f"{done}/{n_pairs} pairs ({done / (time.time() - t0):.1f} pairs/s)")
    writer.close()
    log("Cache written:", writer.out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
