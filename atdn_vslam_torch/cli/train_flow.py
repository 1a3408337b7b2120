"""Flow-network (RAFTGMA) training CLI, the counterpart of the JAX
package's ``cli/train_flow.py`` (ref: GMA/train.py:78-175): the
gamma-decayed sequence loss, a warm-up + cosine (or one-cycle) learning
rate, the global-norm clip and AdamW, EPE metrics.

On the GPU (``--device cuda``, the default) the net trains with float32
parameters and bf16 compute, through the kernels K1 and K2 and their
backward passes; on the CPU (``--device cpu``) in float32 with their
plain versions.

Data parallel over processes, one per device, as ``train_odometry``:
the ``ATDN_*`` variables start the process group (``--backend``, default
``nccl`` on CUDA), each rank loads and trains on its slice of every
batch (the loss over the whole batch's valid pixels, gradients summed,
global batch statistics), and rank 0 writes checkpoints and the output;
``--no-mesh`` trains each process alone.

``--checkpoint-dir`` saves the whole training state every
``--checkpoint-every`` steps (``step_NNNNNNNN``); rerun with the same
directory, a run resumes from the newest one. The batch of step i is
drawn from ``(seed, i)`` alone, so a resumed run sees the batches the
uninterrupted run would have (its augmentation draws start anew, as in
the JAX CLI). ``--output`` writes the weights as a ``state_dict`` in the
reference layout, which ``load_reference_checkpoint`` reads, and with it
``--restore``, ``slam_demo --flow-checkpoint``, ``evaluate_flow`` and
``precompute_flows``.

Usage:
  python -m atdn_vslam_torch.cli.train_flow --dataset kitti \\
      --root /data/kitti2015 --steps 1000 --batch-size 6 --crop 288 960 \\
      [--restore gma.pth] [--output gma_out.pth] \\
      [--checkpoint-dir ckpts/ --checkpoint-every 2500] [--remat] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from atdn_vslam_torch.checkpoint import load_reference_checkpoint
from atdn_vslam_torch.config import Config, FlowNetConfig
from atdn_vslam_torch.models.factory import build_flow_train_model
from atdn_vslam_torch.parallel import distributed, make_mesh, shard_batch
from atdn_vslam_torch.training import flow as train
from atdn_vslam_torch.utils.helpers import log, resolve_device


def build_dataset(p: argparse.ArgumentParser, args: argparse.Namespace):
    """The single dataset (``--dataset``) or the stage mixture
    (``--stage``), augmentors attached; (dataset, label)."""
    from atdn_vslam_torch.data.flow_datasets import (
        STAGE_RECIPES,
        FlyingChairsDataset,
        FlyingThingsDataset,
        HD1KDataset,
        KittiFlowDataset,
        SintelDataset,
        _attach_aug,
        fetch_train_dataset,
    )

    if (args.dataset is None) == (args.stage is None):
        p.error("exactly one of --dataset / --stage is required")
    crop = tuple(args.crop)
    if args.stage is not None:
        roots = {args.stage: args.root} if args.root else {}
        for name in ("things", "kitti", "hd1k"):
            if getattr(args, f"root_{name}"):
                roots[name] = getattr(args, f"root_{name}")
        if args.stage not in roots:
            p.error(f"--stage {args.stage} requires its primary dataset root (--root)")
        return fetch_train_dataset(args.stage, roots, crop_size=crop, seed=args.seed), f"stage {args.stage}"
    if args.root is None:
        p.error("--dataset requires --root")
    if args.dataset == "kitti":
        dataset = KittiFlowDataset(args.root)
    elif args.dataset == "sintel":
        dataset = SintelDataset(args.root, dstype=args.dstype)
    elif args.dataset == "things":
        dataset = FlyingThingsDataset(args.root)
    elif args.dataset == "hd1k":
        dataset = HD1KDataset(args.root)
    else:
        dataset = FlyingChairsDataset(args.root)
    _attach_aug(dataset, crop, args.seed, **STAGE_RECIPES[args.dataset])
    return dataset, args.dataset


def draw_batch(dataset, seed: int, step: int, batch_size: int, mesh=None) -> list[np.ndarray]:
    """The batch of step ``step``: indices from ``default_rng((seed,
    step))``, a pure function of the two (the JAX CLI's draw);
    (im1, im2, flow, valid) stacked. With ``mesh`` this rank's slice of
    the batch, the only samples it loads."""
    idx = np.random.default_rng((seed, step)).integers(0, len(dataset), batch_size)
    if mesh is not None:
        idx = shard_batch(mesh, idx)
    samples = [dataset[int(j)] for j in idx]
    return [np.stack([s[i] for s in samples]) for i in range(4)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="RAFTGMA flow training")
    p.add_argument("--dataset", choices=["kitti", "sintel", "chairs", "things", "hd1k"], default=None,
                   help="single dataset (mutually exclusive with --stage)")
    p.add_argument("--stage", choices=["chairs", "things", "sintel", "kitti"], default=None,
                   help="curriculum stage mixture + aug recipe (ref GMA/core/datasets.py:272-299); "
                        "dataset roots come from --root/--root-*")
    p.add_argument("--root", default=None, help="dataset root (for --dataset, or the --stage's primary dataset)")
    p.add_argument("--root-things", default=None)
    p.add_argument("--root-kitti", default=None)
    p.add_argument("--root-hd1k", default=None)
    p.add_argument("--dstype", default="clean")
    p.add_argument("--steps", type=int, default=50000)
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--crop", type=int, nargs=2, default=(288, 960))
    p.add_argument("--lr", type=float, default=1.25e-4)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--schedule", choices=["warmcos", "onecycle"], default="warmcos",
                   help="onecycle = the reference's linear-anneal OneCycleLR shape (GMA/train.py:68-75); "
                        "warmcos = warmup + cosine decay")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restore", default=None, help="weights to start from: a reference GMA .pth or an --output")
    p.add_argument("--output", default="flow_trained.pth")
    p.add_argument("--checkpoint-dir", default=None,
                   help="full training-state checkpoints; resumes from the newest one when rerun with "
                        "the same directory")
    p.add_argument("--checkpoint-every", type=int, default=2500)
    p.add_argument("--remat", action="store_true",
                   help="recompute each update iteration in the backward pass: less memory, same values")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="collectives of a multi-process run (default: nccl on CUDA, gloo on the CPU)")
    p.add_argument("--no-mesh", action="store_true", help="no data parallelism: each process trains alone")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # before any work: no GPU, no run
    distributed.initialize(backend=args.backend, device=device)
    device = distributed.local_device(device)
    mesh = None if args.no_mesh else make_mesh()
    main_rank = distributed.rank() == 0

    dataset, label = build_dataset(p, args)
    log(f"{label}: {len(dataset)} pairs")

    model = build_flow_train_model(Config(flow=FlowNetConfig(iters=args.iters)), device, remat=args.remat)
    state = train.init_state(model, args.lr, args.steps, args.wd, args.clip, args.schedule, seed=args.seed)
    if args.restore:
        model.load_state_dict(load_reference_checkpoint(args.restore))
        log("Restored from", args.restore)
    if args.checkpoint_dir:
        latest = train.latest_checkpoint(args.checkpoint_dir)
        if latest is not None:
            train.load_checkpoint(latest, state)
            log(f"Resumed from {latest} at step {state.step}")

    for i in range(state.step, args.steps):
        batch = [torch.from_numpy(x).to(device) for x in draw_batch(dataset, args.seed, i, args.batch_size, mesh)]
        _, metrics = train.train_step(state, *batch, gamma=args.gamma, mesh=mesh)
        if i % args.log_every == 0 and main_rank:
            log(f"step {i}: loss {float(metrics['loss']):.4f} epe {float(metrics['epe']):.3f} "
                f"1px {float(metrics['1px']):.3f}")
        if main_rank and args.checkpoint_dir and (i + 1) % args.checkpoint_every == 0:
            train.save_checkpoint(train.checkpoint_path(args.checkpoint_dir, i + 1), state)
            log(f"Checkpointed full train state at step {i + 1}")

    if main_rank:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, args.output)
        log("Saved", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
