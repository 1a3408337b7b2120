"""GMA flow training (GMA's KITTI fine-tuning stage at the JAX flow
CLI's defaults): ``training.flow.train_step`` on batches of image pairs,
driven as ``cli/train_flow.py`` drives it (no read-back between steps).

Set-up builds the training model (float32 parameters, the compute type
of the configuration under autocast) with seeded weights made on the
device, AdamW with its warm-up and cosine schedule and the clip, and
``batches`` distinct batches on the device from the seed: each pair a
smooth random texture and the same texture shifted by a whole-pixel
offset of up to ``max_shift`` px, whose flow is the ground truth, every
pixel valid. It takes the first three steps, which the check follows
(``core/training.py``), on batches 0, 1 and 2, and keeps the first
step's first prediction (the flow after one update, upsampled; a hook on
the model for that step alone): ``first_flow_units`` is its mean gap
from the reference's in units of the same gap for the reference with its
operands rounded to the configuration's type (bf16). Random weights
amplify bf16's rounding through the 12 updates and the backward pass by
a factor that differs from seed to seed, so the three numbers of
``core/training.py`` do not tell bf16 from fp8; one update does. The window cycles through
the batches until ``--seconds`` have passed and synchronises the device
at its end. A sample is one image pair.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from perfbench.core import flops as flop_count
from perfbench.core import trace as tracing
from perfbench.core import training
from perfbench.core.result import Run
from perfbench.runners.stream import LOWER, STATED, seeded_weights
from perfbench.reference.gma import GMA, sequence_loss
from perfbench.reference.optim import warmup_cosine
from perfbench.reference.precision import Precision, float32_only


def shifted_pairs(batch: int, hw, g: torch.Generator, device, max_shift: int):
    """Images (B, H, W, 3) in [0, 255], the flow (B, H, W, 2) and the
    valid mask (B, H, W)."""
    h, w = hw
    pad = 2 * max_shift
    coarse = torch.rand((batch, 3, (h + pad) // 4 + 2, (w + pad) // 4 + 2), generator=g, device=device) * 255
    tex = F.interpolate(coarse, scale_factor=4, mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    mags = torch.randint(0, max_shift + 1, (batch, 2), generator=g, device=device)
    shifts = mags * (2 * torch.randint(0, 2, (batch, 2), generator=g, device=device) - 1)
    im1 = tex[:, max_shift : max_shift + h, max_shift : max_shift + w]
    im2 = torch.stack([
        tex[i, max_shift + dy : max_shift + dy + h, max_shift + dx : max_shift + dx + w]
        for i, (dx, dy) in enumerate(shifts.tolist())
    ])
    flow = (-shifts.float())[:, None, None, :].expand(batch, h, w, 2).contiguous()
    return im1.contiguous(), im2.contiguous(), flow, torch.ones((batch, h, w), device=device)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: str | None = None) -> Run:
    from atdn_vslam_torch.config import Config, FlowNetConfig
    from atdn_vslam_torch.models.factory import build_flow_train_model
    from atdn_vslam_torch.training import flow as program

    cfg, tr = cell.config, cell.traffic
    f = cfg["flow"]
    port = Config(flow=FlowNetConfig(hidden_dim=f["hidden_dim"], context_dim=f["context_dim"],
                                     corr_levels=f["corr_levels"], corr_radius=f["corr_radius"],
                                     num_heads=f["num_heads"], iters=tr["iters"],
                                     mixed_precision=f["compute_dtype"] == "bfloat16"))
    weights = seeded_weights(cfg, seed, device)[0]
    model = build_flow_train_model(port, device)
    model.load_state_dict(weights)
    optimizer, scheduler = program.make_optimizer(model, tr["lr"], tr["steps_total"], tr["wd"], tr["pct_start"],
                                                  "warmcos")
    state = program.FlowTrainState(model, optimizer, scheduler, tr["clip"])
    g = torch.Generator(device=device).manual_seed(seed)
    batches = [shifted_pairs(tr["batch"], tr["crop"], g, device, tr["max_shift"]) for _ in range(tr["batches"])]

    def step(k: int):
        return program.train_step(state, *batches[k % len(batches)], gamma=tr["gamma"])[1]["loss"]

    before = training.snapshot(model)
    prog = {}

    def keep_first(module, args, out):
        prog["first_flow"] = out[0].detach()

    first = model.register_forward_hook(keep_first)
    prog["losses"] = [float(step(0))]
    first.remove()
    prog["grad"] = training.first_gradients(model, optimizer)
    prog["losses"] += [float(step(k)) for k in range(1, training.STEPS)]
    prog["update"] = training.changes(model, before)
    setup_s = time.perf_counter() - t_start

    times, k = [], training.STEPS
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        ts = time.perf_counter()
        step(k)
        times.append(time.perf_counter() - ts)
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out = Run(cell=cell, setup_s=setup_s, units=len(times), samples=len(times) * tr["batch"],
              window_s=window_s, unit_s=times, memory_peak_bytes=peak)
    if trace:
        base = k
        out.trace = tracing.capture(lambda j: step(base + j), tr["profile_steps"], device)
        out.flops = flop_count.flow_step(cfg, tr)
    del state, model, optimizer, scheduler
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.checks = check(cfg, tr, weights, batches, prog, device, control)
    return out


def check(cfg: dict, tr: dict, weights: dict, batches, prog: dict, device, control: str | None = None):
    """``core/training.py``'s numbers. ``control`` replaces the program's
    steps by the reference's one step below the stated precision
    (``"precision"``) or on half of each batch (``"half_batch"``)."""
    f = cfg["flow"]

    def steps(precision: str, half: bool) -> dict:
        ref = GMA(tr["iters"], f["corr_levels"], f["corr_radius"], f["hidden_dim"], f["context_dim"],
                  f["fnet_dim"], f["dim_head"], Precision(precision)).to(device)
        ref.load_state_dict(weights)

        firsts = []

        def loss_of(model, batch):
            im1, im2, flow, valid = training.half_batch(batch) if half else batch
            preds = model(im1, im2, train=True)
            firsts.append(preds[0].detach())
            return sequence_loss(preds, flow, valid, tr["gamma"])

        out = training.reference_steps(ref, batches, loss_of, warmup_cosine(tr["lr"], tr["steps_total"],
                                                                            tr["pct_start"]),
                                       tr["wd"], 1e-8, tr["clip"])
        return {**out, "first_flow": firsts[0]}

    with float32_only():
        ref = steps("float32", False)
        if control == "precision":
            prog = steps(LOWER[f["compute_dtype"]], False)
        elif control == "half_batch":
            prog = steps("float32", True)
        yardstick = GMA(tr["iters"], f["corr_levels"], f["corr_radius"], f["hidden_dim"], f["context_dim"],
                        f["fnet_dim"], f["dim_head"], Precision(STATED[f["compute_dtype"]])).to(device)
        yardstick.load_state_dict(weights)
        n = prog["first_flow"].shape[0]  # half of the batch under that fault: the same first pairs
        with torch.no_grad():
            unit = yardstick(batches[0][0][:n], batches[0][1][:n], train=True)[0].double()
    want = ref["first_flow"][:n].double()
    gap = float((prog["first_flow"].double() - want).abs().mean())
    return {**training.compare(prog, ref), "first_flow_units": gap / max(float((unit - want).abs().mean()), 1e-30)}
