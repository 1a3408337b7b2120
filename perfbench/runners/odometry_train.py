"""ATDNVO training from precomputed flows (the ATDN training job):
``training.odometry.train_step`` on batches of flow windows, driven as
``train_epoch`` drives it (the loss read back after every step).

Set-up builds the model with seeded weights made on the device, AdamW
and its cosine schedule, and ``batches`` distinct batches on the device
from the seed (flows N(0, flow_scale^2), rotations and translations
N(0, rot_scale^2) and N(0, tr_scale^2)); it takes the first three
steps, which the check follows (``core/training.py``), on batches 0, 1
and 2. The window cycles through the batches until ``--seconds`` have
passed. A sample is one window of ``sequence_length`` flows.
"""

from __future__ import annotations

import time

import torch

from perfbench.core import flops as flop_count
from perfbench.core import trace as tracing
from perfbench.core import training
from perfbench.core.result import Run
from perfbench.runners.stream import LOWER, seeded_weights
from perfbench.reference.atdnvo import ATDNVO as RefATDNVO
from perfbench.reference.atdnvo import clvo_loss
from perfbench.reference.optim import cosine
from perfbench.reference.precision import Precision, float32_only


def make_batches(cfg: dict, tr: dict, seed: int, device) -> list[tuple[torch.Tensor, ...]]:
    t = cfg["train"]
    shape = (t["batch_size"], t["sequence_length"])
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn((*shape, cfg["image_height"], cfg["image_width"], 2), generator=g, device=device)
             * tr["flow_scale"],
             torch.randn((*shape, 3), generator=g, device=device) * tr["rot_scale"],
             torch.randn((*shape, 3), generator=g, device=device) * tr["tr_scale"])
            for _ in range(tr["batches"])]


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: str | None = None) -> Run:
    from atdn_vslam_torch.config import Config, LossConfig, OdometryModelConfig, TrainConfig
    from atdn_vslam_torch.models.factory import build_odometry_model
    from atdn_vslam_torch.training import odometry as program

    cfg, tr = cell.config, cell.traffic
    hw = (cfg["image_height"], cfg["image_width"])
    o, t, lc = cfg["odometry"], cfg["train"], cfg["loss"]
    port = Config(
        odometry=OdometryModelConfig(in_channels=o["in_channels"], compressor=o["compressor"],
                                     use_dropout=o["use_dropout"], use_layernorm=o["use_layernorm"],
                                     lstm_size=o["lstm_size"]),
        loss=LossConfig(alpha=lc["alpha"], w=lc["w"], delta=lc["delta"], khi=lc["khi"]),
        train=TrainConfig(batch_size=t["batch_size"], sequence_length=t["sequence_length"], lr=t["lr"],
                          wd=t["wd"], epsilon=t["epsilon"], eta_min=t["eta_min"]),
    )
    weights = seeded_weights(cfg, seed, device)[1]
    model = build_odometry_model(port, device, image_hw=hw)
    model.load_state_dict(weights)
    optimizer, scheduler = program.make_optimizer(model, port.train, tr["steps_total"])
    state = program.OdometryTrainState(model, optimizer, scheduler)
    batches = make_batches(cfg, tr, seed, device)

    def step(k: int) -> float:
        return float(program.train_step(state, *batches[k % len(batches)], port.loss)["loss"])

    before = training.snapshot(model)
    prog = {"losses": [step(0)]}
    prog["grad"] = training.first_gradients(model, optimizer)
    prog["losses"] += [step(k) for k in range(1, training.STEPS)]
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
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out = Run(cell=cell, setup_s=setup_s, units=len(times), samples=len(times) * t["batch_size"],
              window_s=window_s, unit_s=times, memory_peak_bytes=peak)
    if trace:
        base = k
        out.trace = tracing.capture(lambda j: step(base + j), tr["profile_steps"], device)
        out.flops = flop_count.odometry_step(cfg, tr)
    del state, model, optimizer, scheduler
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.checks = check(cfg, tr, weights, batches, prog, device, control)
    return out


def check(cfg: dict, tr: dict, weights: dict, batches, prog: dict, device, control: str | None = None):
    """``core/training.py``'s numbers. ``control`` replaces the program's
    steps by the reference's one step below the stated precision
    (``"precision"``) or on half of each batch (``"half_batch"``)."""
    t, lc = cfg["train"], cfg["loss"]
    hw = (cfg["image_height"], cfg["image_width"])

    def steps(precision: str, half: bool) -> dict:
        ref = RefATDNVO(hw, cfg["odometry"]["lstm_size"], Precision(precision)).to(device)
        ref.load_state_dict(weights)

        def loss_of(model, batch):
            flows, rot, tr_ = training.half_batch(batch) if half else batch
            (p_rot, p_tr), _ = model(flows, model.init_carry(flows.shape[0], device), train=True)
            return clvo_loss(p_rot, p_tr, rot, tr_, lc["alpha"], lc["delta"], lc["khi"])

        return training.reference_steps(ref, batches, loss_of, cosine(t["lr"], t["eta_min"], tr["steps_total"]),
                                        t["wd"], t["epsilon"], None)

    with float32_only():
        ref = steps("float32", False)
        if control == "precision":
            prog = steps(LOWER[cfg["odometry"]["compute_dtype"]], False)
        elif control == "half_batch":
            prog = steps("float32", True)
    return training.compare(prog, ref)
