"""Operations of a frame or a step, counted by ``FlopCounterMode`` over
the reference at the cell's shapes on the meta device (shapes only, no
arithmetic): the convolutions and matrix products, each once, whatever
the program recomputes. Returned by the type the configuration computes
the part in, so each is taken at its own peak."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.atdnvo import ATDNVO, clvo_loss
from perfbench.reference.gma import GMA, sequence_loss


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def gma(cfg: dict) -> GMA:
    f = cfg["flow"]
    return GMA(f["iters"], f["corr_levels"], f["corr_radius"], f["hidden_dim"], f["context_dim"],
               f["fnet_dim"], f["dim_head"])


def stream_frame(cfg: dict) -> dict[str, float]:
    """One streamed frame: the flow step with one feature encode (the
    previous frame's feature map is cached), then ATDNVO on one flow."""
    h, w = cfg["image_height"], cfg["image_width"]
    with torch.device("meta"):
        flow_net, odo = gma(cfg), ATDNVO((h, w), cfg["odometry"]["lstm_size"])
        im = torch.empty(1, h, w, 3)
        fmap = torch.empty(1, cfg["flow"]["fnet_dim"], h // 8, w // 8)
        with torch.no_grad():
            flow = _count(lambda: flow_net(im, im, fmap1=fmap))
            flows = torch.empty(1, 1, h, w, 2)
            odometry = _count(lambda: odo(flows, odo.init_carry(1, "meta")))
    out = {cfg["flow"]["compute_dtype"]: flow}
    kind = cfg["odometry"]["compute_dtype"]
    out[kind] = out.get(kind, 0.0) + odometry
    return out


def odometry_step(cfg: dict, traffic: dict) -> dict[str, float]:
    """One ATDNVO training step, forward and backward, on the batch."""
    h, w = cfg["image_height"], cfg["image_width"]
    b, t = cfg["train"]["batch_size"], cfg["train"]["sequence_length"]
    with torch.device("meta"):
        odo = ATDNVO((h, w), cfg["odometry"]["lstm_size"])
        flows, target = torch.empty(b, t, h, w, 2), torch.empty(b, t, 3)

        def step():
            (rot, tr), _ = odo(flows, odo.init_carry(b, "meta"), train=True)
            clvo_loss(rot, tr, target, target).backward()

        return {cfg["odometry"]["compute_dtype"]: _count(step)}


def flow_step(cfg: dict, traffic: dict) -> dict[str, float]:
    """One GMA training step, forward and backward, on the batch."""
    h, w = traffic["crop"]
    b = traffic["batch"]
    with torch.device("meta"):
        net = gma({**cfg, "flow": {**cfg["flow"], "iters": traffic["iters"]}})
        im, gt, valid = torch.empty(b, h, w, 3), torch.empty(b, h, w, 2), torch.empty(b, h, w)

        def step():
            sequence_loss(net(im, im, train=True), gt, valid, traffic["gamma"]).backward()

        return {cfg["flow"]["compute_dtype"]: _count(step)}
