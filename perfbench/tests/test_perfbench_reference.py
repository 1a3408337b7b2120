"""The frozen reference against the port's float32 CPU path at small
sizes, on the benchmark's own seeded weights: the forward passes, the
losses, the gradients and the optimizer step."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench.core import spec, training
from perfbench.runners.stream import seeded_weights
from perfbench.reference.atdnvo import ATDNVO as RefATDNVO
from perfbench.reference.atdnvo import clvo_loss, pose_matrix
from perfbench.reference.gma import GMA, sequence_loss
from perfbench.reference.optim import AdamW, clip_global, cosine, warmup_cosine

HW = (128, 192)
#: float32 on both sides; the port sums some products in another order
TOL = 1e-4


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def weights():
    cfg = spec.load_cell("kitti_stream").config
    return seeded_weights({**cfg, "image_height": HW[0], "image_width": HW[1]}, 2**31 + 3, torch.device("cpu"))


def _frames(seed=0, batch=1):
    g = torch.Generator().manual_seed(seed)
    im1 = torch.rand((batch, *HW, 3), generator=g) * 255
    return im1, torch.roll(im1, shifts=(1, 3), dims=(1, 2))


def _port_flow(weights, train=False):
    from atdn_vslam_torch.models.flow.network import RAFTGMA

    net = RAFTGMA(iters=3)
    net.load_state_dict(weights[0])
    return net.train() if train else net.eval()


def test_gma_forward_matches_the_port(weights):
    ref = GMA(iters=3)
    ref.load_state_dict(weights[0])
    im1, im2 = _frames()
    with torch.no_grad():
        low, up = _port_flow(weights)(im1, im2)
        rlow, rup = ref(im1, im2)
    assert _rel(low, rlow) < TOL and _rel(up, rup) < TOL


def test_gma_training_step_matches_the_port(weights):
    from atdn_vslam_torch.training.flow import sequence_loss as port_loss

    im1, im2 = _frames(1, batch=2)
    gt = torch.full((2, *HW, 2), -3.0)
    valid = torch.ones(2, *HW)
    port = _port_flow(weights, train=True)
    loss_p, _ = port_loss(port(im1, im2, test_mode=False), gt, valid, 0.8)
    loss_p.backward()
    ref = GMA(iters=3)
    ref.load_state_dict(weights[0])
    loss_r = sequence_loss(ref(im1, im2, train=True), gt, valid, 0.8)
    loss_r.backward()
    assert abs(float(loss_p.detach()) - float(loss_r.detach())) < TOL * abs(float(loss_r.detach()))
    # each gradient against the largest of its module group: some biases' gradients are nought to
    # rounding (instance norm takes their mean away)
    grads_r = dict(ref.named_parameters())
    largest = {}
    for name, p in grads_r.items():
        group = name.split(".", 1)[0]
        largest[group] = max(largest.get(group, 0.0), float(p.grad.abs().max()))
    for name, p in port.named_parameters():
        gap = float((p.grad - grads_r[name].grad).abs().max())
        assert gap < 1e-3 * largest[name.split(".", 1)[0]], name


def test_atdnvo_matches_the_port(weights):
    from atdn_vslam_torch.models.odometry import ATDNVO
    from atdn_vslam_torch.training.losses import clvo_loss as port_clvo

    port = ATDNVO(HW)
    port.load_state_dict(weights[1])
    ref = RefATDNVO(HW)
    ref.load_state_dict(weights[1])
    flows = torch.randn(2, 3, *HW, 2, generator=torch.Generator().manual_seed(4)) * 20
    with torch.no_grad():
        (r1, t1), c1 = port.eval()(flows, port.init_carry(2))
        (r2, t2), c2 = ref(flows, ref.init_carry(2, "cpu"))
    for a, b in zip((r1, t1, *c1[0], *c1[1]), (r2, t2, *c2[0], *c2[1])):
        assert _rel(a, b) < TOL
    target = torch.randn(2, 3, 3, generator=torch.Generator().manual_seed(5))
    (r1, t1), _ = port.train()(flows, port.init_carry(2))
    (r2, t2), _ = ref(flows, ref.init_carry(2, "cpu"), train=True)
    lp, lr = port_clvo(r1, t1, target, target * 10), clvo_loss(r2, t2, target, target * 10)
    assert abs(float(lp.detach()) - float(lr.detach())) < TOL * float(lr.detach())


def test_pose_matrix_matches_the_port():
    from atdn_vslam_torch.geometry.se3 import pose_to_matrix

    rot, tr = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64), torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert torch.allclose(pose_matrix(rot, tr), pose_to_matrix(rot, tr), atol=1e-12)


def test_optimizer_and_schedules_match_the_port():
    from atdn_vslam_torch.config import TrainConfig
    from atdn_vslam_torch.training import flow as port_flow
    from atdn_vslam_torch.training.mapping import cosine_lr

    g = torch.Generator().manual_seed(6)
    p_port = torch.nn.Parameter(torch.randn(40, generator=g))
    p_ref = p_port.detach().clone()
    opt = torch.optim.AdamW([p_port], lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-3)
    ref = AdamW([p_ref], 1e-3, 1e-8)
    for step in range(3):
        grad = torch.randn(40, generator=g) * 5
        p_port.grad = grad.clone()
        port_flow.clip_by_global_norm([p_port.grad], 1.0)
        opt.step()
        ref.step(clip_global([grad], 1.0), 1e-2)
    assert torch.allclose(p_port.detach(), p_ref, atol=1e-6)
    tc = TrainConfig()
    port_cos, ref_cos = cosine_lr(tc, 12000), cosine(tc.lr, tc.eta_min, 12000)
    port_warm, ref_warm = port_flow.make_schedule(1.25e-4, 50000), warmup_cosine(1.25e-4, 50000)
    for step in (0, 1, 2, 2499, 2500, 30000, 60000):
        assert math.isclose(port_cos(step), ref_cos(step), rel_tol=1e-12)
        assert math.isclose(port_warm(step), ref_warm(step), rel_tol=1e-12)


def test_first_gradient_from_adam_state():
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.ones(2, 4)).square().sum().backward()
    want = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
    opt.step()
    got = training.first_gradients(model, opt)
    assert all(math.isclose(got[n], want[n], rel_tol=1e-6) for n in want)
