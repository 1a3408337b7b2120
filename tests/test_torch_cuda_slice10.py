"""The pose-graph solve, loop closure's measurements and the odometry
train step on the GPU against the CPU. Marked ``cuda``; each test skips
when no CUDA device is present. On the GPU machine (which has no JAX, so
the JAX test conftest is left out):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_slice10.py

Tolerances are those the CPU tests hold the port to against the JAX
package (``tests/test_torch_pose_graph.py``,
``tests/test_torch_odometry_train.py``, ``tests/test_torch_runtime.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from atdn_vslam_torch.config import Config, FlowNetConfig, LossConfig, SlamConfig, TrainConfig
from atdn_vslam_torch.geometry.pose_graph import edge_residuals, optimize_pose_graph, se3_exp
from atdn_vslam_torch.geometry.se3 import prefix_products, se3_inverse
from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model, init_params
from atdn_vslam_torch.models.odometry import ATDNVO
from atdn_vslam_torch.ops.attention import attention_probs_spatial
from atdn_vslam_torch.ops.corr_lookup import lookup_corr_pyramid
from atdn_vslam_torch.slam import SlamRuntime
from atdn_vslam_torch.training import odometry as train

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

POSE_ATOL = 1e-4
MSE_RTOL, MSE_ATOL = 1e-3, 1e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _graph(n, seed, noise=0.01, loop=12):
    """A drifted chain of n poses turning 0.5 rad per step, closures
    (i, i + loop) carrying the true relative pose. CPU float32."""
    g = torch.Generator().manual_seed(seed)
    eye = torch.eye(4, dtype=torch.float64)[None]
    step = se3_exp(torch.tensor([0.0, 0.0, 1.0, 0.0, 0.5, 0.0], dtype=torch.float64))
    gt = torch.cat([eye, prefix_products(step.expand(n - 1, 4, 4).contiguous())])
    rel = se3_inverse(gt[:-1]) @ gt[1:] @ se3_exp(torch.randn((n - 1, 6), generator=g, dtype=torch.float64) * noise)
    poses = torch.cat([eye, prefix_products(rel)])
    ci = torch.arange(0, n - loop, 5)
    ei = torch.arange(n - 1)
    meas = torch.cat([se3_inverse(poses[:-1]) @ poses[1:], se3_inverse(gt[ci]) @ gt[ci + loop]])
    w = torch.cat([torch.ones(n - 1), torch.full((len(ci),), 4.0)])
    return poses.float(), torch.cat([ei, ci]), torch.cat([ei + 1, ci + loop]), meas.float(), w


@pytest.mark.parametrize("solver,n", [("dense", 30), ("dense", 200), ("cg", 30), ("cg", 200)])
def test_pose_graph_on_the_gpu_matches_the_cpu(cuda, solver, n):
    graph = _graph(n, n)
    ref, ref_mse = optimize_pose_graph(*graph, solver=solver)
    got, mse = optimize_pose_graph(*(x.to(cuda) for x in graph), solver=solver)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=POSE_ATOL)
    assert abs(float(mse) - float(ref_mse)) <= max(MSE_RTOL * float(ref_mse), MSE_ATOL)
    assert float(mse) < float(torch.mean(edge_residuals(*graph[:4]) ** 2))


def test_pose_graph_keeps_tf32_flags(cuda):
    """The solve turns TF32 off and hands the flags back as it found them."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        optimize_pose_graph(*(x.to(cuda) for x in _graph(20, 1)), iterations=2)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_odometry_train_step_on_the_gpu_matches_the_cpu(cuda):
    hw = (72, 96)
    g = torch.Generator().manual_seed(0)
    flows = torch.randn((2, 3, *hw, 2), generator=g) * 20.0
    rot, tr = torch.randn((2, 3, 3), generator=g) * 0.02, torch.randn((2, 3, 3), generator=g) * 0.5
    init = init_params(ATDNVO(hw), 1).state_dict()
    models, metrics = [], []
    for dev in (cuda, torch.device("cpu")):
        model = ATDNVO(hw).to(dev)
        model.load_state_dict(init)
        opt, sched = train.make_optimizer(model, TrainConfig(), 1)
        state = train.OdometryTrainState(model, opt, sched)
        metrics.append(train.train_step(state, flows.to(dev), rot.to(dev), tr.to(dev), LossConfig(alpha=0.5)))
        models.append(model)
    np.testing.assert_allclose(float(metrics[0]["loss"]), float(metrics[1]["loss"]), rtol=1e-6)
    for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        scale = float(q.grad.abs().max())
        np.testing.assert_allclose(p.grad.cpu().numpy(), q.grad.numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=name)
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        if "running" in name:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_measure_closure_launches_and_matches_the_cpu(cuda, tmp_path):
    """A closure measurement on the GPU runs K1 once and K2 once per
    iteration and gives the CPU's relative pose (float32 flow net)."""
    hw, iters = (96, 192), 2
    cfg = Config(keyframes_path=str(tmp_path / "kf"), flow=FlowNetConfig(iters=iters, mixed_precision=False),
                 slam=SlamConfig(image_height=hw[0], image_width=hw[1], rotation_threshold_deg=0.0,
                                 translation_threshold=0.0))
    flow = init_params(build_flow_model(cfg, "cpu"), 0)
    with torch.no_grad():
        flow.update_block.aggregator.gamma.fill_(0.5)
    weights = (flow.state_dict(), init_params(build_odometry_model(cfg, "cpu"), 1).state_dict())
    rng = np.random.default_rng(2)
    base = rng.integers(0, 255, (hw[0] + 4, hw[1] + 8, 3), dtype=np.uint8)
    frames = [np.ascontiguousarray(base[i : i + hw[0], 2 * i : 2 * i + hw[1]]) for i in range(3)]
    got = []
    for dev in (cuda, torch.device("cpu")):
        rt = SlamRuntime(dataclasses.replace(cfg, keyframes_path=str(tmp_path / dev.type)), *weights, device=dev)
        rt.start_odometry()
        for f in frames:
            rt(f)
        rt.keyframes.flush()
        for fn in (attention_probs_spatial, lookup_corr_pyramid):
            fn.launches = 0
        got.append(rt.measure_closure(2, 0))
        if dev.type == "cuda":
            assert (attention_probs_spatial.launches, lookup_corr_pyramid.launches) == (1, iters)
    np.testing.assert_allclose(got[0], got[1], rtol=1e-4, atol=1e-4)
