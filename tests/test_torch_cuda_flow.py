"""Flow training on the GPU: the backward passes of K1, K2 and K3 through
their autograd.Functions against autograd through the plain versions on
the card (float32, 1e-5 of each gradient's largest entry), the autograd
guards of the kernels without a backward (K5, K2n, K2s, K3t), a train
step on the card against the CPU and in bf16 against float64
(``chip_smoke.flow_train_agreement``, its bounds), K1, K2 and K3 under
``torch.inference_mode``, and the training build's bf16 step. Marked
``cuda``; each test skips when no CUDA device is present. On the GPU
machine (no JAX there, so the JAX test conftest is left out), from the
repository root:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_flow.py
"""

import math

import numpy as np
import pytest
import torch

from atdn_vslam_torch.config import Config, FlowNetConfig
from atdn_vslam_torch.models.factory import build_flow_train_model, init_params
from atdn_vslam_torch.ops import attention as att
from atdn_vslam_torch.ops import corr_lookup as corr
from atdn_vslam_torch.ops.bilinear import coords_grid
from atdn_vslam_torch.ops.corr_dot_tiled import corr_dot_tiled
from atdn_vslam_torch.ops.corr_lookup_nlanes import build_corr_pyramid_nlanes, nlanes_lookup_levels
from atdn_vslam_torch.ops.corr_lookup_slab import lookup_corr_pyramid_slab, pad_pyramid_for_slab
from atdn_vslam_torch.training import flow as train

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

REL = 1e-5  # float32 products on both sides, another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want, rel=REL):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert scale > 0 and err <= rel * scale, f"differs by {err} > {rel} x {scale}"


@pytest.mark.parametrize("b,h,w", [(1, 9, 14), (3, 12, 20)])
def test_k1_backward_on_the_card(cuda, b, h, w):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, h * w, 32), generator=g, device=cuda) * 32**-0.5
    k = torch.randn((b, h * w, 32), generator=g, device=cuda)
    dp = torch.randn((b, h, w, -(-h * w // 128) * 128), generator=g, device=cuda)
    before = att.attention_probs_spatial.launches
    qt, kt = q.clone().requires_grad_(), k.clone().requires_grad_()
    att.attention_probs_spatial(qt, kt, h, w, 1.0).backward(dp)
    assert att.attention_probs_spatial.launches == before + 1
    qr, kr = q.clone().requires_grad_(), k.clone().requires_grad_()
    att.attention_probs_spatial_plain(qr, kr, h, w, 1.0).backward(dp)
    _close(qt.grad, qr.grad)
    _close(kt.grad, kr.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_on_the_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    h, w = 11, 19
    f1 = torch.randn((2, h, w, 64), generator=g, device=cuda).to(dtype)
    f2 = torch.randn((2, h, w, 64), generator=g, device=cuda).to(dtype)
    pyramid = corr.build_corr_pyramid(f1, f2, 4, dtype=dtype)
    coords = coords_grid(h, w, device=cuda)[None] + 5.0 * torch.randn((2, h, w, 2), generator=g, device=cuda)
    coords[0, 0, :2] = torch.tensor([[-30.0, 4.5], [w + 2.5, -1.25]], device=cuda)
    d_window = torch.randn((2, h, w, 4 * 81), generator=g, device=cuda)
    levels = [v.clone().requires_grad_() for v in pyramid]
    corr.lookup_corr_pyramid(levels, coords).backward(d_window)
    if dtype == torch.float32:
        ref = [v.clone().requires_grad_() for v in pyramid]
        corr.lookup_corr_pyramid_plain(ref, coords).backward(d_window)
        for a, r in zip(levels, ref):
            _close(a.grad, r.grad)
    else:  # the bf16 cotangent is the float32 one rounded once
        want = corr.lookup_corr_pyramid_backward(
            [v.shape[-2:] for v in pyramid], [torch.float32] * 4, coords, d_window
        )
        for a, r in zip(levels, want):
            assert a.grad.dtype == torch.bfloat16
            _close(a.grad, r, rel=2.0**-8)


def test_k2_refuses_a_coordinate_gradient(cuda):
    f = torch.randn((1, 8, 8, 32), device=cuda)
    pyramid = [v.requires_grad_() for v in corr.build_corr_pyramid(f, f, 4)]
    coords = coords_grid(8, 8, device=cuda)[None].requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient in the coordinates"):
        corr.lookup_corr_pyramid(pyramid, coords)


def test_k3_backward_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    f1 = torch.randn((2, 150, 64), generator=g, device=cuda)
    f2 = torch.randn((2, 97, 64), generator=g, device=cuda)
    gout = torch.randn((2, 150, 97), generator=g, device=cuda)
    inv = 1.0 / 8.0
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    corr.corr_dot_rowmajor(a, b, inv, torch.float32).backward(gout)
    ra, rb = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    corr.corr_dot_rowmajor_plain(ra, rb, inv, torch.float32).backward(gout)
    _close(a.grad, ra.grad)
    _close(b.grad, rb.grad)


def test_kernels_without_backward_refuse_autograd(cuda):
    """K5, K2n, K2s and K3t raise under grad mode on an input that
    requires grad, and run under ``torch.no_grad`` (the streaming paths
    run under ``torch.inference_mode``)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((1, 200, 32), generator=g, device=cuda) for _ in range(3))
    f1, f2 = (torch.randn((1, 10, 12, 32), generator=g, device=cuda) for _ in range(2))
    coords = coords_grid(10, 12, device=cuda)[None]
    nl = build_corr_pyramid_nlanes(f1, f2, 4)
    slab, rows = pad_pyramid_for_slab(corr.build_corr_pyramid(f1, f2, 4))
    calls = {
        "flash_attend": (lambda t: att.flash_attend(t, k, v), q),
        "nlanes_lookup_levels": (lambda t: nlanes_lookup_levels([t, *nl[2:]], coords.reshape(1, -1, 2)), nl[1]),
        "lookup_corr_pyramid_slab": (lambda t: lookup_corr_pyramid_slab([t, *slab[1:]], coords, 4, orig_rows=rows),
                                     slab[0]),
        "corr_dot_tiled": (lambda t: corr_dot_tiled(f1.reshape(1, 120, 32), t, 32**-0.5), f2),
    }
    for name, (fn, x) in calls.items():
        with pytest.raises(RuntimeError, match="no backward pass"):
            fn(x.clone().requires_grad_())
        with torch.no_grad():
            assert bool(fn(x.clone().requires_grad_()).isfinite().all()), name


def test_kernels_with_backward_launch_once_without_a_graph(cuda):
    """K1, K2 and K3 go through their autograd.Functions on the card in
    every mode: under ``torch.inference_mode`` (the streaming paths) each
    call launches its kernel once and records no graph."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k = (torch.randn((1, 80, 32), generator=g, device=cuda) for _ in range(2))
    f = torch.randn((1, 8, 10, 32), generator=g, device=cuda)
    calls = {
        att.attention_probs_spatial: lambda: att.attention_probs_spatial(q, k, 8, 10),
        corr.lookup_corr_pyramid: lambda: corr.lookup_corr_pyramid(
            corr.build_corr_pyramid(f, f, 4), coords_grid(8, 10, device=cuda)[None]),
        corr.corr_dot_rowmajor: lambda: corr.corr_dot_rowmajor(q, k, 32**-0.5, torch.float32),
    }
    for fn, call in calls.items():
        before = fn.launches
        with torch.inference_mode():
            out = call()
        assert fn.launches == before + 1 and out.grad_fn is None and bool(out.isfinite().all())


def test_flow_train_step_on_the_card_matches_the_cpu(cuda):
    """chip_smoke's flow_train_agreement: float32, 96x192, batch 2, 3
    iterations, card against CPU; the same step in bf16 compute against
    float64; its bounds."""
    import chip_smoke

    out = chip_smoke.flow_train_agreement(cuda)
    for key in ("launches", "launches_bf16"):
        assert out[key]["attention_probs"] == 1 and out[key]["corr_lookup"] == 3


def test_bf16_training_build_steps_on_the_card(cuda):
    """float32 parameters and optimiser state, bf16 compute, the kernels:
    finite losses that fall over a few steps on one batch, gradients in
    the attention projections and the feature encoder."""
    cfg = Config(flow=FlowNetConfig(iters=3))
    model = init_params(build_flow_train_model(cfg, cuda), 5)
    assert model.dtype == torch.bfloat16 and {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.no_grad():
        model.update_block.aggregator.gamma.fill_(0.5)
    state = train.init_state(model, 1e-4, 20, seed=None)
    g = torch.Generator(device=cuda).manual_seed(6)
    big = torch.rand((2, 3, 40, 64), generator=g, device=cuda) * 255
    big = torch.nn.functional.interpolate(big, scale_factor=4, mode="bilinear").permute(0, 2, 3, 1)
    im1, im2 = big[:, :128, :192].contiguous(), big[:, 3:131, 5:197].contiguous()
    flow = torch.tensor([-5.0, -3.0], device=cuda).expand(2, 128, 192, 2).contiguous()
    valid = torch.ones((2, 128, 192), device=cuda)
    losses = []
    for _ in range(6):
        _, m = train.train_step(state, im1, im2, flow, valid)
        losses.append(float(m["loss"]))
        assert float(model.att.to_qk.weight.grad.abs().max()) > 0
        assert float(model.fnet.conv1.weight.grad.abs().max()) > 0
    assert all(math.isfinite(x) for x in losses) and np.mean(losses[-2:]) < losses[0]
