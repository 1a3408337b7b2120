"""The kernels as ``torch.library`` ops and the serving artifact on the
GPU: ``torch.library.opcheck`` with CUDA inputs for each of the eight
``atdn::`` ops (schema, fake implementation against the kernel, AOT
dispatch with dynamic shapes), each op's CUDA output against its plain
version, and a float32 artifact of the streaming step whose pose and
flow equal the eager step's on the card while TF32 is left at cuDNN's
default around the call (``load_exported(...).call`` turns it off, as the
eager step does). Marked ``cuda``; each test skips when no CUDA device is
present. On the GPU machine (no JAX there, so the JAX test conftest is
left out), from the repository root:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_serving.py
"""

import pytest
import torch
import torch.utils._pytree as pytree

from atdn_vslam_torch import serving
from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig
from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model, init_params
from atdn_vslam_torch.ops import attention as att
from atdn_vslam_torch.ops import corr_dot_tiled as tiled
from atdn_vslam_torch.ops import corr_lookup as corr
from atdn_vslam_torch.ops import corr_lookup_nlanes as nl
from atdn_vslam_torch.ops import corr_lookup_slab as slab
from atdn_vslam_torch.ops.bilinear import coords_grid

pytestmark = pytest.mark.cuda

OPS = ("attention_probs", "apply_probs", "flash_attend", "corr_dot", "corr_lookup", "corr_lookup_nlanes",
       "corr_lookup_slab", "corr_dot_tiled")
# each kernel against its plain version: chip_smoke.py's tolerances
TOL = {torch.bfloat16: {"rtol": 2.0**-7, "atol": 1e-5}, torch.float32: {"rtol": 1e-5, "atol": 1e-5}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _args(name, device, dtype):
    g = torch.Generator(device=device).manual_seed(OPS.index(name))
    h, w, d = 6, 20, 64
    n = h * w
    q = (torch.randn((1, n, d), generator=g, device=device) * d**-0.5).to(dtype)
    k, v = (torch.randn((1, n, d), generator=g, device=device).to(dtype) for _ in range(2))
    fh, fw, c = 16, 20, 64
    f1, f2 = (torch.randn((1, fh, fw, c), generator=g, device=device).to(dtype) for _ in range(2))
    coords = coords_grid(fh, fw, device=device)[None] + torch.randn((1, fh, fw, 2), generator=g, device=device) * 3
    pyramid = corr.build_corr_pyramid(f1, f2, 4)
    if name == "attention_probs":
        return q, k, h, w, 1.0
    if name == "apply_probs":
        return att.attention_probs_spatial_plain(q, k, h, w, 1.0), v
    if name == "flash_attend":
        return q, k, v, 1.0
    if name == "corr_dot":
        return f1.reshape(1, -1, c), f2.reshape(1, -1, c), c**-0.5, dtype
    if name == "corr_lookup":
        return pyramid, coords, 4
    if name == "corr_lookup_nlanes":
        return nl.build_corr_pyramid_nlanes(f1, f2, 4)[1:], coords.reshape(1, -1, 2), 1, 4
    if name == "corr_lookup_slab":
        padded, rows = slab.pad_pyramid_for_slab(pyramid)
        return padded, coords, 4, list(rows)
    return f1.reshape(1, -1, c), f2.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), c**-0.5, dtype


def _cpu(args):
    return pytree.tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", OPS)
def test_opcheck_cuda(cuda, name, dtype):
    args = _args(name, cuda, dtype)
    op = getattr(torch.ops.atdn, name)
    result = torch.library.opcheck(op.default, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = op(*args)
    torch.cuda.synchronize()
    want = op(*_cpu(args))  # the CPU implementation: the plain version
    assert got.device.type == "cuda" and got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), equal_nan=True, **TOL[dtype])


def test_artifact_pose_equals_eager_with_tf32_at_its_default(cuda, tmp_path):
    """Float32 at 96x192, 2 iterations: the loaded artifact's outputs
    equal the eager step's on the card, called with TF32 on for cuDNN
    (its default) and restored after the call."""
    h, w = 96, 192
    cfg = Config(flow=FlowNetConfig(iters=2, mixed_precision=False), slam=SlamConfig(image_height=h, image_width=w))
    flow = init_params(build_flow_model(cfg, "cpu"), 0)
    with torch.no_grad():
        flow.update_block.aggregator.gamma.fill_(0.5)
    flow = flow.to(cuda)
    odo = init_params(build_odometry_model(cfg, "cpu"), 1).to(cuda)
    path = tmp_path / "step.pt2"
    serving.save_stream_step(serving.export_stream_step(flow, odo, None, None, h, w), path)
    step = serving.load_exported(path)
    g = torch.Generator(device=cuda).manual_seed(2)
    im1, im2 = (torch.rand((h, w, 3), generator=g, device=cuda) * 255 for _ in range(2))
    with torch.no_grad():
        fmap = serving.encode_frame(flow, None, im1)
        want = serving.make_stream_step(flow, odo, (None, None))(im1, im2, fmap, odo.init_carry(1), torch.eye(4, device=cuda))
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = step.call(im1, im2, fmap, serving.zero_inputs_like(step.exported, 3), torch.eye(4, device=cuda))
        assert torch.backends.cudnn.allow_tf32  # restored after the call
    finally:
        torch.backends.cudnn.allow_tf32 = True
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
