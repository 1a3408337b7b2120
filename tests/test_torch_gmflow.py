"""GMFlow (``models/flow/gmflow.py``) and kernel K5r on the CPU, in
float32, against the benchmark's plain reference
(``perfbench/reference/gmflow.py``, the published GMFlow code in plain
PyTorch) at the published widths: a 64x128 frame pair gives 8x16 tokens
in 2x2 windows of 4x8, shifted by (2, 4). Also K5r's plain version
against the published -100 mask, a shifted layer against its nine
regions one by one, the runtime streaming with ``flow.arch: gmflow``
against the reference GMFlow and ATDNVO, and the configuration's
defaults. The ``cuda`` test holds the K5r kernel to its plain version on
the card and skips here.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig
from atdn_vslam_torch.models.factory import build_flow_model, init_params
from atdn_vslam_torch.models.flow.gmflow import (
    FeatureFlowAttention,
    GlobalMatching,
    GMFlow,
    TransformerLayer,
    partition,
    shift_regions,
    unpartition,
)
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.ops.attention import flash_attend_plain, flash_attend_regions, flash_attend_regions_plain
from atdn_vslam_torch.ops.bilinear import coords_grid
from perfbench.reference import gmflow as ref_gmflow
from perfbench.reference.atdnvo import ATDNVO as RefATDNVO
from perfbench.reference.atdnvo import pose_matrix

torch.set_num_threads(2)

HW = (64, 128)
#: float32 on both sides; the port sums some products in another order
TOL = 1e-4


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _gmflow_config(**slam) -> Config:
    return Config(flow=FlowNetConfig(arch="gmflow"), slam=SlamConfig(**slam))


def _frames(seed=0, hw=HW):
    g = torch.Generator().manual_seed(seed)
    im1 = torch.rand((1, *hw, 3), generator=g) * 255
    return im1, torch.roll(im1, shifts=(1, 3), dims=(1, 2))


@functools.lru_cache(maxsize=1)
def _stages():
    """Every stage of the port's GMFlow and of the reference on one frame
    pair, the same seeded weights."""
    model = build_flow_model(_gmflow_config(), "cpu")
    init_params(model, 7)
    ref = ref_gmflow.GMFlow().eval()
    ref.load_state_dict(model.state_dict())
    got = {}

    def keep(name):
        return lambda module, args, out: got.__setitem__(name, out)

    for i, block in enumerate(model.transformer.layers):
        block.register_forward_hook(keep(f"block{i}"))
    model.matching.register_forward_hook(keep("matched"))
    model.feature_flow_attn.register_forward_hook(keep("propagated"))
    im1, im2 = _frames()
    record = {}
    with torch.no_grad():
        low, up = model(im1, im2)
        ref(im1, im2, record)
    got["upsampled"] = up
    want = {f"block{i}": x for i, x in enumerate(record["blocks"])}
    want["matched"] = record["matched"].permute(0, 2, 3, 1)
    want["propagated"] = record["propagated"].permute(0, 2, 3, 1)
    want["upsampled"] = record["upsampled"][:, : HW[0], : HW[1]]
    got = {k: v.reshape(want[k].shape) for k, v in got.items()}
    return got, want


@pytest.mark.parametrize("stage", [f"block{i}" for i in range(6)] + ["matched", "propagated", "upsampled"])
def test_gmflow_matches_the_reference(stage):
    """Both frames' features after each of the six blocks (the reference's
    ``concat0``, (2, H W, C)), the matched, the propagated and the
    upsampled flow."""
    got, want = _stages()
    assert _rel(got[stage], want[stage]) < TOL


def test_matching_and_propagation_equal_the_padded_values():
    """The matching and the propagation hand K5 their 2 value columns as
    they are; on the CPU their flows equal K5's plain version on those
    columns zero-extended to 16, as GMFlow passed them before, on
    features of GMFlow's magnitude (tokens of norm ~12)."""
    b, h, w, c = 1, 12, 20, 128
    g = torch.Generator().manual_seed(4)
    f0, f1 = (torch.randn((b, h, w, c), generator=g) * (12 / c**0.5) for _ in range(2))
    grid = coords_grid(h, w).reshape(1, h * w, 2)
    padded = flash_attend_plain(f0.reshape(b, h * w, c), f1.reshape(b, h * w, c),
                                torch.nn.functional.pad(grid, (0, 14)), c**-0.5)[..., :2]
    matched = GlobalMatching()(f0, f1)
    assert _rel(matched, (padded - grid).reshape(b, h, w, 2)) < 1e-6
    propagation = FeatureFlowAttention(c)
    with torch.no_grad():
        got = propagation(f0, matched)
        q = propagation.q_proj(f0.reshape(b, h * w, c))
        v = torch.nn.functional.pad(matched.reshape(b, h * w, 2), (0, 14))
        want = flash_attend_plain(q, propagation.k_proj(q), v, c**-0.5)[..., :2].reshape(b, h, w, 2)
    assert _rel(got, want) < 1e-6


def _published_mask_attention(q, k, v, regions):
    """softmax(q k^T / sqrt(D) + mask) v, the mask -100 between regions."""
    s = q @ k.transpose(1, 2) / q.shape[-1] ** 0.5
    s = s + torch.where(regions[:, :, None] == regions[:, None, :], 0.0, -100.0)
    return torch.softmax(s, dim=-1) @ v


@pytest.mark.parametrize("hw,splits", [((8, 16), 2), ((48, 154), 2), ((12, 18), 3)])
def test_k5r_plain_matches_the_published_mask(hw, splits):
    """K5r drops the pairs the published mask weighs by e^-100: the two
    agree to float32 rounding (batch of two frames' windows, 16 wide)."""
    regions = shift_regions(*hw, splits).repeat(2, 1)
    b, n = regions.shape
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((b, n, 16), generator=g) for _ in range(3))
    got = flash_attend_regions_plain(q, k, v, regions)
    assert (got - _published_mask_attention(q, k, v, regions)).abs().max() < 1e-5
    assert torch.equal(flash_attend_regions(q, k, v, regions), got)


def test_shifted_layer_is_its_nine_regions():
    """A shifted layer on the rolled windows equals attention run apart in
    each of the published nine regions of the rolled frame (each inside
    one window), then merged, normed and added."""
    h, w, c, splits = 8, 16, 32, 2
    shift = (h // splits // 2, w // splits // 2)
    torch.manual_seed(3)
    layer = TransformerLayer(c, no_ffn=True, ffn_dim_expansion=4)
    x = torch.randn(2, h, w, c)
    regions = shift_regions(h, w, splits).repeat(2, 1)
    with torch.no_grad():
        got = unpartition(layer(partition(x, splits, shift), partition(x, splits, shift), regions), (h, w), splits,
                          shift)
        rolled = torch.roll(x, (-shift[0], -shift[1]), (1, 2))
        q, k, v = layer.q_proj(rolled), layer.k_proj(rolled), layer.v_proj(rolled)
        message = torch.zeros_like(rolled)
        bounds_h = ((0, h - 2 * shift[0]), (h - 2 * shift[0], h - shift[0]), (h - shift[0], h))
        bounds_w = ((0, w - 2 * shift[1]), (w - 2 * shift[1], w - shift[1]), (w - shift[1], w))
        for y0, y1 in bounds_h:
            for x0, x1 in bounds_w:
                part = [t[:, y0:y1, x0:x1].reshape(2, -1, c) for t in (q, k, v)]
                attn = torch.softmax(part[0] @ part[1].transpose(1, 2) / c**0.5, dim=-1) @ part[2]
                message[:, y0:y1, x0:x1] = attn.reshape(2, y1 - y0, x1 - x0, c)
        want = rolled + layer.norm1(layer.merge(message))
        want = torch.roll(want, shift, (1, 2))
    assert (got - want).abs().max() < 1e-5


def test_slam_runtime_streams_through_gmflow():
    """``SlamRuntime`` with ``flow.arch: gmflow`` streams four frames; its
    poses are the reference GMFlow's flows through the reference ATDNVO,
    chained on the host."""
    from atdn_vslam_torch.models.odometry import ATDNVO
    from atdn_vslam_torch.slam import SlamRuntime

    hw = (128, 192)
    flow = build_flow_model(_gmflow_config(), "cpu")
    init_params(flow, 11)
    odo = ATDNVO(hw)
    init_params(odo, 12)
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 255, (hw[0] + 8, hw[1] + 16, 3))
    frames = [base[i : i + hw[0], 3 * i : 3 * i + hw[1]].astype(np.uint8) for i in range(4)]
    with tempfile.TemporaryDirectory() as kf:
        config = Config(flow=FlowNetConfig(arch="gmflow"), slam=SlamConfig(image_height=hw[0], image_width=hw[1]),
                        keyframes_path=kf)
        rt = SlamRuntime(config, flow.state_dict(), odo.state_dict(), device="cpu")
        rt.start_odometry()
        poses = [rt(f) for f in frames]
        rt.keyframes.flush()
    ref = ref_gmflow.GMFlow().eval()
    ref.load_state_dict(flow.state_dict())
    ref_odo = RefATDNVO(hw).eval()
    ref_odo.load_state_dict(odo.state_dict())
    pose, carry = np.eye(4), ref_odo.init_carry(1, "cpu")
    with torch.no_grad():
        for i in range(1, 4):
            im1, im2 = (torch.from_numpy(frames[j]).float()[None] for j in (i - 1, i))
            _, up = ref(im1, im2)
            (rot, tr), carry = ref_odo(up[:, None], carry)
            pose = pose @ pose_matrix(rot[0, 0], tr[0, 0]).numpy()
            assert np.abs(poses[i] - pose).max() < 1e-5
    assert np.array_equal(poses[0], np.eye(4))


def test_gmflow_refuses_a_warm_start():
    model = GMFlow()
    im1, im2 = _frames()
    with pytest.raises(ValueError, match="flow_init"):
        model(im1, im2, flow_init=torch.zeros(1, 8, 16, 2))
    from atdn_vslam_torch.slam import SlamRuntime

    # the runtime refuses it when it is built, not on the first frame
    config = _gmflow_config(image_height=64, image_width=128, flow_warm_start=True)
    with pytest.raises(ValueError, match="flow_warm_start"):
        SlamRuntime(config, model.state_dict(), {}, device="cpu")


def test_flow_arch_defaults_to_gma():
    assert FlowNetConfig().arch == "gma"
    assert isinstance(build_flow_model(Config(), "cpu"), RAFTGMA)
    assert isinstance(build_flow_model(_gmflow_config(), "cpu"), GMFlow)
    with pytest.raises(ValueError, match="flow.arch"):
        build_flow_model(Config(flow=FlowNetConfig(arch="raft")), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(48, 154), (10, 36)])
def test_k5r_kernel_matches_its_plain_version(dtype, hw):
    """K5r on the card at GMFlow's KITTI shape: 8 windows (two frames) of
    1,848 tokens (14 key tiles and a ragged one), 128 wide, the shifted
    layer's regions; and windows of 90 tokens, inside one tile. f32: the
    same softmax up to summation order (1e-5); bf16: both round the
    weights to bf16 once (rtol 2^-7, atol 2^-8, as K5's test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    regions = shift_regions(*hw, 2).repeat(2, 1).to(dev)
    b, n = regions.shape
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((b, n, 128), generator=g).to(dev, dtype) for _ in range(3))
    before = flash_attend_regions.launches
    got = flash_attend_regions(q, k, v, regions)
    torch.cuda.synchronize()
    assert flash_attend_regions.launches == before + 1
    want = flash_attend_regions_plain(q, k, v, regions)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=2.0**-8)


@pytest.mark.cuda
@pytest.mark.parametrize("mixed_precision", [False, True])
def test_gmflow_on_the_card(mixed_precision):
    """A frame pair through GMFlow on the card: the shifted layers launch
    K5r once each (6), the unshifted layers, the matching and the
    propagation K5 once each (8), the last two through its narrow kernel
    (2); in float32 the flows equal the CPU's (1e-4 of the largest), in
    bf16 they stay finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from atdn_vslam_torch.ops.attention import flash_attend

    torch.backends.cuda.matmul.allow_tf32 = False
    config = Config(flow=FlowNetConfig(arch="gmflow", mixed_precision=mixed_precision))
    cpu = build_flow_model(config, "cpu")
    init_params(cpu, 7)
    card = build_flow_model(config, "cuda")
    card.load_state_dict(cpu.state_dict())
    im1, im2 = _frames()
    k5, k5r, narrow = flash_attend.launches, flash_attend_regions.launches, flash_attend.narrow_launches
    with torch.no_grad():
        low, up = card(im1.cuda(), im2.cuda())
        torch.cuda.synchronize()
        assert (flash_attend.launches - k5, flash_attend_regions.launches - k5r) == (8, 6)
        assert flash_attend.narrow_launches - narrow == 2
        if mixed_precision:
            assert torch.isfinite(up).all()
        else:
            want = cpu(im1, im2)[1]
            assert _rel(up.cpu(), want) < TOL
