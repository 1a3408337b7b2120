"""Kernels K2n, K4, K2s and K3t against their plain PyTorch versions on
the GPU, at small ragged shapes, and K4's backward through its
``autograd.Function``. Marked ``cuda``; each test skips when no CUDA
device is present. On the GPU machine (which has no JAX, so the JAX test
conftest is left out):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_slice3.py
"""

import numpy as np
import pytest
import torch

from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.ops.attention import (
    apply_attention_probs,
    attention_probs_spatial_plain,
    flash_apply_probs,
    flash_apply_probs_plain,
)
from atdn_vslam_torch.ops.corr_dot_tiled import build_pyramid_tiled, corr_dot_tiled, corr_dot_tiled_plain
from atdn_vslam_torch.ops.corr_lookup import build_corr_pyramid, lookup_corr_pyramid
from atdn_vslam_torch.ops.corr_lookup_nlanes import (
    build_corr_pyramid_nlanes,
    lookup_corr_pyramid_nlanes,
    nlanes_lookup_level_plain,
    nlanes_lookup_levels,
)
from atdn_vslam_torch.ops.corr_lookup_slab import (
    lookup_corr_pyramid_slab,
    lookup_corr_pyramid_slab_plain,
    pad_pyramid_for_slab,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _feats(seed, batch, h, w, c, device, dtype):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((batch, h, w, c), generator=g).to(device, dtype) for _ in range(2)]


def _coords(seed, batch, h, w, device):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-12, max(h, w) + 12, size=(batch, h, w, 2)).astype(np.float32)
    xy[0, 0, 0] = (1e6, -1e6)
    xy[0, 0, 1] = (np.nan, 2.0)
    xy[0, 0, 2] = (3.5, np.inf)
    return torch.from_numpy(xy).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(9, 13), (20, 30)])
def test_nlanes_kernel(cuda, dtype, h, w):
    """Levels 1-3 in one launch against the plain version per level:
    both compute the same two-term sums with the same roundings (no
    multiply-add contraction in the kernel): 1e-6. NaN windows for
    non-finite coordinates."""
    f1, f2 = _feats(0, 2, h, w, 32, cuda, dtype)
    pyr = build_corr_pyramid_nlanes(f1, f2, 4, dtype)
    coords = _coords(1, 2, h, w, cuda).reshape(2, h * w, 2)
    before = nlanes_lookup_levels.launches
    got = nlanes_lookup_levels(pyr[1:], coords, 1, 4)
    torch.cuda.synchronize()
    assert nlanes_lookup_levels.launches == before + 1
    ref = torch.cat([nlanes_lookup_level_plain(v, coords, i + 1, 4) for i, v in enumerate(pyr[1:])], -1)
    assert got.shape == ref.shape == (2, h * w, 243)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6, equal_nan=True)
    assert bool(got[0, 1].isnan().all()) and bool(got[0, 2].isnan().all())


def test_nlanes_pyramid_lookup_launches(cuda):
    """One K2 launch for level 0 and one K2n launch for levels 1-3."""
    f1, f2 = _feats(2, 1, 16, 24, 64, cuda, torch.bfloat16)
    pyr = build_corr_pyramid_nlanes(f1, f2, 4)
    coords = _coords(3, 1, 16, 24, cuda)
    k2, k2n = lookup_corr_pyramid.launches, nlanes_lookup_levels.launches
    got = lookup_corr_pyramid_nlanes(pyr, coords, 4)
    torch.cuda.synchronize()
    assert (lookup_corr_pyramid.launches - k2, nlanes_lookup_levels.launches - k2n) == (1, 1)
    assert got.shape == (1, 16, 24, 324)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,d,dv,kp", [
    (1, 5, 9, 16, 32, None), (2, 7, 20, 32, 16, None), (1, 13, 81, 16, 128, None),
    (1, 1, 1, 16, 64, 8),        # M = 1 and one partial key step (K = 8)
    (2, 2, 3, 16, 16, 8),        # batch 2, K = 8
    (2, 17, 30, 16, 64, None),   # batch 2, 510 rows, K = 512: fewer units than SMs
    (1, 40, 50, 16, 128, None),  # 2000 rows, K = 2048: blocks cross tile boundaries
])
def test_apply_probs_kernel(cuda, dtype, b, h, w, d, dv, kp):
    """Rows not a multiple of the 64-row (float32) or 128-row (bf16)
    block, keys (N_pad = 128, 256, 512, 1152, 2048, or K = 8) ragged
    against the 64-key stage, v with fewer rows than P has columns, M =
    1, batch 2 (a load reaching past a batch's rows or v's rows would
    read the next batch's), and the bf16 kernel's key split across
    blocks. Both accumulate the same products in float32 in another
    order: f32 1e-5; bf16 out one ulp (rtol 2^-7)."""
    g = torch.Generator().manual_seed(4)
    n = h * w
    q = (torch.randn((b, n, d), generator=g) * d**-0.5).to(cuda, dtype)
    k = torch.randn((b, n, d), generator=g).to(cuda, dtype)
    v = torch.randn((b, n, dv), generator=g).to(cuda, dtype)
    probs = attention_probs_spatial_plain(q, k, h, w, 1.0)
    if kp is not None:
        probs = torch.nn.functional.pad(probs[..., :n], (0, kp - n))
    before = flash_apply_probs.launches
    got = flash_apply_probs(probs, v)
    torch.cuda.synchronize()
    assert flash_apply_probs.launches == before + 1
    ref = flash_apply_probs_plain(probs, v)
    assert got.shape == ref.shape == (b, h, w, dv) and got.dtype == dtype
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-5)
    via = apply_attention_probs(probs, v.float(), use_pallas=True)  # v cast to probs' type
    assert via.dtype == dtype
    torch.testing.assert_close(via, got, rtol=0, atol=0)


@pytest.mark.parametrize("b,h,w", [(2, 17, 30), (1, 40, 50)])
def test_apply_probs_kernel_is_deterministic(cuda, b, h, w):
    """The bf16 kernel splits tiles between blocks and adds the segments
    in a fixed order behind a counter, not with float atomics: two
    launches give the same bits."""
    g = torch.Generator().manual_seed(6)
    n = h * w
    q = (torch.randn((b, n, 16), generator=g) * 0.25).to(cuda, torch.bfloat16)
    k = torch.randn((b, n, 16), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((b, n, 128), generator=g).to(cuda, torch.bfloat16)
    probs = attention_probs_spatial_plain(q, k, h, w, 1.0)
    first = flash_apply_probs(probs, v)
    second = flash_apply_probs(probs, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_apply_probs_backward_on_the_card(cuda):
    """K4's autograd.Function on CUDA tensors: dP and dv against the
    plain products (float32, 1e-5), zero gradient on the pad columns,
    dv in v's type."""
    g = torch.Generator().manual_seed(5)
    h, w, d = 6, 11, 32
    n = h * w
    q = (torch.randn((1, n, d), generator=g) * d**-0.5).to(cuda)
    k = torch.randn((1, n, d), generator=g).to(cuda)
    probs = attention_probs_spatial_plain(q, k, h, w, 1.0).requires_grad_()
    v = torch.randn((1, n, d), generator=g).to(cuda).requires_grad_()
    cot = torch.randn((1, h, w, d), generator=g).to(cuda)
    (flash_apply_probs(probs, v) * cot).sum().backward()
    dp, dv = probs.grad, v.grad
    probs.grad = v.grad = None
    (flash_apply_probs_plain(probs, v) * cot).sum().backward()
    torch.testing.assert_close(dp, probs.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, v.grad, rtol=1e-5, atol=1e-5)
    assert float(dp[..., n:].abs().max()) == 0.0 and dv.dtype == v.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(30, 17), (9, 13)])
def test_slab_kernel(cuda, dtype, h, w):
    """A 30-row level 0 (padded to 32) and an unpadded pyramid; both
    contract rows then columns with the same two-term float32 sums:
    1e-6; NaN windows for non-finite coordinates."""
    f1, f2 = _feats(6, 2, h, w, 32, cuda, dtype)
    padded, rows = pad_pyramid_for_slab(build_corr_pyramid(f1, f2, 4, dtype=dtype))
    coords = _coords(7, 2, h, w, cuda)
    before = lookup_corr_pyramid_slab.launches
    got = lookup_corr_pyramid_slab(padded, coords, 4, orig_rows=rows)
    torch.cuda.synchronize()
    assert lookup_corr_pyramid_slab.launches == before + 1
    ref = lookup_corr_pyramid_slab_plain(padded, coords, 4, orig_rows=rows)
    assert got.shape == ref.shape == (2, h, w, 324)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("n,hl,wl,c", [(300, 11, 38, 256), (129, 5, 19, 64), (70, 3, 40, 40)])
@pytest.mark.parametrize("channels_first", [False, True])
def test_corr_dot_tiled_kernel(cuda, in_dtype, out_dtype, n, hl, wl, c, channels_first):
    """Ragged N, widths Hl * Wl = 418 and 95 of the KITTI levels 2 and 3,
    120 (the 16-byte store path), C not a multiple of the 32-channel
    stage; f2 contiguous or the NHWC view of an NCHW map (read through
    its strides). Both sum exact products in float32 and scale before one
    cast: f32 out 1e-5, bf16 out one ulp (2^-7)."""
    g = torch.Generator().manual_seed(8)
    f1 = torch.randn((2, n, c), generator=g).to(cuda, in_dtype)
    f2 = torch.randn((2, hl, wl, c), generator=g).to(cuda, in_dtype)
    if channels_first:
        f2 = f2.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = corr_dot_tiled.launches
    got = corr_dot_tiled(f1, f2, c**-0.5, out_dtype)
    torch.cuda.synchronize()
    assert corr_dot_tiled.launches == before + 1
    ref = corr_dot_tiled_plain(f1, f2, c**-0.5, out_dtype)
    assert got.shape == (2, n, hl, wl) and got.dtype == out_dtype
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [256, 40])
def test_corr_dot_tiled_stages_a_channels_first_map(cuda, out_dtype, c):
    """f2 the NHWC view of a (2, C, 47, 154) NCHW map, the KITTI level 0
    as the encoder gives it: its channel stride 47 * 154 * 2 = 14,476
    bytes is no multiple of 16, so no tensor map can read it. The
    wrapper hands the kernel a scratch buffer, the transposing pass
    stages f2 K-major, and one launch is counted; the C entry refuses the
    same f2 without a scratch buffer. f32 out 1e-5, bf16 out one ulp."""
    from atdn_vslam_torch.ops import _kernels

    g = torch.Generator().manual_seed(11)
    f1 = torch.randn((2, 60, c), generator=g).to(cuda, torch.bfloat16)
    f2 = torch.randn((2, c, 47, 154), generator=g).to(cuda, torch.bfloat16).permute(0, 2, 3, 1)
    before = corr_dot_tiled.launches
    got = corr_dot_tiled(f1, f2, c**-0.5, out_dtype)
    torch.cuda.synchronize()
    assert corr_dot_tiled.launches == before + 1
    assert got.shape == (2, 60, 47, 154) and got.dtype == out_dtype
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), corr_dot_tiled_plain(f1, f2, c**-0.5, out_dtype).float(),
                               rtol=rtol, atol=1e-5)
    status = _kernels.library("corr_dot_tiled").atdn_corr_dot_tiled(
        f1.data_ptr(), f2.data_ptr(), None, got.data_ptr(), 2, 60, 47, 154, c, *f2.stride(),
        c**-0.5, 1, int(out_dtype == torch.bfloat16), 0, torch.cuda.current_stream().cuda_stream,
    )
    assert status != 0


@pytest.mark.parametrize("kernel", ["corr_dot", "corr_dot_tiled"])
def test_corr_dot_kernels_are_deterministic(cuda, kernel):
    """Each output element is one block's float32 sum in a fixed order:
    two launches of the bf16 core give the same bits (K3t through its
    staging pass)."""
    from atdn_vslam_torch.ops.corr_lookup import corr_dot_rowmajor

    g = torch.Generator().manual_seed(12)
    f1 = torch.randn((2, 300, 256), generator=g).to(cuda, torch.bfloat16)
    f2 = torch.randn((2, 256, 23, 77), generator=g).to(cuda, torch.bfloat16).permute(0, 2, 3, 1)
    if kernel == "corr_dot":
        f2 = f2.reshape(2, 23 * 77, 256)
        run = lambda: corr_dot_rowmajor(f1, f2, 1 / 16)  # noqa: E731
    else:
        run = lambda: corr_dot_tiled(f1, f2, 1 / 16)  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_pyramid_tiled_through_the_kernel(cuda):
    """build_pyramid_tiled launches K3t once per level and gives the
    levels of the default build (both round a float32 sum once; f1 is
    scaled first there, exact for C = 256): 1e-5 in float32."""
    f1, f2 = _feats(9, 1, 9, 13, 256, cuda, torch.float32)
    before = corr_dot_tiled.launches
    got = build_pyramid_tiled(f1, f2.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), 4, torch.float32)
    torch.cuda.synchronize()
    assert corr_dot_tiled.launches == before + 4
    for a, b in zip(got, build_corr_pyramid(f1, f2, 4)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_raftgma_corr_nlanes_on_cuda(cuda):
    """The nlanes flow net in float32 on the card against the CPU's
    plain versions on the same weights: 1e-3 px, as chip_smoke's
    agreement check."""
    model = RAFTGMA(iters=2, corr_nlanes=True).eval()
    g = torch.Generator().manual_seed(10)
    im1, im2 = (torch.rand((1, 64, 96, 3), generator=g) * 255 for _ in range(2))
    with torch.no_grad():
        want = model(im1, im2)
        model.to(cuda)
        k2n = nlanes_lookup_levels.launches
        got = model(im1.to(cuda), im2.to(cuda))
    assert nlanes_lookup_levels.launches - k2n == 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3)


def test_slice3_kernels_reject_what_they_do_not_take(cuda):
    vol = torch.zeros((1, 3, 4, 12), device=cuda)
    with pytest.raises(ValueError):
        nlanes_lookup_levels([vol], torch.zeros((1, 12, 2), device=cuda), 1, radius=3)
    with pytest.raises(ValueError):
        nlanes_lookup_levels([vol], torch.zeros((1, 11, 2), device=cuda), 1)
    with pytest.raises(TypeError):
        nlanes_lookup_levels([vol.half()], torch.zeros((1, 12, 2), device=cuda), 1)
    probs = torch.zeros((1, 2, 3, 128), device=cuda)
    with pytest.raises(ValueError):
        flash_apply_probs(probs, torch.zeros((1, 6, 24), device=cuda))  # value width 24
    with pytest.raises(TypeError):
        flash_apply_probs(probs, torch.zeros((1, 6, 32), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        flash_apply_probs(probs, torch.zeros((1, 130, 32), device=cuda))  # more rows than keys
    pyr = [torch.zeros((1, 6, 30, 3), device=cuda)]
    with pytest.raises(ValueError):
        lookup_corr_pyramid_slab(pyr, torch.zeros((1, 2, 3, 2), device=cuda), orig_rows=(29,))
    with pytest.raises(ValueError):
        lookup_corr_pyramid_slab(pyr, torch.zeros((1, 2, 3, 2), device=cuda), radius=3)
    with pytest.raises(ValueError):
        corr_dot_tiled(torch.zeros((1, 4, 12), device=cuda), torch.zeros((1, 2, 2, 12), device=cuda), 1.0)
    with pytest.raises(TypeError):
        corr_dot_tiled(torch.zeros((1, 4, 16), device=cuda), torch.zeros((1, 2, 2, 16), device=cuda).bfloat16(), 1.0)
