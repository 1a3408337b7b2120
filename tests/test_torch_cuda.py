"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU, at small ragged shapes. Marked ``cuda``; each test skips when no
CUDA device is present. On the GPU machine (which has no JAX, so the
JAX test conftest is left out):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.ops.attention import (
    attention_probs_spatial,
    attention_probs_spatial_plain,
    flash_attend,
    flash_attend_plain,
)
from atdn_vslam_torch.ops.corr_lookup import (
    build_corr_pyramid,
    corr_dot_rowmajor,
    corr_dot_rowmajor_plain,
    lookup_corr_pyramid,
    lookup_corr_pyramid_plain,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,d,n_kv", [
    (7, 9, 16, 63), (5, 13, 32, 200), (8, 16, 128, 128),
    # n != n_kv: one key, one key short of a tile, one key past it, eight
    # tiles; head widths 16, 64, 128 and 256 (q resident in four boxes)
    (3, 5, 256, 1), (9, 15, 64, 127), (10, 13, 128, 129), (4, 7, 16, 1000), (11, 12, 256, 1000),
])
def test_attention_probs_kernel(cuda, dtype, h, w, d, n_kv):
    """f32: same float32 softmax up to summation order and the fast
    exp (rtol 1e-5); bf16: both round a float32 softmax, one bf16 ulp
    (rtol 2^-7). Batch 2, so a load reaching past a batch's rows would
    read the next batch's. Pad columns are exact zeros, launches are
    counted."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, h * w, d)).astype(np.float32) * d**-0.5)
    k = torch.from_numpy(rng.normal(size=(2, n_kv, d)).astype(np.float32))
    q, k = q.to(cuda, dtype), k.to(cuda, dtype)
    before = attention_probs_spatial.launches
    got = attention_probs_spatial(q, k, h, w, 1.0)
    torch.cuda.synchronize()
    assert attention_probs_spatial.launches == before + 1
    ref = attention_probs_spatial_plain(q, k, h, w, 1.0)
    assert got.shape == ref.shape == (2, h, w, -(-n_kv // 128) * 128)
    assert got.dtype == dtype
    assert bool((got[..., n_kv:] == 0).all())
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("n,n_kv,splits", [(100, 129, 7), (300, 1, 3), (129, 640, 5), (64, 1000, 8)])
def test_attention_probs_bf16_splits(cuda, n, n_kv, splits):
    """The bf16 kernel with a given split count, through its C entry: more
    splits than key tiles (129 keys are two tiles, so five of seven
    splits hold no key; one key: two of three) merge as if they were
    absent, and one split per tile; the same result as the plain version
    within one bf16 ulp (rtol 2^-7), exact-zero pad columns, written
    into a sentinel buffer with 16 bytes free on either side that no
    store reaches."""
    from atdn_vslam_torch.ops import _kernels

    rng = np.random.default_rng(8)
    d = 64
    q = torch.from_numpy(rng.normal(size=(2, n, d)).astype(np.float32) * d**-0.5).to(cuda, torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(2, n_kv, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    n_pad = -(-n_kv // 128) * 128
    ws = torch.empty((2, splits, n, 2), dtype=torch.float32, device=cuda)
    buf = torch.full((2 * n * n_pad + 16,), -7.0, dtype=torch.bfloat16, device=cuda)
    status = _kernels.library("attention_probs").atdn_attention_probs(
        q.data_ptr(), k.data_ptr(), ws.data_ptr(), buf[8:].data_ptr(), 2, n, n_kv, n_pad, d, splits,
        1.0, 1, 0, torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert status == 0
    assert bool((buf[:8] == -7.0).all()) and bool((buf[-8:] == -7.0).all())
    got = buf[8:-8].reshape(2, n, n_pad)
    assert bool((got[..., n_kv:] == 0).all())
    ref = attention_probs_spatial_plain(q, k, 1, n, 1.0).reshape(2, n, n_pad)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=1e-7)


def test_attention_probs_kernel_is_deterministic(cuda):
    """Two launches of the bf16 kernel at a split shape give the same
    bits."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(1, 600, 128)).astype(np.float32) / 128**0.5).to(cuda, torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(1, 900, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    first = attention_probs_spatial(q, k, 20, 30, 1.0)
    second = attention_probs_spatial(q, k, 20, 30, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(5, 7), (12, 20)])
def test_corr_lookup_kernel(cuda, dtype, h, w):
    """Same taps lerped in float32 on both sides (rtol/atol 1e-5),
    coordinates inside, partly and wholly outside, and non-finite."""
    rng = np.random.default_rng(1)
    f1 = torch.from_numpy(rng.normal(size=(2, h, w, 32)).astype(np.float32)).to(cuda, dtype)
    f2 = torch.from_numpy(rng.normal(size=(2, h, w, 32)).astype(np.float32)).to(cuda, dtype)
    pyramid = build_corr_pyramid(f1, f2, 4, dtype=dtype)
    coords = rng.uniform(-12, max(h, w) + 12, size=(2, h, w, 2)).astype(np.float32)
    coords[0, 0, 0] = (1e6, -1e6)
    coords[0, 0, 1] = (np.nan, 2.0)
    coords = torch.from_numpy(coords).to(cuda)
    before = lookup_corr_pyramid.launches
    got = lookup_corr_pyramid(pyramid, coords, 4)
    torch.cuda.synchronize()
    assert lookup_corr_pyramid.launches == before + 1
    ref = lookup_corr_pyramid_plain(pyramid, coords, 4)
    assert got.shape == ref.shape == (2, h, w, 324)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", [
    [(1, 23)],                            # one level of one row
    [(9, 1), (4, 1)],                     # columns of one element
    [(6, 11), (3, 5), (1, 3)],            # odd widths: rows at every 2-byte phase
    [(5, 7), (3, 13), (2, 9), (1, 1)],    # four levels down to 1 x 1
])
def test_corr_lookup_kernel_level_shapes(cuda, dtype, levels):
    """1 to 4 levels of any shape at batch 2 (6 x 7 queries): odd level
    sizes start the queries' slabs and rows at every 2-byte phase, and
    levels of one row, one column or one element; coordinates inside,
    outside and non-finite. Same taps lerped in float32 (1e-5)."""
    rng = np.random.default_rng(2)
    h1, w1 = 6, 7
    pyramid = [torch.from_numpy(rng.normal(size=(2, h1 * w1, hl, wl)).astype(np.float32)).to(cuda, dtype)
               for hl, wl in levels]
    coords = rng.uniform(-14, 30, size=(2, h1, w1, 2)).astype(np.float32)
    coords[1, 2, 3] = (np.inf, 1.0)
    coords[0, 5, 6] = (3.0, -np.inf)
    coords = torch.from_numpy(coords).to(cuda)
    got = lookup_corr_pyramid(pyramid, coords, 4)
    torch.cuda.synchronize()
    ref = lookup_corr_pyramid_plain(pyramid, coords, 4)
    assert got.shape == ref.shape == (2, h1, w1, 81 * len(levels))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 6, 24), device=cuda)
    with pytest.raises(ValueError):
        attention_probs_spatial(q, q, 2, 3)
    pyr = [torch.zeros((1, 6, 2, 3), device=cuda)]
    with pytest.raises(ValueError):
        lookup_corr_pyramid(pyr, torch.zeros((1, 2, 3, 2), device=cuda), radius=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "nq,nk,d,dv",
    [(64, 64, 16, 16), (100, 300, 32, 16), (300, 100, 128, 128), (7, 1000, 64, 128),
     (130, 129, 64, 64), (257, 1000, 16, 64), (65, 300, 64, 16)],
)
def test_flash_attend_kernel(cuda, dtype, nq, nk, d, dv):
    """Nq != Nk and Nk not a multiple of the key tile (128 bf16, 32 f32);
    Nq not a multiple of the 128-row bf16 block; a last key tile of one
    key (Nk = 129); D and Dv of 16, 64 and 128; batch 2 with a ragged key
    count, so a load that reached past a batch's keys would read the
    next batch's. f32: the same softmax up to summation order (1e-5);
    bf16: both round exp(s - max) to bf16, the kernel against its running
    max, so the weights differ by an ulp (atol 2^-8 on outputs of size
    ~0.1-1, rtol 2^-7). Launches are counted; no row past Nq is
    written."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(2, nq, d)).astype(np.float32) * d**-0.5)
    k = torch.from_numpy(rng.normal(size=(2, nk, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, nk, dv)).astype(np.float32))
    q, k, v = q.to(cuda, dtype), k.to(cuda, dtype), v.to(cuda, dtype)
    before = flash_attend.launches
    got = flash_attend(q, k, v, 1.0)
    torch.cuda.synchronize()
    assert flash_attend.launches == before + 1
    ref = flash_attend_plain(q, k, v, 1.0)
    assert got.shape == ref.shape == (2, nq, dv) and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=2.0**-8)


def _float64_attend(q, k, v, scale):
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v.double())


@pytest.mark.parametrize(
    "b,nq,nk,dv",
    [(1, 7392, 7392, 2), (1, 1000, 7392, 2), (1, 7392, 300, 2), (2, 777, 1100, 2), (1, 300, 129, 1),
     (1, 300, 1000, 3), (2, 130, 4097, 4)],
)
def test_flash_attend_narrow_kernel(cuda, b, nq, nk, dv):
    """K5's narrow kernel (float32, Dv of 1 to 4) against float64: GMFlow's
    matching at KITTI (7,392 tokens, 128 wide, Dv 2); Nq != Nk; Nk no
    multiple of the 128-key tile or of the split (129: a last tile of one
    key); batch 2. Features of GMFlow's magnitude (tokens of norm ~12),
    each query a noisy copy of one key, so the softmax is as sharp as the
    matching's; the first queries' copies lie on both sides of every
    boundary between the key parts. Within 1e-5 of the largest value, as
    the float32 plain version; two calls give the same bits; each counts
    one K5 launch and one narrow launch."""
    from atdn_vslam_torch.ops.attention import _narrow_parts

    d = 128
    g = torch.Generator().manual_seed(nq + nk + dv)
    k = torch.randn((b, nk, d), generator=g) * (12 / d**0.5)
    best = torch.randint(0, nk, (b, nq), generator=g)
    parts = _narrow_parts(b, nq, nk, torch.cuda.get_device_properties(cuda).multi_processor_count)
    tiles = -(-nk // 128)
    edges = [p * tiles // parts * 128 for p in range(1, parts)]
    edge_keys = torch.tensor([x for e in edges for x in (e - 1, e)] or [0])[:nq]
    best[:, : len(edge_keys)] = edge_keys
    q = torch.gather(k, 1, best[..., None].expand(-1, -1, d)) + 0.3 * torch.randn((b, nq, d), generator=g)
    v = torch.randn((b, nk, dv), generator=g) * 100
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    before = (flash_attend.launches, flash_attend.narrow_launches)
    got = flash_attend(q, k, v, d**-0.5)
    again = flash_attend(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert (flash_attend.launches, flash_attend.narrow_launches) == (before[0] + 2, before[1] + 2)
    assert got.shape == (b, nq, dv) and got.dtype == torch.float32
    assert torch.equal(got, again)
    want = _float64_attend(q, k, v, d**-0.5)
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) < 1e-5 * scale
    assert float((flash_attend_plain(q, k, v, d**-0.5).double() - want).abs().max()) < 1e-5 * scale


def test_flash_attend_kernel_takes_strided_values(cuda):
    """v as the transposed view the aggregator hands over."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 70, 32)).astype(np.float32)).to(cuda)
    vt = torch.from_numpy(rng.normal(size=(1, 32, 70)).astype(np.float32)).to(cuda)
    got = flash_attend(q, q, vt.transpose(1, 2))
    torch.testing.assert_close(got, flash_attend_plain(q, q, vt.transpose(1, 2)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("n,m,c", [(300, 418, 256), (129, 1771, 64), (5, 8, 8), (200, 264, 40)])
def test_corr_dot_kernel(cuda, in_dtype, out_dtype, n, m, c):
    """Ragged N, the ragged widths M = 418 and 1771 of 2x KITTI's levels
    2 and 3, M a multiple of 8 (the 16-byte store path), C not a
    multiple of the 32-channel stage. Both sum exact products in float32
    and scale before one cast: f32 out 1e-5; bf16 out one ulp (2^-7)
    where the float32 sums round to either side."""
    rng = np.random.default_rng(4)
    f1 = torch.from_numpy(rng.normal(size=(2, n, c)).astype(np.float32)).to(cuda, in_dtype)
    f2 = torch.from_numpy(rng.normal(size=(2, m, c)).astype(np.float32)).to(cuda, in_dtype)
    before = corr_dot_rowmajor.launches
    got = corr_dot_rowmajor(f1, f2, c**-0.5, out_dtype)
    torch.cuda.synchronize()
    assert corr_dot_rowmajor.launches == before + 1
    ref = corr_dot_rowmajor_plain(f1, f2, c**-0.5, out_dtype)
    assert got.shape == (2, n, m) and got.dtype == out_dtype
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,m,c", [(70, 7238, 256), (33, 95, 64), (129, 95, 40), (17, 7238, 8)])
def test_corr_dot_core_rows_at_every_alignment(cuda, out_dtype, n, m, c):
    """The bf16-input core (TMA + wgmma) at batch 2 and widths whose rows
    start at every alignment modulo 16 bytes (M = 7238: four, M = 95:
    eight in bf16, four in float32), so each row's head, 16-byte body
    and tail stores are met; C of 256 (four boxes), 64 (one), 40 (a
    box partly zero-filled) and 8 (less than one product step). The
    output is written into a sentinel-filled buffer with 16 bytes free on
    either side: no store lands outside it. Both round one float32 sum:
    f32 out 1e-5, bf16 out one ulp (2^-7)."""
    from atdn_vslam_torch.ops import _kernels

    rng = np.random.default_rng(6)
    f1 = torch.from_numpy(rng.normal(size=(2, n, c)).astype(np.float32)).to(cuda, torch.bfloat16)
    f2 = torch.from_numpy(rng.normal(size=(2, m, c)).astype(np.float32)).to(cuda, torch.bfloat16)
    pad = 16 // torch.empty((), dtype=out_dtype).element_size()
    buf = torch.full((2 * n * m + 2 * pad,), -7.0, dtype=out_dtype, device=cuda)
    status = _kernels.library("corr_dot").atdn_corr_dot(
        f1.data_ptr(), f2.data_ptr(), buf[pad:].data_ptr(), 2, n, m, c, c**-0.5, 1,
        int(out_dtype == torch.bfloat16), 0, torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert status == 0
    assert bool((buf[:pad] == -7.0).all()) and bool((buf[-pad:] == -7.0).all())
    got = buf[pad:-pad].reshape(2, n, m)
    ref = corr_dot_rowmajor_plain(f1, f2, c**-0.5, out_dtype)
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-5)
    torch.testing.assert_close(corr_dot_rowmajor(f1, f2, c**-0.5, out_dtype), got, rtol=0, atol=0)


def test_corr_pyramid_through_the_kernel(cuda):
    """build_corr_pyramid(use_pallas=True) launches K3 once per level and
    gives the levels of the default path (both round a float32 sum once)."""
    rng = np.random.default_rng(5)
    f1 = torch.from_numpy(rng.normal(size=(1, 9, 13, 256)).astype(np.float32)).to(cuda)
    f2 = torch.from_numpy(rng.normal(size=(1, 9, 13, 256)).astype(np.float32)).to(cuda)
    before = corr_dot_rowmajor.launches
    got = build_corr_pyramid(f1, f2, 4, use_pallas=True)
    torch.cuda.synchronize()
    assert corr_dot_rowmajor.launches == before + 4
    for g, r in zip(got, build_corr_pyramid(f1, f2, 4)):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_new_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 6, 24), device=cuda)
    with pytest.raises(ValueError):
        flash_attend(q, q, q)  # head width 24
    q = torch.zeros((1, 6, 32), device=cuda)
    with pytest.raises(TypeError):
        flash_attend(q, q, q.half())
    with pytest.raises(ValueError):
        flash_attend(q, q[:, :5], q)
    with pytest.raises(ValueError):
        corr_dot_rowmajor(torch.zeros((1, 4, 12), device=cuda), torch.zeros((1, 4, 12), device=cuda), 1.0)
    with pytest.raises(TypeError):
        corr_dot_rowmajor(q, q.bfloat16(), 1.0)


def test_raftgma_refuses_use_pallas_false_on_cuda(cuda):
    """use_pallas=False asks for no kernel: the port raises on the GPU."""
    model = RAFTGMA(iters=1, use_pallas=False).to(cuda).eval()
    im = torch.zeros((1, 64, 96, 3), device=cuda)
    with pytest.raises(ValueError, match="use_pallas=False"):
        with torch.no_grad():
            model(im, im)


# --- K6, the encoders' instance norm with its ReLU (ops/norm.py) --------

NORM_TOL = {torch.bfloat16: {"rtol": 2.0**-7, "atol": 1e-5}, torch.float32: {"rtol": 1e-5, "atol": 1e-5}}


def _conv_like(shape, device, seed):
    """A convolution output's look: per channel an offset and a scale."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    scale = torch.rand((1, c, 1, 1), generator=g, device=device) * 2.5 + 0.5
    offset = torch.randn((1, c, 1, 1), generator=g, device=device) * 2
    return torch.randn(shape, generator=g, device=device) * scale + offset


def _kitti_norm_inputs(cuda):
    """The 15 inputs of GMA's feature encoder's instance norms on one
    376x1232 frame, bf16, with each norm's ``relu``."""
    from atdn_vslam_torch.models.flow.extractor import BasicEncoder, InstanceNorm

    torch.manual_seed(0)
    enc = BasicEncoder(256, "instance").to(cuda, torch.bfloat16)
    seen = []
    for m in enc.modules():
        if isinstance(m, InstanceNorm):
            m.register_forward_pre_hook(lambda mod, args: seen.append((args[0].clone(), mod.relu)))
    im = _conv_like((1, 3, 376, 1232), cuda, 1).to(torch.bfloat16)
    with torch.inference_mode():
        enc(im)
    return seen


def test_instance_norm_kernel_at_the_kitti_encoder_calls(cuda):
    """K6 against its plain version on the 15 calls of a KITTI frame's
    feature encoder (1/2, 1/4, 1/8; 13 with the ReLU), bf16 and the same
    inputs in float32, within one bf16 ulp (rtol 2^-7) and float32's
    1e-5; every input is contiguous; a launch each."""
    from atdn_vslam_torch.ops import norm

    calls = _kitti_norm_inputs(cuda)
    assert len(calls) == 15 and sum(relu for _, relu in calls) == 13
    assert {tuple(x.shape[1:]) for x, _ in calls} == {(64, 188, 616), (96, 94, 308), (128, 47, 154)}
    for x, relu in calls:
        assert x.is_contiguous()
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            before = norm.instance_norm.launches
            with torch.inference_mode():
                got = norm.instance_norm(xd, relu)
            assert norm.instance_norm.launches == before + 1 and got.dtype == dtype
            torch.testing.assert_close(got.float(), norm.instance_norm_plain(xd, relu).float(), **NORM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 64, 512, 1024), (1, 96, 256, 512), (1, 128, 128, 256),
                                   (1, 64, 192, 616), (2, 3, 7, 9), (3, 5, 1, 13), (1, 1, 300, 301)])
def test_instance_norm_kernel(cuda, shape, dtype):
    """Cityscapes' 1/2-1/8 planes, GMFlow's padded KITTI 1/2, ragged
    small planes (unaligned starts, planes shorter than a vector): against
    the plain version with and without the ReLU, the same bits twice."""
    from atdn_vslam_torch.ops import norm

    x = _conv_like(shape, cuda, 2).to(dtype)
    for relu in (True, False):
        got = norm.instance_norm(x, relu)
        torch.testing.assert_close(got.float(), norm.instance_norm_plain(x, relu).float(), **NORM_TOL[dtype])
        assert torch.equal(got, norm.instance_norm(x, relu))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 128, 47, 154), (2, 3, 7, 9), (1, 4, 64, 100)])
def test_instance_norm_every_cluster_and_the_two_pass_form(cuda, shape, dtype):
    """Each cluster size 1-16 (9-16 non-portable) against the plain
    version; the two-pass form, forced, gives the clustered form's bits at
    the same slices (the same sums in the same order), and takes more
    slices than a cluster can."""
    from atdn_vslam_torch.ops import norm

    x = _conv_like(shape, cuda, 3).to(dtype)
    want = norm.instance_norm_plain(x, True).float()
    for k in range(1, 17):
        got = norm.launch(x, True, 1e-5, k, False)
        torch.testing.assert_close(got.float(), want, **NORM_TOL[dtype])
        assert torch.equal(got, norm.launch(x, True, 1e-5, k, True)), k
    for k in (37, 256):
        torch.testing.assert_close(norm.launch(x, True, 1e-5, k, True).float(), want, **NORM_TOL[dtype])


def test_instance_norm_kernel_rejects_what_it_does_not_take(cuda):
    from atdn_vslam_torch.ops import norm

    with pytest.raises(TypeError):
        norm.instance_norm(torch.zeros((1, 2, 3, 4), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        norm.instance_norm(torch.zeros((2, 3, 4), device=cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        norm.instance_norm(torch.zeros((1, 2, 3, 4), device=cuda, requires_grad=True))


@pytest.mark.parametrize("arch", ["gma", "gmflow"])
def test_instance_norm_launches_over_a_stream_frame(cuda, arch):
    """15 launches a frame, bf16 at 96x192: a keyframe's ``encode_only``,
    a streamed frame (the cached feature map), a cold pair (both frames
    in one batch)."""
    from atdn_vslam_torch.config import Config, FlowNetConfig
    from atdn_vslam_torch.models.factory import build_flow_model, init_params
    from atdn_vslam_torch.ops import norm

    cfg = Config(flow=FlowNetConfig(arch=arch, iters=2, mixed_precision=True))
    model = init_params(build_flow_model(cfg, "cpu"), 4)
    flow = build_flow_model(cfg, cuda)
    flow.load_state_dict(model.state_dict())
    im1, im2 = (_conv_like((1, 96, 192, 3), cuda, s).clamp(-3, 3) * 40 + 128 for s in (5, 6))
    with torch.inference_mode():
        before = norm.instance_norm.launches
        fmap = flow(im1, encode_only=True)
        assert norm.instance_norm.launches == before + 15
        flow(im1, im2, fmap1=fmap, return_features=True)
        assert norm.instance_norm.launches == before + 30
        flow(im1, im2)
        assert norm.instance_norm.launches == before + 45


def test_instance_norm_never_launches_in_training(cuda):
    """A GMA training step (bf16 autocast; autograd records the encoders)
    and an ATDNVO training step launch no K6."""
    from atdn_vslam_torch.config import Config, FlowNetConfig, LossConfig, TrainConfig
    from atdn_vslam_torch.models.factory import build_flow_train_model, init_params
    from atdn_vslam_torch.models.odometry import ATDNVO
    from atdn_vslam_torch.ops import norm
    from atdn_vslam_torch.training import flow as flow_train
    from atdn_vslam_torch.training import odometry as odo_train

    before = norm.instance_norm.launches
    model = init_params(build_flow_train_model(Config(flow=FlowNetConfig(iters=2)), cuda), 5)
    state = flow_train.init_state(model, 1e-4, 20, seed=None)
    im1, im2 = (_conv_like((2, 64, 96, 3), cuda, s).clamp(-3, 3) * 40 + 128 for s in (7, 8))
    flow = torch.zeros((2, 64, 96, 2), device=cuda)
    _, m = flow_train.train_step(state, im1, im2, flow, torch.ones((2, 64, 96), device=cuda))
    assert math.isfinite(float(m["loss"]))
    hw = (72, 96)
    odo = init_params(ATDNVO(hw), 1).to(cuda)
    opt, sched = odo_train.make_optimizer(odo, TrainConfig(), 1)
    g = torch.Generator(device=cuda).manual_seed(9)
    flows = torch.randn((2, 3, *hw, 2), generator=g, device=cuda) * 20.0
    rot, tr = torch.randn((2, 3, 3), generator=g, device=cuda) * 0.02, torch.randn((2, 3, 3), generator=g, device=cuda)
    metrics = odo_train.train_step(odo_train.OdometryTrainState(odo, opt, sched), flows, rot, tr, LossConfig(alpha=0.5))
    assert math.isfinite(float(metrics["loss"]))
    assert norm.instance_norm.launches == before
