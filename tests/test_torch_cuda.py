"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU, at small ragged shapes. Marked ``cuda``; each test skips when no
CUDA device is present. On the GPU machine (which has no JAX, so the
JAX test conftest is left out):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from atdn_vslam_torch.ops.attention import (
    attention_probs_spatial,
    attention_probs_spatial_plain,
)
from atdn_vslam_torch.ops.corr_lookup import (
    build_corr_pyramid,
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
@pytest.mark.parametrize("h,w,d,n_kv", [(7, 9, 16, 63), (5, 13, 32, 200), (8, 16, 128, 128)])
def test_attention_probs_kernel(cuda, dtype, h, w, d, n_kv):
    """f32: same float32 softmax up to summation order and the fast
    exp (rtol 1e-5); bf16: both round a float32 softmax, one bf16 ulp
    (rtol 2^-7). Pad columns are exact zeros, launches are counted."""
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


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 6, 24), device=cuda)
    with pytest.raises(ValueError):
        attention_probs_spatial(q, q, 2, 3)
    pyr = [torch.zeros((1, 6, 2, 3), device=cuda)]
    with pytest.raises(ValueError):
        lookup_corr_pyramid(pyr, torch.zeros((1, 2, 3, 2), device=cuda), radius=3)
