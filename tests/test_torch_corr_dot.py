"""Kernel K3's plain version and the pyramid build through it against the
JAX package, on the CPU: ``corr_dot_rowmajor_plain`` against the Pallas
``corr_dot_rowmajor`` in interpret mode, ``build_corr_pyramid(
use_pallas=True)`` against the JAX ``build_corr_pyramid(use_pallas=True,
interpret=True)``. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import corr_lookup as jcorr

from atdn_vslam_torch.ops import corr_lookup as corr

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


def _feats(seed, shape1, shape2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape1).astype(np.float32), rng.normal(size=shape2).astype(np.float32))


@pytest.mark.parametrize("n,m,c", [(96, 96, 64), (37, 418, 32), (130, 45, 256)])
def test_corr_dot_plain_matches_pallas_f32(n, m, c):
    """float32 out, M ragged (418, the width of 2x KITTI's level 2) and
    not a multiple of the blocks; both sum in float32 and scale after:
    1e-5 (summation order)."""
    f1, f2 = _feats(0, (2, n, c), (2, m, c))
    inv = 1.0 / np.sqrt(c)
    want = np.asarray(jcorr.corr_dot_rowmajor(
        jnp.asarray(f1), jnp.asarray(f2), inv, jnp.float32, 64, 128, True
    ))
    got = corr.corr_dot_rowmajor_plain(torch.from_numpy(f1), torch.from_numpy(f2), inv, torch.float32)
    assert got.shape == (2, n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_corr_dot_plain_bf16_out_matches_pallas():
    """bf16 features and bf16 out (the GPU's working type): the float32
    sums of exact products agree to float32 rounding, so the one cast
    gives the same bf16 value or its neighbour: rtol 2^-7."""
    f1, f2 = _feats(1, (1, 60, 64), (1, 77, 64))
    jf1, jf2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    want = np.asarray(jcorr.corr_dot_rowmajor(jf1, jf2, 0.125, jnp.bfloat16, 64, 128, True))
    tf1, tf2 = (torch.from_numpy(x).to(torch.bfloat16) for x in (f1, f2))
    got = corr.corr_dot_rowmajor_plain(tf1, tf2, 0.125, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=2.0**-7, atol=1e-6)


def test_corr_dot_wrapper_on_cpu_is_plain():
    f1, f2 = (torch.from_numpy(x) for x in _feats(2, (1, 20, 16), (1, 30, 16)))
    before = corr.corr_dot_rowmajor.launches
    got = corr.corr_dot_rowmajor(f1, f2, 0.25, torch.float32)
    assert corr.corr_dot_rowmajor.launches == before
    torch.testing.assert_close(got, corr.corr_dot_rowmajor_plain(f1, f2, 0.25, torch.float32), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 8, 12, 64), (2, 9, 13, 256)])
def test_build_corr_pyramid_through_k3_matches_jax(shape, monkeypatch):
    """Every level through K3's plain version against the JAX Pallas
    path (interpret mode), as ``tests/test_ops.py`` holds the JAX paths
    to each other; odd sizes exercise the pooling crop. float32, 1e-5."""
    f1, f2 = _feats(3, shape, shape)
    want = jcorr.build_corr_pyramid(
        jnp.asarray(f1), jnp.asarray(f2), 4, use_pallas=True, interpret=True
    )
    calls = []
    plain = corr.corr_dot_rowmajor_plain

    def spy(*args):
        calls.append(args[1].shape[1])
        return plain(*args)

    monkeypatch.setattr(corr, "corr_dot_rowmajor_plain", spy)
    got = corr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4, use_pallas=True)
    h, w = shape[1:3]
    assert calls == [h * w, (h // 2) * (w // 2), (h // 4) * (w // 4), (h // 8) * (w // 8)]
    assert len(got) == len(want) == 4
    for g, r in zip(got, want):
        r = np.asarray(r)[..., 0]
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)


def test_build_corr_pyramid_paths_agree():
    """use_pallas True (scale after the float32 sum), None and False
    (f1 scaled first, exact for C = 256): the same volumes to 1e-5."""
    f1, f2 = (torch.from_numpy(x) for x in _feats(4, (1, 10, 14, 256), (1, 10, 14, 256)))
    forced = corr.build_corr_pyramid(f1, f2, 4, use_pallas=True)
    for use_pallas in (None, False):
        for a, b in zip(forced, corr.build_corr_pyramid(f1, f2, 4, use_pallas=use_pallas)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
