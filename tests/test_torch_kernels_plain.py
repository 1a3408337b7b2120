"""The plain PyTorch versions of the port's kernels against the JAX
package, on the CPU: K1 (attention probabilities) against the Pallas
``flash_probs_spatial`` in interpret mode and the XLA path, K2 (the
correlation-window lookup) against ``lookup_corr_pyramid`` and the
Pallas ``lookup_corr_pyramid_pallas`` in interpret mode, plus the
pyramid build and the P @ V read. Inputs are made with numpy from a
seed; everything is float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import attention as jatt
from atdn_vslam_tpu.ops import corr_lookup as jcorr
from atdn_vslam_tpu.ops.bilinear import coords_grid as jcoords_grid
from atdn_vslam_tpu.ops.corr_lookup_pallas import lookup_corr_pyramid_pallas
from tools.convert_torch_checkpoint import _corr_window_perm

from atdn_vslam_torch.convert import corr_window_perm
from atdn_vslam_torch.ops.attention import (
    apply_attention_probs,
    attention_probs_spatial,
    attention_probs_spatial_plain,
)
from atdn_vslam_torch.ops.corr_lookup import (
    build_corr_pyramid,
    lookup_corr_pyramid,
    lookup_corr_pyramid_plain,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("h,w,d", [(7, 9, 16), (4, 33, 32)])
def test_attention_probs_plain_matches_pallas_and_xla(h, w, d):
    """float32 softmax on both sides: the values agree to 1e-6 (float32
    summation order); the pad columns up to the next multiple of 128
    are exactly 0 in both."""
    rng = np.random.default_rng(0)
    n = h * w
    q = rng.normal(size=(1, n, d)).astype(np.float32) * d**-0.5
    k = rng.normal(size=(1, n, d)).astype(np.float32)
    got = attention_probs_spatial_plain(torch.from_numpy(q), torch.from_numpy(k), h, w, 1.0)
    n_pad = -(-n // 128) * 128
    assert got.shape == (1, h, w, n_pad)
    assert float(got[..., n:].abs().max()) == 0.0

    pallas = np.asarray(jatt.flash_probs_spatial(
        jnp.asarray(q), jnp.asarray(k), h, w, scale=1.0, bk=32,
        interpret=True, keep_padded=True,
    ))
    assert pallas.shape == got.shape
    assert float(np.abs(pallas[..., n:]).max()) == 0.0
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)

    xla = np.asarray(jatt.attention_probs_spatial(
        jnp.asarray(q), jnp.asarray(k), h, w, scale=1.0, use_pallas=False
    ))
    np.testing.assert_allclose(got.numpy()[..., :n], xla, rtol=1e-5, atol=1e-6)
    # on a CPU tensor the wrapper is the plain version and counts nothing
    before = attention_probs_spatial.launches
    wrapped = attention_probs_spatial(torch.from_numpy(q), torch.from_numpy(k), h, w, 1.0)
    assert attention_probs_spatial.launches == before
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_attention_probs_default_scale():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 12, 16)).astype(np.float32)
    k = rng.normal(size=(2, 12, 16)).astype(np.float32)
    got = attention_probs_spatial_plain(torch.from_numpy(q), torch.from_numpy(k), 3, 4)
    ref = np.asarray(jatt.attention_probs_spatial(
        jnp.asarray(q), jnp.asarray(k), 3, 4, use_pallas=False
    ))
    np.testing.assert_allclose(got.numpy()[..., :12], ref, rtol=1e-5, atol=1e-6)


def test_apply_attention_probs_on_padded_probs():
    """P @ V with the keep_padded pad columns and v zero-extended:
    equals the JAX einsum path (float32, 1e-5)."""
    rng = np.random.default_rng(2)
    h, w, d = 5, 7, 8
    n = h * w
    probs = rng.uniform(0, 1, (1, h, w, 128)).astype(np.float32)
    probs[..., n:] = 0.0
    v = rng.normal(size=(1, n, d)).astype(np.float32)
    got = apply_attention_probs(torch.from_numpy(probs), torch.from_numpy(v))
    ref = np.asarray(jatt.apply_attention_probs(jnp.asarray(probs), jnp.asarray(v), use_pallas=False))
    assert got.shape == (1, h, w, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_build_corr_pyramid_matches_jax():
    """One matmul per level against pooled features; float32, values of
    size ~1, agreement 1e-5. Odd sizes exercise the pooling crop."""
    rng = np.random.default_rng(3)
    f1 = rng.normal(size=(2, 9, 13, 256)).astype(np.float32)
    f2 = rng.normal(size=(2, 9, 13, 256)).astype(np.float32)
    got = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    ref = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        r = np.asarray(r)[..., 0]
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)


def _pyramid_and_coords(seed, b, h, w, c, levels):
    rng = np.random.default_rng(seed)
    f1 = jnp.asarray(rng.normal(size=(b, h, w, c)).astype(np.float32))
    f2 = jnp.asarray(rng.normal(size=(b, h, w, c)).astype(np.float32))
    pyr = jcorr.build_corr_pyramid(f1, f2, levels)
    base = np.asarray(jcoords_grid(h, w))[None]
    coords = base + rng.normal(scale=3.0, size=(b, h, w, 2)).astype(np.float32)
    # partly outside, wholly outside, on the last row/column, far away
    coords[0, 0, 0] = (-2.5, -1.25)
    coords[0, 0, 1] = (w - 0.5, h + 3.75)
    coords[0, 1, 0] = (-40.0, 3.0)
    coords[0, 1, 1] = (w - 1.0, h - 1.0)
    coords[-1, -1, -1] = (1e4, -1e4)
    return pyr, coords.astype(np.float32)


@pytest.mark.parametrize("radius", [4, 2])
def test_corr_lookup_plain_matches_jax_lookups(radius):
    """The port's window is dx-major, JAX's dy-major: after permuting by
    the converter's ``_corr_window_perm`` the float32 lerp of the same
    taps agrees with the XLA hat-matmul lookup to 1e-5 and with the
    Pallas kernel (interpret mode) to 1e-4, the tolerance the JAX
    package's own test holds these two to."""
    pyr, coords = _pyramid_and_coords(4, 2, 6, 10, 16, 4)
    port_pyr = [torch.from_numpy(np.array(p)[..., 0]) for p in pyr]
    got = lookup_corr_pyramid_plain(port_pyr, torch.from_numpy(coords), radius).numpy()
    span = 2 * radius + 1
    assert got.shape == (2, 6, 10, 4 * span * span)
    perm = _corr_window_perm(4, radius)
    np.testing.assert_array_equal(perm, corr_window_perm(4, radius))
    xla = np.asarray(jcorr.lookup_corr_pyramid(pyr, jnp.asarray(coords), radius))
    np.testing.assert_allclose(got[..., perm], xla, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(lookup_corr_pyramid_pallas(pyr, jnp.asarray(coords), radius, interpret=True))
    # The Pallas kernel clamps a window's first row to the level's last
    # row, which turns the y-lerp weight into an extrapolation for a
    # window lying wholly past the last row (floor(y - r) > H_l - 1):
    # it returns non-zero values there where the XLA lookup and the
    # reference read zeros. Those queries are left out of this one
    # comparison (ROADMAP Queue 3).
    below = np.zeros(coords.shape[:-1], bool)
    for level, p in enumerate(pyr):
        below |= np.floor(coords[..., 1] / 2**level - radius) > p.shape[2] - 1
    np.testing.assert_allclose(got[~below][:, perm], pallas[~below], rtol=1e-4, atol=1e-4)
    # the far-away query reads only zero padding
    assert float(np.abs(got[-1, -1, -1]).max()) == 0.0


def test_corr_lookup_wrapper_on_cpu_is_plain_and_handles_tiny_levels():
    """Levels smaller than a window (down to 0x1 at 8x8 features) read
    zeros, as the JAX lookup does; the CPU wrapper counts no launch."""
    pyr, coords = _pyramid_and_coords(5, 1, 8, 8, 8, 4)
    port_pyr = [torch.from_numpy(np.array(p)[..., 0]) for p in pyr]
    before = lookup_corr_pyramid.launches
    got = lookup_corr_pyramid(port_pyr, torch.from_numpy(coords), 4).numpy()
    assert lookup_corr_pyramid.launches == before
    xla = np.asarray(jcorr.lookup_corr_pyramid(pyr, jnp.asarray(coords), 4))
    np.testing.assert_allclose(got[..., _corr_window_perm(4, 4)], xla, rtol=1e-5, atol=1e-5)


def test_corr_lookup_non_finite_coords_give_nan():
    pyr, coords = _pyramid_and_coords(6, 1, 4, 6, 8, 2)
    coords[0, 2, 3] = (np.nan, 1.0)
    port_pyr = [torch.from_numpy(np.array(p)[..., 0]) for p in pyr]
    got = lookup_corr_pyramid_plain(port_pyr, torch.from_numpy(coords), 4).numpy()
    assert np.isnan(got[0, 2, 3]).all()
    assert np.isfinite(np.delete(got.reshape(-1, got.shape[-1]), 2 * 6 + 3, axis=0)).all()
