"""Kernel K2s's plain version (the lookup over a row-padded pyramid)
against the JAX package on the CPU: ``pad_pyramid_for_slab`` and the
Pallas ``lookup_corr_pyramid_slab`` in interpret mode, and against the
port's own K2 plain lookup on the unpadded pyramid. The JAX window is
dy-major and the port's dx-major, so windows are compared through
``corr_window_perm`` at radius 2 and 4. Inputs are made with numpy from
a seed; float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import corr_lookup as jcorr
from atdn_vslam_tpu.ops import corr_lookup_slab as jslab

from atdn_vslam_torch.convert import corr_window_perm
from atdn_vslam_torch.ops import corr_lookup as corr
from atdn_vslam_torch.ops import corr_lookup_slab as slab

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


def _pyramids(seed, h, w, c=32):
    """The same float32 pyramid from both packages (JAX levels keep
    their trailing unit axis)."""
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(1, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(1, h, w, c)).astype(np.float32)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jnp.float32)
    tp = [torch.from_numpy(np.array(x)[..., 0]) for x in jp]
    return jp, tp


def _coords(seed, h, w, margin):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-margin, w + margin, (1, h, w)),
                   rng.uniform(-margin, h + margin, (1, h, w))], -1)
    xy[0, 0, :3] = [(-300.0, 5.0), (2.0, 1e4), (w + 0.5, -70.25)]
    return xy.astype(np.float32)


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("h", [5, 24, 25, 30, 47])
def test_pad_pyramid_for_slab_rows_match_jax(radius, h):
    """Levels of up to 24 rows stay as they are, taller ones are padded
    with zero rows to the JAX package's count (30 -> 32 at radius 4)."""
    vol = np.random.default_rng(0).normal(size=(1, 6, h, 3, 1)).astype(np.float32)
    want, want_rows = jslab.pad_pyramid_for_slab([jnp.asarray(vol)], radius)
    got, got_rows = slab.pad_pyramid_for_slab([torch.from_numpy(vol[..., 0])], radius)
    assert got_rows == want_rows == (h,)
    assert tuple(got[0].shape) == np.asarray(want[0]).shape[:-1]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0])[..., 0])
    if h > 24:
        assert got[0].shape[2] > h and float(got[0][:, :, h:].abs().max()) == 0.0


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("padded_once", [True, False])
def test_slab_lookup_plain_matches_pallas(radius, padded_once):
    """A 30 x 17 map (a 30-row level 0, padded; 510 queries, not a
    multiple of the 16-query block, which the JAX function snaps down),
    coordinates inside, partly and far outside; the pyramid padded once
    with ``orig_rows`` passed on, or padded inside the call. Both
    contract rows then columns in float32, the same two products per
    sum: 1e-5 (multiply-add contraction in XLA)."""
    h, w = 30, 17
    jp, tp = _pyramids(1, h, w)
    coords = _coords(2, h, w, 8.0)
    if padded_once:
        jpad, rows = jslab.pad_pyramid_for_slab(jp, radius)
        want = jslab.lookup_corr_pyramid_slab(jpad, jnp.asarray(coords), radius, orig_rows=rows, interpret=True)
        tpad, trows = slab.pad_pyramid_for_slab(tp, radius)
        assert trows == rows
        got = slab.lookup_corr_pyramid_slab_plain(tpad, torch.from_numpy(coords), radius, orig_rows=trows)
    else:
        want = jslab.lookup_corr_pyramid_slab(jp, jnp.asarray(coords), radius, interpret=True)
        got = slab.lookup_corr_pyramid_slab_plain(tp, torch.from_numpy(coords), radius)
    want = np.asarray(want)
    assert got.shape == want.shape == (1, h, w, 4 * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), want[..., corr_window_perm(4, radius)], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("radius", [2, 4])
def test_slab_lookup_plain_matches_k2_plain(radius):
    """The same function as the port's K2 on the unpadded pyramid; K2
    lerps columns first, K2s contracts rows first: 1e-5 (float32 order)."""
    h, w = 27, 11
    _, tp = _pyramids(3, h, w)
    coords = torch.from_numpy(_coords(4, h, w, 6.0))
    coords[0, 2, 3, 1] = float("nan")  # both give a NaN window
    want = corr.lookup_corr_pyramid_plain(tp, coords, radius)
    padded, rows = slab.pad_pyramid_for_slab(tp, radius)
    got = slab.lookup_corr_pyramid_slab_plain(padded, coords, radius, orig_rows=rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert bool(got[0, 2, 3].isnan().all())


def test_slab_wrapper_on_cpu_is_plain():
    _, tp = _pyramids(5, 9, 10)
    padded, rows = slab.pad_pyramid_for_slab(tp)
    coords = torch.from_numpy(_coords(6, 9, 10, 3.0))
    before = slab.lookup_corr_pyramid_slab.launches
    got = slab.lookup_corr_pyramid_slab(padded, coords, 4, q_blk=7, orig_rows=rows)
    assert slab.lookup_corr_pyramid_slab.launches == before
    want = slab.lookup_corr_pyramid_slab_plain(padded, coords, 4, orig_rows=rows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_slab_non_finite_coordinates_against_jax():
    """A deliberate difference (ROADMAP Queue 3): for an infinite
    coordinate the JAX Pallas ``lookup_corr_pyramid_slab`` (interpret
    mode) gives a zero window, the port a NaN one, as the port's K2 does;
    a NaN coordinate gives NaN in both; finite queries agree (1e-5)."""
    h, w = 12, 11
    jp, tp = _pyramids(12, h, w)
    coords = _coords(13, h, w, 2.0).astype(np.float32)
    coords[0, 1, 2] = (np.nan, 3.0)
    coords[0, 1, 3] = (np.inf, 3.0)
    coords[0, 1, 4] = (2.0, -np.inf)
    jpad, rows = jslab.pad_pyramid_for_slab(jp, 4)
    want = np.asarray(jslab.lookup_corr_pyramid_slab(jpad, jnp.asarray(coords), 4, orig_rows=rows, interpret=True))
    padded, trows = slab.pad_pyramid_for_slab(tp, 4)
    got = slab.lookup_corr_pyramid_slab_plain(padded, torch.from_numpy(coords), 4, orig_rows=trows).numpy()
    assert np.isnan(want[0, 1, 2]).all() and np.isnan(got[0, 1, 2]).all()
    assert (want[0, 1, 3:5] == 0).all() and np.isnan(got[0, 1, 3:5]).all()
    finite = np.isfinite(coords[0]).all(-1)
    np.testing.assert_allclose(got[0][finite], want[0][finite][:, corr_window_perm(4, 4)], rtol=1e-5, atol=1e-5)
