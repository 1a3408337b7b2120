"""The n-in-lanes pyramid and lookup (kernel K2n's plain version) and
``RAFTGMA(corr_nlanes=True)`` against the JAX package on the CPU: the
Pallas ``nlanes_lookup_level`` in interpret mode, its pyramid build and
lookup, and the JAX flow net with ``corr_nlanes=True`` on weights
carried by ``atdn_vslam_torch.convert``. Inputs are made with numpy from
a seed. The JAX window is dy-major and the port's dx-major, so every
comparison of windows permutes with ``corr_window_perm`` (at radius 0
the two orders agree, so the radii tested are 2 and 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.ops import corr_lookup_nlanes as jnl

from atdn_vslam_torch.config import Config, FlowNetConfig
from atdn_vslam_torch.convert import corr_window_perm, gma_state_dict_from_jax
from atdn_vslam_torch.models.factory import build_flow_model
from atdn_vslam_torch.ops import corr_lookup_nlanes as nl

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _maps(seed, h, w, c=32, batch=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, h, w, c)).astype(np.float32),
            rng.normal(size=(batch, h, w, c)).astype(np.float32))


def _coords(seed, batch, h, w, lo, hi):
    """(x, y) uniform in [lo, hi + w) x [lo, hi + h), and a few far out."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(lo, w + hi, (batch, h, w)), rng.uniform(lo, h + hi, (batch, h, w))], -1)
    xy[0, 0, :3] = [(-300.0, 5.0), (2.0, 1e4), (-50.5, -70.25)]
    return xy.astype(np.float32)


@pytest.mark.parametrize("batch,h,w,c", [(1, 8, 12, 32), (2, 9, 13, 64)])
def test_build_corr_pyramid_nlanes_matches_jax(batch, h, w, c):
    """Level 0 (B, N, H0, W0), levels 1-3 (B, Hl, Wl, N); odd sizes
    exercise the pooling crop. float32 on both sides, 1e-5."""
    f1, f2 = _maps(0, h, w, c, batch)
    want = jnl.build_corr_pyramid_nlanes(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jnp.float32)
    got = nl.build_corr_pyramid_nlanes(torch.from_numpy(f1), torch.from_numpy(f2), 4, torch.float32)
    assert len(got) == 4
    assert np.asarray(want[0]).shape == tuple(got[0].shape) + (1,)
    for level, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r)
        if level == 0:
            r = r[..., 0]
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("h,w", [(10, 13), (23, 25)])
def test_nlanes_lookup_level_plain_matches_jax(radius, level, h, w):
    """One level, 130 and 575 queries (neither a multiple of the TPU
    kernel's 512-query block), coordinates inside, partly and far
    outside the level. float32: both sum the same two products per row
    and per column, 1e-5 (multiply-add contraction in XLA)."""
    f1, f2 = _maps(1, h, w)
    pyr = jnl.build_corr_pyramid_nlanes(jnp.asarray(f1), jnp.asarray(f2), 3, dtype=jnp.float32)
    coords = _coords(2, 1, h, w, -8.0, 8.0).reshape(1, h * w, 2)
    want = np.asarray(jnl.nlanes_lookup_level(pyr[level], jnp.asarray(coords), level, radius, interpret=True))
    got = nl.nlanes_lookup_level_plain(
        torch.from_numpy(np.array(pyr[level])), torch.from_numpy(coords), level, radius
    )
    assert got.shape == want.shape == (1, h * w, (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), want[..., corr_window_perm(1, radius)], rtol=1e-5, atol=1e-5)


def test_nlanes_lookup_level_plain_bf16_rounding_matches_jax():
    """bf16 volumes: hat weights and row sums rounded through bf16 as
    the TPU kernel rounds them. Every product of two bf16 values is exact
    in float32 and each sum has two non-zero terms, so both round the
    same float32 sums: equal bit for bit."""
    h, w = 12, 17
    f1, f2 = _maps(3, h, w)
    pyr = jnl.build_corr_pyramid_nlanes(jnp.asarray(f1), jnp.asarray(f2), 3, dtype=jnp.bfloat16)
    coords = _coords(4, 1, h, w, -4.0, 4.0).reshape(1, h * w, 2)
    for level in (1, 2):
        want = np.asarray(jnl.nlanes_lookup_level(pyr[level], jnp.asarray(coords), level, 4, interpret=True))
        vol = torch.from_numpy(np.asarray(pyr[level], np.float32)).to(torch.bfloat16)
        got = nl.nlanes_lookup_level_plain(vol, torch.from_numpy(coords), level, 4)
        np.testing.assert_array_equal(got.numpy(), want[..., corr_window_perm(1, 4)])


def test_nlanes_lookup_level_plain_degenerate_level():
    """A level pooled to no rows gives zero windows, as in JAX."""
    coords = _coords(5, 1, 3, 4, 0.0, 0.0).reshape(1, 12, 2)
    vol = np.zeros((1, 0, 2, 12), np.float32)
    want = np.asarray(jnl.nlanes_lookup_level(jnp.asarray(vol), jnp.asarray(coords), 4, 4, interpret=True))
    got = nl.nlanes_lookup_level_plain(torch.from_numpy(vol), torch.from_numpy(coords), 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(np.abs(want).max()) == 0.0


def test_nlanes_lookup_level_plain_non_finite_gives_nan():
    """A non-finite coordinate gives a NaN window, as the port's K2 does."""
    f1, f2 = _maps(6, 6, 8)
    pyr = nl.build_corr_pyramid_nlanes(torch.from_numpy(f1), torch.from_numpy(f2), 2)
    coords = torch.from_numpy(_coords(7, 1, 6, 8, 0.0, 0.0).reshape(1, 48, 2))
    coords[0, 5, 0] = float("nan")
    coords[0, 9, 1] = float("inf")
    got = nl.nlanes_lookup_level_plain(pyr[1], coords, 1, 4)
    assert bool(got[0, 5].isnan().all()) and bool(got[0, 9].isnan().all())
    assert bool(got[0, :5].isfinite().all())


@pytest.mark.parametrize("radius", [2, 4])
def test_lookup_corr_pyramid_nlanes_matches_jax(radius):
    """Four levels, batch 2: level 0 through K2's plain version, levels
    1-3 through K2n's, against the JAX lookup after the dy -> dx
    permutation. float32, 1e-5."""
    h, w = 11, 14
    f1, f2 = _maps(8, h, w, 32, 2)
    jp = jnl.build_corr_pyramid_nlanes(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jnp.float32)
    tp = nl.build_corr_pyramid_nlanes(torch.from_numpy(f1), torch.from_numpy(f2), 4, torch.float32)
    coords = _coords(9, 2, h, w, -6.0, 6.0)
    want = np.asarray(jnl.lookup_corr_pyramid_nlanes(jp, jnp.asarray(coords), radius, interpret=True))
    got = nl.lookup_corr_pyramid_nlanes(tp, torch.from_numpy(coords), radius)
    assert got.shape == want.shape == (2, h, w, 4 * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), want[..., corr_window_perm(4, radius)], rtol=1e-5, atol=1e-5)


def test_nlanes_levels_wrapper_on_cpu_is_plain():
    f1, f2 = _maps(10, 8, 10)
    pyr = nl.build_corr_pyramid_nlanes(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    coords = torch.from_numpy(_coords(11, 1, 8, 10, -2.0, 2.0).reshape(1, 80, 2))
    before = nl.nlanes_lookup_levels.launches
    got = nl.nlanes_lookup_levels(pyr[1:], coords, 1, 4)
    assert nl.nlanes_lookup_levels.launches == before
    want = torch.cat([nl.nlanes_lookup_level_plain(v, coords, i + 1, 4) for i, v in enumerate(pyr[1:])], -1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


H, W, ITERS = 64, 96, 2
# float32 on both sides over ITERS recurrent updates, as test_torch_models
FLOW_TOL = {"rtol": 1e-4, "atol": 2e-4}


@pytest.fixture(scope="module")
def nlanes_nets():
    """The JAX flow net with corr_nlanes=True and the port's, on the
    same weights (GMA's gamma non-zero so the attention reaches the
    output), and the frames."""
    model = JRAFTGMA(iters=ITERS, use_pallas=False, corr_nlanes=True)
    rng = np.random.default_rng(12)
    base = rng.uniform(0, 255, (1, H + 8, W + 8, 3)).astype(np.float32)
    im1, im2 = base[:, :H, :W], base[:, 3 : H + 3, 5 : W + 5]
    variables = jax.tree.map(
        lambda x: np.array(x, np.float32), model.init(jax.random.key(0), jnp.asarray(im1), jnp.asarray(im2))
    )
    variables["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array([0.7], np.float32)
    cfg = Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False))
    port = build_flow_model(cfg, "cpu", corr_nlanes=True)
    port.load_state_dict(gma_state_dict_from_jax(variables))
    return model, variables, port, im1, im2


def test_raftgma_corr_nlanes_matches_jax(nlanes_nets, monkeypatch):
    """Port RAFTGMA(corr_nlanes=True) against JAX RAFTGMA(corr_nlanes=True)
    at 64x96 (four levels down to 1x1), 2 iterations; the port's lookup
    runs K2 once and K2n once per iteration."""
    model, variables, port, im1, im2 = nlanes_nets
    want_low, want_up = jax.tree.map(
        np.asarray, model.apply(variables, jnp.asarray(im1), jnp.asarray(im2), test_mode=True)
    )
    calls = []
    plain = nl.nlanes_lookup_level_plain
    monkeypatch.setattr(nl, "nlanes_lookup_level_plain", lambda *a: calls.append(a[2]) or plain(*a))
    with torch.no_grad():
        got_low, got_up = port(torch.from_numpy(im1), torch.from_numpy(im2))
    assert calls == [1, 2, 3] * ITERS
    assert float(np.abs(want_low).max()) > 0.05  # the update loop moved the flow
    np.testing.assert_allclose(got_low.numpy(), want_low, **FLOW_TOL)
    np.testing.assert_allclose(got_up.numpy(), want_up, **FLOW_TOL)


def test_raftgma_corr_nlanes_matches_default_build(nlanes_nets):
    """The port's nlanes flow net against its default one on the same
    weights: in float32 the two lookups differ only in summation order,
    atol 1e-4 as the JAX package's own test (test_corr_nlanes.py:129-134)."""
    _, _, port, im1, im2 = nlanes_nets
    default = build_flow_model(Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False)), "cpu")
    default.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(im1), torch.from_numpy(im2))
        want = default(torch.from_numpy(im1), torch.from_numpy(im2))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


def test_nlanes_non_finite_coordinates_against_jax():
    """A deliberate difference (ROADMAP Queue 3): for an infinite
    coordinate the JAX Pallas ``nlanes_lookup_level`` (interpret mode)
    gives a zero window, the port a NaN one, as the port's K2 does; a NaN
    coordinate gives NaN in both, and the finite queries beside them
    agree (1e-5)."""
    h, w = 10, 13
    f1, f2 = _maps(10, h, w)
    pyr = jnl.build_corr_pyramid_nlanes(jnp.asarray(f1), jnp.asarray(f2), 3, dtype=jnp.float32)
    coords = _coords(11, 1, h, w, -2.0, 2.0).reshape(1, h * w, 2)
    coords[0, 4] = (np.nan, 3.0)
    coords[0, 5] = (np.inf, 3.0)
    coords[0, 6] = (2.0, -np.inf)
    want = np.asarray(jnl.nlanes_lookup_level(pyr[1], jnp.asarray(coords), 1, 4, interpret=True))
    got = nl.nlanes_lookup_level_plain(torch.from_numpy(np.array(pyr[1])), torch.from_numpy(coords), 1, 4).numpy()
    assert np.isnan(want[0, 4]).all() and np.isnan(got[0, 4]).all()
    assert (want[0, 5:7] == 0).all() and np.isnan(got[0, 5:7]).all()
    finite = np.isfinite(coords[0]).all(-1)
    np.testing.assert_allclose(got[0, finite], want[0, finite][:, corr_window_perm(1, 4)], rtol=1e-5, atol=1e-5)
