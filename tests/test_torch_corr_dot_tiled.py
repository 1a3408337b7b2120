"""Kernel K3t's plain version and the pyramid built through it against
their counterpart, the profiling experiment
``tools/profiling/exp_r5_tileddot.py`` (``corr_dot_tiled`` in Pallas
interpret mode, ``build_pyramid_tiled``), and against the JAX package's
``build_corr_pyramid`` (the experiment's own ``eq`` check), on the CPU.

The experiment is a script: on import it sets two JAX configuration
values (the compilation-cache directory and its minimum compile time)
and prepends to ``sys.path``. The fixture loads it and restores all
three, so the other tests of the same worker run as before.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import corr_lookup as jcorr

from atdn_vslam_torch.ops import corr_dot_tiled as tiled

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

EXPERIMENT = pathlib.Path(__file__).resolve().parent.parent / "tools" / "profiling" / "exp_r5_tileddot.py"
_CONFIG = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def exp():
    saved = {name: getattr(jax.config, name) for name in _CONFIG}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location("exp_r5_tileddot", EXPERIMENT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        sys.path[:] = path
    return module


def test_loading_the_experiment_leaves_jax_config_as_it_was(exp):
    assert hasattr(exp, "corr_dot_tiled")
    assert jax.config.jax_persistent_cache_min_compile_time_secs != 1.0


def _feats(seed, n, hl, wl, c):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, n, c)).astype(np.float32),
            rng.normal(size=(1, hl, wl, c)).astype(np.float32))


@pytest.mark.parametrize("n,hl,wl,c", [(70, 5, 9, 32), (37, 11, 13, 64)])
def test_corr_dot_tiled_plain_matches_pallas_f32(exp, n, hl, wl, c):
    """float32 out, N ragged against the 32-query block and Hl against
    the 4-row block; both sum in float32 and scale after: 1e-5."""
    f1, f2 = _feats(0, n, hl, wl, c)
    inv = 1.0 / np.sqrt(c)
    want = np.asarray(exp.corr_dot_tiled(
        jnp.asarray(f1), jnp.asarray(f2), inv, jnp.float32, bm=32, bh=4, interpret=True
    ))
    got = tiled.corr_dot_tiled_plain(torch.from_numpy(f1), torch.from_numpy(f2), inv, torch.float32)
    assert got.shape == want.shape == (1, n, hl, wl) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_corr_dot_tiled_plain_bf16_matches_pallas(exp):
    """bf16 features and bf16 out: both round one float32 sum of exact
    products, so the same bf16 value or its neighbour: rtol 2^-7."""
    f1, f2 = _feats(1, 45, 6, 10, 64)
    want = np.asarray(exp.corr_dot_tiled(
        jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16), 0.125, bm=16, bh=4, interpret=True
    ))
    t1, t2 = (torch.from_numpy(x).to(torch.bfloat16) for x in (f1, f2))
    got = tiled.corr_dot_tiled_plain(t1, t2, 0.125, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=2.0**-7, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 8, 12, 64), (1, 9, 13, 256)])
def test_build_pyramid_tiled_matches_experiment_and_jax(exp, shape):
    """Every level against the experiment's build (interpret mode) and
    the JAX package's ``build_corr_pyramid`` (f1 scaled before the
    product there): float32, 1e-5; odd sizes exercise the pooling crop.
    f2 is handed over as the NHWC view of a channels-first map, the
    layout K3t reads through its strides."""
    rng = np.random.default_rng(2)
    f1 = rng.normal(size=shape).astype(np.float32)
    f2 = rng.normal(size=shape).astype(np.float32)
    ours = tiled.build_pyramid_tiled(
        torch.from_numpy(f1), torch.from_numpy(f2.transpose(0, 3, 1, 2).copy()).permute(0, 2, 3, 1),
        4, torch.float32,
    )
    ref_exp = exp.build_pyramid_tiled(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jnp.float32, interpret=True)
    ref_jax = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jnp.float32)
    h, w = shape[1:3]
    for level, (g, a, b) in enumerate(zip(ours, ref_exp, ref_jax)):
        assert g.shape == (1, h * w, h >> level, w >> level)
        np.testing.assert_allclose(g.numpy(), np.asarray(a)[..., 0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(b)[..., 0], rtol=1e-5, atol=1e-5)


def test_corr_dot_tiled_wrapper_on_cpu_is_plain():
    f1, f2 = (torch.from_numpy(x) for x in _feats(3, 20, 3, 5, 16))
    before = tiled.corr_dot_tiled.launches
    got = tiled.corr_dot_tiled(f1, f2, 0.25, torch.float32)
    assert tiled.corr_dot_tiled.launches == before
    torch.testing.assert_close(got, tiled.corr_dot_tiled_plain(f1, f2, 0.25, torch.float32), rtol=0, atol=0)
