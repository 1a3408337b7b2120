"""Kernel K1's bf16 design on the CPU: the key split of its statistics
pass (``_probs_splits``) and the plain version of its split statistics
and their merge (``attention_probs_split_plain``) against the JAX
package's Pallas ``flash_probs_spatial`` in interpret mode. Inputs are
made with numpy from a seed; float32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import attention as jatt

from atdn_vslam_torch.ops import attention as att

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("b,n,n_kv,sms", [
    (1, 7238, 7238, 132),    # KITTI: 57 query tiles x 4 splits
    (1, 28952, 28952, 132),  # 2x KITTI: 227 query tiles, one split
    (2, 100, 1, 132),        # one key: one split
    (1, 300, 1000, 132),     # fewer key tiles (8) than the grid could take
    (3, 129, 1152, 7),
])
def test_probs_splits_cover_every_key_tile_once(b, n, n_kv, sms):
    """The statistics pass's key split: every 128-key tile lands in
    exactly one split, in order, no split is empty, and the grid stays
    within two blocks per SM unless one split already exceeds it."""
    splits = att._probs_splits(b, n, n_kv, sms)
    tiles = -(-n_kv // 128)
    q_blocks = b * -(-n // 128)
    assert 1 <= splits <= tiles
    assert q_blocks * splits <= max(2 * sms, q_blocks)
    ranges = [(s * tiles // splits, (s + 1) * tiles // splits) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
    if (b, n, n_kv) == (1, 7238, 7238):
        assert splits == 4


@functools.lru_cache(maxsize=None)
def _inputs_and_pallas(h, w, d):
    rng = np.random.default_rng(7)
    n = h * w
    q = rng.normal(size=(1, n, d)).astype(np.float32) * d**-0.5
    k = rng.normal(size=(1, n, d)).astype(np.float32)
    pallas = np.asarray(jatt.flash_probs_spatial(
        jnp.asarray(q), jnp.asarray(k), h, w, scale=1.0, bk=32, interpret=True, keep_padded=True,
    ))
    return q, k, pallas


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("h,w,d", [(7, 9, 16), (13, 30, 32)])
def test_attention_probs_split_plain_matches_pallas(h, w, d, splits):
    """The split statistics and their merge give the JAX kernel's
    probabilities to 1e-5 (float32 summation order, 2^x against e^x),
    with exact-zero pad columns, for one split and for several, among
    them splits with no key (63 keys are one tile: 2, 3 and 7 splits
    leave 1, 2 and 6 empty; 390 keys are four tiles: 7 splits leave 3)."""
    q, k, pallas = _inputs_and_pallas(h, w, d)
    n = h * w
    got = att.attention_probs_split_plain(torch.from_numpy(q), torch.from_numpy(k), h, w, 1.0, splits)
    assert got.shape == pallas.shape == (1, h, w, -(-n // 128) * 128)
    assert float(got[..., n:].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)
    plain = att.attention_probs_spatial_plain(torch.from_numpy(q), torch.from_numpy(k), h, w, 1.0)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
