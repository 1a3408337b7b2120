"""Kernel K5's plain version and the attention dispatch against the JAX
package, on the CPU: ``flash_attend_plain`` against the Pallas
``flash_attend`` in interpret mode (square, ragged and rectangular),
``attend`` and ``attend_reference`` against the JAX
``attend_reference``, and the flow net's per-pair choice
``gma_attention``. Inputs are made with numpy from a seed; float32
unless a test says otherwise.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import attention as jatt

from atdn_vslam_torch.ops import attention as att

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(seed, nq, nk, d, dv, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, nq, d)).astype(dtype)
    k = rng.normal(size=(1, nk, d)).astype(dtype)
    v = rng.normal(size=(1, nk, dv)).astype(dtype)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("n", [64, 100, 300])
def test_flash_attend_plain_matches_pallas(n):
    """Against the Pallas kernel in interpret mode with 64 x 64 tiles,
    N not always a multiple of the tile; atol 2e-5, the tolerance the
    JAX package's own test holds that kernel to."""
    q, k, v = _qkv(0, n, n, 32, 16)
    want = np.asarray(jatt.flash_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=64, bk=64, interpret=True
    ))
    got = att.flash_attend_plain(*_t(q, k, v))
    assert got.shape == (1, n, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_flash_attend_plain_rectangular_matches_pallas():
    """Nq != Nk (40 queries against 100 keys, 32-row tiles), atol 2e-5."""
    q, k, v = _qkv(1, 40, 100, 32, 16)
    want = np.asarray(jatt.flash_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=32, bk=32, interpret=True
    ))
    np.testing.assert_allclose(att.flash_attend_plain(*_t(q, k, v)).numpy(), want, atol=2e-5)


def test_flash_attend_plain_explicit_scale():
    """GMA passes q pre-scaled and scale 1.0."""
    q, k, v = _qkv(2, 50, 70, 16, 32)
    want = np.asarray(jatt.flash_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=1.0, bq=32, bk=32, interpret=True
    ))
    got = att.flash_attend_plain(*_t(q, k, v), scale=1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_flash_attend_wrapper_on_cpu_is_plain():
    q, k, v = _t(*_qkv(3, 30, 45, 16, 16))
    before = att.flash_attend.launches
    got = att.flash_attend(q, k, v)
    assert att.flash_attend.launches == before
    torch.testing.assert_close(got, att.flash_attend_plain(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_attend_matches_jax_attend_reference(use_pallas):
    """Every branch of the dispatch computes the JAX reference's
    function: float32, 1e-5 (summation order)."""
    q, k, v = _qkv(4, 96, 96, 32, 32)
    want = np.asarray(jatt.attend_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = att.attend(*_t(q, k, v), use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attend_reference_bf16_rounds_like_jax():
    """bf16 q, k, v: both round the float32 softmax to bf16 before the
    product and the float32 result once, so they agree to one bf16 ulp
    of the output (rtol 2^-7, atol 2^-9 for outputs near 0)."""
    q, k, v = _qkv(5, 64, 80, 16, 16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jatt.attend_reference(jq, jk, jv, scale=0.25).astype(jnp.float32))
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = att.attend_reference(tq, tk, tv, scale=0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=2.0**-9)


def test_attend_dispatches_by_token_count(monkeypatch):
    """use_pallas=None takes K5 from _FLASH_MIN_TOKENS queries on and
    the reference below; True always takes K5, False never."""
    calls = []
    monkeypatch.setattr(att, "flash_attend", lambda *a: calls.append("k5") or att.flash_attend_plain(*a))
    monkeypatch.setattr(att, "attend_reference", lambda *a: calls.append("ref") or a[0])
    assert att._MATERIALIZE_MAX_TOKENS == 8192 and att._FLASH_MIN_TOKENS == 16384
    q = torch.zeros((1, 20, 16))
    monkeypatch.setattr(att, "_FLASH_MIN_TOKENS", 21)
    att.attend(q, q, q)
    monkeypatch.setattr(att, "_FLASH_MIN_TOKENS", 20)
    att.attend(q, q, q)
    att.attend(q, q, q, use_pallas=False)
    monkeypatch.setattr(att, "_FLASH_MIN_TOKENS", 21)
    att.attend(q, q, q, use_pallas=True)
    assert calls == ["ref", "k5", "ref", "k5"]


# gma_attention's table at 4 x 5 = 20 tokens, reached by moving the token
# constants: (keyword arguments, materialise limit, flash threshold, the
# plain functions' calls per pair for 3 iterations); "bias" stands for a
# positional bias, "band" for rows [2, 4) on rank 1 of 2
GMA_ITERS = 3
GMA_TABLE = {
    "materialised": ({}, 8192, 16384, {"attention_probs_spatial_plain": 1, "apply_attention_probs": GMA_ITERS}),
    "per_iteration_reference": ({}, 0, 16384, {"attend_reference": GMA_ITERS}),
    "per_iteration_flash": ({}, 0, 20, {"flash_attend_plain": GMA_ITERS}),
    "use_pallas": ({"use_pallas": True}, 8192, 16384, {"flash_attend_plain": GMA_ITERS}),
    "positional_materialised": (
        {"bias": True}, 8192, 16384, {"attention_probs_biased": 1, "apply_attention_probs": GMA_ITERS}
    ),
    "positional_use_pallas": ({"bias": True, "use_pallas": True}, 8192, 16384, {"attend_reference": GMA_ITERS}),
    "positional_above_limit": ({"bias": True}, 19, 16384, None),
    "band_materialised": (
        {"band": True}, 8192, 16384, {"attention_probs_spatial_plain": 1, "apply_attention_probs": GMA_ITERS}
    ),
    "band_flash": ({"band": True}, 0, 20, {"flash_attend_plain": GMA_ITERS}),
    "band_reference": ({"band": True}, 0, 16384, {"attend_reference": GMA_ITERS}),
}


@pytest.mark.parametrize("case", list(GMA_TABLE))
def test_gma_attention_table(monkeypatch, case):
    """Which plain function computes each outcome of ``gma_attention``,
    how often per frame pair, and that every outcome gives the attention
    of ``attend_reference`` (the band its rows of it)."""
    kwargs, materialise, flash, want_calls = GMA_TABLE[case]
    h, w, d = 4, 5, 16
    q, k, v = _t(*_qkv(7, h * w, h * w, d, d))
    bias = torch.from_numpy(np.random.default_rng(8).normal(size=(1, h * w, h * w)).astype(np.float32))
    bias = bias if kwargs.get("bias") else None
    want = att.attend_reference(q, k, v, 1.0, bias)
    monkeypatch.setattr(att, "_MATERIALIZE_MAX_TOKENS", materialise)
    monkeypatch.setattr(att, "_FLASH_MIN_TOKENS", flash)
    calls = {}
    for name in ("attention_probs_spatial_plain", "attention_probs_biased", "apply_attention_probs",
                 "attend_reference", "flash_attend_plain"):
        def counted(*args, _fn=getattr(att, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)

        monkeypatch.setattr(att, name, counted)
    rows = slice(0, h)
    extra = {"use_pallas": kwargs.get("use_pallas")}
    if kwargs.get("band"):  # rank 1 of a two-rank model axis
        monkeypatch.setattr(att, "group_size", lambda group: 2)
        monkeypatch.setattr(att, "group_rank", lambda group: 1)
        rows = slice(2, 4)
        extra.update(band=(2, 4), mesh=types.SimpleNamespace(group=lambda axis: axis))
    if want_calls is None:
        with pytest.raises(ValueError, match="limit 19"):
            att.gma_attention(q, k, bias, h, w, **extra)
        assert calls == {}
        return
    attn = att.gma_attention(q, k, bias, h, w, **extra)
    for _ in range(GMA_ITERS):
        out = attn(v)
    assert calls == want_calls
    want = want.reshape(1, h, w, d)[:, rows]
    torch.testing.assert_close(out.reshape(want.shape), want)


@pytest.mark.parametrize("dv", [1, 2, 3, 4])
def test_flash_attend_takes_narrow_float32_values(dv):
    """float32 values 1 to 4 wide go to K5's narrow kernel; on the CPU the
    wrapper is the plain version, whose columns equal those of the same
    values zero-extended to 16 (the width K5 took before)."""
    assert att._flash_is_narrow(torch.float32, 128, dv)
    q, k, v = _t(*_qkv(7, 70, 300, 32, dv))
    got = att.flash_attend(q, k, v)
    wide = att.flash_attend_plain(q, k, torch.nn.functional.pad(v, (0, 16 - dv)))
    torch.testing.assert_close(got, wide[..., :dv], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,d,dv,narrow", [
    (torch.float32, 128, 16, False), (torch.float32, 16, 128, False), (torch.bfloat16, 128, 128, False),
    (torch.float32, 128, 5, None), (torch.float32, 128, 8, None), (torch.float32, 128, 0, None),
    (torch.bfloat16, 128, 2, None), (torch.float32, 24, 2, None), (torch.float32, 144, 16, None),
])
def test_flash_attend_widths(dtype, d, dv, narrow):
    """The widths K5's kernels take: D and Dv multiples of 16 in [16, 128]
    (the wide kernels), or float32 Dv of 1 to 4 (the narrow kernel);
    anything else raises before a launch."""
    if narrow is None:
        with pytest.raises(ValueError):
            att._flash_is_narrow(dtype, d, dv)
    else:
        assert att._flash_is_narrow(dtype, d, dv) is narrow


@pytest.mark.parametrize("b,nq,nk,sms", [(1, 7392, 7392, 132), (2, 777, 1100, 132), (1, 300, 129, 132),
                                         (1, 1, 1, 132), (1, 100_000, 200, 132), (3, 28952, 28952, 114)])
def test_narrow_parts(b, nq, nk, sms):
    """The key split of the narrow kernel: every part holds a 128-key tile;
    GMFlow's KITTI calls (7,392 tokens, 58 row blocks and 58 key tiles)
    take 9 parts on the H100's 132 SMs, 522 blocks: 2 or more per SM."""
    parts = att._narrow_parts(b, nq, nk, sms)
    assert 1 <= parts <= -(-nk // 128)
    if (b, nq, nk, sms) == (1, 7392, 7392, 132):
        assert parts == 9 and 58 * parts >= 2 * sms
