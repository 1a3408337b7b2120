"""Kernel K4's plain version (the P @ V read of the materialised
probabilities) and its gradients against the JAX package on the CPU: the
Pallas ``_flash_apply_probs_impl`` in interpret mode and ``jax.grad``
through the custom VJP of ``flash_apply_probs``. Probabilities are
K1-style ``keep_padded``: (B, H, W, N_pad) with exact-zero pad columns.
Inputs are made with numpy from a seed; float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import attention as jatt

from atdn_vslam_torch.ops import attention as att

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


def _probs_and_values(seed, b, h, w, d, dv):
    """Spatial probabilities of random q, k (K1's plain version: zero
    columns up to a multiple of 128) and values."""
    rng = np.random.default_rng(seed)
    n = h * w
    q = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32) * d**-0.5)
    k = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    probs = att.attention_probs_spatial_plain(q, k, h, w, 1.0)
    v = torch.from_numpy(rng.normal(size=(b, n, dv)).astype(np.float32))
    return probs, v


# H not a multiple of the TPU kernel's 8-row block, N not a multiple of
# its 1024-key block (N_pad 128, 256, 1152)
SHAPES = [(1, 5, 9, 16, 32), (2, 7, 20, 32, 16), (1, 13, 81, 16, 48)]


@pytest.mark.parametrize("b,h,w,d,dv", SHAPES)
def test_flash_apply_probs_plain_matches_pallas(b, h, w, d, dv):
    """Both accumulate exact float32 products over the keys, in another
    order: 1e-5."""
    probs, v = _probs_and_values(0, b, h, w, d, dv)
    assert probs.shape[-1] % 128 == 0 and probs.shape[-1] > h * w
    want = np.asarray(jatt._flash_apply_probs_impl(
        jnp.asarray(probs.numpy()), jnp.asarray(v.numpy()), interpret=True
    ))
    got = att.flash_apply_probs_plain(probs, v)
    assert got.shape == want.shape == (b, h, w, dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the entry point the JAX package reaches it through
    via = att.apply_attention_probs(probs, v, use_pallas=True)
    np.testing.assert_allclose(via.numpy(), want, rtol=1e-5, atol=1e-5)


def test_apply_attention_probs_use_pallas_routes_to_k4(monkeypatch):
    """True takes K4 (once) for spatial probabilities, with v cast to the
    probabilities' type; None and False keep the torch.matmul read,
    and (B, N, N) probabilities never take K4."""
    probs, v = _probs_and_values(1, 1, 6, 7, 16, 16)
    calls = []
    plain = att.flash_apply_probs_plain
    monkeypatch.setattr(att, "flash_apply_probs_plain", lambda p, x: calls.append(x.dtype) or plain(p, x))
    ref = att.apply_attention_probs(probs, v)
    att.apply_attention_probs(probs, v, use_pallas=False)
    flat = probs.reshape(1, 42, -1)[..., :42]
    att.apply_attention_probs(flat, v, use_pallas=True)
    assert calls == []
    got = att.apply_attention_probs(probs.to(torch.float64), v, use_pallas=True)
    assert calls == [torch.float64] and got.dtype == torch.float64
    torch.testing.assert_close(got.float(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,d,dv", SHAPES[:2])
def test_flash_apply_probs_gradients_match_jax(b, h, w, d, dv):
    """dP and dv through the port's autograd.Function against jax.grad
    through the JAX custom VJP (both plain float32 products): 1e-5; the
    gradient of every pad column of P is exactly zero on both sides."""
    probs, v = _probs_and_values(2, b, h, w, d, dv)
    cot = np.random.default_rng(3).normal(size=(b, h, w, dv)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jatt.flash_apply_probs(p, x, 8, 128, True) * cot)

    want_dp, want_dv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(probs.numpy()), jnp.asarray(v.numpy()))
    p_t, v_t = probs.clone().requires_grad_(), v.clone().requires_grad_()
    (att.flash_apply_probs(p_t, v_t) * torch.from_numpy(cot)).sum().backward()
    assert p_t.grad.shape == probs.shape and v_t.grad.shape == v.shape
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_dp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v_t.grad.numpy(), np.asarray(want_dv), rtol=1e-5, atol=1e-5)
    n = h * w
    assert float(p_t.grad[..., n:].abs().max()) == 0.0
    assert float(np.abs(np.asarray(want_dp)[..., n:]).max()) == 0.0


def test_flash_apply_probs_gradient_types():
    """dv comes back in v's type and dP in P's, as in the JAX VJP."""
    probs, v = _probs_and_values(4, 1, 4, 5, 16, 16)
    p_t = probs.to(torch.bfloat16).requires_grad_()
    v_t = v.to(torch.bfloat16).requires_grad_()
    out = att.flash_apply_probs(p_t, v_t)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert p_t.grad.dtype == torch.bfloat16 and v_t.grad.dtype == torch.bfloat16


def test_flash_apply_probs_wrapper_on_cpu_is_plain():
    probs, v = _probs_and_values(5, 1, 3, 11, 16, 32)
    before = att.flash_apply_probs.launches
    got = att.flash_apply_probs(probs, v)
    assert att.flash_apply_probs.launches == before
    torch.testing.assert_close(got, att.flash_apply_probs_plain(probs, v), rtol=0, atol=0)
