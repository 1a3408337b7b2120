"""The backward passes of kernels K1, K2 and K3 against ``jax.vjp`` of the
JAX package's functions on the CPU, float32, inputs made with numpy from
a seed.

Each port backward is reached twice: through its ``autograd.Function``
on CPU tensors (the forward is then the kernel's plain version and the
backward the code that runs on the GPU), and, for K1 and K2, through the
public wrapper, which on the CPU is the plain version differentiated by
autograd. The JAX side: K1 ``flash_probs_spatial`` and K3
``corr_dot_rowmajor`` in interpret mode (their custom VJPs), K2 the
default ``lookup_corr_pyramid``, which XLA differentiates. The JAX
window is dy-major and the port's dx-major: cotangents are permuted with
``corr_window_perm``.

Bounds: 1e-5 absolute on outputs of order 0.1-10 (float32 products in
another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.ops import attention as jatt
from atdn_vslam_tpu.ops import corr_lookup as jcorr

from atdn_vslam_torch.convert import corr_window_perm
from atdn_vslam_torch.ops import attention as att
from atdn_vslam_torch.ops import corr_lookup as corr

torch.set_num_threads(1)

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("keep_padded", [False, True])
def test_k1_backward_matches_jax_vjp(keep_padded):
    """dq, dk of softmax(scale q k^T) for a cotangent on every output
    entry, pad rows and columns included (the backward must drop them)."""
    rng = np.random.default_rng(0)
    h, w, d, scale = 5, 6, 16, 0.7
    n = h * w
    q = rng.normal(size=(2, n, d)).astype(np.float32)
    k = rng.normal(size=(2, n, d)).astype(np.float32)
    p, vjp = jax.vjp(
        lambda q, k: jatt.flash_probs_spatial(q, k, h, w, scale, 16, True, keep_padded),
        jnp.asarray(q), jnp.asarray(k),
    )
    ct = rng.normal(size=p.shape).astype(np.float32)
    want_dq, want_dk = (np.asarray(g) for g in vjp(jnp.asarray(ct)))

    n_pad = -(-n // 128) * 128
    ct_port = rng.normal(size=(2, h, w, n_pad)).astype(np.float32)
    ct_port[..., : ct.shape[-1]] = ct[:, :h, :, : n_pad]
    for route in ("function", "wrapper"):
        qt, kt = _t(q).requires_grad_(), _t(k).requires_grad_()
        if route == "function":
            out = att._AttentionProbs.apply(qt, kt, h, w, scale)
        else:
            out = att.attention_probs_spatial(qt, kt, h, w, scale)
        assert out.shape == (2, h, w, n_pad)
        out.backward(_t(ct_port))
        np.testing.assert_allclose(qt.grad.numpy(), want_dq, **TOL, err_msg=route)
        np.testing.assert_allclose(kt.grad.numpy(), want_dk, **TOL, err_msg=route)


def test_k1_backward_formula_matches_autograd_of_plain():
    """:func:`attention_probs_backward` is the VJP of the plain version,
    bf16 inputs giving bf16 gradients as JAX casts them."""
    rng = np.random.default_rng(1)
    h, w, d = 4, 7, 32
    q = _t(rng.normal(size=(1, h * w, d)).astype(np.float32)).requires_grad_()
    k = _t(rng.normal(size=(1, h * w, d)).astype(np.float32)).requires_grad_()
    p = att.attention_probs_spatial_plain(q, k, h, w, 1.0)
    dp = _t(rng.normal(size=p.shape).astype(np.float32))
    p.backward(dp)
    dq, dk = att.attention_probs_backward(q.detach(), k.detach(), p.detach(), dp, 1.0)
    np.testing.assert_allclose(dq.numpy(), q.grad.numpy(), **TOL)
    np.testing.assert_allclose(dk.numpy(), k.grad.numpy(), **TOL)
    qb, kb = q.detach().bfloat16(), k.detach().bfloat16()
    pb = att.attention_probs_spatial_plain(qb, kb, h, w, 1.0)
    dqb, dkb = att.attention_probs_backward(qb, kb, pb, dp.bfloat16(), 1.0)
    assert dqb.dtype == dkb.dtype == torch.bfloat16


def _pyramid_case(seed, batch, h, w, c=32):
    """Feature maps, the JAX pyramid (float32) and coordinates inside,
    partly outside and wholly outside the levels."""
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(batch, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(batch, h, w, c)).astype(np.float32)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jnp.float32)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    coords = np.stack([xs, ys], -1)[None] + rng.normal(scale=4.0, size=(batch, h, w, 2))
    coords[0, 0, :4] = [(-7.5, 2.25), (w + 3.5, h - 1.0), (-300.0, 40.0), (3.0, h + 9.75)]
    return jp, coords.astype(np.float32)


@pytest.mark.parametrize("batch,h,w", [(1, 10, 14), (2, 9, 13)])
def test_k2_pyramid_cotangent_matches_jax_vjp(batch, h, w):
    """Every level's cotangent, radius 4, four levels (odd sizes crop in
    the pooling; 9 x 13 pools to 1 x 1), coordinates leaving the level."""
    radius = 4
    jp, coords = _pyramid_case(2, batch, h, w)
    out, vjp = jax.vjp(lambda *levels: jcorr.lookup_corr_pyramid(list(levels), jnp.asarray(coords), radius), *jp)
    ct = np.random.default_rng(3).normal(size=out.shape).astype(np.float32)
    want = [np.asarray(g)[..., 0] for g in vjp(jnp.asarray(ct))]
    ct_port = _t(ct[..., corr_window_perm(4, radius)])
    for route in ("function", "wrapper"):
        levels = [_t(np.asarray(p)[..., 0]).requires_grad_() for p in jp]
        if route == "function":
            got = corr._LookupCorrPyramid.apply(_t(coords), radius, *levels)
        else:
            got = corr.lookup_corr_pyramid(levels, _t(coords), radius)
        np.testing.assert_allclose(
            got.detach().numpy(), np.asarray(out)[..., corr_window_perm(4, radius)], **TOL, err_msg=route
        )
        got.backward(ct_port)
        for level, (lv, wl) in enumerate(zip(levels, want)):
            assert lv.grad.shape == wl.shape
            np.testing.assert_allclose(lv.grad.numpy(), wl, **TOL, err_msg=f"{route} level {level}")


def test_k2_backward_matches_autograd_of_plain_at_large_coordinates():
    """At a KITTI-wide level, where c + a - r crosses 128 and JAX's hat
    weights round: the Function's backward is the transpose of the
    port's forward (K2's exact lerp weights), 1e-6 of the largest entry."""
    rng = np.random.default_rng(7)
    f1 = _t(rng.normal(size=(1, 12, 150, 32)).astype(np.float32))
    f2 = _t(rng.normal(size=(1, 12, 150, 32)).astype(np.float32))
    pyramid = corr.build_corr_pyramid(f1, f2, 4)
    xs = np.linspace(118.0, 136.0, 12 * 150, dtype=np.float32).reshape(1, 12, 150)
    ys = rng.uniform(-2.0, 13.0, size=(1, 12, 150)).astype(np.float32)
    coords = _t(np.stack([xs, ys], -1))
    ct = _t(rng.normal(size=(1, 12, 150, 4 * 81)).astype(np.float32))
    a = [v.clone().requires_grad_() for v in pyramid]
    corr._LookupCorrPyramid.apply(coords, 4, *a).backward(ct)
    b = [v.clone().requires_grad_() for v in pyramid]
    corr.lookup_corr_pyramid_plain(b, coords, 4).backward(ct)
    for x, y in zip(a, b):
        scale = float(y.grad.abs().max())
        assert float((x.grad - y.grad).abs().max()) <= 1e-6 * scale


def test_k2_backward_gives_the_volume_type():
    """A bf16 pyramid gets bf16 cotangents (JAX accumulates them in the
    volume's type); coordinates get none from the Function."""
    jp, coords = _pyramid_case(4, 1, 8, 9)
    shapes = [tuple(np.asarray(p).shape[2:4]) for p in jp]
    d_window = torch.randn((1, 8, 9, 4 * 81))
    grads = corr.lookup_corr_pyramid_backward(shapes, [torch.bfloat16] * 4, _t(coords), d_window)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4
    assert [tuple(g.shape) for g in grads] == [(1, 72, *s) for s in shapes]
    levels = [_t(np.asarray(p)[..., 0]).requires_grad_() for p in jp]
    c = _t(coords).requires_grad_()
    corr._LookupCorrPyramid.apply(c, 4, *levels).sum().backward()
    assert c.grad is None and all(lv.grad is not None for lv in levels)


def test_k3_backward_matches_jax_vjp():
    """df1, df2 of inv_sqrt_c f1 f2^T, through :class:`_CorrDot` (the
    GPU route's backward) and the CPU wrapper."""
    rng = np.random.default_rng(5)
    f1 = rng.normal(size=(2, 37, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 21, 32)).astype(np.float32)
    inv = 1.0 / np.sqrt(32.0)
    out, vjp = jax.vjp(
        lambda a, b: jcorr.corr_dot_rowmajor(a, b, inv, jnp.float32, 16, 16, True),
        jnp.asarray(f1), jnp.asarray(f2),
    )
    ct = rng.normal(size=out.shape).astype(np.float32)
    want1, want2 = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    for route in ("function", "wrapper"):
        a, b = _t(f1).requires_grad_(), _t(f2).requires_grad_()
        if route == "function":
            got = corr._CorrDot.apply(a, b, inv, torch.float32)
        else:
            got = corr.corr_dot_rowmajor(a, b, inv, torch.float32)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL, err_msg=route)
        got.backward(_t(ct))
        np.testing.assert_allclose(a.grad.numpy(), want1, **TOL, err_msg=route)
        np.testing.assert_allclose(b.grad.numpy(), want2, **TOL, err_msg=route)


def test_wrappers_without_autograd_take_the_kernel_route():
    """Without grad mode (the streaming path's inference mode) the
    wrappers keep their plain result on the CPU and record no graph."""
    jp, coords = _pyramid_case(6, 1, 8, 9)
    levels = [_t(np.asarray(p)[..., 0]).requires_grad_() for p in jp]
    with torch.inference_mode():
        out = corr.lookup_corr_pyramid(levels, _t(coords))
    assert out.grad_fn is None
