"""The port's plain tensor ops against the JAX package on the CPU:
coordinate grids, zero-padded bilinear sampling, the forward warp of a
flow field, convex upsampling, input padding and the SE(3) helpers.
Inputs are made with numpy from a seed, float32. Both sides compute
the same float32 arithmetic in another order, so values agree to 1e-5
(1e-6 where no sum is involved) and integer-valued results exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.geometry import se3 as jse3
from atdn_vslam_tpu.ops import bilinear as jbil
from atdn_vslam_tpu.ops.padding import InputPadder as JInputPadder
from atdn_vslam_tpu.ops.upsample import convex_upsample as jconvex_upsample

from atdn_vslam_torch.geometry import se3
from atdn_vslam_torch.ops.bilinear import bilinear_sample, coords_grid, forward_warp_flow
from atdn_vslam_torch.ops.padding import InputPadder
from atdn_vslam_torch.ops.upsample import convex_upsample

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def test_coords_grid_matches_jax():
    got = coords_grid(5, 7)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbil.coords_grid(5, 7)))


def test_bilinear_sample_matches_jax():
    """Taps outside the image read 0; the four-tap lerp agrees to 1e-5."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 6, 9, 3)).astype(np.float32)
    pts = rng.uniform(-2, 10, size=(2, 40, 2)).astype(np.float32)
    pts[0, 0] = (-5.0, -5.0)
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(pts))
    ref = np.asarray(jbil.bilinear_sample(jnp.asarray(img), jnp.asarray(pts)))
    assert got.shape == (2, 40, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert float(got[0, 0].abs().max()) == 0.0


def test_forward_warp_flow_matches_jax_with_collisions():
    """Rounded splat with collision averaging and zero-filled holes:
    several vectors land on one pixel, some land off the grid, some
    round at exact halves (round half to even on both sides)."""
    rng = np.random.default_rng(1)
    b, h, w = 2, 6, 8
    flow = rng.normal(scale=2.0, size=(b, h, w, 2)).astype(np.float32)
    flow[0, :, :, 0] = 3.0 - np.arange(w)[None, :]  # a whole row onto column 3
    flow[0, 0, 0] = (-20.0, 0.0)  # off the grid
    flow[1, 1, 1] = (0.5, -0.5)  # exact halves
    flow[1, 2, 2] = (1.5, 2.5)
    got = forward_warp_flow(torch.from_numpy(flow))
    ref = np.asarray(jbil.forward_warp_flow(jnp.asarray(flow)))
    assert got.shape == flow.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    zero = forward_warp_flow(torch.zeros(1, h, w, 2))
    assert float(zero.abs().max()) == 0.0  # zero flow is a fixed point


def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(2)
    flow = rng.normal(size=(2, 3, 5, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 3, 5, 9 * 64)).astype(np.float32)
    got = convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    ref = np.asarray(jconvex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    assert got.shape == (2, 24, 40, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["kitti", "sintel"])
def test_input_padder_matches_jax(mode):
    rng = np.random.default_rng(3)
    im = rng.uniform(0, 255, size=(2, 21, 30, 3)).astype(np.float32)
    port = InputPadder(im.shape, mode=mode)
    ref = JInputPadder(im.shape, mode=mode)
    (got,) = port.pad(torch.from_numpy(im))
    (want,) = ref.pad(jnp.asarray(im))
    assert port.padded and got.shape == (2, 24, 32, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(port.unpad(got).numpy(), im)
    (single,) = port.pad(torch.from_numpy(im[0]))
    np.testing.assert_array_equal(single.numpy(), np.asarray(want)[0])


@pytest.mark.parametrize("convention", ["yxz", "yxy", "xyx"])
def test_pose_to_matrix_matches_jax(convention):
    rng = np.random.default_rng(4)
    rot = rng.uniform(-1, 1, size=(5, 3)).astype(np.float32)
    tr = rng.normal(size=(5, 3)).astype(np.float32)
    got = se3.pose_to_matrix(torch.from_numpy(rot), torch.from_numpy(tr), convention)
    ref = np.asarray(jse3.pose_to_matrix(jnp.asarray(rot), jnp.asarray(tr), convention))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("convention", ["yxz", "yxy"])
def test_matrix_to_euler_matches_jax_and_inverts(convention):
    rng = np.random.default_rng(5)
    eul = rng.uniform(-1, 1, size=(6, 3)).astype(np.float32)
    if convention == "yxy":
        eul[:, 1] = np.abs(eul[:, 1]) + 0.1  # beta in (0, pi) for yxy
    R = np.array(jse3.euler_to_matrix(jnp.asarray(eul), convention))
    got = se3.matrix_to_euler(torch.from_numpy(R), convention)
    ref = np.asarray(jse3.matrix_to_euler(jnp.asarray(R), convention))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), eul, atol=1e-5)


def test_bad_convention_raises():
    with pytest.raises(ValueError):
        se3.euler_to_matrix(torch.zeros(3), "zzz")
    with pytest.raises(ValueError):
        se3.matrix_to_euler(torch.eye(3), "xyx")
