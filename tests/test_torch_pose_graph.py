"""The port's SE(3) helpers and pose-graph solve against the JAX
package on the CPU, float32, on the same numpy-seeded inputs: the pose
helpers and trajectory chaining, the exp/log maps and their round trips
at and near both singular angles, the edge Jacobians and the assembled
normal equations, the dense and CG solves on drifted chains with loop
closures, and a closure whose residual is ~180 degrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.geometry import pose_graph as jpg
from atdn_vslam_tpu.geometry import se3 as jse3

from atdn_vslam_torch.geometry import pose_graph as pg
from atdn_vslam_torch.geometry import se3

torch.set_num_threads(1)

SE3_ATOL = 1e-6  # float32 helpers: the same formulas on both sides
EXP_LOG_ATOL = 1e-5
JAC_REL = 1e-5  # of the largest entry
POSE_ATOL = 1e-4
MSE_RTOL, MSE_ATOL = 1e-3, 1e-9


def _t(x):
    return torch.from_numpy(np.array(x))


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    rot = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    tr = rng.normal(size=(n, 3)).astype(np.float32)
    mats = np.asarray(jse3.pose_to_matrix(jnp.asarray(rot), jnp.asarray(tr)))
    return mats[:, :3, :].reshape(n, 12)


def test_pose_matrix_helpers_match_jax():
    lines = _lines(6, 0)
    mats = np.asarray(jse3.line_to_matrix(jnp.asarray(lines)))
    checks = [
        (se3.line_to_matrix(_t(lines)), mats),
        (se3.matrix_to_line(_t(mats)), jse3.matrix_to_line(jnp.asarray(mats))),
        (se3.se3_inverse(_t(mats)), jse3.se3_inverse(jnp.asarray(mats))),
        *zip(se3.matrix_to_pose(_t(mats)), jse3.matrix_to_pose(jnp.asarray(mats))),
        *zip(se3.relative_pose(_t(lines[:3]), _t(lines[3:])),
             jse3.relative_pose(jnp.asarray(lines[:3]), jnp.asarray(lines[3:]))),
        *zip(se3.relative_pose(_t(mats[:3]), _t(mats[3:])),
             jse3.relative_pose(jnp.asarray(mats[:3]), jnp.asarray(mats[3:]))),
        *zip(se3.absolute_to_relative(_t(lines)), jse3.absolute_to_relative(jnp.asarray(lines))),
        *zip(se3.absolute_to_relative(_t(mats)), jse3.absolute_to_relative(jnp.asarray(mats))),
    ]
    for got, want in checks:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SE3_ATOL)
    np.testing.assert_allclose(se3.se3_inverse(_t(mats)).numpy() @ mats, np.tile(np.eye(4), (6, 1, 1)),
                               atol=1e-5)


@pytest.mark.parametrize("steps,base", [(1, False), (7, True), (200, False)], ids=["1", "7-base", "200"])
def test_accumulate_poses_matches_jax(steps, base):
    """The log-depth chain pairs its products as ``lax.associative_scan``
    does: the float32 results agree to rounding, at 200 steps to 1e-6
    of the largest entry; the host chain is float64."""
    rng = np.random.default_rng(steps)
    rot = rng.normal(scale=0.1, size=(steps, 3)).astype(np.float32)
    tr = rng.normal(size=(steps, 3)).astype(np.float32)
    b = np.asarray(jse3.line_to_matrix(jnp.asarray(_lines(1, 9)[0]))) if base else None
    want = np.asarray(jse3.accumulate_poses(jnp.asarray(rot), jnp.asarray(tr),
                                            base=None if b is None else jnp.asarray(b)))
    got = se3.accumulate_poses(_t(rot), _t(tr), base=None if b is None else _t(b)).numpy()
    assert got.shape == (steps + 1, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SE3_ATOL * max(1.0, float(np.abs(want).max())))
    host = se3.accumulate_poses_host(rot, tr, base=b)
    assert host.dtype == np.float64
    np.testing.assert_allclose(host, jse3.accumulate_poses_host(rot, tr, base=b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("theta", [0.0, 1e-5, 1.0, np.pi - 1e-4], ids=["0", "1e-5", "1", "pi-1e-4"])
def test_exp_log_match_jax(theta):
    rng = np.random.default_rng(int(theta * 1e4) + 1)
    axes = rng.normal(size=(4, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w = (axes * theta).astype(np.float32)
    xi = np.concatenate([rng.normal(size=(4, 3)), w], axis=1).astype(np.float32)
    R = pg.so3_exp(_t(w))
    T = pg.se3_exp(_t(xi))
    for got, want in (
        (R, jpg.so3_exp(jnp.asarray(w))),
        (T, jpg.se3_exp(jnp.asarray(xi))),
        (pg.so3_log(R), jpg.so3_log(jnp.asarray(R.numpy()))),
        (pg.se3_log(T), jpg.se3_log(jnp.asarray(T.numpy()))),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=EXP_LOG_ATOL)
    # round trips (near pi both packages recover the angle to ~4e-4)
    trip = 1e-3 if theta > 3 else EXP_LOG_ATOL
    np.testing.assert_allclose(pg.so3_log(R).numpy(), w, rtol=0, atol=trip)
    np.testing.assert_allclose(pg.se3_log(T).numpy(), xi, rtol=0, atol=trip)


@pytest.mark.parametrize("theta", [1.5e-4, 3e-4, 6e-4], ids=["1.5e-4", "3e-4", "6e-4"])
def test_se3_log_small_angle_window(theta):
    """A fault of the JAX package's ``se3_log``: its guard against
    0 / 0 at theta = pi (``|2 th sin th| < 1e-6``) also catches angles in
    (1e-4, 7e-4), where it replaces V^-1's coefficient 1/12 by about
    1/th^2 - 2e6, and the round trip log(exp(xi)) loses up to 95% of
    the translation. The port's half-angle coefficient has no 0 / 0 and
    keeps the round trip: exact in float64, within float32's exp error
    (~theta |rho| / 2) in float32."""
    xi = np.array([1.0, 2.0, -0.5, 0.0, theta, 0.0])
    jax_err = np.abs(np.asarray(jpg.se3_log(jpg.se3_exp(jnp.asarray(xi, jnp.float32))))[:3] - xi[:3]).max()
    assert jax_err > 0.1  # the reference's fault
    got64 = pg.se3_log(pg.se3_exp(torch.tensor(xi))).numpy()
    np.testing.assert_allclose(got64, xi, rtol=0, atol=1e-12)
    got32 = pg.se3_log(pg.se3_exp(torch.tensor(xi, dtype=torch.float32))).numpy()
    np.testing.assert_allclose(got32, xi, rtol=0, atol=theta * 2.5)


def test_gauss_newton_converges_on_a_long_chain():
    """200 drifted poses on a circle with a closure every 20: the float32
    solve lands within 1e-4 of the float64 solve, whose last step is
    below 1e-6 (with the JAX package's log the closure residuals sit in
    its faulty window and the steps stay ~0.05: no convergence)."""
    poses, ei, ej, meas, w = _drifted_graph(
        200, 0, closures=[(i, i + 63) for i in range(0, 137, 20)], weight=4.0, noise=0.005)
    g32 = (_t(poses), _t(ei), _t(ej), _t(meas), _t(w))
    g64 = [x.double() if x.is_floating_point() else x for x in g32]
    got, _ = pg.optimize_pose_graph(*g32)
    ref, _ = pg.optimize_pose_graph(*g64)
    ref9, _ = pg.optimize_pose_graph(*g64, iterations=9)
    assert float((ref - ref9).abs().max()) < 1e-6
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=0, atol=POSE_ATOL)


def _drifted_graph(n, seed, closures=((0, -1), (None, -1)), weight=4.0, noise=0.03):
    """A chain of n poses stepping 1 m forward with a 0.1 rad turn,
    stored with accumulated odometry drift; closures (i, j) carry the
    true relative pose (``None`` is the chain's middle, negative indices
    count from the end). Returns float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    step = np.asarray(jpg.se3_exp(jnp.asarray([0, 0, 1.0, 0, 0.1, 0], jnp.float32)), np.float64)
    gt = [np.eye(4)]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    drift = np.asarray(jpg.se3_exp(jnp.asarray(rng.normal(scale=noise, size=(n - 1, 6)), jnp.float32)),
                       np.float64)
    poses = [gt[0]]
    for i in range(n - 1):
        poses.append(poses[-1] @ np.linalg.inv(gt[i]) @ gt[i + 1] @ drift[i])
    poses = np.stack(poses).astype(np.float32)
    ci = np.array([n // 2 if i is None else i % n for i, _ in closures])
    cj = np.array([j % n for _, j in closures])
    ei, ej = np.arange(n - 1), np.arange(1, n)
    meas = np.concatenate([np.linalg.inv(poses[:-1]) @ poses[1:], np.linalg.inv(gt[ci]) @ gt[cj]])
    weights = np.r_[np.ones(n - 1), np.full(len(ci), weight)].astype(np.float32)
    return poses, np.r_[ei, ci], np.r_[ej, cj], meas.astype(np.float32), weights


@jax.jit
def _jax_normal_equations(poses, ei, ej, meas, weights, damping=1e-6):
    """The JAX package's assembly (``optimize_pose_graph``'s first
    Gauss-Newton step, dense path), written out with its own functions:
    the edge Jacobians, the damped gauge-dropped matrix A and b."""
    n = poses.shape[0]
    sqrt_w = jnp.sqrt(weights)[:, None]

    def edge_res(di, dj, xi, xj, z, sw):
        pred = jse3.se3_inverse(xi @ jpg.se3_exp(di)) @ (xj @ jpg.se3_exp(dj))
        return jpg.se3_log(jse3.se3_inverse(z) @ pred) * sw

    with jax.default_matmul_precision("highest"):
        ji, jj = jax.vmap(jax.jacfwd(edge_res, argnums=(0, 1)), in_axes=(None, None, 0, 0, 0, 0))(
            jnp.zeros(6), jnp.zeros(6), poses[ei], poses[ej], meas, sqrt_w
        )
        r0 = jpg.edge_residuals(poses, ei, ej, meas) * sqrt_w
        rhs = jnp.zeros((n, 6))
        rhs = rhs.at[ei].add(-jnp.einsum("era,er->ea", ji, r0))
        rhs = rhs.at[ej].add(-jnp.einsum("era,er->ea", jj, r0))
        jtj = jnp.zeros((n, 6, n, 6))
        jtj = jtj.at[ei, :, ei, :].add(jnp.einsum("era,erb->eab", ji, ji))
        jtj = jtj.at[ej, :, ej, :].add(jnp.einsum("era,erb->eab", jj, jj))
        jtj = jtj.at[ei, :, ej, :].add(jnp.einsum("era,erb->eab", ji, jj))
        jtj = jtj.at[ej, :, ei, :].add(jnp.einsum("era,erb->eab", jj, ji))
        A = jtj.reshape(n * 6, n * 6)[6:, 6:]
        A = A + damping * jnp.diag(jnp.diagonal(A)) + damping * jnp.eye((n - 1) * 6)
    return ji, jj, A, rhs.reshape(n * 6)[6:]


def _rel_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("consistent", [False, True], ids=["drifted", "at-identity"])
def test_edge_jacobians_and_normal_equations_match_jax(consistent):
    """A consistent graph puts every residual exactly at the identity,
    where the guards of the log map hold the derivatives finite."""
    poses, ei, ej, meas, w = _drifted_graph(10, 3, closures=((0, -1), (2, 7), (7, 2)))
    if consistent:
        meas = np.linalg.inv(poses[ei]) @ poses[ej]
    want = _jax_normal_equations(jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej),
                                 jnp.asarray(meas), jnp.asarray(w))
    n = poses.shape[0]
    r0, ji, jj, rhs = pg.normal_equations(_t(poses), _t(ei), _t(ej), _t(meas), torch.sqrt(_t(w))[:, None])
    jtj = pg.dense_normal_matrix(n, _t(ei), _t(ej), ji, jj).reshape(n * 6, n * 6)[6:, 6:]
    A = jtj + 1e-6 * torch.diag_embed(torch.diagonal(jtj)) + 1e-6 * torch.eye((n - 1) * 6)
    for got, ref in zip((ji, jj, A), want):
        assert bool(torch.isfinite(got).all())
        _rel_close(got.numpy(), ref, JAC_REL)
    b = rhs.reshape(-1)[6:].numpy()
    if consistent:
        # the residuals are float32 rounding of the identity, so is b
        assert np.abs(b).max() < 1e-4 and np.abs(np.asarray(want[3])).max() < 1e-4
    else:
        _rel_close(b, want[3], JAC_REL)
    assert r0.shape == (len(ei), 6)


@pytest.mark.parametrize("solver,n,weighted", [
    ("dense", 8, True), ("dense", 30, True), ("cg", 8, True), ("cg", 30, True), ("dense", 12, False),
], ids=["dense-8", "dense-30", "cg-8", "cg-30", "dense-12-unweighted"])
def test_optimize_pose_graph_matches_jax(solver, n, weighted):
    poses, ei, ej, meas, w = _drifted_graph(n, n)
    weights = w if weighted else None
    want, want_mse = jpg.optimize_pose_graph(
        jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(meas),
        None if weights is None else jnp.asarray(weights), iterations=6, solver=solver,
    )
    got, mse = pg.optimize_pose_graph(
        _t(poses), _t(ei), _t(ej), _t(meas), None if weights is None else _t(weights),
        iterations=6, solver=solver,
    )
    assert got.dtype == torch.float32 and got.shape == (n, 4, 4)
    np.testing.assert_array_equal(got[0].numpy(), poses[0])  # the gauge pose stays put
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=POSE_ATOL)
    want_mse = float(want_mse)
    assert abs(float(mse) - want_mse) <= max(MSE_RTOL * want_mse, MSE_ATOL)
    start = float(torch.mean(pg.edge_residuals(_t(poses), _t(ei), _t(ej), _t(meas)) ** 2))
    assert float(mse) < start


def test_half_turn_closure_gives_no_nan():
    """A closure whose measurement is ~180 degrees off the chain's
    relative pose: the log map takes its near-pi branch, and both solves
    stay finite in both packages. (Near pi the arccos and the axis choice
    amplify float32 rounding, ~1e-3 between the packages' poses, so only
    finiteness is held here.)"""
    poses, ei, ej, meas, w = _drifted_graph(8, 5, closures=((0, -1),))
    flip = np.asarray(jpg.se3_exp(jnp.asarray([0, 0, 0, 0, np.pi - 5e-5, 0], jnp.float32)))
    meas[-1] = meas[-1] @ flip
    res = pg.edge_residuals(_t(poses), _t(ei), _t(ej), _t(meas))
    assert float(torch.linalg.norm(res[-1, 3:])) > 3.0
    for solver in ("dense", "cg"):
        want, want_mse = jpg.optimize_pose_graph(
            jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(meas), jnp.asarray(w),
            iterations=3, solver=solver,
        )
        got, mse = pg.optimize_pose_graph(_t(poses), _t(ei), _t(ej), _t(meas), _t(w), iterations=3,
                                          solver=solver)
        assert bool(torch.isfinite(got).all()) and np.isfinite(float(mse))
        assert np.isfinite(np.asarray(want)).all() and np.isfinite(float(want_mse))


@pytest.mark.parametrize("iterations", [4, 60], ids=["short", "past-convergence"])
def test_pcg_matches_jax(iterations):
    """Fixed-count PCG on a random SPD system with a Jacobi
    preconditioner; past convergence the freeze keeps the answer put."""
    rng = np.random.default_rng(iterations)
    m = rng.normal(size=(12, 12)).astype(np.float32)
    a = (m @ m.T + 0.5 * np.eye(12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    d = np.diag(a).copy()
    want = jpg._pcg_solve(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), lambda r: r / jnp.asarray(d),
                          iterations)
    got = pg._pcg_solve(lambda v: _t(a) @ v, _t(b), lambda r: r / _t(d), iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    if iterations > 12:
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(a, b), rtol=0, atol=1e-3)


def test_solver_arguments():
    poses, ei, ej, meas, _ = _drifted_graph(4, 0)
    with pytest.raises(ValueError, match="solver"):
        pg.optimize_pose_graph(_t(poses), _t(ei), _t(ej), _t(meas), solver="lu")
    i, j = pg.odometry_edges(5, "cpu")
    assert i.tolist() == [0, 1, 2, 3] and j.tolist() == [1, 2, 3, 4]
    ji, jj = jpg.odometry_edges(5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
