"""The port's loop closure against the JAX ``SlamRuntime`` on the CPU:
the same flow, odometry and map weights (carried with
``atdn_vslam_torch.convert``), the same frames, float32, 2 GMA
iterations at 72x96 (the compressor ATDNVO encoder needs at least 72
rows). An out-and-back sequence revisits its first frames pixel for
pixel: the closure pairs, the measured closures and the refined
trajectory of ``close_loops`` agree; ``refine_trajectory`` on the same
drifted keyframe chain and closure agrees; and the JAX package's edge
cases (no candidates, an impossible threshold, aliased embeddings
rejected by the geometric gate) come out the same in both."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atdn_vslam_tpu.slam.runtime as jruntime
from atdn_vslam_tpu.config import Config as JConfig
from atdn_vslam_tpu.config import FlowNetConfig as JFlowNetConfig
from atdn_vslam_tpu.config import SlamConfig as JSlamConfig
from atdn_vslam_tpu.geometry import pose_graph as jpg
from atdn_vslam_tpu.geometry.pose_graph import se3_exp as jse3_exp
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.mapping import MappingVAE as JMappingVAE
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO
from atdn_vslam_tpu.slam import SlamRuntime as JSlamRuntime

import atdn_vslam_torch.slam.runtime as runtime
from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig
from atdn_vslam_torch.convert import (
    atdnvo_state_dict_from_jax,
    gma_state_dict_from_jax,
    mapping_state_dict_from_jax,
)
from atdn_vslam_torch.geometry.se3 import euler_to_matrix
from atdn_vslam_torch.slam import SlamRuntime
from atdn_vslam_torch.slam.keyframes import KeyframeStore

torch.set_num_threads(1)

H, W = 72, 96
# the tolerances of the runtime parity test (tests/test_torch_runtime.py)
POSE_TOL = {"rtol": 1e-4, "atol": 1e-4}
CODE_TOL = {"rtol": 1e-5, "atol": 1e-5}
MSE_RTOL = 1e-3


def _configs(tmp_path):
    slam = dict(image_height=H, image_width=W, rotation_threshold_deg=0.0, translation_threshold=0.0)
    jcfg = JConfig(
        keyframes_path=str(tmp_path / "jax_kf"),
        flow=JFlowNetConfig(iters=2, mixed_precision=False, use_pallas_attention=False),
        slam=JSlamConfig(**slam),
    )
    cfg = Config(
        keyframes_path=str(tmp_path / "port_kf"),
        flow=FlowNetConfig(iters=2, mixed_precision=False),
        slam=SlamConfig(**slam),
    )
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    flow_model = JRAFTGMA(iters=2, use_pallas=False)
    im = jnp.zeros((1, H, W, 3))
    # jitted inits: JAX's op-by-op init of the flow net is much slower
    flow_vars = jax.tree.map(np.array, jax.jit(flow_model.init)(jax.random.key(0), im, im))
    flow_vars["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array([0.5], np.float32)
    odo_model = JATDNVO()
    odo_vars = jax.jit(odo_model.init)(jax.random.key(1), jnp.zeros((1, 1, H, W, 2)), odo_model.init_carry(1))
    odo_vars = jax.tree.map(np.array, odo_vars)
    map_vars = jax.tree.map(np.array, jax.jit(JMappingVAE().init)(jax.random.key(2), im))
    jax_side = (flow_vars, odo_vars, map_vars)
    port = (gma_state_dict_from_jax(flow_vars), atdnvo_state_dict_from_jax(odo_vars, (H, W)),
            mapping_state_dict_from_jax(map_vars))
    return jax_side, port


def _jax_se3_log_repaired(T):
    """The JAX package's ``se3_log`` with the port's half-angle
    coefficient. Its own guard (``|2 th sin th| < 1e-6``) also catches
    rotation angles in (1e-4, 7e-4) and there gives a wrong V^-1 (see
    ``tests/test_torch_pose_graph.py::test_se3_log_small_angle_window``);
    a refine's closure residuals settle in that window."""
    phi = jpg.so3_log(T[..., :3, :3])
    t2 = jnp.sum(phi * phi, axis=-1)[..., None, None]
    K = jpg._skew(phi)
    small = t2 < jpg._SMALL
    t2_safe = jnp.where(small, 1.0, t2)
    theta = jnp.sqrt(t2_safe)
    coef = jnp.where(small, 1.0 / 12.0 + t2 / 720.0,
                     1.0 / t2_safe - jnp.cos(theta / 2) / (2.0 * theta * jnp.sin(theta / 2)))
    v_inv = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), K.shape) - 0.5 * K + coef * (K @ K)
    return jnp.concatenate([(v_inv @ T[..., :3, 3:])[..., 0], phi], -1)


@pytest.fixture
def repaired_jax_solve(monkeypatch):
    """The JAX runtime's pose-graph solve with its ``se3_log`` repaired: a
    fresh jit of the solve, traced with the repaired log."""
    monkeypatch.setattr(jpg, "se3_log", _jax_se3_log_repaired)
    monkeypatch.setattr(jpg, "optimize_pose_graph", jax.jit(
        jpg.optimize_pose_graph.__wrapped__,
        static_argnames=("iterations", "damping", "solver", "cg_iterations"),
    ))


def _fixed_map(monkeypatch, weights):
    """Both runtimes' map training replaced by one shared map (the
    training is held against JAX in ``tests/test_torch_mapping_train.py``)."""
    (_, _, map_vars), (_, _, map_sd) = weights

    def jax_train(model, cfg, images, log_fn=None, save_fn=None, mesh=None):
        return types.SimpleNamespace(params=map_vars["params"], batch_stats=map_vars["batch_stats"])

    def port_train(model, cfg, images, log_fn=None, save_fn=None, mesh=None):
        model.load_state_dict(map_sd)
        return model.eval()

    monkeypatch.setattr(jruntime, "train_mapping", jax_train)
    monkeypatch.setattr(runtime, "train_mapping", port_train)


def _out_and_back(out=5, seed=0):
    """A random texture panned 2 px right and 1 px down per frame for
    ``out`` frames, then back over the same positions: frame out - 1 + k
    is pixel for pixel frame out - 1 - k."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (H + out, W + 2 * out, 3), dtype=np.uint8)
    steps = list(range(out)) + list(range(out - 2, -1, -1))
    return [np.ascontiguousarray(base[i : i + H, 2 * i : 2 * i + W]) for i in steps]


def _runtimes(tmp_path, weights):
    (flow_vars, odo_vars, _), (flow_sd, odo_sd, _) = weights
    jcfg, cfg = _configs(tmp_path)
    return JSlamRuntime(jcfg, flow_vars, odo_vars), SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")


def test_close_loops_matches_jax(tmp_path, weights, monkeypatch, repaired_jax_solve):
    """odometry -> end_odometry -> close_loops on an out-and-back
    sequence, in both packages: embeddings, closure pairs, each measured
    closure, and the refined keyframe trajectory agree (the JAX solve
    with its ``se3_log`` repaired: its closure residuals fall in the
    faulty window, and its refined poses then differ by ~3e-3)."""
    _fixed_map(monkeypatch, weights)
    frames = _out_and_back()
    jrt, rt = _runtimes(tmp_path, weights)
    for r in (jrt, rt):
        r.start_odometry()
        for f in frames:
            r(f)
        r.end_odometry()
    n = len(frames)
    assert len(rt) == len(jrt) == n
    np.testing.assert_allclose(rt.keyframes.poses[:n], jrt.keyframes.poses[:n], **POSE_TOL)
    np.testing.assert_allclose(rt.keyframes.embeddings, jrt.keyframes.embeddings, **CODE_TOL)

    pairs = rt.detect_closure_pairs(min_gap=4)
    want = jrt.detect_closure_pairs(min_gap=4)
    assert [(i, j) for i, j, _ in pairs] == [(i, j) for i, j, _ in want]
    assert (6, 2) in [(i, j) for i, j, _ in pairs]  # a pixel-identical revisit
    np.testing.assert_allclose([d for *_, d in pairs], [d for *_, d in want], rtol=1e-4, atol=1e-4)
    for i, j, _ in pairs:
        np.testing.assert_allclose(rt.measure_closure(i, j), jrt.measure_closure(i, j), **POSE_TOL)
        assert i in rt._kf_fmap_cache  # keyframe i's feature map is kept

    before = rt.keyframes.poses[:n].copy()
    got = rt.close_loops(min_gap=4, closure_weight=4.0)
    ref = jrt.close_loops(min_gap=4, closure_weight=4.0)
    assert got is not None and ref is not None
    np.testing.assert_allclose(got[0], ref[0], **POSE_TOL)
    assert abs(got[1] - ref[1]) <= MSE_RTOL * ref[1] + 1e-9
    assert float(np.abs(got[0] - before).max()) > 1e-6  # the closure moved the chain
    np.testing.assert_array_equal(rt.keyframes.poses[:n], got[0])


def _drifted_keyframes(rts, n, seed, zs=None):
    """Both stores filled with blank keyframes whose poses integrate
    drifted odometry steps along a ground truth that walks along z (or
    through ``zs``); returns the ground truth (n, 4, 4)."""
    rng = np.random.default_rng(seed)
    gt = np.stack([np.eye(4)] * n)
    gt[:, 2, 3] = np.arange(n, dtype=np.float64) if zs is None else zs
    noise = np.asarray(jse3_exp(jnp.asarray(rng.normal(size=(n - 1, 6)) * 0.03, jnp.float32)), np.float64)
    noisy = [gt[0]]
    for i in range(n - 1):
        noisy.append(noisy[-1] @ np.linalg.inv(gt[i]) @ gt[i + 1] @ noise[i])
    for r in rts:
        for pose in noisy:
            r.keyframes.append(np.zeros((4, 4, 3), np.uint8), pose)
    return gt


def test_refine_trajectory_matches_jax(tmp_path, weights):
    """The same drifted chain and closure edge in both stores: the
    refined poses and residual agree, drift falls, the store is updated
    in place and saved; bad closures raise as in the JAX runtime."""
    jrt, rt = _runtimes(tmp_path, weights)
    with pytest.raises(RuntimeError, match="2 keyframes"):
        rt.refine_trajectory([(0, 0, np.eye(4))])
    n = 8
    gt = _drifted_keyframes((jrt, rt), n, seed=7)
    closure = [(0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1])]
    want, want_mse = jrt.refine_trajectory(closure, iterations=8, closure_weight=4.0)
    err_before = np.linalg.norm(rt.keyframes.poses[:n, :3, 3] - gt[:, :3, 3], axis=1).mean()
    got, mse = rt.refine_trajectory(closure, iterations=8, closure_weight=4.0)
    assert got.dtype == np.float64 and got.shape == (n, 4, 4)
    np.testing.assert_allclose(got, want, **POSE_TOL)
    assert np.isfinite(mse) and abs(mse - want_mse) <= MSE_RTOL * want_mse + 1e-9
    assert np.linalg.norm(got[:, :3, 3] - gt[:, :3, 3], axis=1).mean() < err_before
    np.testing.assert_array_equal(rt.keyframes.poses[:n], got)
    saved = KeyframeStore(rt.config.keyframes_path)
    saved.load()
    np.testing.assert_array_equal(saved.poses[:n], got)

    for bad, match in (([], "closure"), ([(0, n, np.eye(4))], "out of range"),
                       ([(-1, 2, np.eye(4))], "out of range")):
        for r in (rt, jrt):
            with pytest.raises(ValueError, match=match):
                r.refine_trajectory(bad)


def test_detect_closures_edge_cases(tmp_path, weights):
    """(JAX ``tests/test_slam_runtime.py::test_detect_closures_edge_cases``)
    a short trajectory has no candidates; an impossible distance
    threshold makes ``close_loops`` a no-op that leaves the poses."""
    jrt, rt = _runtimes(tmp_path, weights)
    with pytest.raises(RuntimeError, match="embeddings"):
        rt.close_loops()
    frames = _out_and_back(3, seed=11)
    for r in (jrt, rt):
        r.start_odometry()
        for f in frames:
            r(f)
        n = len(r)
        r.keyframes.embeddings = np.arange(n * 4, dtype=np.float32).reshape(n, 4) * 10.0
        assert r.detect_closure_pairs(min_gap=10) == []
        before = r.keyframes.poses[:n].copy()
        assert r.close_loops(min_gap=2, max_dist=0.0) is None
        np.testing.assert_array_equal(r.keyframes.poses[:n], before)
    assert len(rt) == len(jrt) == len(frames)


def test_closure_gate_rejects_aliased_embeddings(tmp_path, weights):
    """(JAX ``tests/test_slam_runtime.py::test_closure_discrimination_rejects_aliased_embeddings``)
    out 8 keyframes along z and back: keyframe 15 truly revisits 0, and
    keyframe 8 carries an embedding aliased to keyframe 1's though it is
    7 m away. The embedding search takes both; the translation gate and
    the rotation gate each drop the aliased pair; a forced false edge
    corrupts the trajectory where the gated ``close_loops`` improves it;
    both packages give the same pairs, edges and poses."""
    jrt, rt = _runtimes(tmp_path, weights)
    n = 16
    gt = _drifted_keyframes((jrt, rt), n, seed=23, zs=np.r_[np.arange(8), np.arange(8, 0, -1)])
    emb = np.zeros((n, 4), np.float32)
    emb[:, 0] = 10.0 * np.arange(n)
    emb[15] = emb[0]
    emb[8] = emb[1] + 0.1
    yaw = np.eye(4)
    yaw[:3, :3] = euler_to_matrix(torch.tensor([np.deg2rad(60.0), 0.0, 0.0], dtype=torch.float64)).numpy()

    def fake_measure(i, j):
        t = np.linalg.inv(gt[i]) @ gt[j]
        return t @ yaw if (i, j) == (8, 1) else t

    def err(poses):
        return np.linalg.norm(poses[:n, :3, 3] - gt[:, :3, 3], axis=1).mean()

    results = []
    for r in (rt, jrt):
        r.keyframes.set_embeddings(emb)
        r.measure_closure = fake_measure
        pairs = {(i, j) for i, j, _ in r.detect_closure_pairs(min_gap=5)}
        assert {(15, 0), (8, 1)} <= pairs
        by_tr = r.detect_closures(min_gap=5, max_translation=2.0, max_rotation_deg=0.0)
        by_rot = r.detect_closures(min_gap=5, max_translation=0.0, max_rotation_deg=30.0)
        assert [(i, j) for i, j, _ in by_tr] == [(i, j) for i, j, _ in by_rot] == [(15, 0)]
        before = r.keyframes.poses[:n].copy()
        forced, _ = r.refine_trajectory([(8, 1, fake_measure(8, 1))], iterations=8, closure_weight=4.0)
        r.keyframes.poses[:n] = before
        gated = r.close_loops(min_gap=5, max_translation=2.0, max_rotation_deg=0.0, closure_weight=4.0)
        assert gated is not None
        assert err(gated[0]) < err(before) and err(gated[0]) < err(forced)
        results.append((pairs, forced, gated[0]))
    assert results[0][0] == results[1][0]
    np.testing.assert_allclose(results[0][1], results[1][1], **POSE_TOL)
    np.testing.assert_allclose(results[0][2], results[1][2], **POSE_TOL)
