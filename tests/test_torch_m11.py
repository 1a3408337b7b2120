"""The remaining CLIs and utilities of the port against the JAX package's
counterparts, on the CPU, on the same numpy-made inputs and temporary
files: Kalman fusion (``eval/kalman.py``), the ``kalman`` and
``visualize`` CLIs, the four localisation datasets, ``read_calib`` and
``project_depth``, ``Clock``, ``shape_log``, ``BetaScheduler``, and the
profiling helpers. The host code is a numpy copy, so its results equal
the JAX package's exactly; ``project_depth`` is one float32 product
per point on either side (``DEPTH_TOL``).
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atdn_vslam_tpu.data.localization as jloc
import atdn_vslam_tpu.eval as jeval
import atdn_vslam_tpu.eval.kalman as jkalman
from atdn_vslam_tpu.cli.kalman import main as jkalman_main
from atdn_vslam_tpu.cli.visualize import main as jviz_main
from atdn_vslam_tpu.utils import depth as jdepth
from atdn_vslam_tpu.utils import helpers as jhelpers

import atdn_vslam_torch.data.localization as loc
import atdn_vslam_torch.eval as teval
import atdn_vslam_torch.eval.kalman as kalman
from atdn_vslam_torch.cli.kalman import main as kalman_main
from atdn_vslam_torch.cli.visualize import main as viz_main
from atdn_vslam_torch.utils import depth, helpers, profiling

DEPTH_TOL = {"rtol": 1e-6, "atol": 1e-5}  # float32 K^-1 and one 3x3 product per point


def _trajectory(rng, n=30, noise=0.0, base=None):
    """(n, 12) KITTI lines of a drive: small random turns, forward steps."""
    steps = base if base is not None else np.stack(
        [np.concatenate([rng.normal(scale=0.02, size=3), [0.1, 0.0, 1.0] + rng.normal(scale=0.05, size=3)])
         for _ in range(n - 1)]
    )
    steps = steps + rng.normal(scale=noise, size=steps.shape)
    mats = [np.eye(4)]
    for s in steps:
        a, b, g = s[:3]
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        rz = np.array([[np.cos(g), -np.sin(g), 0], [np.sin(g), np.cos(g), 0], [0, 0, 1]])
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = ry @ rx @ rz, s[3:]
        mats.append(mats[-1] @ step)
    return np.stack(mats)[:, :3, :].reshape(len(mats), 12), steps


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(40)
    gt, steps = _trajectory(rng)
    fwd, _ = _trajectory(rng, noise=0.01, base=steps)
    bwd_fwd_time, _ = _trajectory(rng, noise=0.02, base=steps)
    mats = np.tile(np.eye(4), (len(gt), 1, 1))
    mats[:, :3, :] = bwd_fwd_time.reshape(-1, 3, 4)
    # a backward run: the drive in reverse, starting at its own origin
    rev = np.linalg.inv(mats[-1]) @ mats
    bwd = np.linalg.inv(rev[-1])[None] @ rev[::-1]
    return gt, fwd, bwd[:, :3, :].reshape(-1, 12)


def test_kalman_fusion_matches_jax(runs):
    gt, fwd, bwd = runs
    rb = kalman.rebase_backward_trajectory(bwd)
    np.testing.assert_array_equal(rb, jkalman.rebase_backward_trajectory(bwd))
    for got, want in zip(kalman.relative_steps(fwd), jkalman.relative_steps(fwd)):
        np.testing.assert_array_equal(got, want)
    stds = kalman.error_stds(fwd, rb, gt)
    for got, want in zip(stds, jkalman.error_stds(fwd, rb, gt)):
        np.testing.assert_array_equal(got, want)
    fused = teval.fuse_trajectories(fwd, bwd, stds)
    np.testing.assert_array_equal(fused, jeval.fuse_trajectories(fwd, bwd, stds))
    x1, x2, s1, s2 = (np.random.default_rng(41).uniform(0.1, 1.0, 3) for _ in range(4))
    np.testing.assert_array_equal(kalman.inverse_variance_fusion(x1, x2, s1, s2),
                                  jkalman.inverse_variance_fusion(x1, x2, s1, s2))
    # fusion brings the trajectory no farther from the ground truth than the worse run
    err = lambda t: teval.ate_rmse(t, gt, align=False)  # noqa: E731
    assert err(fused) <= max(err(fwd), err(kalman.rebase_backward_trajectory(bwd))) + 1e-9


def _write_results(root, runs):
    gt, fwd, bwd = runs
    res, gt_dir = root / "results", root / "poses"
    res.mkdir()
    gt_dir.mkdir()
    teval.save_kitti_trajectory(str(res / "00_f.txt"), fwd)
    teval.save_kitti_trajectory(str(res / "00_b.txt"), bwd)
    teval.save_kitti_trajectory(str(gt_dir / "00.txt"), gt)
    return res, gt_dir


def test_kalman_cli_matches_jax(runs, tmp_path, capsys):
    outs = {}
    for name, sub, main in (("port", "a", kalman_main), ("jax", "b", jkalman_main)):  # paths of one length
        (tmp_path / sub).mkdir()
        res, gt_dir = _write_results(tmp_path / sub, runs)
        assert main(["--results", str(res), "--sequence", "00", "--gt-dir", str(gt_dir)]) == 0
        outs[name] = (np.loadtxt(res / "00_k.txt"), capsys.readouterr().out.replace(str(tmp_path / sub), "DIR"))
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert outs["port"][1] == outs["jax"][1]  # the stds and the fused ATE, as printed
    assert "Fused ATE rmse" in outs["port"][1]


def test_visualize_cli_matches_jax(runs, tmp_path, capsys):
    gt, fwd, _ = runs
    teval.save_kitti_trajectory(str(tmp_path / "pred.txt"), fwd)
    teval.save_kitti_trajectory(str(tmp_path / "gt.txt"), gt)
    printed, files = {}, {}
    for name, main in (("port", viz_main), ("jax", jviz_main)):
        out = tmp_path / f"plots_{name[0]}"  # paths of one length: the banners match
        assert main(["--pred", str(tmp_path / "pred.txt"), "--gt", str(tmp_path / "gt.txt"),
                     "--out-dir", str(out)]) == 0
        printed[name] = capsys.readouterr().out.replace(str(out), "OUT")
        files[name] = sorted(os.listdir(out))
        assert all((out / f).stat().st_size > 1000 for f in files[name])
    assert files["port"] == files["jax"] == ["pred_ape.png", "pred_xyz.png", "pred_xz.png"]
    assert printed["port"] == printed["jax"]  # APE and RPE statistics


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("localization")
    rng = np.random.default_rng(42)
    for sub in ("image_2", "rgb", "depth"):
        (root / sub).mkdir()
    for i in range(5):
        rgb = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "image_2" / f"{i:06d}.png"), rgb[..., ::-1])
        np.save(root / "rgb" / f"{i:06d}.npy", rgb.astype(np.float32))
        cv2.imwrite(str(root / "depth" / f"{i:06d}.png"), rng.integers(0, 65535, (12, 16), dtype=np.uint16))
    return root


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["color", "color_store", "double_color", "depth", "color_depth"])
def test_localization_datasets_match_jax(image_dirs, kind):
    root = str(image_dirs)
    make = {
        "color": lambda m: m.ColorDataset(root, division=2),
        "color_store": lambda m: m.ColorDataset(root, use_store=True),
        "double_color": lambda m: m.DoubleColorDataset(root),
        "depth": lambda m: m.DepthDataset(os.path.join(root, "depth"), division=2),
        "color_depth": lambda m: m.ColorDepthDataset(root, os.path.join(root, "depth")),
    }[kind]
    got, want = make(loc), make(jloc)
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        _same(got[i], want[i])


def test_localization_datasets_refuse_what_is_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        loc.ColorDataset(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        loc.DepthDataset(str(tmp_path))


def test_read_calib_and_project_depth_match_jax(tmp_path):
    seq = tmp_path / "dataset" / "sequences" / "04"
    seq.mkdir(parents=True)
    p2 = np.array([[718.856, 0.0, 607.1928, 45.38225], [0.0, 718.856, 185.2157, -0.1130887], [0.0, 0.0, 1.0, 0.003779761]])
    lines = [f"P{i}: " + " ".join(f"{v:.12e}" for v in (p2 + i).reshape(-1)) for i in (0, 1)]
    lines += ["P2: " + " ".join(f"{v:.12e}" for v in p2.reshape(-1)), "Tr: 1 0 0 0 0 1 0 0 0 0 1 0"]
    (seq / "calib.txt").write_text("\n".join(lines) + "\n")
    got = depth.read_calib(str(tmp_path), "04")
    np.testing.assert_array_equal(got, jdepth.read_calib(str(tmp_path), "04"))
    np.testing.assert_allclose(got, p2, rtol=1e-12)

    rng = np.random.default_rng(43)
    d = rng.uniform(1.0, 80.0, (24, 40)).astype(np.float32)
    k = got[:, :3]
    pts = depth.project_depth(torch.from_numpy(d), torch.from_numpy(k))
    want = np.asarray(jdepth.project_depth(jnp.asarray(d), jnp.asarray(k)))
    assert pts.shape == (24, 40, 3) and pts.dtype == torch.float32
    np.testing.assert_allclose(pts.numpy(), want, **DEPTH_TOL)
    np.testing.assert_allclose(pts[..., 2].numpy(), d, rtol=1e-6)  # z is the depth
    with pytest.raises(ValueError, match="P2"):
        (seq / "calib.txt").write_text("P0: 1 2 3\n")
        depth.read_calib(str(tmp_path), "04")


def test_clock_beta_scheduler_and_shape_log(tmp_path, capsys):
    clock = helpers.Clock()
    with pytest.raises(RuntimeError):
        clock.tock()
    for _ in range(3):
        clock.tick()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        assert clock.tock((x, {"y": x})) >= 0.0
    with clock:
        pass
    assert len(clock.times) == 4 and clock.total >= clock.mean >= 0.0
    clock.save(str(tmp_path / "times.txt"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "times.txt"), clock.times)

    for warmup, beta in ((0, 1.0), (10, 0.5), (7, 2.0)):
        got, want = helpers.BetaScheduler(warmup, beta), jhelpers.BetaScheduler(warmup, beta)
        assert [got(s) for s in range(12)] == [want(s) for s in range(12)]

    tree = {"a": np.zeros((2, 3)), "b": [np.zeros(4), np.zeros((1, 1))]}
    jhelpers.shape_log("x", tree)
    want = capsys.readouterr().out
    helpers.shape_log("x", {"a": torch.zeros(2, 3), "b": [torch.zeros(4), torch.zeros(1, 1)]})
    assert capsys.readouterr().out == want == "[shape] x: {'a': (2, 3), 'b': [(4,), (1, 1)]}\n"


def test_profiling_helpers(tmp_path):
    with profiling.timed("matmul") as t:
        t.result = torch.ones(128, 128) @ torch.ones(128, 128)
    assert t.seconds > 0.0 and t.tag == "matmul"
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("stage"):
            torch.ones(32).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert '"stage"' in text
