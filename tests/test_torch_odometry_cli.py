"""The port's odometry CLIs on a tiny synthetic KITTI tree with
``--device cpu``: ``train_odometry`` (stage 1, then stage 2 from it),
``evaluate_odometry`` on the checkpoint, forward and backward, with
plots, and ``slam_demo`` from the sequence's PNGs and from a ``.npy``
frame stack, the odometry net from the trained checkpoint. Flows and
frames are 72x96, the smallest size the compressor encoder takes."""

import numpy as np
import pytest
import torch
import yaml

from atdn_vslam_torch.cli import evaluate_odometry, slam_demo, train_odometry
from atdn_vslam_torch.data import write_flow_cache

torch.set_num_threads(1)

H, W = 72, 96
N = 10


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_cli")
    ds = root / "dataset"
    (ds / "poses").mkdir(parents=True)
    rng = np.random.default_rng(11)
    mats = [np.eye(4)]
    for _ in range(N - 1):
        s = np.eye(4)
        a = rng.normal(scale=0.02)
        s[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        s[:3, 3] = [0.1, 0.0, 1.0]
        mats.append(mats[-1] @ s)
    np.savetxt(ds / "poses" / "00.txt", np.stack([m[:3, :].reshape(12) for m in mats]))
    write_flow_cache(str(ds), "00", rng.normal(scale=5, size=(N - 1, H, W, 2)))
    return root


@pytest.fixture(scope="module")
def trained(kitti_root, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    common = ["--data-path", str(kitti_root), "--checkpoint-dir", str(ckpt), "--log-dir", str(ckpt / "log"),
              "--epochs", "1", "--batch-size", "3", "--sequence-length", "2", "--lr", "1e-3",
              "--sequences", "00", "--device", "cpu"]
    for stage in ("1", "2"):
        assert train_odometry.main(common + ["--stage", stage]) == 0
    return ckpt


def test_train_odometry_cli(trained):
    for stage in (1, 2):
        ckpt = torch.load(trained / f"odometry_stage{stage}.pt", weights_only=True)
        assert ckpt["stage"] == stage and ckpt["step"] == 2  # 8 windows, batch 3
        losses = np.loadtxt(trained / "log" / f"odometry_stage{stage}_loss.txt")
        assert losses.shape == (2,) and np.isfinite(losses).all()


def test_evaluate_odometry_cli(kitti_root, trained, tmp_path):
    out = tmp_path / "eval"
    assert evaluate_odometry.main([
        "--data-path", str(kitti_root), "--checkpoint-dir", str(trained), "--stage", "2",
        "--sequence", "00", "--direction", "both", "--exp", str(out), "--plot", "--device", "cpu",
    ]) == 0
    for suffix in ("f", "b"):
        traj = np.loadtxt(out / f"00_{suffix}.txt")
        assert traj.shape == (N, 12) and np.isfinite(traj).all()
        np.testing.assert_allclose(traj[0], np.eye(4)[:3].reshape(12))
        assert (out / f"00_{suffix}.png").exists()


def test_slam_demo_cli(kitti_root, trained, tmp_path):
    import cv2

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (5, H, W, 3)).astype(np.uint8)
    im_dir = kitti_root / "dataset" / "sequences" / "00" / "image_2"
    im_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(str(im_dir / f"{i:06d}.png"), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    np.save(tmp_path / "frames.npy", frames)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "slam": {"image_height": H, "image_width": W, "rotation_threshold_deg": 0.0,
                 "translation_threshold": 0.0},
        "flow": {"iters": 2, "mixed_precision": False},
        "mapping_train": {"epochs": 1, "batch_size": 2},
    }))
    trajs = []
    for name, extra in (("png", []), ("npy", ["--frames", str(tmp_path / "frames.npy"), "--no-plot"])):
        out = tmp_path / name
        assert slam_demo.main([
            "--config", str(cfg), "--data-path", str(kitti_root), "--sequence", "00",
            "--max-frames", "4", "--query-frame", "2", "--out-dir", str(out),
            "--odometry-checkpoint-dir", str(trained), "--stage", "2", "--device", "cpu", *extra,
        ]) == 0
        traj = np.loadtxt(out / "00_slam.txt")
        assert traj.shape == (4, 12) and np.isfinite(traj).all()
        assert (out / "00_slam_xz.png").exists() == (name == "png")
        assert (out / "keyframes" / "mapping_variables.pt").exists()
        trajs.append(traj)
    np.testing.assert_array_equal(trajs[0], trajs[1])  # the PNGs hold the same frames
