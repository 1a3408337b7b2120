"""The port's flow CLIs with ``--device cpu`` on tiny synthetic trees:
``train_flow`` on a KITTI-2015 tree (2 steps with full-state
checkpoints, then resumed to a third), and its ``--output`` weights
loaded by ``load_reference_checkpoint`` and used by ``evaluate_flow``,
``precompute_flows`` and ``slam_demo --flow-checkpoint``: one weights
format for every flow CLI."""

import numpy as np
import pytest
import torch
import yaml

cv2 = pytest.importorskip("cv2")

from atdn_vslam_torch.checkpoint import load_reference_checkpoint  # noqa: E402
from atdn_vslam_torch.cli import evaluate_flow, precompute_flows, slam_demo, train_flow  # noqa: E402
from atdn_vslam_torch.config import Config, FlowNetConfig  # noqa: E402
from atdn_vslam_torch.data.flow_io import write_kitti_png_flow  # noqa: E402
from atdn_vslam_torch.models.factory import build_flow_model  # noqa: E402
from atdn_vslam_torch.training import flow as train  # noqa: E402

torch.set_num_threads(1)

H, W = 60, 100  # KITTI-2015 frames; the crop is 48 x 64
ODO_H, ODO_W = 72, 96  # the odometry tree (the ATDNVO encoder's smallest size)


def _png(path, img):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


@pytest.fixture(scope="module")
def kitti2015(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti2015")
    rng = np.random.default_rng(40)
    (root / "training" / "flow_occ").mkdir(parents=True)
    for i in range(3):
        _png(root / "training" / "image_2" / f"{i:06d}_10.png", rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        _png(root / "training" / "image_2" / f"{i:06d}_11.png", rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        flow = rng.normal(scale=2.0, size=(H, W, 2)).astype(np.float32)
        write_kitti_png_flow(str(root / "training" / "flow_occ" / f"{i:06d}_10.png"), flow,
                             (rng.uniform(size=(H, W)) > 0.3).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def trained(kitti2015, tmp_path_factory):
    """2 steps checkpointed every step, then a rerun to 3 steps that
    resumes from step 2; the weights of both runs."""
    out = tmp_path_factory.mktemp("train_flow")
    common = ["--dataset", "kitti", "--root", str(kitti2015), "--batch-size", "2", "--crop", "48", "64",
              "--iters", "2", "--lr", "1e-3", "--seed", "5", "--checkpoint-dir", str(out / "ckpt"),
              "--checkpoint-every", "1", "--log-every", "1", "--device", "cpu"]
    assert train_flow.main(common + ["--steps", "2", "--output", str(out / "two.pth")]) == 0
    assert train_flow.main(common + ["--steps", "3", "--output", str(out / "three.pth")]) == 0
    return out


def test_train_flow_checkpoints_and_resumes(trained):
    assert train.latest_checkpoint(str(trained / "ckpt")).endswith("step_00000003")
    for step in (1, 2, 3):
        ckpt = torch.load(trained / "ckpt" / f"step_{step:08d}" / train.STATE_FILE, weights_only=True)
        assert ckpt["step"] == step
    two, three = (load_reference_checkpoint(trained / f"{n}.pth") for n in ("two", "three"))
    assert two.keys() == three.keys()
    moved = [k for k in two if not torch.equal(two[k], three[k])]
    assert "update_block.flow_head.conv2.weight" in moved  # the third step trained
    assert all(torch.isfinite(v).all() for v in three.values() if v.is_floating_point())
    # the resumed run started from step 2's state, not afresh
    state2 = torch.load(trained / "ckpt" / "step_00000002" / train.STATE_FILE, weights_only=True)["model"]
    assert all(torch.equal(state2[k], two[k]) for k in two)


class _Indexed:
    """A dataset whose sample i is i, for the draw's indices."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return (np.array(i),) * 4


def test_train_flow_batch_draw_depends_on_seed_and_step_only():
    draws = [train_flow.draw_batch(_Indexed(), 5, step, 4) for step in (7, 7, 8)]
    np.testing.assert_array_equal(draws[0][0], draws[1][0])
    assert not np.array_equal(draws[0][0], draws[2][0])


def test_train_flow_output_loads_strictly(trained):
    model = build_flow_model(Config(flow=FlowNetConfig(iters=2, mixed_precision=False)), "cpu")
    model.load_state_dict(load_reference_checkpoint(trained / "three.pth"))  # strict


def test_evaluate_flow_cli_on_trained_weights(trained, kitti2015, tmp_path):
    assert evaluate_flow.main(["--dataset", "kitti", "--root", str(kitti2015), "--flow-checkpoint",
                               str(trained / "three.pth"), "--iters", "2", "--limit", "2", "--device", "cpu"]) == 0
    model = evaluate_flow.load_flow_model(FlowNetConfig(iters=2), torch.device("cpu"), str(trained / "three.pth"))
    stats = evaluate_flow.validate_kitti(model, str(kitti2015), limit=2)
    assert np.isfinite(stats["kitti_epe"]) and np.isfinite(stats["kitti_f1"])


@pytest.fixture(scope="module")
def odometry_tree(tmp_path_factory):
    """A KITTI odometry sequence of 5 frames with poses, and a config at
    its size."""
    root = tmp_path_factory.mktemp("kitti_odo")
    rng = np.random.default_rng(41)
    frames = rng.integers(0, 255, (5, ODO_H, ODO_W, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        _png(root / "dataset" / "sequences" / "00" / "image_2" / f"{i:06d}.png", f)
    poses = np.tile(np.eye(4)[:3].reshape(1, 12), (5, 1))
    poses[:, 11] = np.arange(5)
    (root / "dataset" / "poses").mkdir(parents=True)
    np.savetxt(root / "dataset" / "poses" / "00.txt", poses)
    cfg = root / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "slam": {"image_height": ODO_H, "image_width": ODO_W, "rotation_threshold_deg": 0.0,
                 "translation_threshold": 0.0},
        "flow": {"iters": 2, "mixed_precision": False},
        "mapping_train": {"epochs": 1, "batch_size": 2},
    }))
    return root, cfg, frames


def test_precompute_flows_cli_on_trained_weights(trained, odometry_tree):
    root, cfg, _ = odometry_tree
    assert precompute_flows.main(["--config", str(cfg), "--data-path", str(root), "--sequence", "00",
                                  "--batch", "3", "--flow-checkpoint", str(trained / "three.pth"),
                                  "--device", "cpu"]) == 0
    cache = np.load(root / "dataset" / "flows2" / "00.npy")
    assert cache.shape == (4, ODO_H, ODO_W, 2) and cache.dtype == np.float16
    assert np.isfinite(cache).all()
    # pair 3 (the second batch) carries frame 3's feature map over: the
    # same flow as the pair run on its own
    model = evaluate_flow.load_flow_model(FlowNetConfig(iters=2), torch.device("cpu"), str(trained / "three.pth"))
    frames = [torch.from_numpy(cv2.cvtColor(cv2.imread(str(root / "dataset" / "sequences" / "00" / "image_2"
                                                           / f"{i:06d}.png")), cv2.COLOR_BGR2RGB)).float()[None]
              for i in (3, 4)]
    with torch.inference_mode():
        _, up = model(*frames)
    np.testing.assert_allclose(cache[3], up[0].numpy().astype(np.float16), rtol=2e-3, atol=2e-3)


def test_slam_demo_cli_on_trained_weights(trained, odometry_tree, tmp_path):
    root, cfg, frames = odometry_tree
    np.save(tmp_path / "frames.npy", frames)
    out = tmp_path / "demo"
    assert slam_demo.main(["--config", str(cfg), "--data-path", str(root), "--sequence", "00",
                           "--frames", str(tmp_path / "frames.npy"), "--max-frames", "4", "--query-frame", "2",
                           "--out-dir", str(out), "--flow-checkpoint", str(trained / "three.pth"),
                           "--no-plot", "--device", "cpu"]) == 0
    traj = np.loadtxt(out / "00_slam.txt")
    assert traj.shape == (4, 12) and np.isfinite(traj).all()
