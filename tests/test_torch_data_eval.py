"""The port's numpy copies of the data and evaluation modules against the
JAX package's on a synthetic KITTI tree: poses, relative steps, flow
windows with the reverse-time augmentation (the same seeded draws),
batches, both flow-cache layouts, the flow file formats and colour
wheel, the trajectory metrics (1e-12) and the trajectory text files."""

import numpy as np
import pytest

from atdn_vslam_tpu.data import flow_io as jflow_io
from atdn_vslam_tpu.data import kitti as jkitti
from atdn_vslam_tpu.data.flow_cache import FlowCache as JFlowCache
from atdn_vslam_tpu.eval import ate as jate
from atdn_vslam_tpu.eval import kitti_io as jkitti_io

from atdn_vslam_torch.data import flow_io, kitti
from atdn_vslam_torch.data.flow_cache import FlowCache, FlowCacheWriter, write_flow_cache
from atdn_vslam_torch.eval import ate, kitti_io

H, W = 12, 20
N = 10


def _trajectory(n, seed):
    rng = np.random.default_rng(seed)
    mats = [np.eye(4)]
    for _ in range(n - 1):
        a = rng.normal(scale=0.05)
        s = np.eye(4)
        s[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        s[:3, 3] = [rng.normal(scale=0.1), 0.0, 1.0]
        mats.append(mats[-1] @ s)
    return np.stack([m[:3, :].reshape(12) for m in mats])


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Sequence 00 with the native fp16 flow cache; sequence 01 with the
    reference's per-frame layout (here ``.npy`` files, CHW)."""
    root = tmp_path_factory.mktemp("kitti")
    ds = root / "dataset"
    (ds / "poses").mkdir(parents=True)
    rng = np.random.default_rng(1)
    np.savetxt(ds / "poses" / "00.txt", _trajectory(N, 2))
    np.savetxt(ds / "poses" / "01.txt", _trajectory(6, 3))
    write_flow_cache(str(ds), "00", rng.normal(scale=5, size=(N - 1, H, W, 2)))
    legacy = ds / "flows2" / "01"
    legacy.mkdir(parents=True)
    for i in range(5):
        np.save(legacy / f"{i:06d}.npy", rng.normal(size=(2, H, W)).astype(np.float32))
    return str(root)


def test_poses_and_relative_steps_match_jax(kitti_root):
    got, want = kitti.load_poses(kitti_root, "00"), jkitti.load_poses(kitti_root, "00")
    np.testing.assert_array_equal(got, want)
    for a, b in zip(kitti.relative_poses_np(got), jkitti.relative_poses_np(want)):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        kitti.load_poses(kitti_root, "99")


@pytest.mark.parametrize("augment,length", [(True, 3), (False, 2), (-1.0, 1)], ids=["random", "forward", "backward"])
def test_flow_windows_and_batches_match_jax(kitti_root, augment, length):
    """Every window of sequences 00 and 01, drawn in the same order from
    the same seed, and the shuffled batches of the loader with and
    without its prefetch thread."""
    kw = dict(augment=augment, sequence_length=length, seed=5)
    got = kitti.FlowWindowDataset(kitti_root, ["00", "01"], **kw)
    want = jkitti.FlowWindowDataset(kitti_root, ["00", "01"], **kw)
    assert len(got) == len(want) == (N - length) + (6 - length)
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for prefetch in (0, 2):
        loaders = [cls(ds, 3, shuffle=True, seed=7, prefetch=prefetch)
                   for cls, ds in ((kitti.BatchLoader, got), (jkitti.BatchLoader, want))]
        batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == len(batches[1]) == len(got) // 3
        for a, b in zip(*batches):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_flow_caches_match_jax(kitti_root, tmp_path):
    ds = kitti_root + "/dataset"
    for seq in ("00", "01"):
        got, want = FlowCache(ds, seq), JFlowCache(ds, seq)
        assert len(got) == len(want)
        np.testing.assert_array_equal(got.read(1, 3), want.read(1, 3))
    with pytest.raises(FileNotFoundError):
        FlowCache(ds, "99")
    # the incremental writer gives the file write_flow_cache gives; wider
    # flows are centre-cropped to 1232 columns on reading
    flows = np.random.default_rng(4).normal(size=(3, 2, 1236, 2)).astype(np.float16)
    writer = FlowCacheWriter(str(tmp_path), "05", 3, 2, 1236)
    for f in flows:
        writer.append(f)
    writer.close()
    read = FlowCache(str(tmp_path), "05").read(0, 3)
    assert read.shape == (3, 2, 1232, 2)
    np.testing.assert_array_equal(read, flows[:, :, 2:1234].astype(np.float32))


def test_flow_files_and_colours_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    flow = rng.normal(scale=3, size=(H, W, 2)).astype(np.float32)
    flow_io.write_flo(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(jflow_io.read_flo(str(tmp_path / "a.flo")), flow)
    np.testing.assert_array_equal(flow_io.read_flo(str(tmp_path / "a.flo")), flow)
    image = rng.normal(size=(H, W, 3)).astype(np.float32)
    flow_io.write_pfm(str(tmp_path / "a.pfm"), image)
    np.testing.assert_array_equal(flow_io.read_pfm(str(tmp_path / "a.pfm")), jflow_io.read_pfm(str(tmp_path / "a.pfm")))
    np.testing.assert_array_equal(flow_io.read_pfm(str(tmp_path / "a.pfm")), image)
    np.testing.assert_array_equal(flow_io.flow_to_rgb(flow), jflow_io.flow_to_rgb(flow))
    np.testing.assert_array_equal(flow_io.flow_to_rgb(flow, clip=2.0), jflow_io.flow_to_rgb(flow, clip=2.0))
    np.testing.assert_array_equal(flow_io.forward_interpolate(flow), jflow_io.forward_interpolate(flow))
    with pytest.raises(ValueError, match="magic"):
        (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
        flow_io.read_flo(str(tmp_path / "bad.flo"))


def test_trajectory_metrics_match_jax(tmp_path):
    gt = _trajectory(40, 8)
    rng = np.random.default_rng(9)
    pred = gt.reshape(-1, 3, 4).copy()
    pred[:, :, 3] = 1.3 * pred[:, :, 3] + rng.normal(scale=0.2, size=(40, 3))
    pred = pred.reshape(-1, 12)
    for align, scale in ((True, True), (True, False), (False, False)):
        got = ate.ape_statistics(pred, gt, align=align, correct_scale=scale)
        want = jate.ape_statistics(pred, gt, align=align, correct_scale=scale)
        assert got.keys() == want.keys()
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k
    for delta in (1, 5):
        got, want = ate.rpe_statistics(pred, gt, delta), jate.rpe_statistics(pred, gt, delta)
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k
    src, dst = pred.reshape(-1, 3, 4)[:, :, 3], gt.reshape(-1, 3, 4)[:, :, 3]
    for a, b in zip(ate.umeyama_alignment(src, dst), jate.umeyama_alignment(src, dst)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert ate.ate_rmse(pred, gt) == pytest.approx(jate.ate_rmse(pred, gt), rel=1e-12)

    mats = np.tile(np.eye(4), (40, 1, 1))
    mats[:, :3, :] = gt.reshape(-1, 3, 4)
    path = kitti_io.save_kitti_trajectory(str(tmp_path / "sub" / "00.txt"), mats)
    np.testing.assert_array_equal(kitti_io.load_kitti_trajectory(path), jkitti_io.load_kitti_trajectory(path))
    np.testing.assert_allclose(kitti_io.load_kitti_trajectory(path), gt, rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="Unrecognized"):
        ate.ape_statistics(np.zeros((4, 7)), np.zeros((4, 7)))
