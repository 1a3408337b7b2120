"""The port's flow datasets, augmentors and evaluation protocol against
the JAX package's on the CPU: tiny dataset trees written with OpenCV from
a numpy seed, read by both packages' datasets (FlyingChairs with its
split file, FlyingThings3D, Sintel, KITTI 2015, HD1K, the stage
mixtures), with augmentors seeded alike, must give the same arrays;
``evaluate_flow``'s validation and submission writers, on the same
weights (``convert.gma_state_dict_from_jax``), the same metrics and
files within the flow nets' float32 bound."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from atdn_vslam_tpu.cli import evaluate_flow as jeval  # noqa: E402
from atdn_vslam_tpu.data import flow_datasets as jds  # noqa: E402
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA  # noqa: E402

from atdn_vslam_torch.cli import evaluate_flow as teval  # noqa: E402
from atdn_vslam_torch.config import Config, FlowNetConfig  # noqa: E402
from atdn_vslam_torch.convert import gma_state_dict_from_jax  # noqa: E402
from atdn_vslam_torch.data import flow_datasets as tds  # noqa: E402
from atdn_vslam_torch.data.flow_io import read_flo, read_kitti_png_flow, write_flo, write_kitti_png_flow, write_pfm  # noqa: E402,E501
from atdn_vslam_torch.models.factory import build_flow_model  # noqa: E402

torch.set_num_threads(1)

H, W = 60, 80  # not a multiple of 8: the evaluation pads


def _png(path, rng):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), rng.integers(0, 255, (H, W, 3)).astype(np.uint8))


def _flow(rng):
    return rng.normal(scale=3.0, size=(H, W, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One small tree per dataset."""
    base = tmp_path_factory.mktemp("flow_data")
    rng = np.random.default_rng(30)
    chairs = base / "chairs"
    for i in range(1, 5):
        _png(chairs / "data" / f"{i:05d}_img1.ppm", rng)
        _png(chairs / "data" / f"{i:05d}_img2.ppm", rng)
        write_flo(str(chairs / "data" / f"{i:05d}_flow.flo"), _flow(rng))
    np.savetxt(chairs / "FlyingChairs_train_val.txt", [1, 2, 1, 1], fmt="%d")
    things = base / "things"
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for i in range(3):
            _png(things / dstype / "TRAIN" / "A" / "0000" / "left" / f"{i:04d}.png", rng)
    for direction in ("into_future", "into_past"):
        d = things / "optical_flow" / "TRAIN" / "A" / "0000" / direction / "left"
        d.mkdir(parents=True)
        for i in range(3):
            write_pfm(str(d / f"{i:04d}.pfm"), rng.normal(size=(H, W, 3)).astype(np.float32))
    sintel = base / "sintel"
    for split in ("training", "test"):
        for dstype in ("clean", "final"):
            for i in range(3):
                _png(sintel / split / dstype / "alley_1" / f"frame_{i:04d}.png", rng)
    (sintel / "training" / "flow" / "alley_1").mkdir(parents=True)
    for i in range(2):
        write_flo(str(sintel / "training" / "flow" / "alley_1" / f"frame_{i:04d}.flo"), _flow(rng))
    kitti = base / "kitti"
    for split in ("training", "testing"):
        for i in range(2):
            _png(kitti / split / "image_2" / f"{i:06d}_10.png", rng)
            _png(kitti / split / "image_2" / f"{i:06d}_11.png", rng)
    (kitti / "training" / "flow_occ").mkdir()
    for i in range(2):
        valid = (rng.uniform(size=(H, W)) > 0.4).astype(np.float32)
        write_kitti_png_flow(str(kitti / "training" / "flow_occ" / f"{i:06d}_10.png"), _flow(rng), valid)
    hd1k = base / "hd1k"
    (hd1k / "hd1k_flow_gt" / "flow_occ").mkdir(parents=True)
    for i in range(3):
        _png(hd1k / "hd1k_input" / "image_2" / f"000000_{i:04d}.png", rng)
        write_kitti_png_flow(str(hd1k / "hd1k_flow_gt" / "flow_occ" / f"000000_{i:04d}.png"), _flow(rng))
    return {"chairs": chairs, "things": things, "sintel": sintel, "kitti": kitti, "hd1k": hd1k}


def _same_items(got, want, n=None):
    assert len(got) == len(want)
    for i in range(len(want) if n is None else n):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)


def _datasets(mod, roots):
    return {
        "chairs": mod.FlyingChairsDataset(str(roots["chairs"])),
        "chairs_val": mod.FlyingChairsDataset(str(roots["chairs"]), split="validation"),
        "things": mod.FlyingThingsDataset(str(roots["things"])),
        "sintel": mod.SintelDataset(str(roots["sintel"]), dstype="final"),
        "kitti": mod.KittiFlowDataset(str(roots["kitti"])),
        "hd1k": mod.HD1KDataset(str(roots["hd1k"])),
    }


@pytest.mark.parametrize("name", ["chairs", "chairs_val", "things", "sintel", "kitti", "hd1k"])
def test_datasets_match_jax(roots, name):
    got, want = _datasets(tds, roots)[name], _datasets(jds, roots)[name]
    assert len(want) > 0
    assert got.image_pairs == want.image_pairs and got.extra_info == want.extra_info
    _same_items(got, want)


@pytest.mark.parametrize("sparse", [False, True])
def test_augmentors_match_jax(roots, sparse):
    """Both augmentors, every draw (colour jitter in its drawn order,
    eraser, scale and stretch, flips, the crop), from the same seed over
    several samples; the sparse one with its valid-preserving resampling."""
    name = "kitti" if sparse else "things"
    crop = (48, 64)
    got, want = _datasets(tds, roots)[name], _datasets(jds, roots)[name]
    cls_t = tds.SparseFlowAugmentor if sparse else tds.FlowAugmentor
    cls_j = jds.SparseFlowAugmentor if sparse else jds.FlowAugmentor
    got.augmentor = cls_t(crop, min_scale=-0.3, max_scale=0.5, do_flip=True, seed=7, eraser_aug_prob=0.9)
    want.augmentor = cls_j(crop, min_scale=-0.3, max_scale=0.5, do_flip=True, seed=7, eraser_aug_prob=0.9)
    for _ in range(3):  # the generators advance alike
        for i in range(len(want)):
            a, b = got[i], want[i]
            assert a[0].shape == (*crop, 3) and a[2].shape == (*crop, 2)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_stage_mixture_matches_jax(roots):
    """The sintel stage, C+T+S+K+H, each part with its own recipe."""
    rs = {k: str(v) for k, v in roots.items() if k != "chairs"}
    got = tds.fetch_train_dataset("sintel", rs, crop_size=(32, 40), seed=3)
    want = jds.fetch_train_dataset("sintel", rs, crop_size=(32, 40), seed=3)
    assert len(got) == len(want) == 100 * 2 + 100 * 2 + 200 * 2 + 5 * 2 + 4
    for idx in (0, 200, 400, 800, 805, len(want) - 1):
        for a, b in zip(got[idx], want[idx]):
            np.testing.assert_array_equal(a, b)
    assert tds.STAGE_RECIPES == jds.STAGE_RECIPES
    with pytest.raises(ValueError, match="empty dataset"):
        tds.MixedFlowDataset([(tds.KittiFlowDataset(str(roots["sintel"])), 1)])


@pytest.fixture(scope="module")
def nets():
    """The JAX flow net (2 iterations, float32) and the port's inference
    build on its weights, GMA's gamma non-zero."""
    model = JRAFTGMA(iters=2, use_pallas=False)
    z = jnp.zeros((1, 64, 80, 3))
    variables = jax.tree.map(lambda x: np.array(x, np.float32), jax.jit(model.init)(jax.random.key(0), z, z))
    variables["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array([0.5], np.float32)
    port = build_flow_model(Config(flow=FlowNetConfig(iters=2, mixed_precision=False)), "cpu")
    port.load_state_dict(gma_state_dict_from_jax(variables))
    return model, variables, port


# float32 flows of the two packages (tests/test_torch_models.py), and the
# metrics that average them
FLOW_TOL = {"rtol": 1e-4, "atol": 2e-4}


def test_validation_matches_jax(roots, nets):
    """KITTI (bottom padding, per-image EPE, F1-all) and Sintel (centred
    padding, pooled EPE) protocols."""
    model, variables, port = nets
    got = teval.validate_kitti(port, str(roots["kitti"]))
    want = jeval.validate_kitti(model, variables, str(roots["kitti"]))
    np.testing.assert_allclose(got["kitti_epe"], want["kitti_epe"], **FLOW_TOL)
    ds_t, ds_j = tds.KittiFlowDataset(str(roots["kitti"])), jds.KittiFlowDataset(str(roots["kitti"]))
    stats_t = teval.evaluate_dataset(port, ds_t, pad_mode="kitti")
    stats_j = jeval.evaluate_dataset(model, variables, ds_j, pad_mode="kitti")
    assert stats_t["frames"] == stats_j["frames"] == 2
    for key in ("epe", "epe_all"):
        np.testing.assert_allclose(stats_t[key], stats_j[key], **FLOW_TOL, err_msg=key)
    got = teval.validate_sintel(port, str(roots["sintel"]), limit=1)
    want = jeval.validate_sintel(model, variables, str(roots["sintel"]), limit=1)
    for key in ("clean", "final"):
        np.testing.assert_allclose(got[key], want[key], **FLOW_TOL, err_msg=key)


def test_submission_writers_match_jax(roots, nets, tmp_path):
    """Sintel .flo files (warm-started) and KITTI 16-bit pngs."""
    model, variables, port = nets
    teval.create_sintel_submission(port, str(roots["sintel"]), str(tmp_path / "t"), warm_start=True)
    jeval.create_sintel_submission(model, variables, str(roots["sintel"]), str(tmp_path / "j"), warm_start=True)
    for dstype in ("clean", "final"):
        for frame in ("frame0001.flo", "frame0002.flo"):
            a = read_flo(str(tmp_path / "t" / dstype / "alley_1" / frame))
            b = read_flo(str(tmp_path / "j" / dstype / "alley_1" / frame))
            assert a.shape == (H, W, 2)
            np.testing.assert_allclose(a, b, **FLOW_TOL)
    teval.create_kitti_submission(port, str(roots["kitti"]), str(tmp_path / "tk"))
    jeval.create_kitti_submission(model, variables, str(roots["kitti"]), str(tmp_path / "jk"))
    a, va = read_kitti_png_flow(str(tmp_path / "tk" / "000001_10.png"))
    b, vb = read_kitti_png_flow(str(tmp_path / "jk" / "000001_10.png"))
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / 64)  # the png's 1/64 px quantisation
