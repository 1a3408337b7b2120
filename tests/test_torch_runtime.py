"""The port's runtime against the JAX ``SlamRuntime`` on the CPU: the
same weights (carried with ``atdn_vslam_torch.convert``), the same
frames, 96x192 with 2 GMA iterations, float32. Streaming odometry:
poses and keyframe counts agree, with and without the flow warm start;
``run_odometry_sequence`` equals streaming; frames at another size go
through the same antialiased resize as ``jax.image.resize``. The map's
life cycle (``end_odometry`` -> embeddings -> relocalisation queries),
on the same map weights in both packages: embeddings, nearest keyframe,
initial and refined poses; the keyframe feature-map LRU; both warm
starts; and the port's own map training through the whole cycle.
"""

import dataclasses
import os
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
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.mapping import MappingVAE as JMappingVAE
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO
from atdn_vslam_tpu.slam import SlamRuntime as JSlamRuntime

import atdn_vslam_torch.slam.runtime as runtime
from atdn_vslam_torch.config import Config, FlowNetConfig, MappingTrainConfig, SlamConfig, load_config
from atdn_vslam_torch.convert import (
    atdnvo_state_dict_from_jax,
    gma_state_dict_from_jax,
    mapping_state_dict_from_jax,
)
from atdn_vslam_torch.slam import SlamRuntime

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 96, 192
N_FRAMES = 5
# float32 on both sides; a pose is the product of per-pair estimates,
# each within the flow network's 1e-4-level float32 differences
POSE_TOL = {"rtol": 1e-4, "atol": 1e-4}
# float32 codes of one map on both sides (measured ~3e-7 of codes up to ~1)
CODE_TOL = {"rtol": 1e-5, "atol": 1e-5}


def _configs(tmp_path, warm: bool, rot_deg: float, tr: float):
    slam = dict(
        image_height=H, image_width=W, rotation_threshold_deg=rot_deg,
        translation_threshold=tr, flow_warm_start=warm,
    )
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
    flow_vars = jax.tree.map(np.array, flow_model.init(jax.random.key(0), im, im))
    flow_vars["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array(
        [0.5], np.float32
    )
    odo_model = JATDNVO()
    flows = jnp.zeros((1, 1, H, W, 2))
    odo_vars = odo_model.init(jax.random.key(1), flows, odo_model.init_carry(1))
    odo_vars = jax.tree.map(np.array, odo_vars)
    port = (gma_state_dict_from_jax(flow_vars), atdnvo_state_dict_from_jax(odo_vars, (H, W)))
    return (flow_vars, odo_vars), port


def _frames(n, hw=(H, W), seed=0):
    """A random texture panned 2 px right and 1 px down per frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (hw[0] + n, hw[1] + 2 * n, 3), dtype=np.uint8)
    return [np.ascontiguousarray(base[i : i + hw[0], 2 * i : 2 * i + hw[1]]) for i in range(n)]


def _stream(rt, frames):
    rt.start_odometry()
    poses = [rt(f) for f in frames]
    return np.stack(poses)


@pytest.mark.parametrize(
    "warm,rot_deg,tr", [(False, 0.0, 0.0), (True, 10.0, 15.0)], ids=["cold-all-kf", "warm-default"]
)
def test_streaming_poses_and_keyframes_match_jax(tmp_path, weights, warm, rot_deg, tr):
    (flow_vars, odo_vars), (flow_sd, odo_sd) = weights
    jcfg, cfg = _configs(tmp_path, warm, rot_deg, tr)
    frames = _frames(N_FRAMES)
    jrt = JSlamRuntime(jcfg, flow_vars, odo_vars)
    want = _stream(jrt, frames)
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    got = _stream(rt, frames)
    assert got.shape == (N_FRAMES, 4, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got[0], np.eye(4))
    assert float(np.abs(want[-1] - np.eye(4)).max()) > 1e-3  # the poses moved
    np.testing.assert_allclose(got, want, **POSE_TOL)
    if rot_deg == 0.0:
        assert len(rt) == N_FRAMES
    assert len(rt) == len(jrt)
    np.testing.assert_allclose(
        rt.keyframes.poses[: len(rt)], jrt.keyframes.poses[: len(jrt)], **POSE_TOL
    )
    rt.keyframes.flush()
    np.testing.assert_array_equal(rt.keyframes.read_rgb(len(rt) - 1), jrt.keyframes.read_rgb(len(jrt) - 1))


def test_run_odometry_sequence_equals_streaming(tmp_path, weights):
    _, (flow_sd, odo_sd) = weights
    _, cfg = _configs(tmp_path, True, 0.0, 0.0)
    frames = _frames(4, seed=1)
    streamed = _stream(SlamRuntime(cfg, flow_sd, odo_sd, device="cpu"), frames)
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    with pytest.raises(RuntimeError):
        rt.run_odometry_sequence(np.stack(frames))  # not in odometry mode yet
    rt.start_odometry()
    seq = rt.run_odometry_sequence(np.stack(frames))
    np.testing.assert_array_equal(seq, streamed)
    with pytest.raises(RuntimeError):
        rt.run_odometry_sequence(np.stack(frames))  # not a fresh sequence
    assert len(rt) == 4


@pytest.mark.parametrize("shape", [(120, 250), (80, 150), (130, 160)], ids=["down", "up", "mixed"])
def test_prepare_resize_matches_jax(tmp_path, weights, shape):
    """uint8 frames at another size: the bilinear resize antialiases
    when it downscales, as ``jax.image.resize`` does (values in
    [0, 255], float32, agreement 2e-3)."""
    (flow_vars, odo_vars), (flow_sd, odo_sd) = weights
    jcfg, cfg = _configs(tmp_path, False, 0.0, 0.0)
    image = np.random.default_rng(2).integers(0, 255, (*shape, 3), dtype=np.uint8)
    got = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")._prepare(image)
    want = np.asarray(JSlamRuntime(jcfg, flow_vars, odo_vars)._prepare(image))
    assert tuple(got.shape) == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_prepare_pads_to_a_multiple_of_8(tmp_path, weights):
    (flow_vars, odo_vars), (flow_sd, odo_sd) = weights
    jcfg, cfg = _configs(tmp_path, False, 0.0, 0.0)
    jcfg = dataclasses.replace(jcfg, slam=dataclasses.replace(jcfg.slam, image_height=92))
    cfg = dataclasses.replace(cfg, slam=dataclasses.replace(cfg.slam, image_height=92))
    image = np.random.default_rng(3).integers(0, 255, (92, W, 3), dtype=np.uint8)
    got = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")._prepare(image)
    want = np.asarray(JSlamRuntime(jcfg, flow_vars, odo_vars)._prepare(image))
    assert tuple(got.shape) == (96, W, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_runtime_modes_and_unported_paths(tmp_path, weights):
    _, (flow_sd, odo_sd) = weights
    _, cfg = _configs(tmp_path, False, 0.0, 0.0)
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    assert rt.mode() == "idle"
    with pytest.raises(RuntimeError):
        rt(_frames(1)[0])
    rt.end_odometry()  # not in odometry mode: logged, nothing happens
    assert rt.mode() == "idle"
    # the pose graph and loop closure need keyframes and a map first
    with pytest.raises(RuntimeError, match="2 keyframes"):
        rt.refine_trajectory([])
    with pytest.raises(RuntimeError, match="embeddings"):
        rt.close_loops()
    with pytest.raises(ValueError, match="start_mode"):
        SlamRuntime(cfg, flow_sd, odo_sd, start_mode="bogus", device="cpu")


@pytest.fixture(scope="module")
def map_weights():
    """One MappingVAE state for both packages (JAX's init at seed 2 with
    its batch norms drawn away from identity)."""
    variables = jax.tree.map(np.array, JMappingVAE().init(jax.random.key(2), jnp.zeros((1, H, W, 3))))
    rng = np.random.default_rng(5)

    def walk(params, stats):
        for key, node in stats.items():
            if "mean" in node:
                n = node["mean"].shape
                node["mean"] = rng.normal(scale=0.1, size=n).astype(np.float32)
                node["var"] = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
                params[key]["scale"] = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
            else:
                walk(params[key], node)

    walk(variables["params"], variables["batch_stats"])
    return variables, mapping_state_dict_from_jax(variables)


def _fixed_map(monkeypatch, map_weights, saves):
    """Both runtimes' map training replaced by loading ``map_weights``
    (the training itself is held against JAX in
    ``test_torch_mapping_train.py``); each hands the map to its per-epoch
    save callback once."""
    variables, sd = map_weights

    def jax_train(model, cfg, images, log_fn=None, save_fn=None, mesh=None):
        state = types.SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
        save_fn(state)
        return state

    def port_train(model, cfg, images, log_fn=None, save_fn=None):
        model.load_state_dict(sd)
        save_fn(model)
        saves.append(len(images))
        return model.eval()

    monkeypatch.setattr(jruntime, "train_mapping", jax_train)
    monkeypatch.setattr(runtime, "train_mapping", port_train)


def test_mapping_and_relocalization_match_jax(tmp_path, weights, map_weights, monkeypatch):
    """odometry -> end_odometry -> queries, on the same flow, odometry
    and map weights: embeddings, nearest keyframe, initial and refined
    poses and distances agree; a warm start from the saved map answers
    as the runtime that built it."""
    (flow_vars, odo_vars), (flow_sd, odo_sd) = weights
    saves = []
    _fixed_map(monkeypatch, map_weights, saves)
    jcfg, cfg = _configs(tmp_path, False, 0.0, 0.0)
    frames = _frames(N_FRAMES, seed=4)
    jrt = JSlamRuntime(jcfg, flow_vars, odo_vars)
    _stream(jrt, frames)
    jrt.end_odometry()
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    _stream(rt, frames)
    rt.end_odometry()
    assert rt.mode() == jrt.mode() == "relocalization"
    assert saves == [N_FRAMES]
    assert os.path.exists(os.path.join(cfg.keyframes_path, runtime.MAP_FILE))
    emb = rt.keyframes.embeddings
    assert emb.shape == (N_FRAMES, 2 * 3 * 128) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, jrt.keyframes.embeddings, **CODE_TOL)

    for q in (3, 1):
        want = jrt(frames[q])
        got = rt(frames[q])
        assert int(np.argmin(got[2])) == int(np.argmin(want[2])) == q
        np.testing.assert_array_equal(got[0], rt.keyframes.poses[q])
        np.testing.assert_allclose(got[0], want[0], **POSE_TOL)
        np.testing.assert_allclose(got[1], want[1], **POSE_TOL)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
        assert float(np.abs(got[1] - got[0]).max()) > 1e-6  # the refine step moved the pose

    warm = SlamRuntime(cfg, flow_sd, odo_sd, start_mode="relocalization", device="cpu")
    assert warm.mode() == "relocalization" and len(warm) == N_FRAMES
    np.testing.assert_array_equal(warm.keyframes.embeddings, emb)
    for a, b in zip(warm(frames[3]), rt(frames[3])):
        np.testing.assert_array_equal(a, b)


def test_keyframe_fmap_lru(tmp_path, weights, map_weights, monkeypatch):
    """A query re-encodes its keyframe only on a miss; the cache keeps the
    most recently used keyframes up to its cap (2 here, 32 in use)."""
    _, (flow_sd, odo_sd) = weights
    _fixed_map(monkeypatch, map_weights, [])
    monkeypatch.setattr(runtime, "KEYFRAME_FMAP_CACHE", 2)
    assert runtime.KEYFRAME_FMAP_CACHE != 32  # the value in use, restored after the test
    _, cfg = _configs(tmp_path, False, 0.0, 0.0)
    frames = _frames(4, seed=6)
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    _stream(rt, frames)
    rt.end_odometry()
    encoded = []
    fnet = rt._fnet
    rt._fnet = lambda im: encoded.append(1) or fnet(im)
    for q, keys in ((0, [0]), (1, [0, 1]), (0, [1, 0]), (2, [0, 2]), (1, [2, 1])):
        assert int(np.argmin(rt(frames[q])[2])) == q
        assert list(rt._kf_fmap_cache) == keys
    assert len(encoded) == 4  # the one hit (keyframe 0, third query) did not encode


def test_warm_starts(tmp_path, weights, map_weights, monkeypatch):
    """``"relocalization"`` without a map raises; ``"mapping"`` builds the
    map from a store on disk and embeds it as ``end_odometry`` does; a
    map given as ``mapping_state_dict`` needs no saved one."""
    (flow_vars, odo_vars), (flow_sd, odo_sd) = weights
    _fixed_map(monkeypatch, map_weights, [])
    jcfg, cfg = _configs(tmp_path, False, 0.0, 0.0)
    with pytest.raises(ValueError, match="mapping_variables"):
        SlamRuntime(cfg, flow_sd, odo_sd, start_mode="relocalization", device="cpu")
    with pytest.raises(ValueError, match="mapping_variables"):
        JSlamRuntime(jcfg, flow_vars, odo_vars, start_mode="relocalization")

    frames = _frames(3, seed=7)
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    _stream(rt, frames)
    rt.keyframes.save()
    mapped = SlamRuntime(cfg, flow_sd, odo_sd, start_mode="mapping", device="cpu")
    assert mapped.mode() == "relocalization" and len(mapped) == 3
    rt.end_odometry()
    np.testing.assert_array_equal(mapped.keyframes.embeddings, rt.keyframes.embeddings)

    os.remove(os.path.join(cfg.keyframes_path, runtime.MAP_FILE))
    given = SlamRuntime(cfg, flow_sd, odo_sd, map_weights[1], start_mode="relocalization", device="cpu")
    for a, b in zip(given(frames[2]), rt(frames[2])):
        np.testing.assert_array_equal(a, b)


def test_port_trains_its_own_map(tmp_path, weights):
    """The whole cycle with the port's own map training (seeded weights,
    one epoch, batch 2): the map is saved, every keyframe is embedded, a
    keyframe's own frame finds it at distance ~0, and a warm start from
    the saved map gives the same answer."""
    _, (flow_sd, odo_sd) = weights
    _, cfg = _configs(tmp_path, False, 0.0, 0.0)
    cfg = dataclasses.replace(cfg, mapping_train=MappingTrainConfig(epochs=1, batch_size=2, seed=3))
    frames = _frames(3, seed=8)
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    _stream(rt, frames)
    rt.end_odometry()
    assert rt.keyframes.embeddings.shape == (3, 2 * 3 * 128)
    initial, refined, dist = rt(frames[1])
    assert int(np.argmin(dist)) == 1 and dist[1] < 1e-3 * dist.max()
    np.testing.assert_array_equal(initial, rt.keyframes.poses[1])
    assert np.isfinite(refined).all()
    warm = SlamRuntime(cfg, flow_sd, odo_sd, start_mode="relocalization", device="cpu")
    for a, b in zip(warm(frames[1]), (initial, refined, dist)):
        np.testing.assert_array_equal(a, b)


def test_train_mapping_cli_map_warm_starts_the_runtime(tmp_path, weights):
    """``python -m atdn_vslam_torch.cli.train_mapping`` trains on a store
    and writes the map where the runtime's relocalization warm start
    reads it (the JAX package's CLI writes another file name), with the
    embeddings beside it."""
    from atdn_vslam_torch.cli import train_mapping as cli

    _, (flow_sd, odo_sd) = weights
    _, cfg = _configs(tmp_path, False, 0.0, 0.0)
    frames = _frames(3, seed=9)
    rt = SlamRuntime(cfg, flow_sd, odo_sd, device="cpu")
    _stream(rt, frames)
    rt.keyframes.save()
    assert cli.main(["--keyframes", cfg.keyframes_path, "--epochs", "1", "--batch-size", "2",
                     "--device", "cpu"]) == 0
    warm = SlamRuntime(cfg, flow_sd, odo_sd, start_mode="relocalization", device="cpu")
    assert warm.keyframes.embeddings.shape == (3, 2 * 3 * 128)
    initial, refined, dist = warm(frames[2])
    assert int(np.argmin(dist)) == 2 and np.isfinite(refined).all()


def test_config_loads_the_sample_yaml():
    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "kitti.yaml"))
    assert cfg.flow.iters == 12 and cfg.flow.mixed_precision
    assert (cfg.slam.image_height, cfg.slam.image_width) == (376, 1232)
    with pytest.raises(KeyError, match="bogus"):
        from atdn_vslam_torch.config import _build

        _build(Config, {"bogus": 1})
