"""The port's streaming odometry runtime against the JAX
``SlamRuntime`` on the CPU: the same weights (carried with
``atdn_vslam_torch.convert``), the same frames, 96x192 with 2 GMA
iterations, float32. Poses and keyframe counts agree, with and without
the flow warm start; ``run_odometry_sequence`` equals streaming; frames
at another size go through the same antialiased resize as
``jax.image.resize``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.config import Config as JConfig
from atdn_vslam_tpu.config import FlowNetConfig as JFlowNetConfig
from atdn_vslam_tpu.config import SlamConfig as JSlamConfig
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO
from atdn_vslam_tpu.slam import SlamRuntime as JSlamRuntime

from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig, load_config
from atdn_vslam_torch.convert import atdnvo_state_dict_from_jax, gma_state_dict_from_jax
from atdn_vslam_torch.slam import SlamRuntime

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 96, 192
N_FRAMES = 5
# float32 on both sides; a pose is the product of per-pair estimates,
# each within the flow network's 1e-4-level float32 differences
POSE_TOL = {"rtol": 1e-4, "atol": 1e-4}


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
    with pytest.raises(NotImplementedError, match="M7"):
        rt.end_odometry()
    with pytest.raises(NotImplementedError, match="M7"):
        SlamRuntime(cfg, flow_sd, odo_sd, start_mode="relocalization", device="cpu")


def test_config_loads_the_sample_yaml():
    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "kitti.yaml"))
    assert cfg.flow.iters == 12 and cfg.flow.mixed_precision
    assert (cfg.slam.image_height, cfg.slam.image_width) == (376, 1232)
    with pytest.raises(KeyError, match="bogus"):
        from atdn_vslam_torch.config import _build

        _build(Config, {"bogus": 1})
