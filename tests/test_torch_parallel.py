"""The port's parallel paths (``atdn_vslam_torch.parallel``) on the CPU.

One spawn of two processes joined in a gloo group
(``tests/torch_parallel_worker.py``, which imports the port alone) runs
every case of the module: the row-split flow net and the three row-split
attention wrappers over a 1 x 2 mesh, the data-parallel train steps, the
sharded keyframe search, the edge-split pose-graph solve and the runtime
over a 2 x 1 mesh, and the odometry step with its parameters split over
the 1 x 2 mesh's "model" ranks (JAX ``model_parallel_sharding``). Each rank's result is held against the port's own
single-process result and, where the JAX package has the function,
against its sharded counterpart on a 2-device CPU mesh (``conftest.py``
gives JAX 8 virtual devices), with the tolerance beside each test.

The JAX package's batch norm computes in float32 on purpose
(``models/blocks.py`` ``BatchNorm``), so the odometry and map steps meet
JAX's sharded steps in float32 at the bounds the single-process tests use
(``test_torch_odometry_train.py``, ``test_torch_mapping_train.py``), and
the port's two ranks meet its single process in float64. The flow step
meets both in float64, as ``test_torch_flow_train.py`` does.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import atdn_vslam_tpu.models.flow.extractor as jextractor
import atdn_vslam_tpu.models.flow.network as jnetwork
import atdn_vslam_tpu.parallel.flow_sharding as jflow_sharding
from atdn_vslam_tpu.config import LossConfig as JLossConfig
from atdn_vslam_tpu.config import MappingTrainConfig as JMappingTrainConfig
from atdn_vslam_tpu.config import MeshConfig as JMeshConfig
from atdn_vslam_tpu.config import TrainConfig as JTrainConfig
from atdn_vslam_tpu.geometry.pose_graph import optimize_pose_graph_sharded as joptimize_sharded
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.mapping import MappingVAE as JMappingVAE
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO
from atdn_vslam_tpu.ops import attention as jattention
from atdn_vslam_tpu.parallel import make_mesh as jmake_mesh
from atdn_vslam_tpu.parallel.mesh import model_parallel_sharding as jmodel_parallel_sharding
from atdn_vslam_tpu.parallel import shard_batch as jshard_batch
from atdn_vslam_tpu.parallel import sharded_flow_infer as jsharded_flow_infer
from atdn_vslam_tpu.slam.keyframes import nearest_sharded as jnearest_sharded
from atdn_vslam_tpu.training import flow as jflow
from atdn_vslam_tpu.training import mapping as jmapping
from atdn_vslam_tpu.training import odometry as jodometry

from atdn_vslam_torch.config import (
    Config,
    FlowNetConfig,
    LossConfig,
    MappingTrainConfig,
    MeshConfig,
    SlamConfig,
    TrainConfig,
)
from atdn_vslam_torch.convert import atdnvo_state_dict_from_jax, gma_state_dict_from_jax, mapping_state_dict_from_jax
from atdn_vslam_torch.geometry.pose_graph import optimize_pose_graph
from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model, init_params
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.models.mapping import MappingVAE
from atdn_vslam_torch.models.odometry import ATDNVO
from atdn_vslam_torch.ops import attention
from atdn_vslam_torch.parallel import Mesh, distributed, make_mesh, shard_batch, tensor_parallel
from atdn_vslam_torch.slam import SlamRuntime
from atdn_vslam_torch.training import flow, mapping, odometry

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
WORLD = 2
FLOW_HW, FLOW_ITERS = (256, 64), 3  # 32 x 8 rows and columns at 1/8: bands of 16 rows, halo 6
FLASH_TOKENS = 100  # below the 256 tokens: the net attends in every iteration
# the JAX bound of its own sharded flow (tests/test_flow_network.py:221-226)
FLOW_ATOL = 5e-4
# float64 steps of the port, two ranks against one process
GRAD64_REL = 1e-6
LOSS64_RTOL = 1e-10
STATS64_TOL = {"rtol": 1e-9, "atol": 1e-12}
# float32 steps against the JAX package's sharded steps: the single-
# process bounds of test_torch_odometry_train.py / test_torch_mapping_train.py
GRAD32_REL = 1e-3
LOSS32_RTOL = 1e-6
STATS32_TOL = {"rtol": 1e-5, "atol": 1e-5}
# float64 flow step against JAX's: the coordinates stay float32 on both
# sides (test_torch_flow_train.py measured 3.4e-7); zero-gradient biases
# before an instance norm are rounding noise on each side
FLOW_GRAD_REL, FLOW_GRAD_ATOL = 1e-6, 1e-12
TRAIN_HW, TRAIN_B, TRAIN_ITERS, GAMMA = (64, 96), 2, 2, 0.8
LR, STEPS_TOTAL, WD, CLIP = 1e-3, 10, 1e-5, 1.0
ODO_HW, ODO_B, ODO_T = (72, 96), 2, 3
MAP_HW = (96, 192)
SPLIT_STEPS = 3  # the split step's steps, after which the replicated parameters are compared
# the parameters the JAX rule splits at 72x96 (the encoder's 16 x 512 is too small)
SPLIT_72X96 = {"lstm1.weight_ih", "lstm1.weight_hh", "lstm2.weight_ih", "lstm2.weight_hh",
               "lstm_linear.linear.weight", "rotation_regressor.0.linear.weight",
               "translation_regressor.0.linear.weight"}
POSE_ATOL = 1e-4  # tests/test_torch_pose_graph.py; the JAX sharded test's 1e-4
POSE_SPLIT_ATOL = 1e-5  # the port's own solve, edge sums added in another order
RUNTIME_HW = (96, 192)


def _jmesh(data: int, model: int):
    return jmake_mesh(JMeshConfig(data=data, model=model), devices=jax.devices()[:WORLD])


def _np32(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------------
# The cases: weights from the JAX package's initialisers, carried into the
# port's layout; data from numpy generators
# ----------------------------------------------------------------------


def _flow_case():
    model = JRAFTGMA(iters=FLOW_ITERS, use_pallas=False)
    im = jnp.zeros((1, *FLOW_HW, 3))
    variables = jax.tree.map(np.array, jax.jit(model.init)(jax.random.key(0), im, im))
    update = variables["params"]["update"]["GMAUpdateBlock_0"]
    update["Aggregate_0"]["gamma"] = np.array([0.5], np.float32)
    # flows of several pixels (up to ~5), so that a band edge computed
    # from too few halo rows moves them past FLOW_ATOL (one row short of
    # the GRU's reach: 1.3e-3 px)
    update["FlowHead_0"]["Conv_1"]["kernel"] = update["FlowHead_0"]["Conv_1"]["kernel"] * 4.0
    rng = np.random.default_rng(21)
    base = rng.uniform(0, 255, (1, FLOW_HW[0] + 8, FLOW_HW[1] + 8, 3)).astype(np.float32)
    im1, im2 = base[:, : FLOW_HW[0], : FLOW_HW[1]], base[:, 2 : FLOW_HW[0] + 2, 3 : FLOW_HW[1] + 3]
    return variables, np.ascontiguousarray(im1), np.ascontiguousarray(im2)


def _attention_case():
    rng = np.random.default_rng(5)
    h, w, d = 9, 8, 32  # an odd row count: bands of 5 and 4 rows
    n = h * w
    q, k, v = (rng.normal(size=(1, n, d)).astype(np.float32) for _ in range(3))
    p = rng.uniform(size=(1, h, w, n)).astype(np.float32)
    probs = np.zeros((1, h, w, 128), np.float32)
    probs[..., :n] = p / p.sum(-1, keepdims=True)  # K1's layout: zero columns up to 128
    return {"h": h, "w": w, "q": q, "k": k, "v": v, "probs": probs}


def _odometry_case():
    model = JATDNVO()
    jtc = JTrainConfig(batch_size=ODO_B, sequence_length=ODO_T)
    state = jodometry.init_state(model, jtc, 1, jnp.zeros((ODO_B, ODO_T, *ODO_HW, 2)), seed=2)
    rng = np.random.default_rng(6)
    batch = (
        rng.normal(scale=20.0, size=(ODO_B, ODO_T, *ODO_HW, 2)).astype(np.float32),
        rng.normal(scale=0.02, size=(ODO_B, ODO_T, 3)).astype(np.float32),
        rng.normal(scale=0.5, size=(ODO_B, ODO_T, 3)).astype(np.float32),
    )
    return state, batch


def _map_factors(key, b):
    """The factors the JAX ``color_jitter(key, ...)`` draws
    (test_torch_mapping_train.py)."""
    r1, r2, r3 = jax.random.split(key, 3)
    bf = jax.random.uniform(r1, (b, 1, 1, 1), minval=0.9, maxval=1.1)
    sf = jax.random.uniform(r2, (b, 1, 1, 1), minval=0.9, maxval=1.1)
    first = jax.random.bernoulli(r3, 0.5, (b, 1, 1, 1))
    return tuple(torch.from_numpy(np.array(a).reshape(-1)) for a in (bf, sf, first))


def _map_case():
    jcfg = JMappingTrainConfig(epochs=1, batch_size=2, seed=0)
    state = jmapping.init_state(JMappingVAE(), jcfg, 1, jnp.zeros((2, *MAP_HW, 3)))
    images = np.random.default_rng(4).integers(0, 256, (2, *MAP_HW, 3), dtype=np.uint8)
    return state, images, jax.random.key(7)


def _flow_train_case(flow_variables):
    """The flow case's weights at 64x96, batch 2, with ground truth,
    a valid mask and flow beyond MAX_FLOW (test_torch_flow_train.py)."""
    h, w = TRAIN_HW
    rng = np.random.default_rng(20)
    base = rng.uniform(0, 255, (TRAIN_B, h + 8, w + 8, 3))
    flow_gt = np.stack([np.full((TRAIN_B, h, w), -5.0), np.full((TRAIN_B, h, w), -3.0)], -1)
    flow_gt = flow_gt + rng.normal(scale=0.5, size=flow_gt.shape)
    flow_gt[0, :4, :4] = 500.0
    valid = (rng.uniform(size=(TRAIN_B, h, w)) > 0.2).astype(np.float64)
    data = (base[:, :h, :w], base[:, 3 : h + 3, 5 : w + 5], flow_gt, valid)
    as_f32 = lambda x: np.asarray(x, np.float32).astype(np.float64)  # noqa: E731
    variables = jax.tree.map(as_f32, flow_variables)
    return variables, tuple(as_f32(x) for x in data)


def _drifted_graph():
    """A chain of 26 poses with odometry drift and two closures, 27 edges,
    which two ranks do not divide (``test_torch_pose_graph.py``'s graph:
    1 m steps with a 0.1 rad turn, closures on the true relative pose)."""
    from atdn_vslam_tpu.geometry import pose_graph as jpg

    n = 26
    rng = np.random.default_rng(26)
    step = np.asarray(jpg.se3_exp(jnp.asarray([0, 0, 1.0, 0, 0.1, 0], jnp.float32)), np.float64)
    gt = [np.eye(4)]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    drift = np.asarray(jpg.se3_exp(jnp.asarray(rng.normal(scale=0.03, size=(n - 1, 6)), jnp.float32)), np.float64)
    poses = [gt[0]]
    for i in range(n - 1):
        poses.append(poses[-1] @ np.linalg.inv(gt[i]) @ gt[i + 1] @ drift[i])
    poses = np.stack(poses).astype(np.float32)
    ci, cj = np.array([0, n // 2]), np.array([n - 1, n - 1])
    meas = np.concatenate([np.linalg.inv(poses[:-1]) @ poses[1:], np.linalg.inv(gt[ci]) @ gt[cj]])
    weights = np.r_[np.ones(n - 1), np.full(2, 4.0)].astype(np.float32)
    ei, ej = np.r_[np.arange(n - 1), ci], np.r_[np.arange(1, n), cj]
    return tuple(torch.from_numpy(x) for x in (poses, ei, ej, meas.astype(np.float32), weights))


def _runtime_case(work):
    h, w = RUNTIME_HW
    cfg = Config(
        keyframes_path=str(work / "kf_single"),
        flow=FlowNetConfig(iters=2, mixed_precision=False),
        slam=SlamConfig(image_height=h, image_width=w, rotation_threshold_deg=0.0, translation_threshold=0.0),
        mapping_train=MappingTrainConfig(epochs=1, batch_size=2, seed=0),
    )
    flow_model = init_params(build_flow_model(cfg, "cpu"), 0)
    with torch.no_grad():
        flow_model.update_block.aggregator.gamma.fill_(0.5)
    odo = init_params(build_odometry_model(cfg, "cpu"), 1)
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (h + 6, w + 12, 3), dtype=np.uint8)
    frames = [np.ascontiguousarray(base[i : i + h, 2 * i : 2 * i + w]) for i in range(5)]
    return {"config": cfg, "flow": flow_model.state_dict(), "odometry": odo.state_dict(), "frames": frames,
            "queries": [frames[1], frames[3]], "dir": str(work)}


def _single_checkpoint(case: dict, directory: str) -> None:
    """One float64 step of one process from the case's weights, saved as
    stage 1 in ``directory``: the checkpoint the split ranks load."""
    model = _as_float64(ATDNVO(case["hw"]))
    model.load_state_dict(case["state_dict"])
    st = odometry.OdometryTrainState(model, *odometry.make_optimizer(model, case["train_cfg"], case["steps"]))
    odometry.train_step(st, *(x.double() for x in case["batch"]), LossConfig(alpha=case["alpha"]))
    odometry.save_checkpoint(Config(checkpoint_dir=directory), 1, st)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    flow_vars, im1, im2 = _flow_case()
    odo_state, odo_batch = _odometry_case()
    odo_vars = _np32({"params": odo_state.params, "batch_stats": odo_state.batch_stats})
    odo_case = {"state_dict": atdnvo_state_dict_from_jax(odo_vars, ODO_HW), "hw": ODO_HW,
                "train_cfg": TrainConfig(), "alpha": 0.5,
                "batch": tuple(torch.from_numpy(np.asarray(x)) for x in odo_batch)}
    split_case = {**odo_case, "steps": SPLIT_STEPS, "checkpoint_dir": str(work / "ckpt"),
                  "single_checkpoint_dir": str(work / "ckpt" / "single")}
    _single_checkpoint(split_case, split_case["single_checkpoint_dir"])
    map_state, map_images, map_key = _map_case()
    map_vars = _np32({"params": map_state.params, "batch_stats": map_state.batch_stats})
    train_vars, train_data = _flow_train_case(flow_vars)
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(7, 16)).astype(np.float32)
    emb[5] = emb[2]  # equal codes: the lower index wins
    codes = {"random": rng.normal(size=16).astype(np.float32), "tie": emb[2] + 0.25}
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    port = {
        "flow": {"state_dict": gma_state_dict_from_jax(flow_vars), "iters": FLOW_ITERS, "im1": t(im1),
                 "im2": t(im2), "flash_tokens": FLASH_TOKENS},
        "attention": {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in _attention_case().items()},
        "odometry": odo_case,
        "split_odometry": split_case,
        "mapping": {"state_dict": mapping_state_dict_from_jax(map_vars), "images": t(map_images),
                    "factors": _map_factors(map_key, 2)},
        "flow_train": {"state_dict": gma_state_dict_from_jax(train_vars), "iters": TRAIN_ITERS,
                       "optimizer": (LR, STEPS_TOTAL, WD, CLIP, "warmcos"), "gamma": GAMMA,
                       "batch": tuple(t(x) for x in train_data)},
        "nearest": {"embeddings": emb, "codes": codes},
        "pose_graph": {"graph": _drifted_graph(), "iterations": 6},
        "runtime": _runtime_case(work),
    }
    jax_side = {"flow": flow_vars, "odometry": (odo_state, odo_batch), "mapping": (map_state, map_images, map_key),
                "flow_train": (train_vars, train_data)}
    return work, port, jax_side


class Ranks:
    """The worker processes (``world`` of them, the worker's arguments
    after the work directory in ``args``); :meth:`get` waits for their
    results."""

    def __init__(self, work, port, world: int = WORLD, args: tuple = ()):
        torch.save(port, work / "inputs.pt")
        addr = str(_free_port())
        self.work, self.world = work, world
        self.logs = [work / f"rank{r}.log" for r in range(world)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, WORKER, str(r), str(world), addr, str(work), *args], stdout=f,
                    stderr=subprocess.STDOUT,
                ))
        self.results = None

    def get(self) -> list[dict]:
        if self.results is None:
            for r, p in enumerate(self.procs):
                p.wait(timeout=600)
                assert p.returncode == 0, f"rank {r} failed:\n{self.logs[r].read_text()[-4000:]}"
            self.results = [torch.load(self.work / f"rank{r}.pt", weights_only=False) for r in range(self.world)]
        return self.results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(cases):
    work, port, _ = cases
    r = Ranks(work, port)
    yield r
    r.close()


# ----------------------------------------------------------------------
# Bootstrap, mesh and the host helpers (this process alone)
# ----------------------------------------------------------------------


def test_multiprocess_config_from_env_and_arguments(monkeypatch):
    for name in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES, distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    assert distributed.multiprocess_config() is None
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "localhost:1234")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "4")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "3")
    assert distributed.multiprocess_config() == ("localhost:1234", 4, 3)
    assert distributed.multiprocess_config("h:9", 2, 1) == ("h:9", 2, 1)  # the arguments first


def test_multiprocess_config_partial_is_an_error(monkeypatch):
    for name in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES, distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    with pytest.raises(ValueError, match="all three"):
        distributed.multiprocess_config()
    with pytest.raises(ValueError, match="all three"):
        distributed.multiprocess_config("localhost:1", 2)


def test_initialize_is_false_on_a_single_process(monkeypatch):
    for name in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES, distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.default_backend("cuda") == "nccl" and distributed.default_backend("cpu") == "gloo"


@pytest.mark.parametrize("index,count,want", [(0, 3, [0, 3, 6]), (2, 3, [2, 5]), (None, None, list(range(8)))])
def test_host_shard(index, count, want):
    """Round-robin, as the JAX package's; a single process takes all."""
    from atdn_vslam_tpu.parallel.distributed import host_shard as jhost_shard

    items = list(range(8))
    assert distributed.host_shard(items, index, count) == want
    if index is not None:
        assert jhost_shard(items, index, count) == want
    assert distributed.allgather_host_arrays(np.arange(3))[0].tolist() == [0, 1, 2]


def test_single_process_mesh_and_shard_batch():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    x = torch.arange(6).reshape(3, 2)
    assert torch.equal(shard_batch(mesh, x), x)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(MeshConfig(data=2, model=1))


def test_shard_batch_refuses_an_indivisible_batch():
    """The JAX package's rule (``mesh.py:88-93``); a data axis of two,
    this process its first rank, takes the first half."""
    with pytest.raises(ValueError, match="not divisible"):
        jshard_batch(_jmesh(2, 1), (jnp.zeros((3, 4)),))
    two = Mesh(data=2, model=1)
    with pytest.raises(ValueError, match="not divisible by data-axis size 2"):
        shard_batch(two, (torch.zeros(3, 4),))
    a, b = shard_batch(two, (torch.arange(4), np.arange(8).reshape(4, 2)))
    assert a.tolist() == [0, 1] and b.tolist() == [[0, 1], [2, 3]]


@pytest.mark.parametrize("n,size", [(32, 2), (9, 2), (47, 4), (3, 3)])
def test_band_bounds_cover_the_rows(n, size):
    bands = [distributed.band_bounds(n, size, i) for i in range(size)]
    assert bands[0][0] == 0 and bands[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert max(hi - lo for lo, hi in bands) - min(hi - lo for lo, hi in bands) <= 1


# ----------------------------------------------------------------------
# Row-split flow and attention
# ----------------------------------------------------------------------


@pytest.mark.parametrize("regime", ["materialize", "flash"])
def test_row_split_flow_matches(regime, cases, ranks):
    """Both ranks' flows within FLOW_ATOL of the port's unsplit flow and
    of the JAX package's ``sharded_flow_infer`` on a 1 x 2 mesh; the
    bands (16 rows) plus the halo (6) are smaller than the 32 rows."""
    _, port, jax_side = cases
    jmodel = JRAFTGMA(iters=FLOW_ITERS, use_pallas=False)
    case = port["flow"]
    im1, im2 = (jnp.asarray(case[k].numpy()) for k in ("im1", "im2"))
    with pytest.MonkeyPatch.context() as mp:
        if regime == "flash":
            mp.setattr(jnetwork, "_MATERIALIZE_MAX_TOKENS", FLASH_TOKENS)
            mp.setattr(attention, "_MATERIALIZE_MAX_TOKENS", FLASH_TOKENS)
            mp.setattr(attention, "_FLASH_MIN_TOKENS", FLASH_TOKENS)
        jflow_sharding._sharded_infer_fn.cache_clear()  # a trace per regime
        jlow, jup = jsharded_flow_infer(jmodel, jax_side["flow"], im1, im2, _jmesh(1, WORLD))
        model = RAFTGMA(iters=FLOW_ITERS)
        model.load_state_dict(case["state_dict"])
        with torch.no_grad():
            low, up = model.eval()(case["im1"], case["im2"])
    assert float(np.abs(np.asarray(jup)).max()) > 2.0  # flows of pixels
    for out in ranks.get():
        got_low, got_up = out["flow"][regime]
        for got, want in ((got_low, low), (got_up, up)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FLOW_ATOL)
        np.testing.assert_allclose(got_low.numpy(), np.asarray(jlow), rtol=0, atol=FLOW_ATOL)
        np.testing.assert_allclose(got_up.numpy(), np.asarray(jup), rtol=0, atol=FLOW_ATOL)


@pytest.mark.parametrize("which", ["probs", "attend", "apply"])
def test_row_split_attention_wrappers_match(which, cases, ranks):
    """Each rank's band of K1, K5 and K4 (their plain versions on the CPU)
    against the same rows of the unsplit call and of the JAX package's
    sharded kernel on a 1 x 2 mesh (interpret mode), float32 products of
    either order: 1e-5."""
    _, port, _ = cases
    c = port["attention"]
    h, w = c["h"], c["w"]
    n = h * w
    q, k, v, probs = (c[x] for x in ("q", "k", "v", "probs"))
    jq, jk, jv, jp = (jnp.asarray(x.numpy()) for x in (q, k, v, probs))
    mesh = _jmesh(1, WORLD)
    scale = q.shape[-1] ** -0.5
    if which == "probs":
        want = attention.attention_probs_spatial(q, k, h, w)
        jwant = jattention.sharded_flash_probs_spatial(jq, jk, h, w, scale, mesh=mesh, axis="model",
                                                       interpret=True)
    elif which == "attend":
        want = attention.flash_attend(q, k, v).reshape(1, h, w, -1)
        jwant = jattention.sharded_flash_attend(jq, jk, jv, mesh=mesh, axis="model", interpret=True)
        jwant = jwant.reshape(1, h, w, -1)
    else:
        want = attention.flash_apply_probs(probs, v)
        jwant = jattention.sharded_flash_apply_probs(jp, jv, mesh=mesh, axis="model", interpret=True)
    jwant = np.asarray(jwant)[..., :n] if which == "probs" else np.asarray(jwant)
    for r, out in enumerate(ranks.get()):
        lo, hi = distributed.band_bounds(h, WORLD, r)
        got = out["attention"][which].reshape(1, hi - lo, w, -1)
        np.testing.assert_allclose(got.numpy(), want[:, lo:hi].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy()[..., : jwant.shape[-1]], jwant[:, lo:hi], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="band"):  # a band of the wrong rows
        attention.sharded_flash_apply_probs(probs[:, :4], v, mesh=make_mesh(), h=h)


# ----------------------------------------------------------------------
# Data-parallel train steps
# ----------------------------------------------------------------------


def _keep_grads():
    """An optimizer whose state is the gradients (its step hands them back)."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _check_grads(got: dict, want: dict, rel: float, atol: float = 0.0, skip=()) -> None:
    for name, g in got.items():
        if name in skip:
            continue
        r = want[name].double()
        scale = float(r.abs().max())
        err = float((g.double() - r).abs().max())
        assert err <= rel * scale + atol, f"{name}: gradient differs by {err} > {rel} x {scale} + {atol}"


def _check_stats(got: dict, want: dict, tol: dict) -> None:
    assert got.keys() == want.keys() and got
    for name, value in got.items():
        np.testing.assert_allclose(value.double().numpy(), want[name].double().numpy(), err_msg=name, **tol)


def _port_step_result(model, metrics):
    return {
        "metrics": {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)},
        "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
        "stats": {k: v.clone() for k, v in model.state_dict().items() if "running" in k},
    }


def _as_float64(model):
    model.double()
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return model


def jax_odometry_step(state, batch, jmesh, split: bool = False):
    """The JAX package's odometry step on ``jmesh`` (with ``split``, its
    state placed by ``model_parallel_sharding``, at least one leaf over
    "model") whose optimizer hands back the gradients (call it with
    ``jodometry.make_optimizer`` patched to :func:`_keep_grads`): the
    metrics, and the gradients and new batch statistics as port
    ``state_dict``s."""
    jtc = JTrainConfig(batch_size=ODO_B, sequence_length=ODO_T)
    sharding = None
    if split:
        state = jax.device_get(state.replace(opt_state=_keep_grads().init(state.params)))
        sharding = jmodel_parallel_sharding(jmesh, state)
        assert any("model" in str(s.spec) for s in jax.tree.leaves(sharding))
        state = jax.device_put(state, sharding)
    step = jodometry.make_train_step(JATDNVO(), jtc, JLossConfig(alpha=0.5), 1, mesh=jmesh, donate=False,
                                     state_sharding=sharding)
    new_state, jmetrics = step(state, *jshard_batch(jmesh, tuple(jnp.asarray(x) for x in batch)))
    jgrads = atdnvo_state_dict_from_jax(
        {"params": _np32(new_state.opt_state), "batch_stats": _np32(state.batch_stats)}, ODO_HW
    )
    jstats = atdnvo_state_dict_from_jax(
        _np32({"params": state.params, "batch_stats": new_state.batch_stats}), ODO_HW
    )
    return jmetrics, jgrads, jstats


def single_odometry_step64(case: dict) -> dict:
    """The port's float64 step of one process on the case's whole batch."""
    model = _as_float64(ATDNVO(case["hw"]))
    model.load_state_dict(case["state_dict"])
    opt, sched = odometry.make_optimizer(model, case["train_cfg"], 1)
    st = odometry.OdometryTrainState(model, opt, sched)
    metrics = odometry.train_step(st, *(x.double() for x in case["batch"]), LossConfig(alpha=case["alpha"]))
    return _port_step_result(model, metrics)


def check_step64(got: dict, single: dict) -> None:
    """A float64 step of the ranks against one process's: the loss, the
    global gradient norm, every gradient within 1e-6 of its largest
    entry, the batch statistics."""
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(single["metrics"]["loss"]), rtol=LOSS64_RTOL)
    np.testing.assert_allclose(float(got["metrics"]["grad_norm"]), float(single["metrics"]["grad_norm"]),
                               rtol=GRAD64_REL)
    assert got["grads"].keys() == single["grads"].keys()
    _check_grads(got["grads"], single["grads"], GRAD64_REL)
    _check_stats(got["stats"], single["stats"], STATS64_TOL)


def check_step32_jax(got: dict, jmetrics, jgrads: dict, jstats: dict) -> None:
    """A float32 step of the ranks against the JAX package's: the loss and
    every gradient at the single-process bounds (flax's LSTM has one bias
    per gate where the port keeps two equal ones), the batch statistics."""
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(jmetrics["loss"]), rtol=LOSS32_RTOL)
    _check_grads(got["grads"], jgrads, GRAD32_REL, skip={n for n in got["grads"] if n.endswith("bias_ih")})
    _check_stats(got["stats"], {k: jstats[k] for k in got["stats"]}, STATS32_TOL)


def test_data_parallel_odometry_step_matches(cases, ranks, monkeypatch):
    """Two ranks of batch 1 each against one process on batch 2 (float64:
    loss, every gradient within 1e-6 of its largest entry, batch
    statistics) and against the JAX package's step on a 2 x 1 mesh
    (float32, the single-process bounds)."""
    _, port, jax_side = cases
    monkeypatch.setattr(jodometry, "make_optimizer", lambda cfg, steps_total: _keep_grads())
    jmetrics, jgrads, jstats = jax_odometry_step(*jax_side["odometry"], _jmesh(WORLD, 1))
    single = single_odometry_step64(port["odometry"])
    for out in ranks.get():
        got = out["odometry"]
        check_step64(got[str(torch.float64)], single)
        check_step32_jax(got[str(torch.float32)], jmetrics, jgrads, jstats)


# ----------------------------------------------------------------------
# The tensor-parallel split over the 1 x 2 mesh's "model" ranks
# ----------------------------------------------------------------------


def test_split_odometry_step_matches_one_process(cases, ranks):
    """The rule's parameters split over two model ranks, each with the
    whole batch: float64 against one process (the data-parallel bounds,
    on the gathered gradients)."""
    _, port, _ = cases
    single = single_odometry_step64(port["odometry"])
    for out in ranks.get():
        check_step64(out["split_odometry"][str(torch.float64)], single)


def test_split_odometry_step_matches_jax_state_sharding(cases, ranks, monkeypatch):
    """float32 against the JAX package's step on a 1 x 2 mesh with the
    state placed by its ``model_parallel_sharding``."""
    _, _, jax_side = cases
    monkeypatch.setattr(jodometry, "make_optimizer", lambda cfg, steps_total: _keep_grads())
    jmetrics, jgrads, jstats = jax_odometry_step(*jax_side["odometry"], _jmesh(1, WORLD), split=True)
    for out in ranks.get():
        check_step32_jax(out["split_odometry"][str(torch.float32)], jmetrics, jgrads, jstats)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_split_parameters_and_moments_are_half(dtype, ranks):
    """On each rank the rule split the LSTM, the LSTM link's and the
    heads' first weights (the 128 x 512 heads at exactly 65,536
    elements); each split parameter and both its AdamW moments hold half
    of the whole tensor."""
    for out in ranks.get():
        got = out["split_odometry"][str(dtype)]
        assert {n for n, v in got["sharding"].items() if v} == SPLIT_72X96 == set(got["split"])
        for name, (local, whole, exp_avg, exp_avg_sq) in got["split"].items():
            assert 2 * local == whole and exp_avg == exp_avg_sq == local, name


def test_split_replicated_parameters_stay_bitwise_equal(ranks):
    """After SPLIT_STEPS float32 steps every replicated parameter is
    bitwise equal on the two model ranks."""
    a, b = (out["split_odometry"][str(torch.float32)]["replicated"] for out in ranks.get())
    assert a.keys() == b.keys() and len(a) > 0 and not (a.keys() & SPLIT_72X96)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_split_checkpoint_loads_into_one_process(cases, ranks):
    """The split ranks' checkpoint holds the whole state: it loads into
    one process's unsplit model and optimiser with parameters and moments
    equal to the ranks' gathered ones."""
    _, port, _ = cases
    c = port["split_odometry"]
    rank0 = ranks.get()[0]["split_odometry"][str(torch.float64)]
    model = _as_float64(ATDNVO(ODO_HW))
    st = odometry.OdometryTrainState(model, *odometry.make_optimizer(model, c["train_cfg"], c["steps"]))
    odometry.load_checkpoint(Config(checkpoint_dir=os.path.join(c["checkpoint_dir"], "split")), 1, st)
    assert st.step == 1
    for name, value in model.state_dict().items():
        assert torch.equal(value, rank0["whole_state"][name]), name
    names = [n for n, _ in model.named_parameters()]
    moments = st.optimizer.state_dict()["state"]
    assert moments.keys() == rank0["whole_moments"].keys()
    for i, m in moments.items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(m[k], rank0["whole_moments"][i][k]), (names[i], k)


def test_one_process_checkpoint_loads_onto_split_ranks(cases, ranks):
    """A one-process checkpoint after one step, loaded onto the split
    ranks: their next step equals one process's next step (float64
    bounds)."""
    _, port, _ = cases
    c = port["split_odometry"]
    model = _as_float64(ATDNVO(ODO_HW))
    st = odometry.OdometryTrainState(model, *odometry.make_optimizer(model, c["train_cfg"], c["steps"]))
    odometry.load_checkpoint(Config(checkpoint_dir=c["single_checkpoint_dir"]), 1, st)
    metrics = odometry.train_step(st, *(x.double() for x in c["batch"]), LossConfig(alpha=c["alpha"]))
    single = _port_step_result(model, metrics)
    for out in ranks.get():
        got = out["loaded_split_step"]
        assert got["step"] == st.step == 2
        check_step64(got, single)


def test_data_parallel_map_step_matches(cases, ranks, monkeypatch):
    """The map's step at 96x192, batch 2 split over two ranks, the jitter
    factors drawn for the whole batch: float64 against one process,
    float32 against the JAX package's step on a 2 x 1 mesh."""
    _, port, jax_side = cases
    c = port["mapping"]
    state, images, key = jax_side["mapping"]
    monkeypatch.setattr(jmapping, "make_optimizer", lambda cfg, steps_total: _keep_grads())
    jcfg = JMappingTrainConfig(epochs=1, batch_size=2, seed=0)
    jmesh = _jmesh(WORLD, 1)
    new_state, jloss = jmapping.make_train_step(JMappingVAE(), jcfg, 1, mesh=jmesh, donate=False)(
        state, key, *jshard_batch(jmesh, (jnp.asarray(images),))
    )
    jgrads = mapping_state_dict_from_jax({"params": _np32(new_state.opt_state), "batch_stats": _np32(state.batch_stats)})
    jstats = mapping_state_dict_from_jax(_np32({"params": state.params, "batch_stats": new_state.batch_stats}))

    model = _as_float64(MappingVAE())
    model.load_state_dict(c["state_dict"])
    opt, sched = mapping.make_optimizer(model, MappingTrainConfig(epochs=1, batch_size=2, seed=0), 1)
    loss = mapping.train_step(model, opt, sched, c["images"], c["factors"])
    single = _port_step_result(model, {"loss": loss})
    for out in ranks.get():
        g64, g32 = out["mapping"][str(torch.float64)], out["mapping"][str(torch.float32)]
        np.testing.assert_allclose(float(g64["metrics"]["loss"]), float(loss), rtol=LOSS64_RTOL)
        _check_grads(g64["grads"], single["grads"], GRAD64_REL)
        _check_stats(g64["stats"], single["stats"], STATS64_TOL)
        np.testing.assert_allclose(float(g32["metrics"]["loss"]), float(jloss), rtol=LOSS32_RTOL)
        _check_grads(g32["grads"], jgrads, GRAD32_REL)
        _check_stats(g32["stats"], {k: jstats[k] for k in g32["stats"]}, STATS32_TOL)


def _wide_instance_norm(x, eps=1e-5):
    """The JAX ``instance_norm`` in the input's type (test_torch_flow_train.py)."""
    n = x.shape[-3] * x.shape[-2]
    mean = jnp.sum(x, axis=(-3, -2), keepdims=True) / n
    var = jnp.maximum(jnp.sum(x * x, axis=(-3, -2), keepdims=True) / n - mean * mean, 0.0)
    return (x - mean) * jax.lax.rsqrt(var + eps)


def test_data_parallel_flow_step_matches(cases, ranks):
    """The flow step in float64, batch 2 split over two ranks: the loss
    divides by the whole batch's valid pixels and the gradients are
    summed; loss, metrics, grad_norm (the clip's input), every clipped
    gradient and the batch statistics against one process (1e-6), and
    the loss and every gradient against the JAX package's step on a 2 x 1
    mesh (FLOW_GRAD_REL)."""
    _, port, jax_side = cases
    c = port["flow_train"]
    variables, data = jax_side["flow_train"]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jextractor, "instance_norm", _wide_instance_norm)
        jmodel = JRAFTGMA(iters=TRAIN_ITERS, use_pallas=False, dtype=jnp.float64)
        jmesh = _jmesh(WORLD, 1)
        tx = _keep_grads()
        v = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), variables)
        jstate = jflow.FlowTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                      batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
        jbatch = jshard_batch(jmesh, tuple(jnp.asarray(x, jnp.float64) for x in data))
        new_state, jmetrics = jflow.make_train_step(jmodel, tx, GAMMA, mesh=jmesh)(jstate, *jbatch)
        jgrads = jax.tree.map(np.asarray, new_state.opt_state)
        jloss = float(jmetrics["loss"])
    want = gma_state_dict_from_jax({"params": jgrads, "batch_stats": variables["batch_stats"]})

    model = _as_float64(RAFTGMA(iters=TRAIN_ITERS))
    model.load_state_dict(c["state_dict"])
    st = flow.init_state(model, *c["optimizer"], seed=None)
    st, metrics = flow.train_step(st, *(x.double() for x in c["batch"]), gamma=GAMMA)
    single = _port_step_result(model, metrics)
    for out in ranks.get():
        got = out["flow_train"]
        for name in ("loss", "epe", "1px", "3px", "5px", "grad_norm"):
            np.testing.assert_allclose(float(got["metrics"][name]), float(single["metrics"][name]),
                                       rtol=GRAD64_REL, err_msg=name)
        _check_grads(got["grads"], single["grads"], GRAD64_REL, FLOW_GRAD_ATOL)
        _check_stats(got["stats"], single["stats"], STATS64_TOL)
        np.testing.assert_allclose(float(got["metrics"]["loss"]), jloss, rtol=1e-7)
        norm = float(got["metrics"]["grad_norm"])
        unclipped = {n: g * (norm / CLIP if norm >= CLIP else 1.0) for n, g in got["grads"].items()}
        _check_grads(unclipped, want, FLOW_GRAD_REL, FLOW_GRAD_ATOL)


# ----------------------------------------------------------------------
# The keyframe search, the pose graph and the runtime
# ----------------------------------------------------------------------


@pytest.mark.parametrize("which", ["random", "tie"])
def test_nearest_sharded_matches(which, cases, ranks):
    """7 keyframes over two ranks (4 + 3 and a +inf pad); equal codes at
    2 and 5 tie and the lower index wins, as ``jnp.argmin``; the same
    index and distances (float32: 1e-5) as the host search and the JAX
    package's sharded search."""
    _, port, _ = cases
    emb, code = port["nearest"]["embeddings"], port["nearest"]["codes"][which]
    jidx, jd = jnearest_sharded(_jmesh(WORLD, 1), emb, code)
    d = np.linalg.norm(emb - code[None], axis=1)
    if which == "tie":
        assert d[2] == d[5] and int(np.argmin(d)) == 2
    for out in ranks.get():
        idx, dist = out["nearest"][which]
        assert idx == int(np.argmin(d)) == jidx
        np.testing.assert_allclose(dist, d, rtol=1e-5)
        np.testing.assert_allclose(dist, jd, rtol=1e-5)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_sharded_matches(solver, cases, ranks):
    """27 edges over two ranks (a weight-0 self-edge pads them), 6
    Gauss-Newton iterations: the
    poses against the port's single solve (POSE_SPLIT_ATOL) and the JAX
    package's sharded solve (POSE_ATOL); the mean squared residual
    against the single solve's (the JAX one also counts the pad)."""
    _, port, _ = cases
    graph, iters = port["pose_graph"]["graph"], port["pose_graph"]["iterations"]
    want, want_mse = optimize_pose_graph(*graph, iterations=iters, solver=solver)
    jgraph = [jnp.asarray(x.numpy()) for x in graph]
    jpose, _ = joptimize_sharded(_jmesh(WORLD, 1), *jgraph, iterations=iters, solver=solver)
    for out in ranks.get():
        got, mse = out["pose_graph"][solver]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=POSE_SPLIT_ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jpose), rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(float(mse), float(want_mse), rtol=1e-4, atol=1e-12)


def test_runtime_with_a_mesh_matches_one_process(cases, ranks):
    """``SlamRuntime(mesh=...)`` over two ranks: streamed poses, the
    nearest keyframe of each query and its refined pose equal to the
    single-process runtime's (the map trained on the split batch)."""
    work, port, _ = cases
    c = port["runtime"]
    rt = SlamRuntime(c["config"], c["flow"], c["odometry"], device="cpu")
    rt.start_odometry()
    poses = np.stack([rt(f) for f in c["frames"]])
    rt.end_odometry()
    answers = [rt(f) for f in c["queries"]]
    for out in ranks.get():
        np.testing.assert_array_equal(out["runtime"]["poses"], poses)
        for (init, refined, dist), (w_init, w_refined, w_dist) in zip(out["runtime"]["answers"], answers):
            assert int(np.argmin(dist)) == int(np.argmin(w_dist))
            np.testing.assert_array_equal(init, w_init)
            np.testing.assert_array_equal(refined, w_refined)


def test_mesh_layout_of_the_ranks(ranks):
    res = ranks.get()
    for r, out in enumerate(res):
        assert out["mesh"] == {"rows": {"data": 1, "model": 2}, "batch": {"data": 2, "model": 1},
                               "model_index": r, "data_index": r}
