"""The port's serving export (``atdn_vslam_torch/serving.py``) on the CPU,
at 96x192 with 2 iterations, as the JAX ``tests/test_serving.py``: one
module-scoped export of the streaming step and the encoder from the
JAX package's initial weights (carried with ``convert.py``, GMA's gamma
non-zero, batch-norm statistics drawn away from identity), then

  * the loaded artifact against the eager ``make_stream_step`` (the same
    graph of the same ops: bitwise);
  * the port's artifact against the JAX ``serving.export_stream_step``
    artifact on the same weights, three frames chained through both
    (pose, flow, LSTM carry, feature map; ``JAX_TOL``);
  * the weights as call arguments, and another model's weights through
    the same artifact;
  * ``zero_inputs_like``;
  * a fresh process that loads the step and the encoder through
    ``atdn_vslam_torch.serving`` alone and never imports
    ``atdn_vslam_torch.models``.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from atdn_vslam_tpu import serving as jserving
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO

from atdn_vslam_torch import serving
from atdn_vslam_torch.convert import atdnvo_state_dict_from_jax, gma_state_dict_from_jax
from atdn_vslam_torch.models.factory import init_params
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.models.odometry import ATDNVO

torch.set_num_threads(1)

H, W, ITERS = 96, 192, 2  # the smallest size the ATDNVO encoder takes
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides: the flow as tests/test_torch_models.py holds it;
# the pose, carry and feature map, which the flow feeds or which the
# encoders give, within the same bounds after three chained frames
JAX_TOL = {"rtol": 1e-4, "atol": 2e-4}


def _perturb_batch_norm(tree, rng):
    def walk(params, stats):
        for key, node in stats.items():
            if "mean" in node:
                n = node["mean"].shape
                node["mean"] = rng.normal(scale=0.1, size=n).astype(np.float32)
                node["var"] = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
                params[key]["scale"] = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
                params[key]["bias"] = rng.normal(scale=0.1, size=n).astype(np.float32)
            else:
                walk(params[key], node)

    walk(tree["params"], tree["batch_stats"])
    return tree


def _jax_weights(seed):
    flow_model, odo_model = JRAFTGMA(iters=ITERS, use_pallas=False), JATDNVO()
    im = jnp.zeros((1, H, W, 3))
    to_np = lambda t: jax.tree.map(lambda x: np.array(x, np.float32), t)  # noqa: E731
    flow_vars = to_np(jax.jit(flow_model.init)(jax.random.key(seed), im, im))
    flow_vars["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array([0.7], np.float32)
    odo_vars = to_np(
        jax.jit(odo_model.init)(jax.random.key(seed + 1), jnp.zeros((1, 1, H, W, 2)), odo_model.init_carry(1))
    )
    rng = np.random.default_rng(seed)
    return flow_model, odo_model, _perturb_batch_norm(flow_vars, rng), _perturb_batch_norm(odo_vars, rng)


def _port_models(flow_vars, odo_vars):
    flow = RAFTGMA(iters=ITERS).eval()
    flow.load_state_dict(gma_state_dict_from_jax(flow_vars))
    odo = ATDNVO((H, W)).eval()
    odo.load_state_dict(atdnvo_state_dict_from_jax(odo_vars, (H, W)))
    return flow, odo


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jflow, jodo, flow_vars, odo_vars = _jax_weights(0)
    flow, odo = _port_models(flow_vars, odo_vars)
    out = tmp_path_factory.mktemp("serving")
    step_path, enc_path = out / "step.pt2", out / "encoder.pt2"
    serving.save_stream_step(serving.export_stream_step(flow, odo, None, None, H, W), step_path)
    serving.save_stream_step(serving.export_encoder(flow, None, H, W), enc_path)
    rng = np.random.default_rng(3)
    frames = [rng.uniform(0, 255, (H, W, 3)).astype(np.float32) for _ in range(4)]
    return {"jax": (jflow, jodo, flow_vars, odo_vars), "port": (flow, odo), "step": step_path,
            "encoder": enc_path, "frames": frames, "dir": out}


def _leaves(tree):
    return [x.detach() for x in pytree.tree_leaves(tree)]


def test_loaded_artifact_equals_eager_step(setup):
    flow, odo = setup["port"]
    im1, im2 = (torch.from_numpy(f) for f in setup["frames"][:2])
    step = serving.load_exported(setup["step"])
    encoder = serving.load_exported(setup["encoder"])
    fmap = encoder.call(im1)
    carry = serving.zero_inputs_like(step.exported, 3)
    got = step.call(im1, im2, fmap, carry, torch.eye(4))
    live = serving.make_stream_step(flow, odo, (flow.state_dict(), odo.state_dict()))
    with torch.no_grad():
        fmap_live = serving.encode_frame(flow, None, im1)
        want = live(im1, im2, fmap_live, odo.init_carry(1), torch.eye(4))
    assert torch.equal(fmap, fmap_live)
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the LSTM carry as ATDNVO makes it, one tensor four times, is accepted too
    again = step.call(im1, im2, fmap, odo.init_carry(1), torch.eye(4))
    for g, w in zip(_leaves(again), _leaves(got)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_artifact_chain_matches_jax_artifact(setup):
    """Three frames chained through the port's loaded artifact and through
    the JAX package's exported step (its own encoder artifact bootstraps
    the cache): every output of every step within JAX_TOL."""
    jflow, jodo, flow_vars, odo_vars = setup["jax"]
    frames = setup["frames"]
    jstep = jserving.export_stream_step(jflow, jodo, flow_vars, odo_vars, H, W)
    jcache = jserving.export_encoder(jflow, flow_vars, H, W).call(jnp.asarray(frames[0]))
    jcarry, jpose = jodo.init_carry(1), jnp.eye(4)

    step = serving.load_exported(setup["step"])
    fmap = serving.load_exported(setup["encoder"]).call(torch.from_numpy(frames[0]))
    np.testing.assert_allclose(fmap.numpy(), np.asarray(jcache[0]), **JAX_TOL)
    carry, pose = serving.zero_inputs_like(step.exported, 3), torch.eye(4)
    for im1, im2 in zip(frames[:-1], frames[1:]):
        jpose, jcache, jcarry, jflow_up = jstep.call(jnp.asarray(im1), jnp.asarray(im2), jcache, jcarry, jpose)
        pose, fmap, carry, flow_up = step.call(torch.from_numpy(im1), torch.from_numpy(im2), fmap, carry, pose)
        np.testing.assert_allclose(flow_up.numpy(), np.asarray(jflow_up), **JAX_TOL)
        np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), **JAX_TOL)
        np.testing.assert_allclose(fmap.numpy(), np.asarray(jcache[0]), **JAX_TOL)
        for g, w in zip(_leaves(carry), jax.tree.leaves(jcarry), strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL)
    r = pose.numpy()[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)  # still a rotation
    assert float(np.abs(flow_up.numpy()).max()) > 0.1  # the flow moved


def test_weights_as_arguments(setup):
    """``bake_weights=False``: the artifact takes the weights first, as
    plain ``dict``s; the same weights give the eager step's outputs, and
    another model's weights (seeded, gamma 0.5) give that model's."""
    flow, odo = setup["port"]
    frames = [torch.from_numpy(f) for f in setup["frames"][:2]]
    exported = serving.export_stream_step(flow, odo, None, None, H, W, bake_weights=False)
    path = setup["dir"] / "step_args.pt2"
    serving.save_stream_step(exported, path)
    step = serving.load_exported(path)
    other = tuple(init_params(copy.deepcopy(m), seed) for seed, m in enumerate((flow, odo), 2))
    with torch.no_grad():
        other[0].update_block.aggregator.gamma.fill_(0.5)
    live = serving.make_stream_step(flow, odo)
    for f, o in ((flow, odo), other):
        states = (dict(f.state_dict()), dict(o.state_dict()))
        with torch.no_grad():
            fmap = serving.encode_frame(flow, states[0], frames[0])
            want = live(*states, *frames, fmap, o.init_carry(1), torch.eye(4))
        got = step.call(*states, *frames, fmap, serving.zero_inputs_like(step.exported, 5), torch.eye(4))
        for g, w in zip(_leaves(got), _leaves(want), strict=True):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the two models' poses differ: the weights did reach the graph
    assert not torch.equal(got[0], step.call(*(dict(m.state_dict()) for m in (flow, odo)), *frames,
                                             serving.encode_frame(flow, None, frames[0]),
                                             serving.zero_inputs_like(step.exported, 5), torch.eye(4))[0])
    # the models keep their own weights after the functional calls
    for name, p in flow.state_dict().items():
        assert type(p) is torch.Tensor, name


def test_zero_inputs_like(setup):
    step = serving.load_exported(setup["step"])
    carry = serving.zero_inputs_like(step.exported, 3)
    assert isinstance(carry, tuple) and all(isinstance(c, tuple) and len(c) == 2 for c in carry)
    leaves = _leaves(carry)
    assert [tuple(x.shape) for x in leaves] == [(1, 512)] * 4
    assert all(x.dtype == torch.float32 and not x.any() for x in leaves)
    assert len({x.data_ptr() for x in leaves}) == 4  # four tensors, not one aliased
    fmap = serving.zero_inputs_like(step.exported, 2)
    assert fmap.shape == (1, H // 8, W // 8, 256)
    assert serving.zero_inputs_like(step.exported, 4).shape == (4, 4)


def test_bootstrap_in_a_fresh_process(setup):
    """The serving process: the two artifacts, ``atdn_vslam_torch.serving``
    and nothing of ``atdn_vslam_torch.models``; its pose and flow equal
    this process's eager step's."""
    flow, odo = setup["port"]
    frames = setup["frames"][:2]
    inputs = setup["dir"] / "frames.npy"
    np.save(inputs, np.stack(frames))
    result = setup["dir"] / "served.pt"
    code = f"""
import json, sys
import numpy as np
import torch
from atdn_vslam_torch import serving
torch.set_num_threads(1)  # the summation order of this process's eager step
step = serving.load_exported({str(setup['step'])!r})
encoder = serving.load_exported({str(setup['encoder'])!r})
im1, im2 = torch.from_numpy(np.load({str(inputs)!r}))
pose, fmap, carry, flow = step.call(im1, im2, encoder.call(im1), serving.zero_inputs_like(step.exported, 3),
                                    torch.eye(4))
torch.save({{"pose": pose, "flow": flow}}, {str(result)!r})
print(json.dumps({{"models_imported": any(m.startswith("atdn_vslam_torch.models") for m in sys.modules)}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"models_imported": False}
    served = torch.load(result)
    im1, im2 = (torch.from_numpy(f) for f in frames)
    with torch.no_grad():
        fmap = serving.encode_frame(flow, None, im1)
        pose, _, _, flow_up = serving.make_stream_step(flow, odo, (None, None))(
            im1, im2, fmap, odo.init_carry(1), torch.eye(4)
        )
    torch.testing.assert_close(served["pose"], pose, rtol=0, atol=0)
    torch.testing.assert_close(served["flow"], flow_up, rtol=0, atol=0)
