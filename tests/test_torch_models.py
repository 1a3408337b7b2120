"""The port's models against the JAX package on the CPU, on the same
weights: JAX variables carried into the port with
``atdn_vslam_torch.convert`` (and back through
``tools/convert_torch_checkpoint.py``, exactly), then RAFTGMA in test
mode and ATDNVO on the same numpy-made inputs, float32 throughout
except for one test of the flow net in bfloat16.

GMA's ``gamma`` is set non-zero and the batch-norm statistics are
drawn away from their initial values before the weights are carried:
at gamma = 0 the attention path (and kernel K1's contract) would not
reach the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO
from tools.convert_torch_checkpoint import convert_atdnvo, convert_gma

from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig
from atdn_vslam_torch.convert import atdnvo_state_dict_from_jax, gma_state_dict_from_jax
from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model, cast_flow_model
from atdn_vslam_torch.models.flow.network import RAFTGMA

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 64, 96  # flow: 8x12 features, four levels down to 1x1
ODO_H, ODO_W = 96, 192  # the smallest size the ATDNVO encoder takes
ITERS = 3


def _to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _perturb_batch_norm(tree, rng):
    """Batch-norm scale/bias and statistics drawn away from identity."""
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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def gma():
    model = JRAFTGMA(iters=ITERS, use_pallas=False)
    im = jnp.zeros((1, H, W, 3))
    variables = _to_numpy(model.init(jax.random.key(0), im, im))
    variables["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array(
        [0.7], np.float32
    )
    variables = _perturb_batch_norm(variables, np.random.default_rng(10))
    cfg = Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False))
    port = build_flow_model(cfg, "cpu")
    port.load_state_dict(gma_state_dict_from_jax(variables))
    return model, variables, port


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 255, (1, H + 8, W + 8, 3)).astype(np.float32)
    return base[:, :H, :W], base[:, 3 : H + 3, 5 : W + 5]  # a shifted view


def test_gma_weights_round_trip_exactly(gma):
    _, variables, _ = gma
    _assert_same_tree(convert_gma(gma_state_dict_from_jax(variables)), variables)


def test_atdnvo_weights_round_trip_exactly():
    """At the KITTI size, where the converter's flatten permutation is
    defined (16 x 4 x 13 = 832); shapes from eval_shape, random values."""
    model = JATDNVO()
    flows = jnp.zeros((1, 1, 376, 1232, 2))
    shapes = jax.eval_shape(model.init, jax.random.key(0), flows, model.init_carry(1))
    rng = np.random.default_rng(12)
    variables = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes
    )
    sd = atdnvo_state_dict_from_jax(variables, (376, 1232))
    assert sd["encoder_CNN.8.linear.weight"].shape == (512, 832)
    _assert_same_tree(convert_atdnvo(sd), variables)
    # and the state dict loads into the port's module as is
    build_odometry_model(Config(), "cpu").load_state_dict(sd)


def _jax_flow(model, variables, *args, **kwargs):
    return jax.tree.map(np.asarray, model.apply(variables, *args, test_mode=True, **kwargs))


# float32 on both sides over ITERS recurrent updates; the residual
# differences come from convolution summation order and the JAX
# encoder's one-pass instance-norm moments (F.instance_norm is two-pass)
FLOW_TOL = {"rtol": 1e-4, "atol": 2e-4}


def test_raftgma_cold_pair_matches_jax(gma, frames):
    model, variables, port = gma
    im1, im2 = frames
    want_low, want_up = _jax_flow(model, variables, jnp.asarray(im1), jnp.asarray(im2))
    with torch.no_grad():
        got_low, got_up = port(torch.from_numpy(im1), torch.from_numpy(im2))
    assert got_low.shape == (1, H // 8, W // 8, 2) and got_up.shape == (1, H, W, 2)
    assert float(np.abs(want_low).max()) > 0.05  # the update loop moved the flow
    np.testing.assert_allclose(got_low.numpy(), want_low, **FLOW_TOL)
    np.testing.assert_allclose(got_up.numpy(), want_up, **FLOW_TOL)


def test_raftgma_attention_reaches_the_output(gma, frames):
    """With gamma at 0 the flow changes: the probabilities are used."""
    _, _, port = gma
    im1, im2 = (torch.from_numpy(x) for x in frames)
    agg = port.update_block.aggregator
    with torch.no_grad():
        low, _ = port(im1, im2)
        saved = agg.gamma.clone()
        agg.gamma.zero_()
        try:
            low0, _ = port(im1, im2)
        finally:
            agg.gamma.copy_(saved)
    assert float((low - low0).abs().max()) > 1e-3


def test_raftgma_cached_fmap_pair_matches_jax(gma, frames):
    """The streaming form: image1's feature map from ``encode_only``,
    image2's returned for the next pair."""
    model, variables, port = gma
    im1, im2 = frames
    fmap1 = model.apply(variables, jnp.asarray(im1), encode_only=True)
    (want_low, want_up), (want_f2, _) = _jax_flow(
        model, variables, jnp.asarray(im1), jnp.asarray(im2), fmap1=fmap1,
        return_features=True,
    )
    with torch.no_grad():
        f1 = port(torch.from_numpy(im1), encode_only=True)
        np.testing.assert_allclose(f1.numpy(), np.asarray(fmap1[0]), rtol=1e-4, atol=1e-4)
        (got_low, got_up), got_f2 = port(
            torch.from_numpy(im1), torch.from_numpy(im2), fmap1=f1, return_features=True
        )
    assert got_f2.shape == (1, H // 8, W // 8, 256)
    np.testing.assert_allclose(got_f2.numpy(), want_f2, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_low.numpy(), want_low, **FLOW_TOL)
    np.testing.assert_allclose(got_up.numpy(), want_up, **FLOW_TOL)


def test_raftgma_flow_init_pair_matches_jax(gma, frames):
    model, variables, port = gma
    im1, im2 = frames
    init = np.random.default_rng(13).normal(scale=1.5, size=(1, H // 8, W // 8, 2))
    init = init.astype(np.float32)
    want_low, want_up = _jax_flow(
        model, variables, jnp.asarray(im1), jnp.asarray(im2), flow_init=jnp.asarray(init)
    )
    with torch.no_grad():
        got_low, got_up = port(
            torch.from_numpy(im1), torch.from_numpy(im2), flow_init=torch.from_numpy(init)
        )
    np.testing.assert_allclose(got_low.numpy(), want_low, **FLOW_TOL)
    np.testing.assert_allclose(got_up.numpy(), want_up, **FLOW_TOL)


def test_raftgma_bf16_matches_jax_bf16(gma, frames):
    """RAFTGMA in bfloat16, cast as ``build_flow_model`` casts it (batch
    norm kept float32), against the JAX flow net with
    ``dtype=jnp.bfloat16``, same weights and frames. The two frameworks
    round to bf16 at other places (convolution outputs, the cast of the
    volume, the attention), so the tolerance is the reference's own
    bf16 error: the port's bf16 flow may lie no farther from the JAX bf16
    flow than that lies from the JAX float32 flow, at either resolution
    (measured: 0.62x of it at 1/8 resolution, 0.53x at full, on flows of
    up to 3.3 and 22.6 px)."""
    model, variables, port = gma
    im1, im2 = frames
    want_f32 = _jax_flow(model, variables, jnp.asarray(im1), jnp.asarray(im2))
    jax_bf16 = JRAFTGMA(iters=ITERS, use_pallas=False, dtype=jnp.bfloat16)
    want = [np.asarray(x, np.float32) for x in _jax_flow(jax_bf16, variables, jnp.asarray(im1), jnp.asarray(im2))]
    bf16 = RAFTGMA(iters=ITERS, dtype=torch.bfloat16)
    bf16.load_state_dict(port.state_dict())
    cast_flow_model(bf16, torch.bfloat16).eval()
    assert bf16.fnet.conv1.weight.dtype == torch.bfloat16
    assert all(m.running_var.dtype == torch.float32 for m in bf16.modules() if isinstance(m, torch.nn.BatchNorm2d))
    with torch.no_grad():
        got = [x.float().numpy() for x in bf16(torch.from_numpy(im1), torch.from_numpy(im2))]
    for g, w, w32 in zip(got, want, want_f32):
        reference_gap = float(np.abs(w - w32).max())
        assert reference_gap > 0.0  # the JAX bf16 path did round
        assert np.isfinite(g).all()
        assert float(np.abs(g - w).max()) <= reference_gap


def test_raftgma_refuses_what_is_not_ported(gma, frames):
    _, _, port = gma
    im = torch.from_numpy(frames[0])
    with pytest.raises(ValueError):
        port(im[:, :60], im[:, :60])
    from atdn_vslam_torch.ops.attention import gma_attention

    # the positional modes are ported; like the JAX package they refuse
    # to materialise their (N, N) bias above 8192 tokens (64 x 129 here)
    q = torch.zeros(1, 64 * 129, 16)
    with pytest.raises(ValueError, match="8192"):
        gma_attention(q, q, None, 64, 129, position_only=True)


def test_atdnvo_two_steps_match_jax_with_carry():
    """Two streaming steps (T = 1 each) threading the LSTM carry, then
    one window of T = 2 from zero: rotations, translations and the
    carry agree (float32; the JAX stem sums its 7x7 taps in another
    order, 1e-5)."""
    model = JATDNVO()
    rng = np.random.default_rng(14)
    flows = rng.normal(scale=20.0, size=(1, 2, ODO_H, ODO_W, 2)).astype(np.float32)
    variables = _to_numpy(model.init(jax.random.key(1), jnp.asarray(flows[:, :1]), model.init_carry(1)))
    variables = _perturb_batch_norm(variables, rng)
    cfg = Config(slam=SlamConfig(image_height=ODO_H, image_width=ODO_W))
    port = build_odometry_model(cfg, "cpu")
    port.load_state_dict(atdnvo_state_dict_from_jax(variables, (ODO_H, ODO_W)))

    carry_j = model.init_carry(1)
    carry_t = port.init_carry(1)
    with torch.no_grad():
        for t in range(2):
            (rot_j, tr_j), carry_j = model.apply(variables, jnp.asarray(flows[:, t : t + 1]), carry_j)
            (rot_t, tr_t), carry_t = port(torch.from_numpy(flows[:, t : t + 1]), carry_t)
            np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-4, atol=1e-5)
        for (cj, hj), (ct, ht) in zip(carry_j, carry_t):
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-5)
        (rot_w, tr_w), _ = port(torch.from_numpy(flows), port.init_carry(1))
    np.testing.assert_allclose(rot_w[:, 1].numpy(), rot_t[:, 0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr_w[:, 1].numpy(), tr_t[:, 0].numpy(), rtol=1e-5, atol=1e-6)


def _spy(monkeypatch, module, name, calls):
    """Count the calls of ``module.name`` and pass them through."""
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def _attention_spies(monkeypatch):
    import atdn_vslam_torch.ops.attention as port_attention
    import atdn_vslam_torch.ops.corr_lookup as port_corr

    calls = {}
    _spy(monkeypatch, port_attention, "attention_probs_spatial", calls)
    _spy(monkeypatch, port_attention, "attend_reference", calls)
    _spy(monkeypatch, port_attention, "flash_attend_plain", calls)
    _spy(monkeypatch, port_corr, "corr_dot_rowmajor_plain", calls)
    return calls


# the three attention regimes of the default build (use_pallas=None),
# reached at 8 x 12 = 96 tokens by moving the port's token constants:
# (materialise limit, flash threshold, the calls per pair)
REGIMES = {
    "materialised": (8192, 16384, {"attention_probs_spatial": 1}),
    "per_iteration_reference": (0, 16384, {"attend_reference": ITERS}),
    "per_iteration_flash": (0, 96, {"flash_attend_plain": ITERS}),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_raftgma_attention_regimes_match_jax(gma, frames, monkeypatch, regime):
    """Each regime of the port's default build against the JAX flow net
    with its materialise limit set to match (per-iteration attention in
    JAX is its XLA ``attend_reference`` on the CPU); FLOW_TOL as above."""
    import atdn_vslam_tpu.models.flow.network as jax_network
    import atdn_vslam_torch.ops.attention as port_attention

    materialise, flash, want_calls = REGIMES[regime]
    model, variables, port = gma
    im1, im2 = frames
    monkeypatch.setattr(jax_network, "_MATERIALIZE_MAX_TOKENS", materialise)
    want_low, want_up = _jax_flow(model, variables, jnp.asarray(im1), jnp.asarray(im2))
    monkeypatch.setattr(port_attention, "_MATERIALIZE_MAX_TOKENS", materialise)
    monkeypatch.setattr(port_attention, "_FLASH_MIN_TOKENS", flash)
    calls = _attention_spies(monkeypatch)
    with torch.no_grad():
        got_low, got_up = port(torch.from_numpy(im1), torch.from_numpy(im2))
    assert calls == want_calls
    np.testing.assert_allclose(got_low.numpy(), want_low, **FLOW_TOL)
    np.testing.assert_allclose(got_up.numpy(), want_up, **FLOW_TOL)


def test_raftgma_use_pallas_true_matches_jax(gma, frames, monkeypatch):
    """The port's forced streaming path (K3 builds the four levels, K5
    attends in every iteration, their plain versions on the CPU) against
    the JAX flow net's XLA path with the materialise limit at 0, which
    computes the same function (JAX's own use_pallas=True needs the TPU
    or interpret mode); FLOW_TOL."""
    import atdn_vslam_tpu.models.flow.network as jax_network

    model, variables, port = gma
    im1, im2 = frames
    monkeypatch.setattr(jax_network, "_MATERIALIZE_MAX_TOKENS", 0)
    want_low, want_up = _jax_flow(model, variables, jnp.asarray(im1), jnp.asarray(im2))
    cfg = Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False))
    forced = build_flow_model(cfg, "cpu", use_pallas=True)
    forced.load_state_dict(port.state_dict())
    calls = _attention_spies(monkeypatch)
    with torch.no_grad():
        got_low, got_up = forced(torch.from_numpy(im1), torch.from_numpy(im2))
    assert calls == {"corr_dot_rowmajor_plain": 4, "flash_attend_plain": ITERS}
    np.testing.assert_allclose(got_low.numpy(), want_low, **FLOW_TOL)
    np.testing.assert_allclose(got_up.numpy(), want_up, **FLOW_TOL)


def test_raftgma_use_pallas_false_on_cpu_acts_like_none(gma, frames, monkeypatch):
    """On the CPU use_pallas=False takes the default schedule: the same
    calls and exactly the same flow as use_pallas=None."""
    _, _, port = gma
    im1, im2 = (torch.from_numpy(x) for x in frames)
    cfg = Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False))
    off = build_flow_model(cfg, "cpu", use_pallas=False)
    off.load_state_dict(port.state_dict())
    calls = _attention_spies(monkeypatch)
    with torch.no_grad():
        want_low, want_up = port(im1, im2)
        got_low, got_up = off(im1, im2)
    assert calls == {"attention_probs_spatial": 2}
    torch.testing.assert_close(got_low, want_low, rtol=0, atol=0)
    torch.testing.assert_close(got_up, want_up, rtol=0, atol=0)
