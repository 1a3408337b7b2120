"""GMA's positional attention (``position_and_content``, ``position_only``)
against the JAX package on the CPU, on the same weights: ``RelPosEmb``'s
bias, RAFTGMA in both modes on the materialised path and on the
attend-anew path (``use_pallas=True`` in both packages; the JAX K3 in
interpret mode), one float32 train-mode gradient check, the refusal above
8192 tokens, and the positional tables through ``convert.py`` and
``checkpoint.py``. Float32, 64x96 frames, 3 iterations, inputs made from
a seed with numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atdn_vslam_tpu.models.flow.network as jax_network
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.models.flow.gma import AttentionQK as JAttentionQK
from atdn_vslam_tpu.models.flow.gma import RelPosEmb as JRelPosEmb
from atdn_vslam_tpu.training import flow as jtrain

import atdn_vslam_torch.ops.attention as port_attention
from atdn_vslam_torch.checkpoint import load_reference_checkpoint, reference_state_dict
from atdn_vslam_torch.convert import gma_state_dict_from_jax
from atdn_vslam_torch.models.flow.gma import AttentionQK, RelPosEmb
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.training import flow as train

torch.set_num_threads(1)

H, W, ITERS = 64, 96, 3
MODES = ("position_and_content", "position_only")
# float32 on both sides over ITERS updates (tests/test_torch_models.py)
FLOW_TOL = {"rtol": 1e-4, "atol": 2e-4}
BIAS_TOL = {"rtol": 1e-5, "atol": 1e-5}  # one float32 einsum per axis, another order
# the JAX float32 train gradients past the encoders sit up to 2.2e-3 of
# their largest entry from float64 (tests/test_torch_flow_train.py)
GRAD32_REL = 5e-3


def _to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _variables(mode, seed):
    """JAX variables of the positional flow net, gamma 0.7 so that the
    attention reaches the flow, and the port's model on the same weights."""
    model = JRAFTGMA(iters=ITERS, use_pallas=False, **{mode: True})
    im = jnp.zeros((1, H, W, 3))
    variables = _to_numpy(model.init(jax.random.key(seed), im, im))
    variables["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array([0.7], np.float32)
    return variables


def _port(variables, mode, **kwargs):
    port = RAFTGMA(iters=ITERS, **{mode: True}, **kwargs).eval()
    port.load_state_dict(gma_state_dict_from_jax(variables))  # strict: pos_emb included
    return port


@pytest.fixture(scope="module")
def weights():
    return {mode: _variables(mode, seed) for seed, mode in enumerate(MODES)}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(31)
    base = rng.uniform(0, 255, (1, H + 8, W + 8, 3)).astype(np.float32)
    return base[:, :H, :W], base[:, 3 : H + 3, 5 : W + 5]


def test_relpos_bias_structure_and_values():
    """JAX ``tests/test_flow_network.py::test_relpos_bias_structure`` on
    the port's module, and its values against JAX's on the same tables."""
    h, w, d = 4, 5, 8
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, h * w, d)).astype(np.float32)
    jm = JRelPosEmb(max_pos_size=8, dim_head=d)
    jvars = jm.init(jax.random.key(0), jnp.asarray(q), h, w)
    want = np.asarray(jm.apply(jvars, jnp.asarray(q), h, w))

    port = RelPosEmb(max_pos_size=8, dim_head=d)
    with torch.no_grad():
        port.rel_height.weight.copy_(torch.from_numpy(np.array(jvars["params"]["rel_height"])))
        port.rel_width.weight.copy_(torch.from_numpy(np.array(jvars["params"]["rel_width"])))
        bias = port(torch.from_numpy(q), h, w)
    assert bias.shape == (2, h * w, h * w) and bias.dtype == torch.float32
    b = bias[0].numpy().reshape(h, w, h, w)
    # decomposition: bias[x, y, u, v] - bias[x, y, u, v'] independent of u
    np.testing.assert_allclose(b[1, 2, 0, 3] - b[1, 2, 0, 1], b[1, 2, 3, 3] - b[1, 2, 3, 1], atol=1e-5)
    np.testing.assert_allclose(bias.numpy(), want, **BIAS_TOL)


def _spies(monkeypatch):
    calls = {}
    for name in ("attention_probs_biased", "attention_probs_spatial_plain", "attend_reference",
                 "flash_attend_plain"):
        fn = getattr(port_attention, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(port_attention, name, counted)
    return calls


@pytest.mark.parametrize("path", ["materialised", "attend_anew"])
@pytest.mark.parametrize("mode", MODES)
def test_raftgma_positional_matches_jax(weights, frames, monkeypatch, mode, path):
    """The materialised path (the bias added to the scores once per
    pair; never K1) and the attend-anew path (``use_pallas=True``: the
    bias in every iteration's ``attend_reference``, never K5; the pyramid
    by K3, the JAX one in interpret mode); FLOW_TOL."""
    variables = weights[mode]
    use_pallas = True if path == "attend_anew" else None
    if use_pallas:
        monkeypatch.setattr(
            jax_network, "build_corr_pyramid", functools.partial(jax_network.build_corr_pyramid, interpret=True)
        )
    jmodel = JRAFTGMA(iters=ITERS, use_pallas=use_pallas, **{mode: True})
    im1, im2 = frames
    want_low, want_up = jax.tree.map(
        np.asarray, jmodel.apply(variables, jnp.asarray(im1), jnp.asarray(im2), test_mode=True)
    )
    port = _port(variables, mode, use_pallas=use_pallas)
    calls = _spies(monkeypatch)
    with torch.no_grad():
        got_low, got_up = port(torch.from_numpy(im1), torch.from_numpy(im2))
    want_calls = {"attend_reference": ITERS} if use_pallas else {"attention_probs_biased": 1}
    assert calls == want_calls
    np.testing.assert_allclose(got_low.numpy(), want_low, **FLOW_TOL)
    np.testing.assert_allclose(got_up.numpy(), want_up, **FLOW_TOL)
    # the positional tables reach the flow
    sd = port.state_dict()
    sd["att.pos_emb.rel_width.weight"] = sd["att.pos_emb.rel_width.weight"] * 2.0
    port.load_state_dict(sd)
    with torch.no_grad():
        assert not torch.allclose(port(torch.from_numpy(im1), torch.from_numpy(im2))[0], got_low)


def test_train_mode_positional_gradients_match_jax(weights, frames):
    """One float32 train-mode forward and backward (``position_and_content``,
    batch 1, 2 iterations, the sequence loss): predictions (FLOW_TOL), the
    loss, and the gradients of the attention projections, the positional
    tables and the update block within GRAD32_REL of each tensor's
    largest JAX gradient."""
    mode, iters, gamma = "position_and_content", 2, 0.8
    variables = weights[mode]
    im1, im2 = frames
    rng = np.random.default_rng(32)
    flow_gt = rng.normal(scale=3.0, size=(1, H, W, 2)).astype(np.float32)
    valid = (rng.uniform(size=(1, H, W)) > 0.2).astype(np.float32)

    jmodel = JRAFTGMA(iters=iters, use_pallas=False, **{mode: True})

    def loss_fn(params):
        preds, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(im1), jnp.asarray(im2),
            True, False, mutable=["batch_stats"],
        )
        return jtrain.sequence_loss(preds, jnp.asarray(flow_gt), jnp.asarray(valid), gamma)[0], preds

    (jloss, jpreds), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    want = gma_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads),
                                    "batch_stats": variables["batch_stats"]})

    port = RAFTGMA(iters=iters, **{mode: True}).train()
    port.load_state_dict(gma_state_dict_from_jax(variables))
    preds = port(torch.from_numpy(im1), torch.from_numpy(im2), test_mode=False)
    loss, _ = train.sequence_loss(preds, torch.from_numpy(flow_gt), torch.from_numpy(valid), gamma)
    loss.backward()
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(jpreds), **FLOW_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(port.att.pos_emb.rel_height.weight.grad.abs().max()) > 0
    checked = 0
    for name, p in port.named_parameters():
        if not name.startswith(("att", "update_block")):
            continue
        g, r = p.grad.double(), want[name].double()
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= GRAD32_REL * scale + 1e-12, name
        checked += 1
    assert checked > 20


def test_positional_refused_above_8192_tokens():
    """64 x 129 = 8256 tokens: both packages refuse to materialise the bias
    (the port where the flow net schedules its attention, on what its
    ``AttentionQK`` returns)."""
    fmap = np.zeros((1, 64, 129, 128), np.float32)
    for mode in MODES:
        with pytest.raises(ValueError, match="8192"):
            JAttentionQK(**{mode: True}).init(jax.random.key(0), jnp.asarray(fmap))
        with torch.no_grad():
            q, k, bias = AttentionQK(**{mode: True})(torch.from_numpy(fmap).permute(0, 3, 1, 2))
        with pytest.raises(ValueError, match="8192"):
            port_attention.gma_attention(q, k, bias, 64, 129, position_only=mode == "position_only")


def test_pos_emb_through_convert_and_checkpoint(weights, tmp_path):
    variables = weights["position_and_content"]
    sd = gma_state_dict_from_jax(variables)
    pos = variables["params"]["AttentionQK_0"]["RelPosEmb_0"]
    for name in ("rel_height", "rel_width"):
        got = sd[f"att.pos_emb.{name}.weight"]
        assert got.shape == (2 * 160 - 1, 128)
        np.testing.assert_array_equal(got.numpy(), pos[name])

    # the reference ships through DataParallel: "module." on every key
    path = tmp_path / "gma.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    positional = RAFTGMA(iters=ITERS, position_and_content=True)
    positional.load_state_dict(load_reference_checkpoint(path, positional), strict=True)
    for name in ("rel_height", "rel_width"):
        assert torch.equal(getattr(positional.att.pos_emb, name).weight, sd[f"att.pos_emb.{name}.weight"])
    content = RAFTGMA(iters=ITERS)
    loaded = load_reference_checkpoint(path, content)
    assert not any(k.startswith("att.pos_emb.") for k in loaded)
    content.load_state_dict(loaded, strict=True)
    assert not any(k.startswith("att.pos_emb.") for k in load_reference_checkpoint(path))

    wrong = dict(sd, **{"att.pos_emb.rel_width.weight": torch.zeros(2 * 154 - 1, 128)})
    with pytest.raises(ValueError, match=r"\(307, 128\).*\(319, 128\)"):
        reference_state_dict(wrong, positional)
