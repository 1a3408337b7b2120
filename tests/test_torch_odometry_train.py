"""The port's odometry training against the JAX package on the CPU,
float32, numpy-seeded inputs: the CLVO loss and its gradient, ATDNVO's
three encoder variants in eval mode on converted weights, the optimiser
against optax, one train step from JAX's initial weights (dropout off),
the dropout masks, and the checkpoints with the stage warm start.

Tolerances are those of the map's train step
(``tests/test_torch_mapping_train.py``): loss 1e-6 relative, gradients
1e-3 of each tensor's largest, batch statistics 1e-5. Flows are batch 2
x 3 steps at 72x96, the smallest size the compressor encoder takes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atdn_vslam_tpu.config import LossConfig as JLossConfig
from atdn_vslam_tpu.config import TrainConfig as JTrainConfig
from atdn_vslam_tpu.models.odometry import ATDNVO as JATDNVO
from atdn_vslam_tpu.training import losses as jlosses
from atdn_vslam_tpu.training import odometry as jodometry

from atdn_vslam_torch.config import Config, LossConfig, OdometryModelConfig, TrainConfig
from atdn_vslam_torch.convert import atdnvo_state_dict_from_jax
from atdn_vslam_torch.models.blocks import Dropout
from atdn_vslam_torch.models.factory import build_odometry_model
from atdn_vslam_torch.models.odometry import ATDNVO
from atdn_vslam_torch.training import losses
from atdn_vslam_torch.training import odometry as training

torch.set_num_threads(1)

H, W = 72, 96
B, T = 2, 3
LOSS_RTOL = 1e-6
GRAD_REL = 1e-3
STATS_TOL = {"rtol": 1e-5, "atol": 1e-5}
OUT_REL = 1e-5  # eval-mode outputs, of the largest


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _batch(seed):
    rng = np.random.default_rng(seed)
    flows = rng.normal(scale=20.0, size=(B, T, H, W, 2)).astype(np.float32)
    rot = rng.normal(scale=0.02, size=(B, T, 3)).astype(np.float32)
    tr = rng.normal(scale=0.5, size=(B, T, 3)).astype(np.float32)
    return flows, rot, tr


@pytest.mark.parametrize("alpha", [1.0, 0.5], ids=["alpha1", "alpha0.5"])
def test_clvo_loss_matches_jax(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    x = [rng.normal(scale=s, size=(4, 6, 3)).astype(np.float32) for s in (0.05, 1.0, 0.05, 1.0)]
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda pr, pt: jlosses.clvo_loss(pr, pt, x[2], x[3], alpha=alpha, w=3), argnums=(0, 1)
    ))(x[0], x[1])
    pr, pt = _t(x[0]).requires_grad_(), _t(x[1]).requires_grad_()
    got = losses.clvo_loss(pr, pt, _t(x[2]), _t(x[3]), alpha=alpha, w=3)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for g, w in zip((pr.grad, pt.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * float(np.abs(w).max()))
    if alpha != 1.0:  # the composed term alone
        np.testing.assert_allclose(
            losses.composed_pose_loss(*map(_t, x)).numpy(),
            np.asarray(jax.jit(jlosses.composed_pose_loss)(*x)), rtol=1e-5,
        )


VARIANTS = {
    "compressor": {},
    "non-compressor": {"compressor": False},
    "layernorm-dropout": {"use_layernorm": True, "use_dropout": True},
}


@pytest.mark.parametrize("variant", list(VARIANTS), ids=list(VARIANTS))
def test_encoder_variants_match_jax(variant):
    """Every odometry configuration the JAX factory builds, built by
    ``build_odometry_model`` and loaded with converted weights: the same
    rotations, translations and carry in eval mode (dropout off)."""
    opts = VARIANTS[variant]
    jmodel = JATDNVO(**opts)
    variables = _np(jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((1, 1, H, W, 2)), jmodel.init_carry(1)))
    flows, _, _ = _batch(4)
    (want_rot, want_tr), want_carry = jax.jit(jmodel.apply)(variables, jnp.asarray(flows), jmodel.init_carry(B))
    cfg = Config(odometry=OdometryModelConfig(**opts))
    cfg = dataclasses.replace(cfg, slam=dataclasses.replace(cfg.slam, image_height=H, image_width=W))
    model = build_odometry_model(cfg, "cpu")
    model.load_state_dict(atdnvo_state_dict_from_jax(variables, (H, W)), strict=True)
    assert not model.training
    with torch.no_grad():
        (rot, tr), carry = model(_t(flows), model.init_carry(B))
    for got, want in ((rot, want_rot), (tr, want_tr), (carry[1][1], want_carry[1][1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_REL * float(np.abs(want).max()))


def test_optimizer_matches_optax():
    """The odometry AdamW (its own epsilon and weight decay) and cosine
    schedule against the JAX package's ``make_optimizer``."""
    cfg = TrainConfig(lr=1e-2, wd=1e-3, epsilon=1e-8, eta_min=1e-9)
    steps = 5
    tx = jodometry.make_optimizer(JTrainConfig(lr=1e-2, wd=1e-3, epsilon=1e-8, eta_min=1e-9), steps)
    param = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6))
    opt, sched = training.make_optimizer(torch.nn.ParameterList([param]), cfg, steps)
    jparam = jnp.array(param.detach().numpy())
    jstate = tx.init(jparam)
    grads = np.random.default_rng(5).normal(size=(steps + 1, 6)).astype(np.float32)
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        updates, jstate = tx.update(jnp.asarray(g), jstate, jparam)
        jparam = optax.apply_updates(jparam, updates)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jparam), rtol=1e-6, atol=1e-7)


def test_train_step_matches_jax(monkeypatch):
    """One step of the JAX package's train step and of the port's from
    JAX's initial weights on the same batch, alpha 0.5 (both loss
    terms): the loss, the gradient norm, every parameter's gradient and
    the batch statistics after the step. The JAX optimiser is swapped
    for one that keeps the gradients as its state, so its step hands
    them back (the optimiser itself is held against optax above)."""
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )
    monkeypatch.setattr(jodometry, "make_optimizer", lambda cfg, steps_total: keep_grads)
    flows, rot, tr = _batch(6)
    jmodel = JATDNVO()
    jtc = JTrainConfig(batch_size=B, sequence_length=T)
    state = jodometry.init_state(jmodel, jtc, 1, jnp.zeros((B, T, H, W, 2)), seed=2)
    variables = _np({"params": state.params, "batch_stats": state.batch_stats})
    new_state, metrics = jodometry.make_train_step(jmodel, jtc, JLossConfig(alpha=0.5), 1, donate=False)(
        state, jnp.asarray(flows), jnp.asarray(rot), jnp.asarray(tr)
    )

    model = ATDNVO((H, W))
    model.load_state_dict(atdnvo_state_dict_from_jax(variables, (H, W)), strict=True)
    opt, sched = training.make_optimizer(model, TrainConfig(), 1)
    st = training.OdometryTrainState(model, opt, sched)
    got = training.train_step(st, _t(flows), _t(rot), _t(tr), LossConfig(alpha=0.5))
    assert got["step"] == 0 and st.step == 1
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=LOSS_RTOL)

    want_grads = atdnvo_state_dict_from_jax(
        {"params": _np(new_state.opt_state), "batch_stats": variables["batch_stats"]}, (H, W)
    )
    # the port's LSTM cells keep the reference's two biases, whose
    # gradients are equal; flax's have one: its norm counts them once
    twice = sum(float(want_grads[f"lstm{i}.bias_hh"].square().sum()) for i in (1, 2))
    np.testing.assert_allclose(float(got["grad_norm"]), np.sqrt(float(metrics["grad_norm"]) ** 2 + twice),
                               rtol=GRAD_REL)
    for name, p in model.named_parameters():
        if name.endswith("bias_ih"):  # the same gradient as bias_hh
            torch.testing.assert_close(p.grad, dict(model.named_parameters())[name[:-2] + "hh"].grad)
            continue
        scale = float(want_grads[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)
    after = atdnvo_state_dict_from_jax(
        _np({"params": state.params, "batch_stats": new_state.batch_stats}), (H, W)
    )
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    assert len(stats) == 2 * 14
    for name, value in stats.items():
        np.testing.assert_allclose(value.numpy(), after[name].numpy(), err_msg=name, **STATS_TOL)


def test_dropout_masks():
    """Eval mode is the identity; train mode keeps about 80% of the
    values, each scaled by 1 / 0.8, and the seeded generator repeats its
    masks; ``init_state`` hands every dropout of the model its
    generator."""
    x = torch.ones(64, 512)
    drop = Dropout(0.2)
    drop.eval()
    assert torch.equal(drop(x), x)
    drop.train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    kept = y != 0
    assert 0.77 < float(kept.float().mean()) < 0.83
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / 0.8))
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)

    model = ATDNVO((H, W), use_dropout=True)
    st = training.init_state(model, TrainConfig(seed=3), 1)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    assert len(drops) == 6 and all(m.generator is drops[0].generator for m in drops)
    flows, rot, tr = _batch(7)
    metrics = training.train_step(st, _t(flows), _t(rot), _t(tr), LossConfig())
    assert np.isfinite(float(metrics["loss"]))


def test_checkpoint_round_trip_and_warm_start(tmp_path):
    """A saved state restores model, optimiser, schedule and step: the
    next step from the restored state equals the next step from the
    original. Stage 2's warm start takes stage 1's weights and batch
    statistics with a fresh optimiser."""
    cfg = Config(checkpoint_dir=str(tmp_path / "ckpt"), train=TrainConfig(stage=1, seed=4))
    flows, rot, tr = (_t(a) for a in _batch(8))
    states = []
    for _ in range(2):
        st = training.init_state(ATDNVO((H, W)), cfg.train, 4)
        states.append(st)
    training.train_step(states[0], flows, rot, tr, cfg.loss)
    path = training.save_checkpoint(cfg, 1, states[0])
    assert path.endswith("odometry_stage1.pt")
    training.load_checkpoint(cfg, 1, states[1])
    assert states[1].step == 1
    assert states[1].scheduler.last_epoch == states[0].scheduler.last_epoch
    for st in states:
        training.train_step(st, flows, rot, tr, cfg.loss)
    for a, b in zip(states[0].model.state_dict().values(), states[1].model.state_dict().values()):
        assert torch.equal(a, b)

    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, stage=2))
    fresh = training.init_state(ATDNVO((H, W)), cfg2.train, 4, seed=9)
    training.warm_start(cfg2, fresh)
    saved = training.read_checkpoint(cfg, 1)
    assert saved["stage"] == 1 and saved["step"] == 1
    for name, value in fresh.model.state_dict().items():
        assert torch.equal(value, saved["model"][name]), name
    assert fresh.step == 0 and not fresh.optimizer.state
    with pytest.raises(FileNotFoundError, match="stage 2"):
        training.read_checkpoint(cfg2, 2)
    assert training.warm_start(cfg, fresh) is fresh  # stage 1: nothing to load
