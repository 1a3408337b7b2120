"""The port's map training against the JAX package on the CPU, float32:
the three losses, the colour jitter on the same factors, the blur, the
learning-rate schedule and AdamW against optax, one train step from
JAX's initial weights (loss, gradients before the optimizer, batch
statistics after the step) and two epochs of ``train_mapping``. Inputs
come from a numpy seed; images are batch 2 at 96x192.

Tolerances. The losses, jitter, blur and schedule compute the same
float32 expressions (``TOL``). One train step: loss within 1e-6
relative (measured 1e-7); gradients within ``GRAD_REL`` of each
tensor's largest gradient (measured 1.8e-4: reductions through 37 batch
norms summed in another order); statistics within ``STATS_TOL``. After
a step the parameters can differ by 2 x lr where a gradient is too
small for its sign to survive float32 (Adam's first step is about
lr x sign(g)), and over ``train_mapping``'s four steps those flips carry
on: the epoch losses agree to 4.7e-4 relative, parameters to 2.0e-3 and
codes to 0.34% of the largest code (measured), bounded by
``EPOCH_LOSS_RTOL``, 4 x lr and ``CODE_REL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atdn_vslam_tpu.config import MappingTrainConfig as JMappingTrainConfig
from atdn_vslam_tpu.models.mapping import MappingVAE as JMappingVAE
from atdn_vslam_tpu.training import losses as jlosses
from atdn_vslam_tpu.training import mapping as jmapping

from atdn_vslam_torch.config import MappingTrainConfig
from atdn_vslam_torch.convert import mapping_state_dict_from_jax
from atdn_vslam_torch.models.mapping import MappingVAE
from atdn_vslam_torch.training import losses, mapping

torch.set_num_threads(1)

H, W = 96, 192
TOL = {"rtol": 1e-5, "atol": 1e-5}
GRAD_REL = 1e-3
STATS_TOL = {"rtol": 1e-5, "atol": 1e-5}
EPOCH_LOSS_RTOL = 2e-3
CODE_REL = 0.015


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _uint8_images(seed, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3), dtype=np.uint8)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(2, 5, 7, 3)).astype(np.float32) for _ in range(2))
    mu, logvar = (rng.normal(scale=0.5, size=(2, 2, 3, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(losses.vae_loss(_t(pred), _t(target), _t(mu), _t(logvar), beta=0.7)),
        float(jlosses.vae_loss(pred, target, mu, logvar, beta=0.7)), **TOL,
    )
    emb, pts = rng.normal(size=(3, 48)).astype(np.float32), rng.normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.embedding_distance_loss(_t(emb), _t(pts))),
        float(jlosses.embedding_distance_loss(emb, pts)), **TOL,
    )
    # the reconstruction loss and its gradient, which the map training follows
    want, want_grad = jax.value_and_grad(jlosses.mapping_reconstruction_loss)(pred, target)
    p = _t(pred).requires_grad_()
    got = losses.mapping_reconstruction_loss(p, _t(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), **TOL)
    # the saturation term reduces over the channel (last) axis
    flat = np.repeat(target[..., :1], 3, axis=-1)
    assert float(losses.mapping_reconstruction_loss(_t(flat), _t(flat))) == 0.0


def _jax_factors(key, b):
    """The factors ``jax color_jitter(key, ...)`` draws, in its order."""
    r1, r2, r3 = jax.random.split(key, 3)
    bf = jax.random.uniform(r1, (b, 1, 1, 1), minval=0.9, maxval=1.1)
    sf = jax.random.uniform(r2, (b, 1, 1, 1), minval=0.9, maxval=1.1)
    first = jax.random.bernoulli(r3, 0.5, (b, 1, 1, 1))
    return tuple(torch.from_numpy(np.array(a).reshape(-1)) for a in (bf, sf, first))


def test_color_jitter_matches_jax_on_the_same_factors():
    images = _uint8_images(1, n=4).astype(np.float32)
    key = jax.random.key(3)
    factors = _jax_factors(key, 4)
    assert factors[2].any() and not factors[2].all()  # both op orders occur
    want = jmapping.color_jitter(key, jnp.asarray(images))
    got = mapping.color_jitter(torch.from_numpy(images), factors)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0


def test_jitter_factors_are_seeded_and_in_range():
    a = mapping.jitter_factors(64, torch.Generator().manual_seed(5))
    b = mapping.jitter_factors(64, torch.Generator().manual_seed(5))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for f in a[:2]:
        assert float(f.min()) >= 0.9 and float(f.max()) < 1.1
    assert a[2].dtype == torch.bool and 0 < int(a[2].sum()) < 64


def test_gaussian_blur_matches_jax():
    images = np.random.default_rng(2).uniform(0, 255, (2, 9, 13, 3)).astype(np.float32)
    want = jmapping.gaussian_blur_5x5(jnp.asarray(images))
    got = mapping.gaussian_blur_5x5(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_schedule_and_adamw_match_optax():
    """The lr of every step (and past the end) and the parameters after
    AdamW steps with decoupled weight decay, against ``optax.adamw`` on
    its cosine schedule."""
    cfg = MappingTrainConfig(lr=1e-3, wd=1e-3, eta_min=1e-5)
    steps = 7
    schedule = optax.cosine_decay_schedule(cfg.lr, steps, alpha=cfg.eta_min / cfg.lr)
    param = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 5))
    opt, sched = mapping.make_optimizer(torch.nn.ParameterList([param]), cfg, steps)
    tx = optax.adamw(schedule, weight_decay=cfg.wd)
    jparam = jnp.array(param.detach().numpy())  # a copy: the torch step works in place
    jstate = tx.init(jparam)
    grads = np.random.default_rng(3).normal(size=(steps + 2, 5)).astype(np.float32)
    for t in range(steps + 2):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(schedule(t)), rtol=1e-6)
        param.grad = torch.from_numpy(grads[t])
        opt.step()
        sched.step()
        updates, jstate = tx.update(jnp.asarray(grads[t]), jstate, jparam)
        jparam = optax.apply_updates(jparam, updates)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jparam), rtol=1e-6, atol=1e-7)
    assert opt.param_groups[0]["lr"] == pytest.approx(cfg.eta_min)


def test_train_step_matches_jax(monkeypatch):
    """One step of the JAX package's own train step and of the port's,
    from JAX's initial weights on the same batch and jitter factors:
    loss, every parameter's gradient and the batch statistics after the
    step. The JAX step's optimizer is swapped for one that keeps the
    gradients as its state and leaves the parameters alone, so the step
    hands back its exact gradients (AdamW itself is held against optax
    above)."""
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )
    monkeypatch.setattr(jmapping, "make_optimizer", lambda cfg, steps_total: keep_grads)
    jcfg = JMappingTrainConfig(epochs=1, batch_size=2, seed=0)
    jmodel = JMappingVAE()
    state = jmapping.init_state(jmodel, jcfg, 1, jnp.zeros((2, H, W, 3)))
    variables = _np({"params": state.params, "batch_stats": state.batch_stats})
    images = _uint8_images(4)
    key = jax.random.key(7)
    new_state, jloss = jmapping.make_train_step(jmodel, jcfg, 1, donate=False)(
        state, key, jnp.asarray(images)
    )

    model = MappingVAE()
    model.load_state_dict(mapping_state_dict_from_jax(variables), strict=True)
    opt, sched = mapping.make_optimizer(model, MappingTrainConfig(epochs=1, batch_size=2, seed=0), 1)
    loss = mapping.train_step(model, opt, sched, torch.from_numpy(images), _jax_factors(key, 2))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)

    want_grads = mapping_state_dict_from_jax(
        {"params": _np(new_state.opt_state), "batch_stats": variables["batch_stats"]}
    )
    for name, p in model.named_parameters():
        scale = float(want_grads[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)

    after = mapping_state_dict_from_jax(_np({"params": state.params, "batch_stats": new_state.batch_stats}))
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    assert len(stats) == 2 * 37
    for name, value in stats.items():
        np.testing.assert_allclose(value.numpy(), after[name].numpy(), err_msg=name, **STATS_TOL)


def test_train_mapping_matches_jax(monkeypatch):
    """Two epochs of two steps (5 keyframes, batch 2) from JAX's initial
    weights, the jitter set to the identity in both packages: the same
    shuffled batches, per-epoch losses, trained weights and codes; the
    map is handed to ``save_fn`` after every epoch."""
    monkeypatch.setattr(jmapping, "color_jitter", lambda rng, images: images)
    monkeypatch.setattr(mapping, "color_jitter", lambda images, factors: images)
    images = _uint8_images(5, n=5)
    kw = dict(epochs=2, batch_size=2, seed=0)
    jlog, log, saved = [], [], []
    state = jmapping.train_mapping(JMappingVAE(), JMappingTrainConfig(**kw), images,
                                   log_fn=lambda e, v: jlog.append(v))
    init = _np(JMappingVAE().init(jax.random.key(0), jnp.zeros((2, H, W, 3))))
    model = mapping.train_mapping(
        MappingVAE(), MappingTrainConfig(**kw), images, log_fn=lambda e, v: log.append(v),
        save_fn=lambda m: saved.append(m.state_dict()["out_conv.bias"].clone()),
        init_state_dict=mapping_state_dict_from_jax(init),
    )
    assert not model.training and len(saved) == 2 and not torch.equal(saved[0], saved[1])
    np.testing.assert_allclose(log, jlog, rtol=EPOCH_LOSS_RTOL)

    trained = mapping_state_dict_from_jax(_np({"params": state.params, "batch_stats": state.batch_stats}))
    lr = MappingTrainConfig().lr
    for name, value in model.state_dict().items():
        if "num_batches" not in name and "running" not in name:
            assert float((value - trained[name]).abs().max()) <= 4 * lr, name

    jmodel = JMappingVAE()
    want = np.asarray(jmodel.apply({"params": state.params, "batch_stats": state.batch_stats},
                                   images.astype(np.float32), method=jmodel.get_code))
    with torch.no_grad():
        got = model.get_code(torch.from_numpy(images).float()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CODE_REL * float(np.abs(want).max()))
