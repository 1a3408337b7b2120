"""RAFTGMA's train mode and the flow train step against the JAX package
on the CPU, on the same weights (JAX variables carried into the port with
``convert.gma_state_dict_from_jax``, GMA's gamma non-zero so that the
attention, and K1's backward, reach the loss; batch-norm statistics drawn
away from their initial values), at 64x96, batch 2, 2 iterations, the
same numpy-made frames, ground truth and valid mask.

Two precisions:

  * float32, as the JAX package runs (``RAFTGMA(use_pallas=False)``): the
    prediction stack, the loss and metrics, the batch statistics after
    the forward, and the gradients of every parameter past the two
    encoders. The JAX package's own float32 gradients lie up to 2.2e-3
    of a tensor's largest gradient from its float64 ones here (the
    port's float32 ones within 2e-6 of the port's float64 ones), hence
    ``GRAD32_REL``. The encoders' float32 gradients are left to the
    float64 test: a weight's gradient there is a small difference of
    large terms, and float32 rounding moves it by up to 5% in either
    package.
  * float64 (``jax.enable_x64``; the port's modules in float64): every
    gradient, the batch statistics and the parameters after one AdamW
    step with the global-norm clip. Both packages keep their coordinates,
    lookup outputs and upsampling in float32; the JAX instance norm casts
    to float32 on purpose (``extractor.instance_norm``), so this test
    replaces it by the same one-pass formula in the input's type, as the
    port's ``InstanceNorm`` keeps float64. Measured: 3.4e-7 of each
    tensor's largest gradient, hence ``GRAD64_REL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import atdn_vslam_tpu.models.flow.extractor as jextractor
from atdn_vslam_tpu.models.flow import RAFTGMA as JRAFTGMA
from atdn_vslam_tpu.training import flow as jtrain

from atdn_vslam_torch.config import Config, FlowNetConfig
from atdn_vslam_torch.convert import gma_state_dict_from_jax
from atdn_vslam_torch.models.factory import build_flow_train_model
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.training import flow as train

torch.set_num_threads(1)

H, W, B, ITERS = 64, 96, 2, 2
GAMMA = 0.8
LR, STEPS_TOTAL, WD, CLIP = 1e-3, 10, 1e-5, 1.0
FLOW_TOL = {"rtol": 1e-4, "atol": 2e-4}  # tests/test_torch_models.py
GRAD32_REL = 5e-3
GRAD64_REL = 1e-5
# the biases of the convolutions before an instance norm get an exact zero
# gradient, which each side computes as rounding noise (~1e-16 in float64)
GRAD64_ATOL = 1e-12
BF16_GAP = 1.5


def _perturb_batch_norm(tree, rng):
    def walk(params, stats):
        for key, node in stats.items():
            if "mean" in node:
                n = node["mean"].shape
                node["mean"] = rng.normal(scale=0.1, size=n)
                node["var"] = rng.uniform(0.5, 1.5, size=n)
                params[key]["scale"] = rng.uniform(0.5, 1.5, size=n)
                params[key]["bias"] = rng.normal(scale=0.1, size=n)
            else:
                walk(params[key], node)

    walk(tree["params"], tree["batch_stats"])
    return tree


@pytest.fixture(scope="module")
def case():
    """Weights and data as float32 values (the port's state dicts are
    float32), kept in float64 numpy arrays for the float64 cases."""
    model = JRAFTGMA(iters=ITERS, use_pallas=False)
    im = jnp.zeros((B, H, W, 3))
    variables = jax.tree.map(lambda x: np.array(x, np.float64), model.init(jax.random.key(0), im, im))
    variables["params"]["update"]["GMAUpdateBlock_0"]["Aggregate_0"]["gamma"] = np.array([0.7])
    rng = np.random.default_rng(20)
    variables = _perturb_batch_norm(variables, rng)
    base = rng.uniform(0, 255, (B, H + 8, W + 8, 3))
    flow_gt = np.stack([np.full((B, H, W), -5.0), np.full((B, H, W), -3.0)], -1)
    flow_gt = flow_gt + rng.normal(scale=0.5, size=flow_gt.shape)
    flow_gt[0, :4, :4] = 500.0  # beyond MAX_FLOW: excluded from the loss
    valid = (rng.uniform(size=(B, H, W)) > 0.2).astype(np.float64)
    data = (base[:, :H, :W], base[:, 3 : H + 3, 5 : W + 5], flow_gt, valid)
    as_f32 = lambda x: np.asarray(x, np.float32).astype(np.float64)  # noqa: E731
    return jax.tree.map(as_f32, variables), tuple(as_f32(x) for x in data)


def _cast(tree, dtype):
    return jax.tree.map(lambda x: np.asarray(x, dtype), tree)


def _jax_step(dtype, variables, data, param_dtype=None):
    """JAX loss, metrics, predictions, gradients and new batch statistics
    of one train-mode forward, and the parameters after one step of the
    JAX trainer's optimizer (numpy): computing in ``dtype``, with
    parameters and data in ``param_dtype`` (default ``dtype``)."""
    param_dtype = dtype if param_dtype is None else param_dtype
    model = JRAFTGMA(iters=ITERS, use_pallas=False, dtype=dtype)
    im1, im2, flow_gt, valid = (jnp.asarray(x, param_dtype) for x in data)
    tx = jtrain.make_optimizer(LR, STEPS_TOTAL, WD, CLIP, schedule="warmcos")

    def loss_fn(params, batch_stats):
        preds, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, im1, im2, True, False, mutable=["batch_stats"]
        )
        loss, metrics = jtrain.sequence_loss(preds, flow_gt, valid, GAMMA)
        return loss, (metrics, preds, mutated["batch_stats"])

    @jax.jit
    def run(params, batch_stats):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, aux, grads, optax.apply_updates(params, updates)

    v = _cast(variables, param_dtype)
    loss, (metrics, preds, batch_stats), grads, params = run(v["params"], v["batch_stats"])
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"loss": float(loss), "metrics": to_np(metrics), "preds": np.asarray(preds), "grads": to_np(grads),
            "batch_stats": to_np(batch_stats), "params": to_np(params)}


def _wide_instance_norm(x, eps=1e-5):
    """The JAX package's ``instance_norm`` (one-pass moments) in the
    input's type instead of float32."""
    n = x.shape[-3] * x.shape[-2]
    mean = jnp.sum(x, axis=(-3, -2), keepdims=True) / n
    var = jnp.maximum(jnp.sum(x * x, axis=(-3, -2), keepdims=True) / n - mean * mean, 0.0)
    return (x - mean) * jax.lax.rsqrt(var + eps)


@pytest.fixture(scope="module")
def jax32(case):
    return _jax_step(jnp.float32, *case)


@pytest.fixture(scope="module")
def jax_bf16(case):
    """The JAX trainer's accelerator build: bf16 compute, float32 parameters."""
    return _jax_step(jnp.bfloat16, *case, param_dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax64(case):
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jextractor, "instance_norm", _wide_instance_norm)
        return _jax_step(jnp.float64, *case)


def _port(variables, dtype, **kwargs) -> RAFTGMA:
    cfg = Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False))
    model = build_flow_train_model(cfg, "cpu", **kwargs)
    model.load_state_dict(gma_state_dict_from_jax(variables))
    if dtype == torch.float64:
        model.double()
        model.dtype = torch.float64
    return model


def _tensors(data, dtype):
    return [torch.from_numpy(np.asarray(x)).to(dtype) for x in data]


def _grads_sd(variables, grads):
    """JAX gradients in the port's layout: the converter is a linear
    layout map (transposes, the z|r split, the window permutation), which
    writes float32 (relative rounding 6e-8, far below every bound)."""
    sd = gma_state_dict_from_jax({"params": grads, "batch_stats": variables["batch_stats"]})
    return {k: v.double() for k, v in sd.items()}


def _stats_sd(variables, batch_stats):
    sd = gma_state_dict_from_jax({"params": variables["params"], "batch_stats": batch_stats})
    return {k: v for k, v in sd.items() if "running" in k}


def _forward_backward(model, data, dtype):
    im1, im2, flow_gt, valid = _tensors(data, dtype)
    preds = model(im1, im2, test_mode=False)
    loss, metrics = train.sequence_loss(preds, flow_gt, valid, GAMMA)
    loss.backward()
    return preds.detach(), loss.detach(), metrics


def _check_grads(model, want, rel, atol=0.0, names=None) -> float:
    """Each gradient within ``rel`` of its tensor's largest JAX gradient
    (plus ``atol``); returns the largest relative difference."""
    worst = 0.0
    for name, p in model.named_parameters():
        if names is not None and not name.startswith(names):
            continue
        g, r = p.grad.double(), want[name]
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        assert err <= rel * scale + atol, f"{name}: gradient differs by {err} > {rel} x {scale} + {atol}"
        if err > atol:
            worst = max(worst, err / scale)
    return worst


def test_train_mode_float32_matches_jax(case, jax32):
    variables, data = case
    model = _port(variables, torch.float32)
    preds, loss, metrics = _forward_backward(model, data, torch.float32)
    assert preds.shape == (ITERS, B, H, W, 2)
    assert float(np.abs(jax32["preds"]).max()) > 1.0  # the updates moved the flow
    np.testing.assert_allclose(preds.numpy(), jax32["preds"], **FLOW_TOL)
    np.testing.assert_allclose(float(loss), jax32["loss"], rtol=1e-5)
    for key in ("epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(metrics[key]), float(jax32["metrics"][key]), rtol=1e-5, atol=1e-4)
    got_stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    want_stats = _stats_sd(_cast(variables, np.float32), jax32["batch_stats"])
    assert got_stats.keys() == want_stats.keys()
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    # K1's backward reaches the attention projections, K2's the feature encoder
    assert float(model.att.to_qk.weight.grad.abs().max()) > 0
    assert float(model.fnet.conv2.weight.grad.abs().max()) > 0
    _check_grads(model, _grads_sd(variables, jax32["grads"]), GRAD32_REL, names=("update_block", "att"))


def test_train_mode_bf16_matches_jax_bf16(case, jax32, jax_bf16):
    """bf16 compute with float32 parameters, as both trainers run on an
    accelerator: the port's forward under ``torch.autocast`` (the CPU's
    here), the JAX flow net with ``dtype=jnp.bfloat16``. The two round to
    bf16 at other places (autocast chooses op by op, flax casts every
    layer's inputs), so the bound is the reference's own bf16 error: the
    port's loss, prediction stack and each module group's gradients lie
    no farther from the JAX float32 step than ``BF16_GAP`` times the JAX
    bf16 step does, each group's distance taken relative to its largest
    float32 gradient (measured: loss 1.11x, predictions 0.88x,
    gradients 0.83x fnet, 0.87x cnet, 0.74x att, 0.13x update block)."""
    variables, data = case
    model = _port(variables, torch.float32)
    model.dtype = torch.bfloat16
    preds, loss, _ = _forward_backward(model, data, torch.float32)
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert preds.dtype == torch.float32 and bool(preds.isfinite().all())
    want32, want16 = _grads_sd(variables, jax32["grads"]), _grads_sd(variables, jax_bf16["grads"])
    gaps = {"loss": (abs(float(loss) - jax32["loss"]), abs(jax_bf16["loss"] - jax32["loss"])),
            "preds": (float(np.abs(preds.numpy() - jax32["preds"]).max()),
                      float(np.abs(jax_bf16["preds"] - jax32["preds"]).max()))}
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    for group in ("fnet", "cnet", "att", "update_block"):
        names = [n for n in grads if n.split(".")[0] == group]
        gaps[group] = tuple(max(float((g[n] - want32[n]).abs().max()) for n in names) for g in (grads, want16))
    for key, (got, reference_gap) in gaps.items():
        assert reference_gap > 0.0, key  # the JAX bf16 path did round
        assert got <= BF16_GAP * reference_gap, f"{key}: {got} > {BF16_GAP} x {reference_gap}"


def test_train_step_float64_matches_jax(case, jax64):
    """Every gradient, the batch statistics after the step and the
    parameters after one clipped AdamW step."""
    variables, data = case
    model = _port(variables, torch.float64)
    _, loss, _ = _forward_backward(model, data, torch.float64)
    np.testing.assert_allclose(float(loss), jax64["loss"], rtol=1e-7)  # float32 coordinates
    _check_grads(model, _grads_sd(variables, jax64["grads"]), GRAD64_REL, GRAD64_ATOL)

    model = _port(variables, torch.float64)
    state = train.init_state(model, LR, STEPS_TOTAL, WD, CLIP, "warmcos", seed=None)
    state, metrics = train.train_step(state, *_tensors(data, torch.float64), gamma=GAMMA)
    assert state.step == 1 and float(metrics["grad_norm"]) > CLIP  # the clip acted
    got = model.state_dict()
    for k, v in _stats_sd(variables, jax64["batch_stats"]).items():
        # the converter writes float32: its rounding, 6e-8
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-7, atol=1e-12, err_msg=k)
    want = gma_state_dict_from_jax({"params": jax64["params"], "batch_stats": variables["batch_stats"]})
    for name, p in model.named_parameters():
        # a step moves a weight by at most ~lr: the float32 coordinates
        # leave ~1e-7 of each gradient's scale, far below the step
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-3 * LR, err_msg=name)


def test_remat_changes_no_value_or_gradient(case):
    """``remat=True`` recomputes each iteration in the backward pass."""
    variables, data = case
    runs = []
    for remat in (False, True):
        model = _port(variables, torch.float32, remat=remat)
        preds, loss, _ = _forward_backward(model, data, torch.float32)
        runs.append((preds, loss, {n: p.grad for n, p in model.named_parameters()}, model.state_dict()))
    (p0, l0, g0, s0), (p1, l1, g1, s1) = runs
    torch.testing.assert_close(p1, p0, rtol=0, atol=0)
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-9, msg=name)
    for name in s0:  # the recompute moves no batch statistic a second time
        torch.testing.assert_close(s1[name], s0[name], rtol=0, atol=0, msg=name)


def test_train_mode_ignores_corr_nlanes(case):
    """The JAX flow net applies ``corr_nlanes`` in test mode only."""
    variables, data = case
    im1, im2, _, _ = _tensors(data, torch.float32)
    outs = []
    for nlanes in (False, True):
        model = _port(variables, torch.float32)
        model.corr_nlanes = nlanes
        model.eval()
        with torch.no_grad():
            outs.append(model(im1, im2, test_mode=False))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


def test_checkpoint_resume_continues_exactly(case, tmp_path):
    """Two steps in one run equal one step, a checkpoint, a fresh state
    restored from it and one more step: weights, statistics, optimiser
    moments and schedule."""
    variables, data = case
    batch = _tensors(data, torch.float32)

    def fresh():
        return train.init_state(_port(variables, torch.float32), LR, STEPS_TOTAL, WD, CLIP, seed=None)

    straight = fresh()
    for _ in range(2):
        train.train_step(straight, *batch, gamma=GAMMA)
    first = fresh()
    train.train_step(first, *batch, gamma=GAMMA)
    assert train.latest_checkpoint(str(tmp_path)) is None
    train.save_checkpoint(train.checkpoint_path(str(tmp_path), first.step), first)
    path = train.latest_checkpoint(str(tmp_path))
    assert path.endswith("step_00000001")
    resumed = train.load_checkpoint(path, fresh())
    assert resumed.step == 1
    train.train_step(resumed, *batch, gamma=GAMMA)
    assert resumed.step == straight.step == 2
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    assert resumed.scheduler.get_last_lr() == straight.scheduler.get_last_lr()


def test_sequence_loss_matches_jax():
    rng = np.random.default_rng(21)
    preds = rng.normal(scale=3.0, size=(4, 2, 8, 10, 2)).astype(np.float32)
    gt = rng.normal(scale=3.0, size=(2, 8, 10, 2)).astype(np.float32)
    gt[0, 0, 0] = 450.0  # beyond MAX_FLOW
    valid = (rng.uniform(size=(2, 8, 10)) > 0.3).astype(np.float32)
    want_loss, want = jtrain.sequence_loss(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid), 0.85)
    loss, got = train.sequence_loss(*(torch.from_numpy(x) for x in (preds, gt, valid)), gamma=0.85)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("steps_total,pct", [(1000, 0.05), (37, 0.3), (20, 0.25)])
def test_onecycle_matches_torch_one_cycle_lr(steps_total, pct):
    """The reference's OneCycleLR (GMA/train.py:68-75: linear anneal,
    div_factor 25, final_div_factor 1e4, no momentum cycling)."""
    lr = 2e-4
    sched = train.onecycle_schedule(lr, steps_total, pct)
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=lr)
    ref = torch.optim.lr_scheduler.OneCycleLR(
        opt, lr, total_steps=steps_total, pct_start=pct, cycle_momentum=False, anneal_strategy="linear"
    )
    for step in range(steps_total):
        np.testing.assert_allclose(sched(step), opt.param_groups[0]["lr"], rtol=1e-9, err_msg=str(step))
        opt.step()
        ref.step()


@pytest.mark.parametrize("steps_total,schedule", [(200, "warmcos"), (10, "warmcos"), (200, "onecycle")])
def test_optimizer_schedule_matches_optax(steps_total, schedule):
    """The learning rate each optimiser step uses, against the JAX
    trainer's schedule evaluated at the same update count. Both JAX
    schedules compute in float32: a bound of float32's rounding of the
    peak rate (the cosine's tail falls to lr/1e4)."""
    lr = 1.25e-4
    opt, sched = train.make_optimizer(torch.nn.Linear(2, 2), lr, steps_total, schedule=schedule)
    if schedule == "warmcos":
        warmup = max(1, int(0.05 * steps_total))
        ref = optax.warmup_cosine_decay_schedule(lr / 25.0, lr, warmup, max(steps_total, warmup + 1), lr / 1e4)
    else:
        ref = jtrain.onecycle_schedule(lr, steps_total)
    for step in range(steps_total + 5):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(ref(step)), rtol=1e-6, atol=1e-6 * lr,
                                   err_msg=str(step))
        opt.step()
        sched.step()


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(22)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = train.clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_training_build_keeps_float32_parameters():
    cfg = Config(flow=FlowNetConfig(iters=2))
    model = build_flow_train_model(cfg, "cpu", remat=True)
    assert model.training and model.remat and model.dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
