"""The port's map network against the JAX package on the CPU, float32,
on the same weights (JAX variables carried with
``atdn_vslam_torch.convert``): the training-mode batch norm, the conv
blocks (the ConvTranspose kernel flip among them), MappingVAE's forward
in eval and training mode, ``get_code`` and the variational path on
JAX's own noise. Inputs come from a numpy seed; batch 2 at 96x192,
where the latent is 2x3 and the decoded image 65x129.

Tolerances, float32 on both sides: the blocks agree to ~1e-6 and the
model's eval outputs to ~3e-7 of values up to ~3 (measured); ``TOL``
leaves ten times that for other summation orders, and batch statistics
get ``STATS_TOL``. In training mode the deep batch norms normalise over
as few as 12 values (2 x 2 x 3 at the bottleneck), which magnifies
float32 rounding: the outputs agree to 1.1e-5 of their largest value
and the statistics to 7e-7 (measured over three seeds), so
``TRAIN_REL`` and ``TRAIN_STATS_TOL`` leave four to seven times that.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atdn_vslam_tpu.models import blocks as jblocks
from atdn_vslam_tpu.models.mapping import MappingVAE as JMappingVAE
from atdn_vslam_tpu.models.mapping import normalize_rgb as jnormalize_rgb

from atdn_vslam_torch import convert
from atdn_vslam_torch.config import Config, MappingModelConfig
from atdn_vslam_torch.models import blocks
from atdn_vslam_torch.models.factory import build_mapping_model, mapping_compute_dtype
from atdn_vslam_torch.models.mapping import MappingVAE, normalize_rgb

torch.set_num_threads(1)

H, W = 96, 192
TOL = {"rtol": 1e-5, "atol": 1e-5}
STATS_TOL = {"rtol": 1e-5, "atol": 1e-6}
TRAIN_REL = 5e-5
TRAIN_STATS_TOL = {"rtol": 1e-5, "atol": 5e-6}


def _np(tree):
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


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _stats(module):
    return {k: v for k, v in module.state_dict().items() if "running" in k}


def test_batch_norm_training_matches_flax():
    """Training mode: biased variance for the output and for the running
    variance (momentum 0.1, flax's 0.9), where ``nn.BatchNorm2d`` moves
    towards the unbiased one; eval mode is ``nn.BatchNorm2d`` bit for
    bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (2, 5, 7, 4)).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    variables = _np(flax_bn.init(jax.random.key(0), x))
    variables["params"]["scale"] = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    variables["params"]["bias"] = rng.normal(size=4).astype(np.float32)
    want, mutated = flax_bn.apply(variables, x, mutable=["batch_stats"])

    sd = {}
    convert._put_bn(sd, "bn", variables["params"], variables["batch_stats"])
    bn = blocks.BatchNorm2d(4, eps=1e-5)
    bn.load_state_dict({k[3:]: v for k, v in sd.items()})
    plain = torch.nn.BatchNorm2d(4, eps=1e-5)
    plain.load_state_dict(bn.state_dict())
    got = bn.train()(_nchw(x))
    plain.train()(_nchw(x))
    _close(got.permute(0, 2, 3, 1), want)
    _close(bn.running_mean, mutated["batch_stats"]["mean"], STATS_TOL)
    _close(bn.running_var, mutated["batch_stats"]["var"], STATS_TOL)
    n = 2 * 5 * 7
    assert not np.allclose(plain.running_var.numpy(), bn.running_var.numpy(), rtol=1e-3)
    np.testing.assert_allclose(
        (plain.running_var - 0.9).numpy() * (n - 1) / n, (bn.running_var - 0.9).numpy(), rtol=1e-5
    )
    assert int(bn.num_batches_tracked) == 1

    plain.load_state_dict(bn.state_dict())
    with torch.no_grad():
        xt = _nchw(x)
        np.testing.assert_array_equal(bn.eval()(xt).numpy(), plain.eval()(xt).numpy())


def _block_case(kind, rng):
    """(JAX block, its input (NHWC), port block, a function that fills the
    port block's state_dict from the JAX variables)."""
    if kind == "conv":
        return (jblocks.ConvBlock(6, (3, 3), (2, 2), (1, 1)), rng.normal(size=(2, 9, 13, 4)),
                blocks.ConvBlock(4, 6, 3, 2, 1), lambda sd, p, s: convert._conv_block(sd, "b", p, s))
    if kind == "residual":
        return (jblocks.ResidualConvBlock(6, (2, 2)), rng.normal(size=(2, 9, 13, 4)),
                blocks.ResidualConvBlock(4, 6, 2), lambda sd, p, s: convert._residual_block(sd, "b", p, s))
    if kind == "transposed":
        return (jblocks.TransposedConvBlock(5), rng.normal(size=(2, 6, 11, 4)),
                blocks.TransposedConvBlock(4, 5),
                lambda sd, p, s: convert._transposed_conv_block(sd, "b", p, s))
    if kind == "duc":
        return (jblocks.DUCBlock(3), rng.normal(size=(2, 6, 7, 4)), blocks.DUCBlock(4, 3),
                lambda sd, p, s: convert._conv_block(sd, "b.conv", p["ConvBlock_0"], s["ConvBlock_0"]))

    def connected(sd, p, s):
        convert._conv_block(sd, "b.conv", p["ConvBlock_0"], s["ConvBlock_0"])
        convert._conv_block(sd, "b.duc.conv", p["DUCBlock_0"]["ConvBlock_0"], s["DUCBlock_0"]["ConvBlock_0"])

    return (jblocks.ConnectedDUCBlock(3), (rng.normal(size=(2, 6, 7, 4)), rng.normal(size=(2, 6, 7, 2))),
            blocks.ConnectedDUCBlock(4, 2, 3), connected)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["conv", "residual", "transposed", "duc", "connected_duc"])
def test_blocks_match_jax(kind, train):
    """Each block's output, and in training mode its batch statistics
    after the forward."""
    rng = np.random.default_rng(1)
    jblock, x, block, to_sd = _block_case(kind, rng)
    xs = tuple(np.asarray(a, np.float32) for a in (x if isinstance(x, tuple) else (x,)))
    variables = _perturb_batch_norm(_np(jblock.init(jax.random.key(2), *xs)), rng)
    sd = {}
    to_sd(sd, variables["params"], variables["batch_stats"])
    block.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    block.train(train)
    if train:
        want, mutated = jblock.apply(variables, *xs, True, mutable=["batch_stats"])
    else:
        want = jblock.apply(variables, *xs)
    got = block(*(_nchw(a) for a in xs)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got, want)
    if train:
        sd_after = {}
        to_sd(sd_after, variables["params"], _np(mutated["batch_stats"]))
        for key, value in _stats(block).items():
            _close(value, sd_after["b." + key], STATS_TOL)


def test_transposed_conv_needs_the_kernel_flip():
    """flax's ``nn.ConvTranspose`` correlates the dilated input with its
    kernel as stored; torch's flips it. The converted weight (flipped)
    matches; the same weight unflipped does not."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 5, 6, 3)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
    variables = _np(layer.init(jax.random.key(0), x))
    want = np.asarray(layer.apply(variables, x))
    kernel = variables["params"]["kernel"]
    tconv = torch.nn.ConvTranspose2d(3, 4, 3, 2, 1)
    for flip, agrees in ((True, True), (False, False)):
        k = kernel[::-1, ::-1] if flip else kernel
        with torch.no_grad():
            tconv.weight.copy_(torch.from_numpy(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))))
            tconv.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
            got = tconv(_nchw(x)).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, 9, 11, 4)
        assert np.allclose(got, want, **TOL) == agrees


def _images(seed, batch=2):
    return np.random.default_rng(seed).uniform(0, 255, (batch, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "variational"])
def mapping_pair(request):
    variational = request.param
    jmodel = JMappingVAE(variational=variational)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((2, H, W, 3)), rng=jax.random.key(1))
    variables = _perturb_batch_norm(_np(variables), np.random.default_rng(4))
    model = MappingVAE(variational=variational)
    model.load_state_dict(convert.mapping_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model.eval()


def test_mapping_vae_matches_jax(mapping_pair):
    """mu, logvar, latent and decoded in eval mode; on the variational
    path the port takes JAX's noise."""
    jmodel, variables, model = mapping_pair
    images = _images(5)
    key = jax.random.key(6)
    want = jmodel.apply(variables, images, rng=key)
    noise = None
    if jmodel.variational:
        noise = torch.from_numpy(np.array(jax.random.normal(key, want[0].shape, jnp.float32)))
    with torch.no_grad():
        got = model(torch.from_numpy(images), noise=noise)
    assert tuple(got[0].shape) == (2, 2, 3, 128) and tuple(got[3].shape) == (2, 65, 129, 3)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float32
            _close(g, w)
    if jmodel.variational:
        assert float((got[2] - got[0]).abs().max()) > 0.1  # the noise reached the latent


def test_get_code_matches_jax(mapping_pair):
    jmodel, variables, model = mapping_pair
    images = _images(7)
    want = jmodel.apply(variables, images, method=jmodel.get_code)
    with torch.no_grad():
        got = model.get_code(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, 3, 128)
    _close(got, want)
    # the flattened code is the JAX embedding, element for element
    _close(got.reshape(2, -1), np.asarray(want).reshape(2, -1))


def test_mapping_vae_training_forward_matches_jax():
    """Training mode: the outputs on batch statistics and every running
    statistic after the forward."""
    jmodel = JMappingVAE()
    variables = _perturb_batch_norm(
        _np(jmodel.init(jax.random.key(0), jnp.zeros((2, H, W, 3)))), np.random.default_rng(8)
    )
    model = MappingVAE()
    model.load_state_dict(convert.mapping_state_dict_from_jax(variables), strict=True)
    images = _images(9)
    want, mutated = jmodel.apply(variables, images, True, mutable=["batch_stats"])
    got = model.train()(torch.from_numpy(images))
    for g, w in zip(got, want):
        if w is not None:
            scale = float(np.abs(np.asarray(w)).max())
            _close(g, w, {"rtol": 0, "atol": TRAIN_REL * scale})
    after = convert.mapping_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": _np(mutated["batch_stats"])}
    )
    stats = _stats(model)
    assert len(stats) == 2 * 37  # every batch norm of the model
    for key, value in stats.items():
        _close(value, after[key], TRAIN_STATS_TOL)


def test_variational_noise_from_a_generator():
    model = MappingVAE(variational=True).eval()
    images = torch.from_numpy(_images(10, batch=1))
    with torch.no_grad(), pytest.raises(ValueError, match="noise or a generator"):
        model(images)
    with torch.no_grad():
        a = model(images, generator=torch.Generator().manual_seed(3))
        b = model(images, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())


def test_normalize_rgb_matches_jax():
    images = _images(11)
    _close(normalize_rgb(torch.from_numpy(images)), jnormalize_rgb(jnp.asarray(images)))


def test_build_mapping_model_compute_type():
    """bf16 only on the GPU and only when configured; float32 parameters
    and eval mode either way."""
    bf16 = Config()
    f32 = Config(mapping=MappingModelConfig(compute_dtype="float32"))
    assert mapping_compute_dtype(bf16, torch.device("cuda")) == torch.bfloat16
    assert mapping_compute_dtype(f32, torch.device("cuda")) == torch.float32
    assert mapping_compute_dtype(bf16, torch.device("cpu")) == torch.float32
    model = build_mapping_model(bf16, "cpu")
    assert model.dtype == torch.float32 and not model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not hasattr(model, "sigma_lin")
