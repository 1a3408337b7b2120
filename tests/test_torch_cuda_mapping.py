"""The map and relocalisation on the GPU: one float32 map train step
(TF32 off) against the CPU, the bf16 code against the float32 code, and
the runtime's query path with its kernel launches. Marked ``cuda``;
each test skips when no CUDA device is present. On the GPU machine
(which has no JAX, so the JAX test conftest is left out):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_mapping.py

Tolerances are those the CPU tests hold the port's step to against the
JAX package (``tests/test_torch_mapping_train.py``); the bf16 bound is
the JAX package's own (``tests/test_training.py:210``).
"""

import numpy as np
import pytest
import torch

from atdn_vslam_torch.config import Config, FlowNetConfig, MappingTrainConfig, SlamConfig
from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model, init_params
from atdn_vslam_torch.models.mapping import MappingVAE
from atdn_vslam_torch.ops.attention import attention_probs_spatial
from atdn_vslam_torch.ops.corr_lookup import lookup_corr_pyramid
from atdn_vslam_torch.slam import SlamRuntime
from atdn_vslam_torch.training import mapping as train
from atdn_vslam_torch.utils.helpers import full_float32

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

H, W = 64, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _images(seed, n=2, hw=(H, W)):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8))


def test_train_step_on_the_gpu_matches_the_cpu(cuda):
    images = _images(0)
    factors = train.jitter_factors(2, torch.Generator().manual_seed(0))
    init = init_params(MappingVAE(), 1).state_dict()
    cfg = MappingTrainConfig(epochs=1, batch_size=2)
    models, losses = [], []
    with full_float32():
        for dev in (cuda, torch.device("cpu")):
            model = MappingVAE().to(dev)
            model.load_state_dict(init)
            opt, sched = train.make_optimizer(model, cfg, 1)
            losses.append(float(train.train_step(model, opt, sched, images.to(dev), factors)))
            models.append(model)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        scale = float(q.grad.abs().max())
        np.testing.assert_allclose(p.grad.cpu().numpy(), q.grad.numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=name)
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        if "running" in name:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("hw", [(64, 96), (96, 192)])
def test_bf16_code_within_the_jax_bound(cuda, hw):
    init = init_params(MappingVAE(), 2).state_dict()
    images = _images(1, hw=hw).to(cuda).float()
    codes = []
    for dtype in (torch.bfloat16, torch.float32):
        model = MappingVAE(dtype=dtype).to(cuda).eval()
        model.load_state_dict(init)
        with torch.inference_mode():
            codes.append(model.get_code(images))
    assert codes[0].dtype == torch.float32 and bool(codes[0].isfinite().all())
    scale = float(codes[1].abs().max())
    assert float((codes[0] - codes[1]).abs().max()) <= 0.05 * scale


def test_relocalization_queries_on_the_card(cuda, tmp_path):
    """Odometry -> end_odometry (the bf16 map trained on the card) ->
    queries: each keyframe's own frame finds it, with K1 once and K2 once
    per GMA iteration per query; a warm start answers the same."""
    iters = 2
    cfg = Config(
        keyframes_path=str(tmp_path / "kf"), flow=FlowNetConfig(iters=iters),
        slam=SlamConfig(image_height=96, image_width=192, rotation_threshold_deg=0.0,
                        translation_threshold=0.0),
        mapping_train=MappingTrainConfig(epochs=1, batch_size=2),
    )
    flow = init_params(build_flow_model(cfg, "cpu"), 0)
    with torch.no_grad():
        flow.update_block.aggregator.gamma.fill_(0.5)
    weights = (flow.state_dict(), init_params(build_odometry_model(cfg, "cpu"), 1).state_dict())
    base = np.random.default_rng(3).integers(0, 255, (96 + 16, 192 + 64, 3), dtype=np.uint8)
    frames = [np.ascontiguousarray(base[4 * i : 4 * i + 96, 16 * i : 16 * i + 192]) for i in range(4)]
    rt = SlamRuntime(cfg, *weights, device=cuda)
    rt.start_odometry()
    for f in frames:
        rt(f)
    rt.end_odometry()
    assert rt.mode() == "relocalization" and rt.keyframes.embeddings.shape == (4, 2 * 3 * 128)
    for fn in (attention_probs_spatial, lookup_corr_pyramid):
        fn.launches = 0
    answers = {q: rt(frames[q]) for q in (0, 3, 0)}
    assert attention_probs_spatial.launches == 3 and lookup_corr_pyramid.launches == 3 * iters
    for q, (initial, refined, dist) in answers.items():
        assert int(np.argmin(dist)) == q
        np.testing.assert_array_equal(initial, rt.keyframes.poses[q])
        assert np.isfinite(refined).all()
    warm = SlamRuntime(cfg, *weights, start_mode="relocalization", device=cuda)
    for a, b in zip(warm(frames[3]), answers[3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
