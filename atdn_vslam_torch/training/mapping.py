"""MappingVAE training, the runtime's online map building (JAX
``training/mapping.py``; ref: slam_framework/neural_slam.py:305-352).

  * AdamW (lr 1e-3, weight decay 1e-3) on every parameter, the learning
    rate on a per-step cosine from ``lr`` to ``eta_min``
    (neural_slam.py:310-321);
  * inputs get a per-image brightness and saturation jitter
    (neural_slam.py:323,329);
  * targets are the *unjittered* images resized to the decoder's output,
    blurred and ImageNet-normalised (neural_slam.py:332-334);
  * loss: reconstruction MSE + saturation L1 (``training/losses.py``).

Random draws come from explicit generators: the batch order from
``np.random.default_rng(seed)`` as in the JAX package, the jitter
factors from a ``torch.Generator`` seeded with ``seed``.

Data parallel (``mesh=``, JAX ``make_train_step(mesh=...)``): every rank
draws the order and the jitter factors of the whole batch and takes its
slice of both; batch norm sees the whole batch and loss and gradients
are averaged over the "data" ranks before the step, which then equals
the single-process step.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F

from atdn_vslam_torch.config import MappingTrainConfig, TrainConfig
from atdn_vslam_torch.models.blocks import global_batch
from atdn_vslam_torch.models.factory import init_params
from atdn_vslam_torch.models.mapping import MappingVAE, normalize_rgb
from atdn_vslam_torch.parallel.distributed import all_reduce
from atdn_vslam_torch.parallel.mesh import shard_batch
from atdn_vslam_torch.training.losses import mapping_reconstruction_loss
from atdn_vslam_torch.utils.helpers import full_float32

JitterFactors = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def jitter_factors(
    batch: int, generator: torch.Generator, brightness: float = 0.1, saturation: float = 0.1
) -> JitterFactors:
    """One draw of :func:`color_jitter`'s factors per image: brightness and
    saturation uniform in [1 - a, 1 + a), and whether brightness goes
    first."""
    bf = (1.0 - brightness) + 2.0 * brightness * torch.rand(batch, generator=generator)
    sf = (1.0 - saturation) + 2.0 * saturation * torch.rand(batch, generator=generator)
    first_bright = torch.rand(batch, generator=generator) < 0.5
    return bf, sf, first_bright


def color_jitter(images: torch.Tensor, factors: JitterFactors) -> torch.Tensor:
    """Brightness and saturation jitter of NHWC [0, 255] RGB, in the
    image's own op order with a clamp after each op (torchvision's
    ``ColorJitter`` semantics; the reference's hue jitter of amplitude
    1e-3 is left out, as in the JAX package)."""
    bf, sf, first_bright = (f.to(images.device).view(-1, 1, 1, 1) for f in factors)

    def bright(x):
        return torch.clamp(x * bf, 0.0, 255.0)

    def sat(x):
        gray = x.mean(dim=-1, keepdim=True)
        return torch.clamp(gray + sf * (x - gray), 0.0, 255.0)

    return torch.where(first_bright, sat(bright(images)), bright(sat(images)))


def gaussian_blur_5x5(images: torch.Tensor) -> torch.Tensor:
    """Separable 5x5 gaussian, sigma 1.1 (torchvision's default for a
    5-tap kernel) with zero padding, as the JAX package (torchvision
    pads by reflection) (ref: TF.gaussian_blur(im, [5, 5]),
    neural_slam.py:333). NHWC."""
    x = torch.arange(-2, 3, dtype=images.dtype, device=images.device)
    kernel = torch.exp(-0.5 * (x / 1.1) ** 2)
    kernel = kernel / kernel.sum()
    c = images.shape[-1]
    y = images.permute(0, 3, 1, 2)
    y = F.conv2d(y, kernel.view(1, 1, 5, 1).expand(c, 1, 5, 1), padding=(2, 0), groups=c)
    y = F.conv2d(y, kernel.view(1, 1, 1, 5).expand(c, 1, 1, 5), padding=(0, 2), groups=c)
    return y.permute(0, 2, 3, 1)


def mapping_target(images: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """The reconstruction target: NHWC [0, 255] images resized
    bilinearly to ``hw`` (antialiased when downscaling, as
    ``jax.image.resize``), blurred, normalised; float32."""
    x = F.interpolate(
        images.float().permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
        align_corners=False, antialias=True,
    ).permute(0, 2, 3, 1)
    return normalize_rgb(gaussian_blur_5x5(x))


def cosine_lr(cfg: MappingTrainConfig | TrainConfig, steps_total: int) -> Callable[[int], float]:
    """Step -> learning rate, ``optax.cosine_decay_schedule(lr,
    steps_total, alpha=eta_min / lr)``: step t uses lr(t). Takes the
    map's or the odometry's training config."""
    decay = max(steps_total, 1)
    alpha = cfg.eta_min / cfg.lr

    def lr(step: int) -> float:
        t = min(step, decay)
        return cfg.lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + alpha)

    return lr


def make_optimizer(model: torch.nn.Module, cfg: MappingTrainConfig, steps_total: int):
    """(AdamW on every parameter, its per-step cosine schedule): call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.wd
    )
    lr = cosine_lr(cfg, steps_total)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda t: lr(t) / cfg.lr)
    return optimizer, scheduler


def train_step(model: MappingVAE, optimizer, scheduler, images: torch.Tensor,
               factors: JitterFactors, mesh=None) -> torch.Tensor:
    """One optimizer step on a batch of NHWC uint8 images; returns the
    loss. The batch-norm statistics move in the training forward; the
    gradients stay in the parameters' ``.grad`` until the next step.

    :param mesh: ``images`` and ``factors`` are this rank's slices of the
        global batch; loss, gradients and statistics are the global
        batch's.
    """
    images = images.float()
    model.train()
    optimizer.zero_grad()
    group = None if mesh is None else mesh.data_group
    with global_batch(group):
        _, _, _, decoded = model(color_jitter(images, factors))
    with torch.no_grad():
        target = mapping_target(images, decoded.shape[1:3])
    loss = mapping_reconstruction_loss(decoded, target)
    with full_float32():
        loss.backward()
    if group is not None:
        params = [p for p in model.parameters() if p.grad is not None]
        *grads, loss = all_reduce([p.grad for p in params] + [loss.detach()[None]], group, mean=True)
        for p, g in zip(params, grads):
            p.grad = g
        loss = loss[0]
    optimizer.step()
    scheduler.step()
    return loss.detach()


def train_mapping(
    model: MappingVAE,
    cfg: MappingTrainConfig,
    images: np.ndarray,
    log_fn: Callable[[int, float], None] | None = None,
    save_fn: Callable[[MappingVAE], None] | None = None,
    init_state_dict: dict | None = None,
    mesh=None,
) -> MappingVAE:
    """Map building over keyframe images (N, H, W, 3) uint8
    (ref: neural_slam.py:305-352). Starts from ``init_state_dict`` or
    from seeded weights (``cfg.seed``), trains ``model`` in place on its
    device and returns it in eval mode.

    :param log_fn: called with (epoch, mean loss) after each epoch.
    :param save_fn: called with the model after each epoch (the
        reference saves the weights every epoch, neural_slam.py:347-348).
    :param mesh: split each batch over the "data" ranks (each rank passes
        the same ``images``). The batch is rounded down to a multiple of
        the data size; with fewer keyframes than ranks each rank trains
        alone on the whole batch, the JAX package's rule.
    """
    n = len(images)
    batch = min(cfg.batch_size, n)
    if mesh is not None:
        batch = batch // mesh.data * mesh.data
        if batch == 0:
            mesh, batch = None, min(cfg.batch_size, n)
    steps_per_epoch = max(n // batch, 1)
    steps_total = cfg.epochs * steps_per_epoch
    if init_state_dict is None:
        init_params(model, cfg.seed)
    else:
        model.load_state_dict(init_state_dict)
    optimizer, scheduler = make_optimizer(model, cfg, steps_total)
    device = next(model.parameters()).device
    generator = torch.Generator().manual_seed(cfg.seed)
    order_rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        order = order_rng.permutation(n)
        epoch_loss = 0.0
        for i in range(steps_per_epoch):
            idx = order[i * batch : (i + 1) * batch]
            imgs, factors = images[idx], jitter_factors(len(idx), generator)
            if mesh is not None:
                imgs, *factors = shard_batch(mesh, (imgs, *factors))
            imgs = torch.from_numpy(imgs).to(device)
            loss = train_step(model, optimizer, scheduler, imgs, tuple(factors), mesh)
            epoch_loss += float(loss)
        if log_fn is not None:
            log_fn(epoch, epoch_loss / steps_per_epoch)
        if save_fn is not None:
            save_fn(model)
    return model.eval()
