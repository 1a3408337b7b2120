"""Model builders from config, and seeded parameter initialisation.

Every builder takes an explicit ``device``, default ``"cuda"``, which
raises on a machine without a GPU; tests pass ``device="cpu"``.
Compute types mirror the JAX package's policy: the flow net computes in
bf16 on the GPU when ``mixed_precision`` is on and in float32
otherwise (always float32 on the CPU); ATDNVO computes in float32, in
training too;
MappingVAE computes in bf16 on the GPU when ``mapping.compute_dtype`` is
``"bfloat16"`` and in float32 otherwise, from float32 parameters.
Batch-norm parameters and statistics stay float32 in every case.
The flow net's training build keeps every parameter float32 and computes
in the same type as the inference build, under ``torch.autocast``
(``RAFTGMA.forward``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from atdn_vslam_torch.config import Config
from atdn_vslam_torch.models.flow.gma import RelPosEmb
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.models.mapping import MappingVAE
from atdn_vslam_torch.models.odometry import ATDNVO
from atdn_vslam_torch.utils.helpers import resolve_device


def flow_compute_dtype(config: Config, device: torch.device) -> torch.dtype:
    if config.flow.mixed_precision and device.type == "cuda":
        return torch.bfloat16
    return torch.float32


def working_size(config: Config) -> tuple[int, int]:
    """The runtime's image size: the configured size padded to /8."""
    h, w = config.slam.image_height, config.slam.image_width
    return -(-h // 8) * 8, -(-w // 8) * 8


def build_flow_model(
    config: Config,
    device: str | torch.device = "cuda",
    use_pallas: bool | None = None,
    corr_nlanes: bool = False,
) -> RAFTGMA:
    """RAFTGMA in the config's widths and compute type. ``use_pallas``
    and ``corr_nlanes`` are :class:`RAFTGMA`'s kernel switches; the
    runtime keeps the defaults (attention by token count, the default
    pyramid), as the JAX factory does on a TPU."""
    dev = resolve_device(device)
    c = config.flow
    dtype = flow_compute_dtype(config, dev)
    model = RAFTGMA(
        iters=c.iters, corr_levels=c.corr_levels, corr_radius=c.corr_radius,
        hidden_dim=c.hidden_dim, context_dim=c.context_dim, heads=c.num_heads,
        dtype=dtype, use_pallas=use_pallas, corr_nlanes=corr_nlanes,
    )
    model.to(dev)
    return cast_flow_model(model, dtype).eval()


def build_flow_train_model(
    config: Config,
    device: str | torch.device = "cuda",
    remat: bool = False,
) -> RAFTGMA:
    """RAFTGMA for training, in ``.train()`` mode: float32 parameters (and
    so float32 optimizer state), computing in the inference build's type
    (bf16 on the GPU with ``mixed_precision``, float32 on the CPU), with
    attention by token count and the kernels on the GPU, as the JAX
    trainer builds it on a TPU (``cli/train_flow.py:141-146``).
    """
    dev = resolve_device(device)
    c = config.flow
    model = RAFTGMA(
        iters=c.iters, corr_levels=c.corr_levels,
        corr_radius=c.corr_radius, hidden_dim=c.hidden_dim, context_dim=c.context_dim,
        heads=c.num_heads, dtype=flow_compute_dtype(config, dev), remat=remat,
    )
    return model.to(dev).train()


def cast_flow_model(model: RAFTGMA, dtype: torch.dtype) -> RAFTGMA:
    """``model`` in ``dtype``, in place, with its batch-norm parameters
    and statistics, and the positional embeddings (which the JAX package
    keeps and scores in float32), kept float32."""
    if dtype != torch.float32:
        model.to(dtype)
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm2d, RelPosEmb)):
                m.float()
    return model


def build_odometry_model(
    config: Config, device: str | torch.device = "cuda", image_hw: tuple[int, int] | None = None
) -> ATDNVO:
    """ATDNVO with every encoder variant and option of
    ``config.odometry`` (``train_compute_dtype`` and ``wpack`` steer TPU
    lowerings and are ignored), in eval mode, for flows of ``image_hw``
    (default: the runtime's working size)."""
    dev = resolve_device(device)
    c = config.odometry
    hw = working_size(config) if image_hw is None else tuple(image_hw)
    model = ATDNVO(hw, c.in_channels, c.lstm_size, c.compressor, c.use_dropout, c.use_layernorm)
    return model.to(dev).eval()


def mapping_compute_dtype(config: Config, device: torch.device) -> torch.dtype:
    if config.mapping.compute_dtype == "bfloat16" and device.type == "cuda":
        return torch.bfloat16
    return torch.float32


def build_mapping_model(config: Config, device: str | torch.device = "cuda") -> MappingVAE:
    """MappingVAE in the config's widths and compute type, parameters in
    float32 (``mapping.wpack`` steers a TPU lowering and is ignored)."""
    dev = resolve_device(device)
    c = config.mapping
    model = MappingVAE(c.variational, c.channels, c.latent_channels, mapping_compute_dtype(config, dev))
    return model.to(dev).eval()


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random parameters, drawn on the CPU from one
    ``torch.Generator`` so that a seed gives the same weights on any
    device: uniform(+-1/sqrt(fan_in)) for convolutions (transposed ones
    too), linear layers and LSTM cells (PyTorch's own default bounds),
    identity batch and layer norm, standard normal embeddings (GMA's
    positional ones: the JAX package's ``normal(1.0)``).
    GMA's ``gamma`` keeps its reference initial value 0."""
    g = torch.Generator().manual_seed(seed)

    def fill(p: torch.Tensor, bound: float) -> None:
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            fill(m.weight, bound)
            if m.bias is not None:
                fill(m.bias, bound)
        elif isinstance(m, nn.LSTMCell):
            for p in m.parameters():
                fill(p, 1.0 / math.sqrt(m.hidden_size))
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.empty(m.weight.shape).normal_(generator=g))
    return module
