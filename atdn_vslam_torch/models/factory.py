"""Model builders from config, and seeded parameter initialisation.

Every builder takes an explicit ``device``, default ``"cuda"``, which
raises on a machine without a GPU; tests pass ``device="cpu"``.
Compute types mirror the JAX package's policy: the flow net computes in
bf16 on the GPU when ``mixed_precision`` is on and in float32
otherwise (always float32 on the CPU); ATDNVO computes in float32.
Batch-norm parameters and statistics stay float32 in either case.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from atdn_vslam_torch.config import Config
from atdn_vslam_torch.models.flow.network import RAFTGMA
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


def cast_flow_model(model: RAFTGMA, dtype: torch.dtype) -> RAFTGMA:
    """``model`` in ``dtype``, in place, with its batch-norm parameters
    and statistics kept float32."""
    if dtype != torch.float32:
        model.to(dtype)
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.float()
    return model


def build_odometry_model(config: Config, device: str | torch.device = "cuda") -> ATDNVO:
    dev = resolve_device(device)
    c = config.odometry
    if not c.compressor or c.use_dropout or c.use_layernorm:
        raise NotImplementedError(
            "only the compressor ATDNVO without dropout or layer norm is ported"
        )
    model = ATDNVO(working_size(config), c.in_channels, c.lstm_size)
    return model.to(dev).eval()


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random parameters, drawn on the CPU from one
    ``torch.Generator`` so that a seed gives the same weights on any
    device: uniform(+-1/sqrt(fan_in)) for convolutions, linear layers
    and LSTM cells (PyTorch's own default bounds), identity batch norm.
    GMA's ``gamma`` keeps its reference initial value 0."""
    g = torch.Generator().manual_seed(seed)

    def fill(p: torch.Tensor, bound: float) -> None:
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            fill(m.weight, bound)
            if m.bias is not None:
                fill(m.bias, bound)
        elif isinstance(m, nn.LSTMCell):
            for p in m.parameters():
                fill(p, 1.0 / math.sqrt(m.hidden_size))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
