"""Conv and linear blocks of the odometry and mapping networks
(ref: atdn_vslam/layers/conv.py:7-197, layers/linear.py:5-41).

Block order is conv -> activation -> batch norm, as in the reference
(``bn(act(conv(x)))``); the residual block's skip is a strided 1x1 conv
and the sum goes through activation and batch norm. Attribute names
follow the reference ``state_dict`` (``conv``/``bn``, ``skip_layer``,
``out_block``, ``linear``).

``dtype`` is a block's compute type, as in the JAX blocks: convolutions
and activations run in it from float32 parameters, batch norm computes
in float32 and its output is cast back. float32 (the default) computes
exactly as a plain ``bn(mish(conv(x)))``.

Inside :func:`global_batch`, batch norm in training mode takes its
statistics over the whole batch of a data-parallel step, every rank's
slice of it together, and dropout takes its rank's slice of a mask drawn
for the whole batch: the step computes what one process would on the
whole batch, as flax's batch norm and dropout do under GSPMD.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from atdn_vslam_torch.parallel.distributed import all_reduce_sum_grad, group_rank, group_size

#: the data group whose ranks' batch slices make up the batch of a
#: training forward (set by :func:`global_batch`)
_batch_group = None


@contextlib.contextmanager
def global_batch(group):
    """Training forwards inside see the whole batch of ``group`` (a "data"
    process group whose ranks each hold an equal slice, rank order;
    None: the local batch is the batch): batch norm takes its statistics
    over every slice, dropout its rank's part of one mask."""
    global _batch_group
    prev, _batch_group = _batch_group, group
    try:
        yield
    finally:
        _batch_group = prev


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation x * tanh(softplus(x))."""
    return F.mish(x)


def cast_conv(conv: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x)`` computed in ``dtype``: input, weight and bias cast to it
    (flax's ``nn.Conv(dtype=...)``), the parameters themselves unchanged."""
    if x.dtype == dtype == conv.weight.dtype:
        return conv(x)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(
            x.to(dtype), w, b, conv.stride, conv.padding, conv.output_padding, conv.groups, conv.dilation
        )
    return conv._conv_forward(x.to(dtype), w, b)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with the JAX package's statistics (flax
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``).

    It computes in float32 on a float32 copy of its input (float64 stays
    float64). In training
    mode it normalises with the biased batch variance, as torch does, and
    moves ``running_var`` towards the *biased* variance with momentum
    0.1, where ``nn.BatchNorm2d`` takes the unbiased one. Eval mode is
    ``nn.BatchNorm2d``'s. The ``state_dict`` keys are unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return super().forward(x)
        if _batch_group is not None:
            return self._global_forward(x, _batch_group)
        # momentum 1 hands back this batch's mean and unbiased variance
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        self._track(mean, var, (n - 1) / n)
        return out

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        """Training statistics over the group's whole batch: the sums of
        x, then of the squared deviations from the global mean, and the
        element count, each summed over the ranks by an all-reduce whose
        gradient flows back to every rank."""
        dims = [0, *range(2, x.ndim)]
        count = x.new_full((1,), x.numel() // x.shape[1])
        sums = all_reduce_sum_grad(torch.cat([x.sum(dim=dims), count]), group)
        n = sums[-1]
        mean = sums[:-1] / n
        shape = [1, -1] + [1] * (x.ndim - 2)
        dev = x - mean.view(shape)
        var = all_reduce_sum_grad((dev * dev).sum(dim=dims), group) / n
        out = dev * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            out = out * self.weight.view(shape) + self.bias.view(shape)
        self._track(mean.detach(), var.detach(), 1.0)
        return out

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor, to_biased: float) -> None:
        """Move the running statistics towards ``mean`` and the biased
        variance ``var * to_biased``."""
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum * to_biased)
        self.num_batches_tracked.add_(1)


class ConvBlock(nn.Module):
    """Conv -> Mish -> BatchNorm."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=padding)
        self.bn = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(mish(cast_conv(self.conv, x, self.dtype))).to(self.dtype)


class ResidualConvBlock(nn.Module):
    """Two 3x3 ConvBlocks plus a strided 1x1 skip, then Mish and
    BatchNorm on the sum."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Sequential(
            ConvBlock(cin, cin, 3, 1, 1, dtype), ConvBlock(cin, cout, 3, stride, 1, dtype)
        )
        self.skip_layer = nn.Conv2d(cin, cout, 1, stride)
        self.out_block = nn.Sequential(nn.Mish(), BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x) + cast_conv(self.skip_layer, x, self.dtype)
        return self.out_block(y).to(self.dtype)


class TransposedConvBlock(nn.Module):
    """3x3 ConvBlock -> 3x3 stride-2 transposed conv (torch arithmetic,
    out = 2 * in - 1) -> Mish -> BatchNorm, plus a skip: the block's
    input resized bilinearly to the output's size, then a 1x1 conv; Mish
    and BatchNorm on the sum (JAX ``models/blocks.py:343-410``)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvBlock(cin, cout, 3, 1, 1, dtype)
        self.tconv = nn.ConvTranspose2d(cout, cout, 3, 2, 1)
        self.bn = BatchNorm2d(cout, eps=1e-5)
        self.skip_layer = nn.Conv2d(cin, cout, 1)
        self.out_block = nn.Sequential(nn.Mish(), BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = cast_conv(self.tconv, self.conv(x), self.dtype)
        y = self.bn(mish(y)).to(self.dtype)
        skip = F.interpolate(x.to(self.dtype), size=y.shape[-2:], mode="bilinear", align_corners=False)
        return self.out_block(y + cast_conv(self.skip_layer, skip, self.dtype)).to(self.dtype)


class DUCBlock(nn.Module):
    """Dense-upscale conv: a 3x3 ConvBlock to 4 x ``cout`` channels,
    then a 2x pixel shuffle (channel c * 4 + 2 * dy + dx goes to channel
    c at offset (dy, dx))."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBlock(cin, 4 * cout, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), 2)


class ConnectedDUCBlock(nn.Module):
    """U-Net up step: concatenate the direct and skip inputs on the
    channels, a 3x3 ConvBlock back to the direct input's width, then a
    :class:`DUCBlock`."""

    def __init__(self, cin_direct: int, cin_skip: int, cout: int):
        super().__init__()
        self.conv = ConvBlock(cin_direct + cin_skip, cin_direct, 3, 1, 1)
        self.duc = DUCBlock(cin_direct, cout)

    def forward(self, direct: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.duc(self.conv(torch.cat([direct, skip], dim=1)))


class Dropout(nn.Dropout):
    """``nn.Dropout`` that draws its masks from ``generator`` once one is
    set (a ``torch.Generator`` on the input's device; the odometry
    trainer sets one seeded from its config), else from torch's default
    generator. Identity in eval mode."""

    generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0 or self.generator is None:
            return super().forward(x)
        n, r = group_size(_batch_group), group_rank(_batch_group)
        shape = (x.shape[0] * n, *x.shape[1:])  # the whole batch's mask, this rank's rows
        u = torch.rand(shape, generator=self.generator, device=x.device, dtype=x.dtype)
        keep = u[r * x.shape[0] : (r + 1) * x.shape[0]] >= self.p
        return x * keep / (1.0 - self.p)


class LinearBlock(nn.Module):
    """Linear -> Mish -> [LayerNorm] -> [Dropout 0.2]
    (ref: layers/linear.py:5-41). The layer norm is flax's
    ``nn.LayerNorm()``: the last axis, epsilon 1e-6."""

    def __init__(self, fin: int, fout: int, norm: bool = False, dropout: bool = False):
        super().__init__()
        self.linear = nn.Linear(fin, fout)
        self.norm = nn.LayerNorm(fout, eps=1e-6) if norm else None
        self.dropout = Dropout(0.2) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = mish(self.linear(x))
        if self.norm is not None:
            x = self.norm(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x
