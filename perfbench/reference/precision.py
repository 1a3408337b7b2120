"""The arithmetic the reference computes in.

``Precision("float32")`` is the reference itself: float32 operands, and
on a GPU with TF32 off (:func:`float32_only`). The two lower precisions
are the controls of the check: the reference put in the program's place
one step below what a configuration states. Each rounds the operands of
every convolution and matrix product, and in a backward pass the
gradient that reaches each product's output, and accumulates in
float32, which is what the hardware does in those types:

- ``tf32``: operands rounded to 10 mantissa bits (round to nearest even),
  the control of a float32 model;
- ``fp8``: operands scaled per tensor to the e4m3 range and rounded to
  ``float8_e4m3fn`` (gradients to ``float8_e5m2``, as fp8 training
  keeps them), the control of a bf16 model.

``bf16`` (operands rounded to bfloat16) is no control: it gives the gap
that bf16 operands alone open, the yardstick of a bf16 model's gap.

The rounding is emulated, so a control reads the same on the CPU and the
card. The gradient of a rounding is taken as 1 (straight through).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

KINDS = ("float32", "tf32", "bf16", "fp8")


@contextlib.contextmanager
def float32_only():
    """TF32 off for cuDNN and cuBLAS while the reference runs, as before after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    keep = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return keep.view(torch.float32)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _round_fp8(x: torch.Tensor, kind=torch.float8_e4m3fn) -> torch.Tensor:
    scale = torch.finfo(kind).max / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(kind).to(torch.float32) / scale


_ROUND = {"tf32": _round_tf32, "bf16": _round_bf16, "fp8": _round_fp8}
_ROUND_GRAD = {"tf32": _round_tf32, "bf16": _round_bf16,
               "fp8": lambda g: _round_fp8(g, torch.float8_e5m2)}


class _RoundGrad(torch.autograd.Function):
    """Identity forward; rounds the gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ROUND_GRAD[ctx.kind](g.contiguous()), None


class Precision:
    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"unknown precision {kind!r}, not one of {KINDS}")
        self.kind = kind

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        rounded = _ROUND[self.kind](x.detach())
        return x + (rounded - x.detach())

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32" or not y.requires_grad:
            return y
        return _RoundGrad.apply(y, self.kind)

    def conv2d(self, x, conv: torch.nn.Conv2d) -> torch.Tensor:
        return self.output(F.conv2d(self.operand(x), self.operand(conv.weight), conv.bias, conv.stride,
                                    conv.padding, conv.dilation, conv.groups))

    def linear(self, x, weight, bias=None) -> torch.Tensor:
        return self.output(F.linear(self.operand(x), self.operand(weight), bias))

    def matmul(self, a, b) -> torch.Tensor:
        return self.output(torch.matmul(self.operand(a), self.operand(b)))
