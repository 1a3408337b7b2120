"""Logging, device and precision helpers."""

from __future__ import annotations

import contextlib

import torch


def log(*args) -> None:
    """Dashed-banner print (ref: helpers.py:7-22)."""
    msg = " ".join(str(a) for a in args)
    print("-" * max(len(msg), 8))
    print(msg)
    print("-" * max(len(msg), 8))


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of
    every entry point) raises when no GPU is present instead of quietly
    running on the CPU; pass ``device="cpu"`` to ask for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_float32():
    """Run float32 convolutions and matmuls in full float32.

    cuDNN computes float32 convolutions in TF32 by default, which keeps
    about three decimal digits; the port's float32 paths (ATDNVO, and
    the flow net when ``mixed_precision`` is off) ask for float32 on
    purpose. No effect on the CPU or on bfloat16 work."""
    cudnn_prev = torch.backends.cudnn.allow_tf32
    mm_prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_prev
        torch.backends.cuda.matmul.allow_tf32 = mm_prev
