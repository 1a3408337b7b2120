"""Logging, timing, device and precision helpers (ref:
atdn_vslam/utils/helpers.py:7-111).

``Clock`` synchronises the device before reading the clock when the
result it is handed lies on a GPU (``torch.cuda.synchronize``): CUDA
launches return before the work ends, so a reference-style
``time.time()`` pair would measure the launches alone.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.utils._pytree as pytree


def log(*args) -> None:
    """Dashed-banner print (ref: helpers.py:7-22)."""
    msg = " ".join(str(a) for a in args)
    print("-" * max(len(msg), 8))
    print(msg)
    print("-" * max(len(msg), 8))


class Clock:
    """tick/tock timer with optional device sync and txt flush
    (ref: helpers.py:43-88)."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: list[float] = []
        self._start: float | None = None

    def tick(self) -> None:
        self._start = time.perf_counter()

    def tock(self, result=None) -> float:
        """Seconds since :meth:`tick`; first waits for the device of every
        CUDA tensor in ``result`` (a tensor or a nest of them)."""
        if self.sync and result is not None:
            for dev in {x.device for x in pytree.tree_leaves(result) if isinstance(x, torch.Tensor)}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        if self._start is None:
            raise RuntimeError("tock() without tick()")
        dt = time.perf_counter() - self._start
        self.times.append(dt)
        self._start = None
        return dt

    def __enter__(self):
        self.tick()
        return self

    def __exit__(self, *exc):
        self.tock()
        return False

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def total(self) -> float:
        return float(np.sum(self.times))

    def save(self, path: str) -> None:
        np.savetxt(path, np.asarray(self.times))


def shape_log(tag: str, x) -> None:
    """Print the shapes of a tensor or a nest of tensors (ref:
    ShapeLogLayer, helpers.py:25-40)."""
    shapes = pytree.tree_map(lambda a: tuple(a.shape), x)
    print(f"[shape] {tag}: {shapes}")


class BetaScheduler:
    """Linear KLD-weight warmup (ref: helpers.py:91-111)."""

    def __init__(self, warmup_steps: int, beta_max: float = 1.0):
        self.warmup_steps = max(warmup_steps, 1)
        self.beta_max = beta_max

    def __call__(self, step: int) -> float:
        return self.beta_max * min(step / self.warmup_steps, 1.0)


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
