"""AdamW (Loshchilov and Hutter, ICLR 2019) with the decay applied to
every parameter, the global-norm clip (g / norm * max when norm >= max)
and the two learning-rate schedules of the benchmark's training jobs, in
plain PyTorch."""

from __future__ import annotations

import math

import torch


def cosine(lr: float, eta_min: float, steps_total: int):
    """Cosine decay from lr to eta_min over steps_total steps."""
    alpha = eta_min / lr

    def at(step: int) -> float:
        t = min(step, steps_total)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / steps_total)) + alpha)

    return at


def warmup_cosine(lr: float, steps_total: int, pct_start: float = 0.05):
    """Linear warm-up from lr/25 to lr over pct_start of the run, then a
    cosine to lr/1e4."""
    warmup = max(1, int(pct_start * steps_total))
    decay = max(steps_total, warmup + 1)
    init, end = lr / 25.0, lr / 1e4

    def at(step: int) -> float:
        if step < warmup:
            return init + (lr - init) * step / warmup
        t = min(max(step - warmup, 0), decay - warmup) / (decay - warmup)
        return end + (lr - end) * 0.5 * (1.0 + math.cos(math.pi * t))

    return at


def clip_global(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if norm < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


class AdamW:
    def __init__(self, params: list[torch.Tensor], wd: float, eps: float, betas=(0.9, 0.999)):
        self.params, self.wd, self.eps, self.betas = params, wd, eps, betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - lr * self.wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v / (1.0 - b2**self.t)).sqrt() + self.eps
            p.sub_(lr / (1.0 - b1**self.t) * m / denom)
