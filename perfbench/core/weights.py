"""Seeded weights, made on the device from one generator in one call.

The state dict of a template module gives the names and shapes. Every
convolution, linear and LSTM tensor is drawn uniform(+-bound) from one
``torch.rand`` over all of them: bound 1/sqrt(fan_in) for convolution and
linear weights and their biases, 1/sqrt(hidden) for LSTM tensors
(PyTorch's default bounds). Batch norm starts as the identity (weight
1, bias 0, mean 0, variance 1). ``fill`` sets named tensors to a value,
or each row of a named tensor to a value of a list (``None`` keeps the
row's draw); ``gain`` scales named tensors.
"""

from __future__ import annotations

import math

import torch


def _bound(name: str, shape: torch.Size, sd: dict) -> float | None:
    """The uniform bound of a tensor, None for a norm's tensors."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        return 1.0 / math.sqrt(shape[0] // 4)
    if leaf == "weight" and len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "bias":
        weight = sd.get(name[: -len("bias")] + "weight")
        if weight is not None and weight.ndim >= 2:
            return 1.0 / math.sqrt(math.prod(weight.shape[1:]))
    return None


@torch.no_grad()
def seeded_states(templates: list[dict], seed: int, device, fill: dict | None = None,
                  gain: dict | None = None) -> list[dict]:
    """One state dict per template (name -> tensor, float32 on ``device``)."""
    fill, gain = fill or {}, gain or {}
    drawn = [[(k, v.shape, _bound(k, v.shape, sd)) for k, v in sd.items()] for sd in templates]
    total = sum(math.prod(s) for entries in drawn for _, s, b in entries if b is not None)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device)
    out, offset = [], 0
    for entries, sd in zip(drawn, templates):
        state = {}
        for name, shape, bound in entries:
            n = math.prod(shape)
            if bound is not None:
                t = (u[offset : offset + n].reshape(shape) * 2.0 - 1.0) * (bound * gain.get(name, 1.0))
                offset += n
            elif name.endswith("num_batches_tracked"):
                t = torch.zeros((), dtype=torch.long, device=device)
            elif name.endswith(("running_var", "weight")):
                t = torch.ones(shape, device=device)
            else:
                t = torch.zeros(shape, device=device)
            value = fill.get(name)
            if isinstance(value, list):
                for row, v in enumerate(value):
                    if v is not None:
                        t[row] = float(v)
            elif value is not None:
                t = torch.full(shape, float(value), device=device)
            state[name] = t
        out.append(state)
    return out
