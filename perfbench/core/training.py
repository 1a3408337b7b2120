"""The check of a training cell.

Set-up drives the program's training state through its first three
steps, on three batches that all differ, through the call the window
makes. From those steps it keeps each step's loss, the first gradient as
the optimizer got it (AdamW's first moment after one step divided by
1 - beta1) and each parameter's change after the third step. Once the
window has closed the reference takes the same initial weights through
the same three steps, and the two are compared:

- ``loss_rel``: the largest gap of a step's loss, as a share of the
  reference's;
- ``grad_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient, as a share of the larger of
  the reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same for the change after three steps;
- ``loss_rel_first``, ``grad_gap_median``, ``update_gap_median``: the
  first step's loss alone and the median leaf's gaps, steady from seed
  to seed where Adam's later steps or one small leaf make the others
  swing (a cell's limits file says which numbers it compares).

Both take the leaves whose reference gradient is at least a thousandth
of the median leaf's. The others are nought to rounding: a bias ahead of
an instance or batch norm, whose mean the norm takes away, has a
gradient of rounding alone (1e-9 in float32, far more in bf16), and Adam
moves such a leaf by round-off alone.
"""

from __future__ import annotations

import statistics
import sys

import torch

from perfbench.reference.optim import AdamW, clip_global

STEPS = 3
BETA1 = 0.9
#: leaves under this share of the median leaf's first gradient are left
#: out of ``update_gap``
GRAD_FLOOR = 1e-3


def snapshot(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def first_gradients(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict[str, float]:
    """Each leaf's norm of the gradient the optimizer took at its first
    step, from its first moment (0 for a leaf it took no step on)."""
    return {n: float(torch.linalg.vector_norm(optimizer.state[p]["exp_avg"].double()) / (1.0 - BETA1))
            if "exp_avg" in optimizer.state.get(p, {}) else 0.0
            for n, p in model.named_parameters()}


def changes(model: torch.nn.Module, before: dict[str, torch.Tensor]) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(p.detach().double() - before[n].double()))
            for n, p in model.named_parameters()}


def reference_steps(model: torch.nn.Module, batches: list, loss_of, lr_at, wd: float, eps: float,
                    clip: float | None) -> dict:
    """The reference's three steps from its current weights: plain AdamW
    (decay on every parameter), the global-norm clip when ``clip`` is
    set. ``loss_of(model, batch)`` gives a step's loss."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    before = {n: p.detach().clone() for n, p in zip(names, params)}
    opt = AdamW(params, wd, eps)
    losses, grads = [], None
    for step, batch in enumerate(batches[:STEPS]):
        for p in params:
            p.grad = None
        loss = loss_of(model, batch)
        loss.backward()
        g = [p.grad for p in params]
        if clip is not None:
            g = clip_global(g, clip)
        if step == 0:
            grads = {n: float(torch.linalg.vector_norm(x.double())) for n, x in zip(names, g)}
        opt.step(g, lr_at(step))
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad": grads, "update": changes(model, before)}


def compare(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers above, the gradients' and changes' over the leaves whose reference gradient is at
    least ``GRAD_FLOOR`` of the median leaf's; each leaf's worst gap is
    named on standard error."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"].values())
    kept = [n for n, g in ref["grad"].items() if g >= GRAD_FLOOR * med_g]
    med_u = statistics.median(ref["update"][n] for n in kept)
    gaps = {
        "grad_gap": {n: abs(prog["grad"][n] - ref["grad"][n]) / max(ref["grad"][n], med_g) for n in kept},
        "update_gap": {n: abs(prog["update"][n] - ref["update"][n]) / max(ref["update"][n], med_u) for n in kept},
    }
    out = {"loss_rel": loss_rel, "loss_rel_first": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])}
    for key, by_leaf in gaps.items():
        leaf = max(by_leaf, key=by_leaf.get)
        out[key] = by_leaf[leaf]
        out[f"{key}_median"] = statistics.median(by_leaf.values())
        print(f"{key}: worst leaf {leaf} {by_leaf[leaf]!r}", file=sys.stderr)
    print(f"leaves left out (gradient under {GRAD_FLOOR} of the median leaf's): "
          f"{sorted(set(ref['grad']) - set(kept))}", file=sys.stderr)
    return out


def half_batch(batch):
    """The fault that leaves half of the batch out: the first half alone."""
    return [x[: x.shape[0] // 2] for x in batch]
