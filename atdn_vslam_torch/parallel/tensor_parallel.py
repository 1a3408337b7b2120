"""Tensor parallelism over the mesh's "model" ranks: the split that the
JAX package's ``model_parallel_sharding`` asks GSPMD for, with its
collectives written out.

A split layer holds its rank's rows of the output features and computes
only those; its output is all-gathered (:func:`gather_from_model`) so
that every later layer sees the whole activation, as under GSPMD. The
whole tensors it reads (the input, the LSTM state, the replicated
biases, of which it uses only its units' rows) go through
:func:`copy_to_model`, whose backward sums their gradients over the
model ranks: each rank computes its part of them, and after the sum
every replicated parameter's gradient is whole on every model rank
(equal up to the rounding of each rank's own kernels, which the odometry
train step averages away). Biases stay whole on every rank, as the JAX
rule replicates 1-D leaves.

:func:`shard_model` swaps the modules the rule picks (``nn.Linear`` for
:class:`ColumnParallelLinear`, ``nn.LSTMCell`` for
:class:`ColumnParallelLSTMCell`) in place; every rank slices the same
whole weights. The ``state_dict`` keys stay the reference's; a split
parameter's tensor is the rank's rows. :func:`gathered_state_dict` and
:func:`load_state_dict` convert between that and the whole
``state_dict``; :func:`gathered_optimizer_state` and
:func:`shard_optimizer_state` do the same for an optimiser's moments.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from atdn_vslam_torch.parallel.distributed import all_reduce
from atdn_vslam_torch.parallel.mesh import Mesh, Split, model_parallel_sharding


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the group."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=v) if g is None else g for g, (s, d, v) in zip(grads, ctx.like)]
        return (None, *all_reduce(grads, ctx.group))


def copy_to_model(*xs: torch.Tensor, group) -> tuple[torch.Tensor, ...]:
    """The tensors as they are; their gradients summed over ``group`` (a
    "model" group; None: the identity)."""
    return xs if group is None else _CopyToModel.apply(group, *xs)


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last dim; the backward takes the rank's own
    part of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, dy):
        index = dist.get_rank(ctx.group)
        return dy[..., index * ctx.width : (index + 1) * ctx.width].contiguous(), None


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Every model rank's ``x`` joined along the last dim in rank order
    (None: ``x``)."""
    return x if group is None else _GatherFromModel.apply(x, group)


class ColumnParallelLinear(nn.Module):
    """``nn.Linear`` whose weight holds this rank's rows (output
    features); the output is gathered whole. ``bias`` stays whole."""

    def __init__(self, linear: nn.Linear, mesh: Mesh, split: Split):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.group, self.splits = mesh.model_group, {"weight": split}
        rows = split.rows(linear.out_features, mesh.model, mesh.model_index).to(linear.weight.device)
        self.register_buffer("rows", rows, persistent=False)
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone())
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            (x,) = copy_to_model(x, group=self.group)
            return gather_from_model(F.linear(x, self.weight), self.group)
        x, bias = copy_to_model(x, self.bias, group=self.group)
        return gather_from_model(F.linear(x, self.weight, bias[self.rows]), self.group)


class ColumnParallelLSTMCell(nn.Module):
    """``nn.LSTMCell`` that computes this rank's hidden units: the rows of
    its units in each of the four gates (i, f, g, o) of the weights the
    rule split (a weight it keeps whole is read at those rows), the
    biases whole. ``forward(x, (h, c))`` takes and returns the whole
    state; each rank updates its units' part of ``c`` and the new ``h``
    and ``c`` are gathered."""

    def __init__(self, cell: nn.LSTMCell, mesh: Mesh, splits: dict[str, Split | None]):
        super().__init__()
        self.input_size, self.hidden_size = cell.input_size, cell.hidden_size
        self.group, self.splits = mesh.model_group, {k: v for k, v in splits.items() if v is not None}
        self.units = cell.hidden_size // mesh.model
        self.first = mesh.model_index * self.units
        rows = Split(4).rows(4 * cell.hidden_size, mesh.model, mesh.model_index).to(cell.weight_ih.device)
        self.register_buffer("rows", rows, persistent=False)
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            p = getattr(cell, name).detach()
            setattr(self, name, nn.Parameter((p[rows] if name in self.splits else p).clone()))

    def forward(self, x: torch.Tensor, hx: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        h, c = hx
        whole = [n for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh") if n not in self.splits]
        x, h, c, *read = copy_to_model(x, h, c, *(getattr(self, n) for n in whole), group=self.group)
        p = {n: getattr(self, n) for n in self.splits} | {n: t[self.rows] for n, t in zip(whole, read)}
        gates = F.linear(x, p["weight_ih"], p["bias_ih"]) + F.linear(h, p["weight_hh"], p["bias_hh"])
        i, f, g, o = gates.reshape(x.shape[0], 4, self.units).unbind(1)
        c = torch.sigmoid(f) * c[:, self.first : self.first + self.units] + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        h, c = gather_from_model(torch.stack([h, c]), self.group).unbind(0)
        return h, c


def shard_model(model: nn.Module, mesh: Mesh, splits: dict[str, Split | None] | None = None) -> nn.Module:
    """Swap, in place, every module holding a parameter that ``splits``
    (default: :func:`model_parallel_sharding` of ``model``) splits for
    its column-parallel form, cut from the module's own whole weights;
    returns ``model``. Raises ``NotImplementedError`` for a split
    convolution (none at ATDNVO's widths)."""
    if splits is None:
        splits = model_parallel_sharding(mesh, model)
    for prefix, module in list(model.named_modules()):
        mine = {n: splits.get(f"{prefix}.{n}" if prefix else n) for n, _ in module.named_parameters(recurse=False)}
        if not any(mine.values()):
            continue
        if isinstance(module, nn.Linear):
            new = ColumnParallelLinear(module, mesh, mine["weight"])
        elif isinstance(module, nn.LSTMCell):
            new = ColumnParallelLSTMCell(module, mesh, mine)
        else:
            raise NotImplementedError(f"no column-parallel form of {type(module).__name__} ({prefix})")
        parent, _, name = prefix.rpartition(".")
        setattr(model.get_submodule(parent), name, new)
    return model


def _split_modules(model: nn.Module):
    """(``state_dict`` key, split, module) of every split parameter."""
    for prefix, module in model.named_modules():
        for name, split in getattr(module, "splits", {}).items():
            yield (f"{prefix}.{name}" if prefix else name), split, module


def model_splits(model: nn.Module) -> dict[str, Split]:
    """The split parameters of a sharded model by ``state_dict`` key."""
    return {key: split for key, split, _ in _split_modules(model)}


def model_group(model: nn.Module):
    """The "model" group a sharded model's split modules gather over
    (None when nothing is split)."""
    return next((module.group for _, _, module in _split_modules(model)), None)


def _gather_rows(split: Split, x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return split.join(parts)


def gather_split(model: nn.Module, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``tensors`` (named as the ``state_dict``: parameters, their
    gradients) with every split one gathered whole; a collective over the
    model group that every model rank calls."""
    splits, group = model_splits(model), model_group(model)
    return {k: _gather_rows(splits[k], v, group) if k in splits else v for k, v in tensors.items()}


def gathered_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a sharded model, as one process's
    unsplit model holds it (a collective over the group its split
    modules hold: every model rank calls it)."""
    return gather_split(model, model.state_dict())


def _rows(model: nn.Module) -> dict[str, torch.Tensor]:
    """This rank's rows of each split parameter, by ``state_dict`` key."""
    return {key: module.rows for key, _, module in _split_modules(model)}


def load_state_dict(model: nn.Module, whole: dict[str, torch.Tensor]):
    """Load a whole ``state_dict`` into a sharded model (or an unsplit
    one): each split parameter takes this rank's rows."""
    rows = _rows(model)
    return model.load_state_dict({k: v[rows[k].to(v.device)] if k in rows else v for k, v in whole.items()})


def gathered_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module) -> dict:
    """The optimiser's ``state_dict`` with the moments of every split
    parameter gathered whole (an optimiser built over
    ``model.parameters()``; a collective over the model group)."""
    sd = optimizer.state_dict()
    splits, group = model_splits(model), model_group(model)
    state = {}
    for i, name in enumerate(n for n, _ in model.named_parameters()):
        if i in sd["state"]:
            s = sd["state"][i]
            state[i] = {k: _gather_rows(splits[name], v, group) if name in splits and _is_moment(v) else v
                        for k, v in s.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_optimizer_state(whole: dict, model: nn.Module) -> dict:
    """A whole optimiser ``state_dict`` cut to this rank's rows of each
    split parameter's moments: what :meth:`Optimizer.load_state_dict`
    of the sharded model's optimiser takes."""
    rows = _rows(model)
    state = {}
    for i, name in enumerate(n for n, _ in model.named_parameters()):
        if i in whole["state"]:
            s = whole["state"][i]
            state[i] = {k: v[rows[name].to(v.device)] if name in rows and _is_moment(v) else v
                        for k, v in s.items()}
    return {"state": state, "param_groups": whole["param_groups"]}


def _is_moment(v) -> bool:
    """A per-element optimiser state (not AdamW's 0-d ``step``)."""
    return torch.is_tensor(v) and v.ndim >= 1
