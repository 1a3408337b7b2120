"""The ("data", "model") mesh over the ranks of a multi-process run
(JAX ``parallel/mesh.py``).

Rank ``r`` sits at (data index, model index) = divmod(r, model). The
"data" group of a rank holds the ranks of its model index (training
batches and the keyframe map split over it); its "model" group the ranks
of its data index (the image rows of the flow net split over it).
Without a process group the mesh is the single process, 1 x 1, whose
groups are ``None`` and whose collectives are the identity.

:func:`model_parallel_sharding` is the JAX package's tensor-parallel
rule: it picks the large parameters that split over "model" by their
output features, deciding each on its JAX layout; ``tensor_parallel``
swaps the modules that hold them for column-parallel ones.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from atdn_vslam_torch.config import MeshConfig
from atdn_vslam_torch.parallel.distributed import group_rank


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a data x model grid of processes.

    :param data_group: the process group of this rank's "data" axis, or
        None on a single process; model_group: of its "model" axis.
    """

    data: int
    model: int
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return group_rank(self.data_group)

    @property
    def model_index(self) -> int:
        return group_rank(self.model_group)

    def group(self, axis: str):
        if axis not in ("data", "model"):
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self.data_group if axis == "data" else self.model_group


def make_mesh(config: MeshConfig | None = None) -> Mesh:
    """A ("data", "model") mesh over the ranks of the process group (one
    process if there is none). Axis sizes of -1 fill with the remaining
    ranks, data first; ``ValueError`` when data x model exceeds them.
    Every rank must call it (each creates every group); a rank past data
    x model takes part and gets None."""
    config = config or MeshConfig()
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = config.model if config.model > 0 else 1
    data = config.data if config.data > 0 else n // model
    if data * model > n or data < 1:
        raise ValueError(f"Mesh {data}x{model} needs {data * model} processes, have {n}")
    if not dist.is_initialized():
        return Mesh(1, 1)
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model):  # the "data" axis of model index m
        g = dist.new_group([d * model + m for d in range(data)])
        if rank < data * model and rank % model == m:
            data_group = g
    for d in range(data):  # the "model" axis of data index d
        g = dist.new_group([d * model + m for m in range(model)])
        if rank < data * model and rank // model == d:
            model_group = g
    if rank >= data * model:
        return None
    return Mesh(data, model, data_group, model_group)


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of the leading axis of each tensor (or array) in
    ``batch``, a tensor or a tuple/list of them, split over "data".
    Raises ``ValueError`` on a batch the data size does not divide (the
    data pipeline drops the last partial batch)."""
    single = not isinstance(batch, (tuple, list))
    items = [batch] if single else list(batch)
    size, index = mesh.data, mesh.data_index
    out = []
    for x in items:
        if x.shape[0] % size != 0:
            raise ValueError(f"Batch axis {x.shape[0]} not divisible by data-axis size {size}")
        per = x.shape[0] // size
        out.append(x[index * per : (index + 1) * per])
    if single:
        return out[0]
    return tuple(out) if isinstance(batch, tuple) else out


@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter splits over "model": its dim 0 (the output
    features) holds ``blocks`` equal blocks (the four gates of an LSTM
    cell's weights, one block for a linear layer's), and model rank ``m``
    of ``size`` holds part ``m`` of each block."""

    blocks: int = 1

    def rows(self, n: int, size: int, index: int) -> torch.Tensor:
        """The indices of rank ``index``'s rows among ``n``."""
        block = n // self.blocks
        part = block // size
        base = torch.arange(index * part, (index + 1) * part)
        return torch.cat([base + b * block for b in range(self.blocks)])

    def join(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's rows, in rank order."""
        blocks = [p.chunk(self.blocks) for p in parts]
        return torch.cat([b[i] for i in range(self.blocks) for b in blocks])


def model_parallel_sharding(mesh: Mesh, model: nn.Module, min_size: int = 65_536) -> dict[str, Split | None]:
    """The JAX package's tensor-parallel rule (``parallel/mesh.py``
    ``model_parallel_sharding``) for ``model``'s ``state_dict``: a leaf
    of the JAX layout splits over "model" when it is at least 2-D, the
    "model" size divides its last dim and it holds at least ``min_size``
    elements; everything else (every 1-D tensor and buffer) is
    replicated, None. A split over one rank is no split: all None.

    The leaves are the JAX package's: a linear layer's (in, out) kernel
    (the port's (out, in) weight splits its rows), an LSTM cell's (in, H)
    and (H, H) kernels per gate (decided for each of ``weight_ih`` and
    ``weight_hh``; each rank holds its units' rows of every gate), a
    convolution's (kh, kw, in, out) kernel. Raises ``ValueError`` on a
    parameter of another module of 2-D or more.
    """
    size = mesh.shape["model"]
    splits: dict[str, Split | None] = dict.fromkeys(model.state_dict())

    def rule(fin: int, fout: int, blocks: int = 1) -> Split | None:
        return Split(blocks) if size > 1 and fout % size == 0 and fin * fout >= min_size else None

    for prefix, module in model.named_modules():
        key = f"{prefix}." if prefix else ""
        if isinstance(module, nn.Linear):
            splits[key + "weight"] = rule(module.in_features, module.out_features)
        elif isinstance(module, nn.LSTMCell):
            h = module.hidden_size
            splits[key + "weight_ih"] = rule(module.input_size, h, 4)
            splits[key + "weight_hh"] = rule(h, h, 4)
        elif isinstance(module, nn.Conv2d):
            w = module.weight
            splits[key + "weight"] = rule(w[0].numel(), w.shape[0])
        else:
            for name, p in module.named_parameters(recurse=False):
                if p.ndim >= 2:
                    raise ValueError(f"no JAX layout known for {key + name} of {type(module).__name__}")
    return splits
