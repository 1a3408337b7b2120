"""Multi-process bootstrap and the collectives of the parallel paths
(JAX ``parallel/distributed.py``).

One process per device. ``initialize`` reads the same three settings as
the JAX package, from its arguments or from the environment
(``ATDN_COORDINATOR_ADDRESS``, ``ATDN_NUM_PROCESSES``,
``ATDN_PROCESS_ID``), and starts ``torch.distributed`` with a TCP
rendezvous at the coordinator's address. The backend is an argument:
``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU unless the caller
names one; nothing switches it. Two ranks on one card need ``"gloo"``
(NCCL refuses a second rank on the same GPU); gloo runs all-reduce,
all-gather and broadcast on CUDA tensors itself.

The collectives take a process group (a mesh axis, ``parallel/mesh.py``)
or ``None``, the single-process mesh, for which they are the identity.
A group of one process still runs its collective, so a one-rank NCCL
run goes through a real communicator.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

#: environment variables that request a multi-process run (the JAX
#: package's names)
ENV_COORDINATOR = "ATDN_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "ATDN_NUM_PROCESSES"
ENV_PROCESS_ID = "ATDN_PROCESS_ID"


def multiprocess_config(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[str, int, int] | None:
    """The (coordinator, num_processes, process_id) triple from the
    arguments, else the environment; None for a single-process run.
    Raises ``ValueError`` when only part of it is given."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator_address is None and num_processes is None:
        return None
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "multi-process bootstrap needs all three of coordinator_address, num_processes, "
            f"process_id (got {coordinator_address!r}, {num_processes!r}, {process_id!r})"
        )
    return coordinator_address, int(num_processes), int(process_id)


def default_backend(device: str | torch.device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Start the process group of a multi-process run: False (and
    nothing started) on a single process, True once the group exists.
    Idempotent.

    :param coordinator_address: ``host:port`` of rank 0's rendezvous
        (``tcp://`` is prepended when no scheme is given).
    :param backend: ``"nccl"`` or ``"gloo"``; None takes
        :func:`default_backend` of ``device``.
    :param device: the device this process computes on; with NCCL it
        becomes the current CUDA device (:func:`local_device`).
    """
    cfg = multiprocess_config(coordinator_address, num_processes, process_id)
    if cfg is None:
        return False
    if dist.is_initialized():
        return True
    address, world, process_id = cfg
    backend = backend or default_backend(device)
    init_method = address if "://" in address else f"tcp://{address}"
    kwargs = {}
    if backend == "nccl":
        dev = local_device(device, process_id)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=process_id, **kwargs)
    return True


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device: str | torch.device = "cuda", index: int | None = None) -> torch.device:
    """This rank's device: a CUDA device without an index becomes card
    ``index % device_count`` (default: this rank; ranks share cards
    round-robin); any other device is returned as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    index = rank() if index is None else index
    return torch.device("cuda", index % torch.cuda.device_count())


def host_shard(items: list, process_index: int | None = None, process_count: int | None = None) -> list:
    """This process's part of a work list (sequences, keyframe ranges),
    round-robin."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]


def allgather_host_arrays(x: np.ndarray) -> list[np.ndarray]:
    """Every process's array, in rank order, on every process; ``[x]``
    on a single process."""
    if world_size() == 1:
        return [x]
    gathered: list = [None] * world_size()
    dist.all_gather_object(gathered, np.asarray(x))
    return gathered


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(tensors: list[torch.Tensor], group, mean: bool = False) -> list[torch.Tensor]:
    """Sum (or mean) of each tensor over ``group``, through one flat
    buffer per dtype: new tensors, the inputs untouched. ``None`` (one
    process) hands the tensors back as they are."""
    if group is None:
        return list(tensors)
    out: list[torch.Tensor | None] = [None] * len(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    n = dist.get_world_size(group)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        if mean:
            flat /= n
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose gradient is the sum of the ranks'
    gradients: every rank's loss reads the reduced value."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity for None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def band_bounds(n: int, size: int, index: int) -> tuple[int, int]:
    """Rows [lo, hi) of band ``index`` when ``n`` rows split into
    ``size`` bands as evenly as they go (the first ``n % size`` bands a
    row longer)."""
    base, extra = divmod(n, size)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def gather_bands(x: torch.Tensor, group, dim: int, n: int) -> torch.Tensor:
    """All-gather of the bands of :func:`band_bounds` along ``dim``: each
    rank passes its band of the ``n`` rows and receives all ``n`` in
    order. Bands are padded to the longest for the collective and cut
    back after it. No gradient."""
    if group is None:
        return x
    size = dist.get_world_size(group)
    longest = band_bounds(n, size, 0)[1]
    own = x.shape[dim]
    if own < longest:
        pad_shape = list(x.shape)
        pad_shape[dim] = longest - own
        x = torch.cat([x, x.new_zeros(pad_shape)], dim=dim)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    cut = [p.narrow(dim, 0, band_bounds(n, size, i)[1] - band_bounds(n, size, i)[0]) for i, p in enumerate(parts)]
    return torch.cat(cut, dim=dim)
