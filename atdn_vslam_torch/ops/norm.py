"""The flow encoders' instance norm and the ReLU after it, as one kernel.

Kernel K6 (``csrc/instance_norm.cu``) replaces no TPU kernel: the JAX
package's ``instance_norm`` (``atdn_vslam_tpu/models/flow/extractor.py``)
is left to XLA. It computes what the port's
:class:`~atdn_vslam_torch.models.flow.extractor.InstanceNorm` computes
with ``F.instance_norm`` on a float32 copy: per (b, c) plane the biased
mean and variance in float32, ``(x - mean) / sqrt(var + eps)`` in
float32, then ``max(., 0)`` when ``relu`` is set, rounded once to the
input's type. Only the order of the moments' sums differs. K6 launches
only through its custom op ``atdn::instance_norm``.
"""

from __future__ import annotations

import functools

import torch

from atdn_vslam_torch.ops import _kernels

#: a block's threads (``csrc/instance_norm.cu`` ``kThreads``)
_THREADS = 256
#: a clustered block's resident slice, at most: two fit on an SM
_SLICE_BYTES = 100 * 1024
#: blocks a plane: a cluster's, and the two-pass form's
_MAX_CLUSTER = 16
_MAX_PARTS = 256
#: the two-pass form's slice, about, in elements
_PART_ELEMS = 65536


def instance_norm_plain(x: torch.Tensor, relu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K6 on a (B, C, H, W) tensor: the moments
    of each (b, c) plane in float32 (float64 for a float64 input), the
    variance biased, ``(x - mean) * (1 / sqrt(var + eps))``, ``max(., 0)``
    when ``relu``, rounded once to ``x``'s type."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(dim=(2, 3), keepdim=True)
    centred = x32 - mean
    var = centred.square().mean(dim=(2, 3), keepdim=True)
    y = centred * (1.0 / torch.sqrt(var + eps))
    return (torch.relu(y) if relu else y).to(x.dtype)


def instance_norm(x: torch.Tensor, relu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """K6: the instance norm of a (B, C, H, W) tensor, with the ReLU after
    it when ``relu`` (:func:`instance_norm_plain` gives the contract).

    On CPU tensors this is the plain version; on CUDA tensors (bf16 or
    float32) it launches the kernel through ``atdn::instance_norm`` and
    counts one launch, or raises. The kernel has no backward, so under
    grad mode an input that requires grad raises.
    """
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu, eps)
    _kernels.refuse_autograd("instance_norm (K6)", x)
    _kernels.require_cuda("instance_norm", x)
    return torch.ops.atdn.instance_norm(x, relu, eps)


instance_norm.launches = 0


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(planes: int, n: int, itemsize: int, sms: int) -> tuple[int, bool]:
    """K6's blocks a plane and its form, ``(k, two_pass)``, from the shape.

    Clustered (``two_pass`` False): the least k that fits a slice of the
    plane (n / k elements and two 16-byte vectors of alignment) into
    ``_SLICE_BYTES`` of shared memory and, unless that would cut slices
    below a vector a thread, puts two blocks per SM (``planes * k >= 2 *
    sms``); at most 16, the largest cluster. A plane that 16 slices cannot
    hold takes the two-pass form, about ``_PART_ELEMS`` elements a slice
    and two blocks per SM, at most 256 slices.
    """
    vec = 16 // itemsize
    fill = -(-2 * sms // planes)
    fit = next((k for k in range(1, _MAX_CLUSTER + 1)
                if (-(-n // k) + 2 * vec) * itemsize <= _SLICE_BYTES), None)
    if fit is None:
        return min(_MAX_PARTS, max(fill, -(-n // _PART_ELEMS))), True
    whole = -(-n // (_THREADS * vec))
    return min(_MAX_CLUSTER, max(fit, min(fill, whole))), False


def launch(x: torch.Tensor, relu: bool, eps: float, k: int, two_pass: bool) -> torch.Tensor:
    """One call of K6 on a contiguous, 16-byte aligned CUDA tensor in the
    form ``(k, two_pass)`` (:func:`_plan` picks it for the op; tests and
    ``chip_smoke.py`` force one)."""
    b, c, h, w = x.shape
    planes, n = b * c, h * w
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    parts = torch.empty(planes * k * 3, dtype=torch.float32, device=x.device) if two_pass else None
    status = _kernels.library("instance_norm").atdn_instance_norm(
        x.data_ptr(), out.data_ptr(), 0 if parts is None else parts.data_ptr(), planes, n, k,
        int(two_pass), int(x.dtype == torch.bfloat16), int(relu), eps, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _kernels.check(status, "instance_norm kernel")
    instance_norm.launches += 1
    return out


def _fake(x: torch.Tensor, relu: bool, eps: float) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _cuda(x: torch.Tensor, relu: bool, eps: float) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"instance_norm takes bf16 or float32, got {x.dtype}")
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"instance_norm takes a non-empty (B, C, H, W) tensor, got {tuple(x.shape)}")
    x = _kernels.aligned(x)
    b, c, h, w = x.shape
    k, two_pass = _plan(b * c, h * w, x.element_size(), _sms(x.device.index or 0))
    return launch(x, relu, eps, k, two_pass)


_kernels.define_op(
    "instance_norm", "(Tensor x, bool relu, float eps) -> Tensor",
    instance_norm_plain, _fake, _cuda,
)
