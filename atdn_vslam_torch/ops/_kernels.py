"""Build and load the port's CUDA kernels (``atdn_vslam_torch/csrc``).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, into ``build/kernels/`` at the root of
the checkout; a library is named after the hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once.

Every kernel is also a ``torch.library`` custom op under the namespace
``atdn`` (:func:`define_op`): its CUDA implementation launches the
kernel, its CPU implementation is the kernel's plain PyTorch version,
and its fake implementation gives the output's shape, type and strides
from the arguments alone, so ``torch.export`` traces through every
kernel and a loaded artifact launches it (``serving.py``).

Nothing here builds at import time: the CPU tests import every module
of the port on a machine without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the C entry points of each source: name -> argtypes
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "attention_probs": {
        # q, k, ws, out, b, n, n_kv, n_pad, d, splits, scale, is_bf16, device, stream
        "atdn_attention_probs": (_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _P),
        # pass (1 statistics, 2 write), d, blocks (out), device
        "atdn_attention_probs_occupancy": (_I, _I, _IP, _I),
    },
    "corr_lookup": {
        # vol0..3, coords, out, h0..3, w0..3, b, n, levels, radius, is_bf16, device, stream
        "atdn_corr_lookup": (_P,) * 6 + (_I,) * 8 + (_I,) * 6 + (_P,),
        # is_bf16, blocks (out), device
        "atdn_corr_lookup_occupancy": (_I, _IP, _I),
    },
    "flash_attend": {
        # q, k, v, out, b, nq, nk, d, dv, scale, is_bf16, device, stream
        "atdn_flash_attend": (_P,) * 4 + (_I,) * 5 + (_F, _I, _I, _P),
    },
    "corr_dot": {
        # f1, f2, out, b, n, m, c, inv_sqrt_c, in_bf16, out_bf16, device, stream
        "atdn_corr_dot": (_P,) * 3 + (_I,) * 4 + (_F, _I, _I, _I, _P),
        # out_bf16, blocks (out), device
        "atdn_corr_dot_occupancy": (_I, _IP, _I),
    },
    "corr_lookup_nlanes": {
        # vol0..3, coords, out, h0..3, w0..3, b, n, levels, first_level, radius,
        # is_bf16, device, stream
        "atdn_corr_lookup_nlanes": (_P,) * 6 + (_I,) * 8 + (_I,) * 7 + (_P,),
        # is_bf16, blocks (out), device
        "atdn_corr_lookup_nlanes_occupancy": (_I, _IP, _I),
    },
    "apply_probs": {
        # p, v, out, ws, counters, b, m, kp, nv, dv, grid, is_bf16, device, stream
        "atdn_apply_probs": (_P,) * 5 + (_I,) * 8 + (_P,),
    },
    "corr_lookup_slab": {
        # vol0..3, coords, out, hp0..3, w0..3, b, n, levels, radius, is_bf16, device, stream
        "atdn_corr_lookup_slab": (_P,) * 6 + (_I,) * 8 + (_I,) * 6 + (_P,),
        # is_bf16, blocks (out), device
        "atdn_corr_lookup_slab_occupancy": (_I, _IP, _I),
    },
    "corr_dot_tiled": {
        # f1, f2, scratch, out, b, n, hl, wl, c, sb, sh, sw, sc, inv_sqrt_c, in_bf16,
        # out_bf16, device, stream
        "atdn_corr_dot_tiled": (_P,) * 4 + (_I,) * 5 + (_L,) * 4 + (_F, _I, _I, _I, _P),
        # out_bf16, blocks (out), device
        "atdn_corr_dot_tiled_occupancy": (_I, _IP, _I),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's "
        "CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


class _Build:
    """One ``nvcc`` run compiling ``csrc/<name>.cu`` to a temporary file,
    moved into place when it succeeds (concurrent builds never load a
    half-written library)."""

    def __init__(self, name: str):
        self.name = name
        self.out = _lib_path(name)
        self.proc = None
        if self.out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(self.tmp), str(_CSRC / f"{name}.cu")]
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )

    def wait(self) -> str:
        """The compiler's output ("" when the library was up to date)."""
        if self.proc is None:
            return ""
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{self.name}.cu:\n{log}")
        os.replace(self.tmp, self.out)
        (BUILD_DIR / f"{self.name}.ptxas.txt").write_text(log)
        return log


def build_all() -> dict[str, str]:
    """Compile every kernel source that has no up-to-date library,
    one ``nvcc`` process per source, all started together. Returns the
    compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) for each source it built."""
    with _lock:
        builds = [_Build(name) for name in _SIGNATURES]
        return {b.name: b.wait() for b in builds}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build = _Build(name)
            build.wait()
            lib = ctypes.CDLL(str(build.out))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    (the launch was refused, or an argument was rejected)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def blocks_per_sm(name: str, device: torch.device, *args: int) -> int:
    """Blocks of a kernel of ``csrc/<name>.cu`` that stay resident on one
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), through the C
    entry ``atdn_<name>_occupancy(*args, &blocks, device)``: for
    ``corr_dot`` and ``corr_dot_tiled`` args = (out_bf16,) of the
    bf16-input kernel; for ``attention_probs`` (pass, d) of the bf16
    kernels; for ``corr_lookup``, ``corr_lookup_slab`` and
    ``corr_lookup_nlanes`` (is_bf16,), the last for its three-level
    block."""
    blocks = ctypes.c_int(0)
    fn = getattr(library(name), f"atdn_{name}_occupancy")
    check(fn(*args, ctypes.byref(blocks), device.index or 0), f"{name} occupancy")
    return blocks.value


def aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels load 16 bytes
    per thread)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def require_cuda(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` lies on a CUDA device: a wrapper takes its plain
    version on the CPU, its kernel on a CUDA device, and nothing else."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x.device}")


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a kernel that has no backward
    (the JAX package has no VJP for it either): the ctypes launch leaves
    its output without a ``grad_fn``, so the gradient would be silently
    missing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward pass (no VJP in the JAX package either); call it "
            "under torch.no_grad() or torch.inference_mode(), or on tensors that need no gradient"
        )


#: the ``torch.library`` namespace of the kernels' custom ops
_LIBRARY = torch.library.Library("atdn", "DEF")


def define_op(name: str, schema: str, plain: Callable, fake: Callable, cuda: Callable) -> None:
    """Register the custom op ``atdn::<name>`` with ``schema`` (its
    arguments and result, e.g. ``"(Tensor q, Tensor k, int h, int w,
    float scale) -> Tensor"``; no argument is mutated): ``plain`` on CPU
    tensors, ``cuda`` (the launch, which counts it) on CUDA tensors,
    ``fake`` under fake and meta tensors. Each returns a fresh tensor,
    never a view of an input. Callers reach the op as
    ``torch.ops.atdn.<name>``. The op has no autograd kernel: the
    wrappers call it inside their ``autograd.Function``s or refuse
    autograd first. Registered through the dispatcher directly, so a call
    costs one Python kernel call (and imports nothing of
    ``torch._dynamo``, which ``torch.library.custom_op``'s kernels do)."""
    _LIBRARY.define(name + schema)
    _LIBRARY.impl(name, plain, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"atdn::{name}", fake, lib=_LIBRARY)
