#!/usr/bin/env python3
"""Time edited copies of a bf16 kernel of the PyTorch port on one GPU.

    python3 kernel_variants.py NAME DIR [DIR ...]

NAME is one of flash_attend, apply_probs, corr_dot, corr_dot_tiled,
attention_probs, corr_lookup.

Each DIR holds an edited copy of ``atdn_vslam_torch/csrc/<name>.cu``
and of every header it includes (``hopper.cuh``; for ``corr_dot`` and
``corr_dot_tiled`` also ``corr_dot_wgmma.cuh`` and
``corr_dot_tiles.cuh``; for ``attention_probs`` ``corr_dot_wgmma.cuh``).
Each copy is built with the port's ``nvcc`` flags, its C entry point
called through ctypes on chip_smoke's inputs (K5 and K3 at 2x KITTI,
28952 tokens; K4 on K1's KITTI output; K3t on the four KITTI levels,
level 0 the NHWC view of a channels-first map, staged into a scratch
buffer as the wrapper does; K1 at KITTI with the wrapper's split count;
K2 on the KITTI and the 2x KITTI pyramids), checked against the plain
version, and timed with chip_smoke's ``time_ms`` (K4 with a per-call
zeroed counter buffer); the last lines time the tree's own wrapper. One
JSON line per copy and input: ptxas's register, spill and wgmma lines,
the max abs error, whether it is within the kernel's chip_smoke
tolerance, and the ms of three timings. Exits non-zero when no CUDA
device is present.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def build(name: str, path: str) -> tuple[ctypes.CDLL | None, list[str]]:
    from atdn_vslam_torch.ops import _kernels

    out = os.path.join(path, f"lib{name}.so")
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", path, "-o", out, os.path.join(path, f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    log = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
           if any(w in ln for w in ("registers", "spill", "wgmma", "error"))]
    if r.returncode != 0:
        return None, log
    lib = ctypes.CDLL(out)
    fn = getattr(lib, f"atdn_{name}")
    fn.argtypes = list(_kernels._SIGNATURES[name][f"atdn_{name}"])
    fn.restype = ctypes.c_int
    return lib, log


NAMES = ("flash_attend", "apply_probs", "corr_dot", "corr_dot_tiled", "attention_probs", "corr_lookup")


def cases(name: str, dev: torch.device, stream: int) -> list[dict]:
    """The inputs of ``name``'s chip_smoke line as cases: a label, ``call(fn)``
    launching the C entry ``fn`` into ``out()``, the plain version's
    ``ref``, and ``tree()`` calling the tree's own wrapper."""
    import chip_smoke
    from atdn_vslam_torch.ops import attention as att
    from atdn_vslam_torch.ops import corr_dot_tiled as k3t
    from atdn_vslam_torch.ops import corr_lookup

    if name == "flash_attend":
        g = torch.Generator(device=dev).manual_seed(5)
        n, d = 94 * 308, 128
        q = (torch.randn((1, n, d), generator=g, device=dev) * d**-0.5).to(torch.bfloat16)
        k, v = (torch.randn((1, n, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        out = torch.empty_like(q)
        return [{"label": "2x", "out": lambda: out, "ref": att.flash_attend_plain(q, k, v, 1.0),
                 "call": lambda fn: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, n,
                                       n, d, d, 1.0, 1, 0, stream),
                 "tree": lambda: att.flash_attend(q, k, v, 1.0)}]
    if name == "corr_dot":
        g = torch.Generator(device=dev).manual_seed(6)
        n, c = 94 * 308, 256
        f1, f2 = (torch.randn((1, n, c), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        out = torch.empty((1, n, n), dtype=torch.bfloat16, device=dev)
        return [{"label": "2x level 0", "out": lambda: out,
                 "ref": corr_lookup.corr_dot_rowmajor_plain(f1, f2, c**-0.5),
                 "call": lambda fn: fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), 1, n, n, c,
                                       c**-0.5, 1, 1, 0, stream),
                 "tree": lambda: corr_lookup.corr_dot_rowmajor(f1, f2, c**-0.5)}]
    if name == "corr_dot_tiled":
        f1, levels = chip_smoke.k3t_inputs(dev, (47, 154), 256, 10)
        n, c = f1.shape[1:]
        outs = [torch.empty((1, n, *f2l.shape[1:3]), dtype=torch.bfloat16, device=dev) for f2l in levels]
        scratch = [None if f2l.is_contiguous() and f2l.data_ptr() % 16 == 0
                   else torch.empty((1, f2l.shape[1] * f2l.shape[2], c), dtype=torch.bfloat16, device=dev)
                   for f2l in levels]

        def call(fn):
            status = 0
            for f2l, o, sc in zip(levels, outs, scratch):
                status = status or fn(
                    f1.data_ptr(), f2l.data_ptr(), None if sc is None else sc.data_ptr(), o.data_ptr(),
                    1, n, f2l.shape[1], f2l.shape[2], c, *f2l.stride(), c**-0.5, 1, 1, 0, stream)
            return status

        return [{"label": "KITTI levels", "out": lambda: torch.cat([o.flatten() for o in outs]),
                 "ref": torch.cat([k3t.corr_dot_tiled_plain(f1, f2l, c**-0.5).flatten() for f2l in levels]),
                 "call": call, "tree": lambda: [k3t.corr_dot_tiled(f1, f2l, c**-0.5) for f2l in levels]}]
    if name == "attention_probs":
        g = torch.Generator(device=dev).manual_seed(0)
        h, w, d = 47, 154, 128
        n = h * w
        q = (torch.randn((1, n, d), generator=g, device=dev) * d**-0.5).to(torch.bfloat16)
        k = torch.randn((1, n, d), generator=g, device=dev).to(torch.bfloat16)
        n_pad = -(-n // 128) * 128
        splits = att._probs_splits(1, n, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        ws = torch.empty((1, splits, n, 2), dtype=torch.float32, device=dev)
        out = torch.empty((1, n, n_pad), dtype=torch.bfloat16, device=dev)
        return [{"label": "KITTI", "out": lambda: out.reshape(1, h, w, n_pad),
                 "ref": att.attention_probs_spatial_plain(q, k, h, w, 1.0),
                 "call": lambda fn: fn(q.data_ptr(), k.data_ptr(), ws.data_ptr(), out.data_ptr(), 1, n,
                                       n, n_pad, d, splits, 1.0, 1, 0, stream),
                 "tree": lambda: att.attention_probs_spatial(q, k, h, w, 1.0)}]
    if name == "corr_lookup":
        result = []
        for label, hw8 in (("KITTI", (47, 154)), ("2x", (94, 308))):
            f1, f2, coords = chip_smoke.lookup_inputs(dev, hw8, 256, torch.bfloat16, 1)
            pyr = corr_lookup.build_corr_pyramid(f1, f2, 4, dtype=torch.bfloat16)
            flat = coords.reshape(-1, 2).contiguous()
            out = torch.empty((1, *hw8, 324), dtype=torch.float32, device=dev)
            result.append({
                "label": label, "out": lambda out=out: out,
                "ref": corr_lookup.lookup_corr_pyramid_plain(pyr, coords, 4),
                "call": lambda fn, pyr=pyr, flat=flat, out=out, n=hw8[0] * hw8[1]: fn(
                    *(v.data_ptr() for v in pyr), flat.data_ptr(), out.data_ptr(),
                    *(v.shape[2] for v in pyr), *(v.shape[3] for v in pyr), 1, n, 4, 4, 1, 0, stream),
                "tree": lambda pyr=pyr, coords=coords: corr_lookup.lookup_corr_pyramid(pyr, coords, 4),
            })
        return result
    probs, v, _ = chip_smoke.k4_inputs(dev, (47, 154), 128, 8)
    b, h, w, kp = probs.shape
    out = torch.empty((b, h, w, 128), dtype=torch.bfloat16, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid, tiles = att._apply_probs_split(b, h * w, kp, sms)
    ws = torch.empty((grid, att._APPLY_PARTIALS), dtype=torch.float32, device=dev)

    def call(fn):
        counters = torch.zeros((tiles, 2), dtype=torch.int32, device=dev)
        return fn(probs.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  counters.data_ptr(), b, h * w, kp, v.shape[1], 128, grid, 1, 0, stream)

    return [{"label": "K1's KITTI output", "out": lambda: out,
             "ref": att.flash_apply_probs_plain(probs, v), "call": call,
             "tree": lambda: att.flash_apply_probs(probs, v)}]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2 or args[0] not in NAMES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    name, dirs = args[0], args[1:]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tol = {"flash_attend": chip_smoke.K5_TOL, "apply_probs": chip_smoke.K4_TOL,
           "attention_probs": chip_smoke.K1_TOL, "corr_lookup": chip_smoke.K2_TOL}.get(name, chip_smoke.K3_TOL)
    runs = cases(name, dev, stream)
    for path in dirs:
        lib, log = build(name, path)
        for case in runs:
            row = {"variant": path, "case": case["label"], "ptxas": log}
            if lib is not None:
                fn = getattr(lib, f"atdn_{name}")
                status = case["call"](fn)
                torch.cuda.synchronize()
                row["status"] = status
                if status == 0:
                    out, ref = case["out"](), case["ref"]
                    row["max_abs_err"] = float(torch.nan_to_num((out.float() - ref.float()).abs()).max())
                    try:
                        chip_smoke.check_close(name, out, ref, **tol)
                        row["within_tolerance"] = True
                    except AssertionError:
                        row["within_tolerance"] = False
                    row["ms"] = [chip_smoke.time_ms(lambda: case["call"](fn), dev) for _ in range(3)]
            print(json.dumps(row), flush=True)
    for case in runs:
        print(json.dumps({"variant": "tree wrapper", "case": case["label"],
                          "ms": [chip_smoke.time_ms(case["tree"], dev) for _ in range(3)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
