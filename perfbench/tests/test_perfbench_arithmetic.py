"""The operation and byte counts at the configurations' shapes.

Operations per unit, counted by ``FlopCounterMode`` over the reference
(``core/flops.py``), against the figures counted over the port's float32
CPU path. They differ by a known amount: the port multiplies the
attention by a value matrix padded to a multiple of 128 tokens (KITTI:
7296 for 7238). The Cityscapes frame is held to the KITTI frame's count:
its convolutions scale with the pixels (both cameras halve exactly down
to 1/8), the attention and the correlation volume with the tokens'
products.
"""

from __future__ import annotations

import math

import pytest

from perfbench.core import flops, roofline, spec

KITTI_N, KITTI2X_N, D, ITERS = 47 * 154, 94 * 308, 128, 12
CITYSCAPES_HW8, FNET = (128, 256), 256


def _cfg(name):
    return spec.load_cell(name).config


def test_stream_frame_operations():
    kitti = flops.stream_frame(_cfg("kitti_stream"))
    padding = 2.0 * KITTI_N * (7296 - KITTI_N) * D * ITERS
    assert math.isclose(kitti["bfloat16"] + padding, 896.8e9, rel_tol=2e-4)
    assert math.isclose(kitti["float32"], 1.28e9, rel_tol=5e-3)
    cityscapes = flops.stream_frame(_cfg("cityscapes_stream"))
    n = CITYSCAPES_HW8[0] * CITYSCAPES_HW8[1]
    per_pixel = (kitti["bfloat16"] - _tokens_products((47, 154))) / KITTI_N
    assert math.isclose(cityscapes["bfloat16"], per_pixel * n + _tokens_products(CITYSCAPES_HW8), rel_tol=1e-9)
    # ATDNVO: the encoder's convolutions at about the pixels' ratio, and its 3360-wide linear layer
    assert 4.0 * kitti["float32"] < cityscapes["float32"] < 4.9 * kitti["float32"]


def _tokens_products(hw8) -> float:
    """The scores once and the attention applied in every iteration, and
    the correlation volume's four levels (features pooled, odd edges cut)."""
    n = hw8[0] * hw8[1]
    levels = [(hw8[0] >> k) * (hw8[1] >> k) for k in range(4)]
    return 2.0 * n * n * D * (1 + ITERS) + sum(2.0 * n * m * FNET for m in levels)


def test_training_operations():
    cell = spec.load_cell("kitti_odometry_train")
    per_window = flops.odometry_step(cell.config, cell.traffic)["float32"] / cell.config["train"]["batch_size"]
    assert math.isclose(per_window, 23.06e9, rel_tol=5e-4)
    flow = spec.load_cell("kitti_flow_train")
    per_pair = flops.flow_step(flow.config, flow.traffic)["bfloat16"] / flow.traffic["batch"]
    # forward and backward, every iteration upsampled: more than 3x the 522 GFLOP forward
    assert 3 * 522e9 < per_pair < 3.5 * 522e9


def test_kernel_bounds():
    # the kernel table's bounds: K1 105.6 MB written + 3.7 MB read; K5 4.29e11 operations
    k1_bytes, k1_ops = roofline.attention_probs(KITTI_N, D, "bfloat16")
    assert math.isclose(k1_bytes, 105.6e6 + 3.7e6, rel_tol=2e-3)
    assert roofline.bound_s(k1_bytes, k1_ops, "bfloat16") == pytest.approx(0.0326e-3, rel=5e-3)
    k5_bytes, k5_ops = roofline.flash_attend(KITTI2X_N, KITTI2X_N, D, D, "bfloat16")
    assert math.isclose(k5_ops, 4.29e11, rel_tol=2e-3)
    assert roofline.bound_s(k5_bytes, k5_ops, "bfloat16") == pytest.approx(0.434e-3, rel=5e-3)
    # K2 at the identity coordinates, KITTI and 2x: the kernel table's 0.00394 and 0.0168 ms are of
    # coordinates spread around the identity, 5% far outside, so within a few percent
    k2 = roofline.bound_s(*roofline.corr_lookup((47, 154), 4, 4, "bfloat16"), "bfloat16")
    k2x = roofline.bound_s(*roofline.corr_lookup((94, 308), 4, 4, "bfloat16"), "bfloat16")
    assert k2 == pytest.approx(0.00394e-3, rel=0.1) and k2x == pytest.approx(0.0168e-3, rel=0.1)
