"""GMFlow's share of the arithmetic of ``core/flops.py`` and
``core/roofline.py``: the reference built from a configuration, the
operations of a streamed frame by type, and the work of each attention
kernel call a frame makes (K5r on the shifted windows, K5 on the
unshifted windows, the matching and the propagation).

The work of K5r counts the query-key pairs inside a region only: the
kernel's share of its roofline then reads the same work whatever it
does with the pairs it leaves out."""

from __future__ import annotations

import torch

from perfbench.core import roofline
from perfbench.core.flops import _count
from perfbench.reference.atdnvo import ATDNVO
from perfbench.reference.gmflow import GMFlow
from perfbench.reference.precision import Precision

#: the matching's grid and the propagated flow: 2 columns, zero-extended
#: to K5's narrowest value width
FLOW_WIDTH = 2
VALUE_WIDTH = 16


def reference(cfg: dict, precision: str = "float32", matching: str = "float32") -> GMFlow:
    f = cfg["flow"]
    return GMFlow(f["feature_channels"], f["num_transformer_layers"], f["ffn_dim_expansion"], f["attn_splits"],
                  f["padding_factor"], Precision(precision), Precision(matching))


def padded_hw8(cfg: dict) -> tuple[int, int]:
    """The transformer's token grid: the frame padded to /padding_factor, over 8."""
    pf = cfg["flow"]["padding_factor"]
    return -(-cfg["image_height"] // pf) * pf // 8, -(-cfg["image_width"] // pf) * pf // 8


def stream_frame(cfg: dict) -> dict[str, float]:
    """One streamed frame: the backbone on the new frame (the previous
    one's features are cached), the transformer on both, the upsampler
    in the flow net's type; matching, propagation and ATDNVO on one flow
    in float32."""
    h, w = cfg["image_height"], cfg["image_width"]
    h8, w8 = padded_hw8(cfg)
    c = cfg["flow"]["feature_channels"]
    with torch.device("meta"), torch.no_grad():
        net, odo = reference(cfg), ATDNVO((h, w), cfg["odometry"]["lstm_size"])
        im = torch.empty(1, h, w, 3)
        feats = torch.empty(1, c, h8, w8)
        flow = torch.empty(1, 2, h8, w8)
        low = _count(lambda: net.backbone(net._prep(im), net.P))
        low += _count(lambda: net.transform(feats, feats))
        low += _count(lambda: net.upsample(flow, feats))
        high = _count(lambda: net.match(feats, feats)) + _count(lambda: net.propagate(feats, flow))
        high += _count(lambda: odo(torch.empty(1, 1, h, w, 2), odo.init_carry(1, "meta")))
    out = {cfg["flow"]["compute_dtype"]: low}
    kind = cfg["flow"]["matching_dtype"]
    out[kind] = out.get(kind, 0.0) + high
    return out


def region_pairs(cfg: dict) -> int:
    """Query-key pairs inside a region over the windows of one frame's
    shifted layer: sum over windows and regions of (tokens in it)^2."""
    h8, w8 = padded_hw8(cfg)
    s = cfg["flow"]["attn_splits"]
    ws_h, ws_w = h8 // s, w8 // s
    rows = torch.zeros(h8, dtype=torch.long)
    cols = torch.zeros(w8, dtype=torch.long)
    rows[h8 - ws_h : h8 - ws_h // 2], rows[h8 - ws_h // 2 :] = 1, 2
    cols[w8 - ws_w : w8 - ws_w // 2], cols[w8 - ws_w // 2 :] = 1, 2
    ids = (3 * rows[:, None] + cols[None]).reshape(s, ws_h, s, ws_w).permute(0, 2, 1, 3).reshape(s * s, -1)
    return int(sum((torch.bincount(window) ** 2).sum() for window in ids))


def k5r_call(cfg: dict) -> tuple[float, float]:
    """(bytes, operations) of one K5r call: both frames' windows of one
    shifted layer; q, k, v and the region ids read, the output written;
    q k^T and p v over the in-region pairs."""
    h8, w8 = padded_hw8(cfg)
    d = cfg["flow"]["feature_channels"]
    tokens = 2 * h8 * w8
    size = roofline.SIZE[cfg["flow"]["compute_dtype"]]
    return 4 * tokens * d * size + 4 * tokens, 2.0 * 2 * region_pairs(cfg) * (d + d)


def k5_calls(cfg: dict) -> list[tuple[float, float, str]]:
    """(bytes, operations, type) of each K5 call of a frame, at its own
    shape: one per unshifted layer (both frames' windows, in the flow
    net's type), the matching and the propagation (all tokens, float32).
    The last two read and write their 2 value columns zero-extended to
    16, and their work counts the 2 alone: what the function needs."""
    f = cfg["flow"]
    h8, w8 = padded_hw8(cfg)
    s, d = f["attn_splits"], f["feature_channels"]
    windows, n = 2 * s * s, h8 * w8 // (s * s)
    byts, ops = roofline.flash_attend(n, n, d, d, f["compute_dtype"])
    unshifted = 2 * ((f["num_transformer_layers"] + 1) // 2)
    calls = [(windows * byts, windows * ops, f["compute_dtype"])] * unshifted
    n = h8 * w8
    glob = roofline.flash_attend(n, n, d, VALUE_WIDTH, f["matching_dtype"])[0], 2.0 * n * n * (d + FLOW_WIDTH)
    return calls + [(*glob, f["matching_dtype"])] * 2
