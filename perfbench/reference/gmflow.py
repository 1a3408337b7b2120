"""GMFlow (Xu, Zhang, Cai, Rezatofighi, Tao, CVPR 2022, "GMFlow: Learning
Optical Flow via Global Matching", arXiv:2111.13680), the one-scale
published model, in plain PyTorch: the reference of the benchmark's
second flow net.

It follows the published code (github.com/haofeixu/gmflow:
``gmflow/gmflow.py``, ``backbone.py``, ``transformer.py``,
``matching.py``, ``utils.py``, ``position.py``), layer by layer in its
own layouts: the backbone on ``(x / 255 - mean) / std``, the sine
position encoding added per window, the feature transformer on the
flattened features with both directions batched (``concat0``,
``concat1``), its shifted windows rolled with ``torch.roll`` and masked
by the published additive -100 between regions, the global matching's
softmax over every key, the propagation whose key is projected from the
projected query, and the convex x8 upsampling. Frames are replicate-
padded at the bottom and the right to /``padding_factor`` and the flows
cropped back (the published 'kitti' padder centres the width's padding;
KITTI's 1232 columns need none). No cache, no kernel, nothing of the
program. Module and parameter names are the published ``state_dict``'s.

Two :class:`Precision` s: ``precision`` for the backbone, the
transformer and the upsampler (bf16 in the configuration), ``matching``
for the matching and the propagation (float32 in the configuration);
the reference itself is float32 in both, and every stage runs with
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False (restored after it). Images
are NHWC in [0, 255], flows NHWC with channels (x, y), features NCHW.
``features``, ``transform``, ``match``, ``propagate`` and ``upsample``
are the forward's stages, so that a check can run each from the
program's own input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.gma import convex_upsample
from perfbench.reference.precision import Precision, float32_only

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, padding=1, stride=stride, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride), nn.InstanceNorm2d(planes))

    def forward(self, x, P: Precision):
        y = F.relu(F.instance_norm(P.conv2d(x, self.conv1)))
        y = F.relu(F.instance_norm(P.conv2d(y, self.conv2)))
        if self.downsample is not None:
            x = F.instance_norm(P.conv2d(x, self.downsample[0]))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    def __init__(self, out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1), ResidualBlock(64, 64, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 2), ResidualBlock(128, 128, 1))
        self.conv2 = nn.Conv2d(128, out, 1)

    def forward(self, x, P: Precision):
        x = F.relu(F.instance_norm(P.conv2d(x, self.conv1)))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, P)
        return P.conv2d(x, self.conv2)


def position_sine(b: int, h: int, w: int, num_pos_feats: int, device) -> torch.Tensor:
    """``PositionEmbeddingSine(num_pos_feats, 10000, normalize=True)``
    of a (b, ., h, w) input: (b, 2 num_pos_feats, h, w)."""
    mask = torch.ones((b, h, w), device=device)
    y_embed = mask.cumsum(1, dtype=torch.float32)
    x_embed = mask.cumsum(2, dtype=torch.float32)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = 10000 ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def split_feature(x: torch.Tensor, s: int, channel_last: bool = False) -> torch.Tensor:
    if channel_last:  # (B, H, W, C) -> (B s s, H/s, W/s, C)
        b, h, w, c = x.shape
        return x.view(b, s, h // s, s, w // s, c).permute(0, 1, 3, 2, 4, 5).reshape(b * s * s, h // s, w // s, c)
    b, c, h, w = x.shape  # (B, C, H, W) -> (B s s, C, H/s, W/s)
    return x.view(b, c, s, h // s, s, w // s).permute(0, 2, 4, 1, 3, 5).reshape(b * s * s, c, h // s, w // s)


def merge_splits(x: torch.Tensor, s: int, channel_last: bool = False) -> torch.Tensor:
    if channel_last:
        b, h, w, c = x.shape
        return x.view(b // s // s, s, s, h, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b // s // s, s * h, s * w, c)
    b, c, h, w = x.shape
    return x.view(b // s // s, s, s, c, h, w).permute(0, 3, 1, 4, 2, 5).reshape(b // s // s, c, s * h, s * w)


def shift_window_mask(h: int, w: int, ws_h: int, ws_w: int, sh: int, sw: int, device) -> torch.Tensor:
    """The published attention mask of the shifted windows: (s^2, L, L),
    -100 between tokens of different regions, 0 within one."""
    img_mask = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws_h), slice(-ws_h, -sh), slice(-sh, None)):
        for ws in (slice(0, -ws_w), slice(-ws_w, -sw), slice(-sw, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    windows = split_feature(img_mask, w // ws_w, channel_last=True).view(-1, ws_h * ws_w)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def window_attention(q, k, v, splits: int, shift: bool, h: int, w: int, mask, P: Precision):
    """``single_head_split_window_attention``: (B, L, C) each."""
    b, _, c = q.shape
    q, k, v = (x.view(b, h, w, c) for x in (q, k, v))
    ws_h, ws_w = h // splits, w // splits
    if shift:
        q, k, v = (torch.roll(x, shifts=(-(ws_h // 2), -(ws_w // 2)), dims=(1, 2)) for x in (q, k, v))
    q, k, v = (split_feature(x, splits, channel_last=True).reshape(b * splits * splits, -1, c) for x in (q, k, v))
    scores = P.matmul(q, k.transpose(1, 2)) / c**0.5
    if shift:
        scores = scores + mask.repeat(b, 1, 1)
    out = P.matmul(torch.softmax(scores, dim=-1), v)
    out = merge_splits(out.view(b * splits * splits, ws_h, ws_w, c), splits, channel_last=True)
    if shift:
        out = torch.roll(out, shifts=(ws_h // 2, ws_w // 2), dims=(1, 2))
    return out.reshape(b, -1, c)


class TransformerLayer(nn.Module):
    def __init__(self, d: int, no_ffn: bool, expansion: int, with_shift: bool):
        super().__init__()
        self.with_shift = with_shift
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.norm1 = nn.LayerNorm(d)
        self.mlp = None
        if not no_ffn:
            self.mlp = nn.Sequential(nn.Linear(2 * d, 2 * d * expansion, bias=False), nn.GELU(),
                                     nn.Linear(2 * d * expansion, d, bias=False))
            self.norm2 = nn.LayerNorm(d)

    def forward(self, source, target, h: int, w: int, splits: int, mask, P: Precision):
        q = P.linear(source, self.q_proj.weight)
        k = P.linear(target, self.k_proj.weight)
        v = P.linear(target, self.v_proj.weight)
        if splits > 1:
            message = window_attention(q, k, v, splits, self.with_shift, h, w, mask, P)
        else:
            message = P.matmul(torch.softmax(P.matmul(q, k.transpose(1, 2)) / q.shape[-1] ** 0.5, dim=-1), v)
        message = self.norm1(P.linear(message, self.merge.weight))
        if self.mlp is not None:
            hidden = F.gelu(P.linear(torch.cat([source, message], dim=-1), self.mlp[0].weight))
            message = self.norm2(P.linear(hidden, self.mlp[2].weight))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, d: int, expansion: int, with_shift: bool):
        super().__init__()
        self.self_attn = TransformerLayer(d, True, expansion, with_shift)
        self.cross_attn_ffn = TransformerLayer(d, False, expansion, with_shift)

    def forward(self, source, target, h, w, splits, mask, P: Precision):
        source = self.self_attn(source, source, h, w, splits, mask, P)
        return self.cross_attn_ffn(source, target, h, w, splits, mask, P)


class FeatureTransformer(nn.Module):
    def __init__(self, layers: int, d: int, expansion: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerBlock(d, expansion, i % 2 == 1) for i in range(layers))

    def forward(self, feature0, feature1, splits: int, P: Precision, record: list | None = None):
        """(B, C, H, W) each -> the same; ``record`` takes ``concat0``
        (2B, H W, C) after each block."""
        b, c, h, w = feature0.shape
        ws_h, ws_w = h // splits, w // splits
        mask = shift_window_mask(h, w, ws_h, ws_w, ws_h // 2, ws_w // 2, feature0.device) if splits > 1 else None
        feature0 = feature0.flatten(-2).permute(0, 2, 1)
        feature1 = feature1.flatten(-2).permute(0, 2, 1)
        concat0 = torch.cat((feature0, feature1), dim=0)
        concat1 = torch.cat((feature1, feature0), dim=0)
        for layer in self.layers:
            concat0 = layer(concat0, concat1, h, w, splits, mask, P)
            concat1 = torch.cat(concat0.chunk(chunks=2, dim=0)[::-1], dim=0)
            if record is not None:
                record.append(concat0)
        feature0, feature1 = concat0.chunk(chunks=2, dim=0)
        return (feature0.reshape(b, h, w, c).permute(0, 3, 1, 2), feature1.reshape(b, h, w, c).permute(0, 3, 1, 2))


class FeatureFlowAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """(B, 2, H, W), channels (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys]).float()[None].repeat(b, 1, 1, 1)


class GMFlow(nn.Module):
    def __init__(self, feature_channels: int = 128, num_transformer_layers: int = 6, ffn_dim_expansion: int = 4,
                 attn_splits: int = 2, padding_factor: int = 16, precision: Precision | None = None,
                 matching: Precision | None = None):
        super().__init__()
        self.feature_channels, self.attn_splits, self.padding_factor = feature_channels, attn_splits, padding_factor
        self.P, self.M = precision or Precision(), matching or Precision()
        self.backbone = CNNEncoder(feature_channels)
        self.transformer = FeatureTransformer(num_transformer_layers, feature_channels, ffn_dim_expansion)
        self.feature_flow_attn = FeatureFlowAttention(feature_channels)
        self.upsampler = nn.Sequential(nn.Conv2d(2 + feature_channels, 256, 3, 1, 1), nn.ReLU(),
                                       nn.Conv2d(256, 8**2 * 9, 1, 1, 0))

    def _prep(self, image):
        """NHWC [0, 255] -> the normalised, padded NCHW frame."""
        mean = torch.tensor(MEAN, device=image.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=image.device).view(1, 3, 1, 1)
        x = (image.permute(0, 3, 1, 2).float() / 255.0 - mean) / std
        h, w = x.shape[-2:]
        f = self.padding_factor
        return F.pad(x, (0, -w % f, 0, -h % f), mode="replicate")

    @float32_only()
    def features(self, image1, image2):
        """The backbone's features of both frames, (B, C, H'/8, W'/8) each."""
        return self.backbone(torch.cat((self._prep(image1), self._prep(image2))), self.P).chunk(2)

    @float32_only()
    def transform(self, feature0, feature1, record: list | None = None):
        """The position encoding per window, then the transformer."""
        s = self.attn_splits
        f0, f1 = split_feature(feature0, s), split_feature(feature1, s)
        pos = position_sine(f0.shape[0], f0.shape[2], f0.shape[3], self.feature_channels // 2, f0.device)
        feature0, feature1 = merge_splits(f0 + pos, s), merge_splits(f1 + pos, s)
        return self.transformer(feature0, feature1, s, self.P, record)

    @float32_only()
    def match(self, feature0, feature1):
        """``global_correlation_softmax``: (B, 2, H, W)."""
        M = self.M
        b, c, h, w = feature0.shape
        correlation = M.matmul(feature0.view(b, c, -1).permute(0, 2, 1), feature1.view(b, c, -1)) / c**0.5
        init_grid = coords_grid(b, h, w, feature0.device)
        grid = init_grid.view(b, 2, -1).permute(0, 2, 1)
        prob = F.softmax(correlation, dim=-1)
        return M.matmul(prob, grid).view(b, h, w, 2).permute(0, 3, 1, 2) - init_grid

    @float32_only()
    def propagate(self, feature0, flow):
        """``FeatureFlowAttention`` (global): (B, 2, H, W)."""
        M, att = self.M, self.feature_flow_attn
        b, c, h, w = feature0.shape
        query = M.linear(feature0.view(b, c, h * w).permute(0, 2, 1), att.q_proj.weight, att.q_proj.bias)
        key = M.linear(query, att.k_proj.weight, att.k_proj.bias)
        value = flow.view(b, flow.size(1), h * w).permute(0, 2, 1)
        prob = torch.softmax(M.matmul(query, key.permute(0, 2, 1)) / c**0.5, dim=-1)
        return M.matmul(prob, value).view(b, h, w, 2).permute(0, 3, 1, 2)

    @float32_only()
    def upsample(self, flow, feature0):
        """The convex x8 upsampling by the mask of [flow; f0]: (B, 8H, 8W, 2)."""
        P = self.P
        mask = P.conv2d(F.relu(P.conv2d(torch.cat((flow, feature0), dim=1), self.upsampler[0])), self.upsampler[2])
        return convex_upsample(flow, mask)

    @float32_only()
    def forward(self, image1, image2, record: dict | None = None):
        """(low-resolution flow (B, H/8, W/8, 2), flow (B, H, W, 2)), both
        cropped to the frames' size; ``record`` takes every stage's output."""
        h, w = image1.shape[1:3]
        f0, f1 = self.features(image1, image2)
        blocks = [] if record is not None else None
        f0, f1 = self.transform(f0, f1, blocks)
        matched = self.match(f0, f1)
        flow = self.propagate(f0, matched)
        up = self.upsample(flow, f0)
        if record is not None:
            record.update(blocks=blocks, features=(f0, f1), matched=matched, propagated=flow, upsampled=up)
        return flow.permute(0, 2, 3, 1)[:, : h // 8, : w // 8], up[:, :h, :w]
