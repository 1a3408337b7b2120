"""GMFlow (Xu, Zhang, Cai, Rezatofighi, Tao, "GMFlow: Learning Optical
Flow via Global Matching", CVPR 2022; ref: github.com/haofeixu/gmflow,
``gmflow/gmflow.py``, ``backbone.py``, ``transformer.py``, ``matching.py``,
``utils.py``, ``position.py``), the one-scale model of the published
weights (``num_scales=1``, ``attn_splits_list=[2]``,
``corr_radius_list=[-1]``, ``prop_radius_list=[-1]``), in test mode.

It keeps :class:`~atdn_vslam_torch.models.flow.network.RAFTGMA`'s runtime
contract: NHWC images in [0, 255] (H and W multiples of 8), ``model(im1,
im2, fmap1=..., return_features=True) -> ((flow_low, flow_up), fmap2)``
and ``model(im, encode_only=True) -> fmap``, where a feature map is the
backbone's output (B, H'/8, W'/8, C) at the padded size H' x W'. Per
frame pair, each stage a submodule (forward hooks read them) and a span
(``utils/profiling.py``):

- ``atdn::gmflow.backbone``: ``(x / 255 - mean) / std`` with ImageNet's
  mean and std, replicate padding to /``PADDING_FACTOR``, then
  ``backbone`` (``CNNEncoder``: conv7x7/2 3->64 bias-free, instance norm
  (no affine), ReLU, stages of two residual blocks at 64, 96/2 and
  128/2 with bias-free 3x3 convolutions and a 1x1 strided convolution
  plus norm where the shape changes, then conv1x1 128->C), on the new
  frame alone when the caller passes the previous one's ``fmap``;
- ``atdn::gmflow.transformer``: DETR's sine position encoding (64
  frequencies a coordinate, temperature 1e4, normalised to 2 pi) of one
  window added to every window of both frames, then ``transformer``:
  its blocks (one ``atdn::gmflow.block`` each) run both directions
  batched, c0 = [f0; f1] against c1 = [f1; f0], c1 taking c0's halves
  swapped after every block. A block is self-attention (no FFN), then
  cross-attention with the FFN (W2 gelu(W1 [s; m]), 2C -> 2C e -> C),
  each layer ``s + LN(merge(attn(q s, k t, v t)))``, one head, bias-free
  projections, scale C^-0.5, in ``ATTN_SPLITS`` x ``ATTN_SPLITS``
  windows. The odd blocks roll the features by (-ws_h // 2, -ws_w // 2)
  first and restrict attention to the regions of the published mask,
  then roll back. The unshifted windows go through K5
  (:func:`~atdn_vslam_torch.ops.attention.flash_attend`), the shifted
  ones through K5r (:func:`~atdn_vslam_torch.ops.attention.flash_attend_regions`),
  one launch a layer for all windows of both frames;
- ``atdn::gmflow.match``: ``matching``, softmax(f0 f1^T / sqrt(C)) over
  every key, the (x, y) pixel grid averaged by it, less the grid: K5 in
  float32 on the grid's 2 columns (its narrow kernel);
- ``atdn::gmflow.propagate``: ``feature_flow_attn``, q = q_proj(f0), k =
  k_proj(q) (the published code projects the key from the projected
  query), softmax(q k^T / sqrt(C)) over every key applied to the flow: K5
  in float32 on the flow's 2 columns;
- ``atdn::gmflow.upsample``: ``upsampler`` (conv3x3 (2 + C) -> 256,
  ReLU, conv1x1 256 -> 576) on [flow; f0], RAFT's convex x8 upsampling
  (:func:`~atdn_vslam_torch.ops.upsample.convex_upsample`), then both
  flows cropped back to the input's size.

Precision: the backbone, the transformer and the upsampler compute in
``dtype`` (bf16 on the GPU with ``mixed_precision``); matching and
propagation in float32 (coordinates and flows are their values: bf16
would round a coordinate near 150 to a whole pixel), TF32 off.

Departures from the published code, none of which changes a value
beyond rounding: the padding puts all of it at the bottom and the right
(RAFT's ``InputPadder`` 'kitti' mode centres the width's), so the
low-resolution flow crops back by whole rows and columns; the shifted
layers drop the pairs of different regions where the published mask
adds -100 to their scores (their weight, e^-100 of the row's largest,
lies below float32's smallest normal); the layers run on the windows
(rolled and split once a block) where the published code splits the
projected q, k and v in every layer, which is the same per-token
arithmetic in another order of tokens; the layer norms compute in the
features' type with float32 statistics. The flow of the previous pair
(GMA's warm start, ``flow_init``) has no counterpart and raises; so does
train mode (GMFlow's training is not ported).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from atdn_vslam_torch.models.flow.extractor import InstanceNorm
from atdn_vslam_torch.ops.attention import flash_attend, flash_attend_regions
from atdn_vslam_torch.ops.bilinear import coords_grid
from atdn_vslam_torch.ops.upsample import convex_upsample
from atdn_vslam_torch.utils.helpers import full_float32
from atdn_vslam_torch.utils.profiling import span

#: ImageNet's channel mean and std (``gmflow/utils/utils.py`` ``normalize_img``)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
#: the published model's widths (``main.py``): features, transformer
#: blocks, the FFN's expansion, and windows a side
FEATURE_CHANNELS = 128
NUM_TRANSFORMER_LAYERS = 6
FFN_DIM_EXPANSION = 4
ATTN_SPLITS = 2
#: the frames' padding: the published evaluation's for KITTI
PADDING_FACTOR = 16
#: the convex upsampling's factor: the backbone's 1/8 resolution
_UPSAMPLE = 8


class ResidualBlock(nn.Module):
    """``relu(x' + relu(n2(c2(relu(n1(c1 x))))))`` with bias-free 3x3
    convolutions; ``x'`` is a 1x1 strided convolution and norm where the
    shape changes (ref: backbone.py ``ResidualBlock``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.norm1, self.norm2 = InstanceNorm(relu=True), InstanceNorm(relu=True)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = InstanceNorm()
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm2(self.conv2(self.norm1(self.conv1(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """1/8-resolution features, NCHW (ref: backbone.py ``CNNEncoder``,
    one output scale)."""

    def __init__(self, output_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.norm1 = InstanceNorm(relu=True)
        layers, cin = [], 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(ResidualBlock(cin, planes, stride), ResidualBlock(planes, planes, 1)))
            cin = planes
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(self.conv1(x))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def window_position(h: int, w: int, channels: int, device=None) -> torch.Tensor:
    """DETR's ``PositionEmbeddingSine(channels // 2, 1e4, normalize=True,
    scale=2 pi)`` of one h x w window: (h, w, channels) float32, the y
    half first (ref: position.py)."""
    npf, eps, scale = channels // 2, 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + eps) * scale
    dim_t = 1e4 ** (2 * torch.div(torch.arange(npf, device=device), 2, rounding_mode="floor") / npf)

    def embed(c):
        pos = c[:, None] / dim_t
        return torch.stack((pos[:, 0::2].sin(), pos[:, 1::2].cos()), dim=2).flatten(1)

    pos_y, pos_x = embed(y), embed(x)
    return torch.cat([pos_y[:, None].expand(h, w, npf), pos_x[None].expand(h, w, npf)], dim=-1)


def partition(x: torch.Tensor, splits: int, shift: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, H, W, C) -> (B * splits^2, H/splits * W/splits, C) windows,
    batch-major, row-major over the windows (ref: utils.py
    ``split_feature``), the features first rolled by -``shift``."""
    if shift is not None:
        x = torch.roll(x, shifts=(-shift[0], -shift[1]), dims=(1, 2))
    b, h, w, c = x.shape
    x = x.reshape(b, splits, h // splits, splits, w // splits, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * splits * splits, (h // splits) * (w // splits), c)


def unpartition(x: torch.Tensor, hw: tuple[int, int], splits: int,
                shift: tuple[int, int] | None = None) -> torch.Tensor:
    """The inverse of :func:`partition` (ref: utils.py ``merge_splits``)."""
    h, w = hw
    c = x.shape[-1]
    b = x.shape[0] // (splits * splits)
    x = x.reshape(b, splits, splits, h // splits, w // splits, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, h, w, c)
    if shift is not None:
        x = torch.roll(x, shifts=shift, dims=(1, 2))
    return x


def shift_regions(h: int, w: int, splits: int) -> torch.Tensor:
    """The region id of each token of the rolled features, as windows:
    (splits^2, H/splits * W/splits) int32. The published mask's nine
    regions (ref: transformer.py ``generate_shift_window_attn_mask``): per
    axis ``[0, -ws)``, ``[-ws, -shift)``, ``[-shift, end)``."""
    ws_h, ws_w = h // splits, w // splits
    sh, sw = ws_h // 2, ws_w // 2
    rows = torch.zeros(h, dtype=torch.int32)
    cols = torch.zeros(w, dtype=torch.int32)
    rows[h - ws_h : h - sh], rows[h - sh :] = 1, 2
    cols[w - ws_w : w - sw], cols[w - sw :] = 1, 2
    ids = (3 * rows[:, None] + cols[None])[None, :, :, None]
    return partition(ids, splits)[..., 0].contiguous()


class TransformerLayer(nn.Module):
    """``s + LN1(merge(attn(q_proj s, k_proj t, v_proj t)))``, and with the
    FFN ``s + LN2(W2 gelu(W1 [s; m]))`` (ref: transformer.py
    ``TransformerLayer``), on windows: (B', L, C) source and target,
    ``regions`` (B', L) int32 for a shifted layer, else None."""

    def __init__(self, d_model: int, no_ffn: bool, ffn_dim_expansion: int):
        super().__init__()
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model)
        self.mlp = None
        if not no_ffn:
            width = 2 * d_model
            self.mlp = nn.Sequential(
                nn.Linear(width, width * ffn_dim_expansion, bias=False),
                nn.GELU(),
                nn.Linear(width * ffn_dim_expansion, d_model, bias=False),
            )
            self.norm2 = nn.LayerNorm(d_model)

    def forward(self, source: torch.Tensor, target: torch.Tensor, regions: torch.Tensor | None) -> torch.Tensor:
        q, k, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        scale = q.shape[-1] ** -0.5
        if regions is None:
            message = flash_attend(q, k, v, scale)
        else:
            message = flash_attend_regions(q, k, v, regions, scale)
        message = self.norm1(self.merge(message))
        if self.mlp is not None:
            message = self.norm2(self.mlp(torch.cat([source, message], dim=-1)))
        return source + message


class TransformerBlock(nn.Module):
    """Self-attention, then cross-attention with the FFN, in the same
    windows (ref: transformer.py ``TransformerBlock``)."""

    def __init__(self, d_model: int, ffn_dim_expansion: int, with_shift: bool):
        super().__init__()
        self.with_shift = with_shift
        self.self_attn = TransformerLayer(d_model, True, ffn_dim_expansion)
        self.cross_attn_ffn = TransformerLayer(d_model, False, ffn_dim_expansion)

    def forward(self, concat0: torch.Tensor, splits: int, regions: torch.Tensor | None) -> torch.Tensor:
        """(2B, H, W, C) both directions -> the same after the block."""
        h, w = concat0.shape[1:3]
        shift = (h // splits // 2, w // splits // 2) if self.with_shift else None
        source = partition(concat0, splits, shift)
        target = torch.cat(source.chunk(2)[::-1])  # c1 = [f1; f0], window by window
        regions = regions if self.with_shift else None
        source = self.self_attn(source, source, regions)
        source = self.cross_attn_ffn(source, target, regions)
        return unpartition(source, (h, w), splits, shift)


class FeatureTransformer(nn.Module):
    """``num_layers`` blocks, every odd one shifted (ref: transformer.py
    ``FeatureTransformer``): (f0, f1) NHWC -> (f0, f1)."""

    def __init__(self, num_layers: int = 6, d_model: int = 128, ffn_dim_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion, with_shift=i % 2 == 1) for i in range(num_layers)
        )
        self._regions: dict = {}

    def regions(self, b: int, h: int, w: int, splits: int, device) -> torch.Tensor:
        """The shifted layers' region ids for 2b frames, (2b splits^2,
        L) int32 on ``device`` (kept per shape)."""
        key = (b, h, w, splits, str(device))
        ids = self._regions.get(key)
        if ids is None:
            ids = shift_regions(h, w, splits).repeat(2 * b, 1).to(device)
            self._regions[key] = ids
        return ids

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor, splits: int):
        b, h, w, _ = feature0.shape
        if h % splits or w % splits:
            raise ValueError(f"{h} x {w} features do not split into {splits} x {splits} windows")
        regions = self.regions(b, h, w, splits, feature0.device)
        concat0 = torch.cat([feature0, feature1])
        for layer in self.layers:
            with span("atdn::gmflow.block"):
                concat0 = layer(concat0, splits, regions)
        return concat0.chunk(2)


def _grid_values(b: int, h: int, w: int, device) -> torch.Tensor:
    """The (x, y) pixel grid as K5's values: (b, h w, 2) float32."""
    return coords_grid(h, w, device=device).reshape(1, h * w, 2).expand(b, -1, -1).contiguous()


class GlobalMatching(nn.Module):
    """``softmax(f0 f1^T / sqrt(C)) @ grid - grid`` over all tokens (ref:
    matching.py ``global_correlation_softmax``): (B, H, W, C) float32
    features -> (B, H, W, 2) flow, through K5 in float32."""

    def __init__(self):
        super().__init__()
        self._grids: dict = {}

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor) -> torch.Tensor:
        b, h, w, c = feature0.shape
        key = (b, h, w, str(feature0.device))
        grid = self._grids.get(key)
        if grid is None:
            grid = self._grids[key] = _grid_values(b, h, w, feature0.device)
        match = flash_attend(feature0.reshape(b, h * w, c), feature1.reshape(b, h * w, c), grid, c**-0.5)
        return (match - grid).reshape(b, h, w, 2)


class FeatureFlowAttention(nn.Module):
    """Global propagation of the flow by self-attention on f0 (ref:
    transformer.py ``FeatureFlowAttention``): q = q_proj(f0), k =
    k_proj(q), ``softmax(q k^T / sqrt(C)) @ flow``, through K5 in float32.
    Kept float32 by ``cast_flow_model``."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        b, h, w, c = feature0.shape
        q = self.q_proj(feature0.reshape(b, h * w, c))
        k = self.k_proj(q)
        return flash_attend(q, k, flow.reshape(b, h * w, 2), c**-0.5).reshape(b, h, w, 2)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class GMFlow(nn.Module):
    """:param dtype: the compute type of the backbone, the transformer and
        the upsampler (module docstring); matching and propagation
        compute in float32.
    """

    #: the runtime's ``flow_warm_start`` needs a ``flow_init``; GMFlow has none
    takes_flow_init = False

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = CNNEncoder(FEATURE_CHANNELS)
        self.transformer = FeatureTransformer(NUM_TRANSFORMER_LAYERS, FEATURE_CHANNELS, FFN_DIM_EXPANSION)
        self.matching = GlobalMatching()
        self.feature_flow_attn = FeatureFlowAttention(FEATURE_CHANNELS)
        self.upsampler = nn.Sequential(
            nn.Conv2d(2 + FEATURE_CHANNELS, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, _UPSAMPLE**2 * 9, 1, 1, 0),
        )
        self._consts: dict = {}

    def _prep(self, image: torch.Tensor) -> torch.Tensor:
        """NHWC [0, 255] -> NCHW normalised in ``dtype``, replicate-padded
        at the bottom and the right to /``PADDING_FACTOR``."""
        key = str(image.device)
        consts = self._consts.get(key)
        if consts is None:
            mean = torch.tensor(MEAN, device=image.device) * 255.0
            inv = 1.0 / (torch.tensor(STD, device=image.device) * 255.0)
            consts = self._consts[key] = (mean, inv)
        mean, inv = consts
        x = _nchw((image - mean) * inv).to(self.dtype)
        h, w = x.shape[-2:]
        pad_h, pad_w = -h % PADDING_FACTOR, -w % PADDING_FACTOR
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="replicate")
        return x

    def _position(self, h: int, w: int, device) -> torch.Tensor:
        """The window's encoding tiled over the splits x splits windows,
        (h, w, C) in ``dtype``."""
        key = (h, w, str(device))
        pos = self._consts.get(key)
        if pos is None:
            s = ATTN_SPLITS
            pos = window_position(h // s, w // s, FEATURE_CHANNELS, device).repeat(s, s, 1)
            pos = self._consts[key] = pos.to(self.dtype)
        return pos

    def forward(
        self,
        image1: torch.Tensor,
        image2: torch.Tensor | None = None,
        test_mode: bool = True,
        flow_init: torch.Tensor | None = None,
        fmap1: torch.Tensor | None = None,
        fmap2: torch.Tensor | None = None,
        return_features: bool = False,
        encode_only: bool = False,
    ):
        """Flow between an RGB frame pair, as ``RAFTGMA.forward``.

        :param image1, image2: (B, H, W, 3) RGB in [0, 255]; H and W
            multiples of 8.
        :param fmap1, fmap2: feature maps (B, H'/8, W'/8, C) of the frames
            from an earlier ``return_features`` or ``encode_only``.
        :return: (low-res flow (B, H/8, W/8, 2), flow (B, H, W, 2)), plus
            image2's feature map with ``return_features``; with
            ``encode_only`` image1's feature map alone.
        """
        h, w = image1.shape[-3:-1]
        if h % 8 or w % 8:
            raise ValueError(f"Image size {(h, w)} not divisible by 8")
        if flow_init is not None:
            raise ValueError("GMFlow takes no flow_init: it has no warm start (flow.arch 'gma' has)")
        if not test_mode:
            raise NotImplementedError("GMFlow runs in test mode only: its training is not ported")
        with full_float32():
            if encode_only:
                with span("atdn::gmflow.backbone"):
                    return _nhwc(self.backbone(self._prep(image1)))
            with span("atdn::gmflow.backbone"):
                if fmap1 is None:
                    if fmap2 is not None:
                        raise ValueError("fmap2 without fmap1 is not supported")
                    f0, f1 = self.backbone(torch.cat([self._prep(image1), self._prep(image2)])).chunk(2)
                else:
                    f0 = _nchw(fmap1)
                    f1 = self.backbone(self._prep(image2)) if fmap2 is None else _nchw(fmap2)
            fmap = _nhwc(f1)
            with span("atdn::gmflow.transformer"):
                pos = self._position(f0.shape[2], f0.shape[3], f0.device)
                f0, f1 = self.transformer(_nhwc(f0) + pos, fmap + pos, ATTN_SPLITS)
            with span("atdn::gmflow.match"):
                flow = self.matching(f0.float(), f1.float())
            with span("atdn::gmflow.propagate"):
                flow = self.feature_flow_attn(f0.float(), flow)
            with span("atdn::gmflow.upsample"):
                mask = self.upsampler(torch.cat([_nchw(flow).to(self.dtype), _nchw(f0)], dim=1))
                flow_up = convex_upsample(flow, _nhwc(mask).float(), _UPSAMPLE)
                flow_low = flow[:, : h // 8, : w // 8]
                flow_up = flow_up[:, :h, :w]
        if return_features:
            return (flow_low, flow_up), fmap
        return flow_low, flow_up
