"""GMA (Jiang et al., ICCV 2021, "Learning to Estimate Hidden Motions
with Global Motion Aggregation"), content-only attention, one head, in
plain PyTorch: the reference of the benchmark's flow net.

It follows the published RAFT/GMA code: the all-pairs volume
f1^T f2 / sqrt(C) and its average poolings (:func:`corr_pyramid`), the window lookup with
``grid_sample`` (corners aligned, zeros outside; the window flattened
x-offset-major, as RAFT's ``CorrBlock`` emits it), the attention
softmax(q k^T) with q scaled by 128^-0.5 and materialised once per pair,
``motion + gamma * attn @ v``, the separable ConvGRU, the flow head and
the convex upsampling through ``unfold``. Everything computes in the
arithmetic of a :class:`Precision` (float32 for the reference). Module
and parameter names are those of the published ``state_dict``.

Images are NHWC in [0, 255]; flows NHWC with channels (x, y). Train mode
(``train=True``) detaches the coordinates at every iteration, upsamples
every iteration and returns the (iters, B, H, W, 2) stack; batch norm
then takes the batch's statistics. After a forward, ``first_delta`` holds
the flow head's output of the first iteration, (B, 2, H/8, W/8).
``prepare``, ``step`` and ``upsample`` are the forward's parts, so that
a check can run one update from a given hidden state and flow.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.precision import Precision


class InstanceNorm(nn.Module):
    def forward(self, x, train: bool):
        return F.instance_norm(x, eps=1e-5)


class BatchNorm(nn.BatchNorm2d):
    """The running statistics in eval mode, the batch's in train mode."""

    def forward(self, x, train: bool):
        if train:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


def Norm(kind: str, planes: int) -> nn.Module:
    return BatchNorm(planes, eps=1e-5) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1, self.norm2 = Norm(norm, planes), Norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = Norm(norm, planes)
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x, P: Precision, train: bool):
        y = F.relu(self.norm1(P.conv2d(x, self.conv1), train))
        y = F.relu(self.norm2(P.conv2d(y, self.conv2), train))
        if self.downsample is not None:
            x = self.norm3(P.conv2d(x, self.downsample[0]), train)
        return F.relu(x + y)


class Encoder(nn.Module):
    def __init__(self, out: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = Norm(norm, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm, 1), ResidualBlock(64, 64, norm, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2), ResidualBlock(96, 96, norm, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2), ResidualBlock(128, 128, norm, 1))
        self.conv2 = nn.Conv2d(128, out, 1)

    def forward(self, x, P: Precision, train: bool):
        x = F.relu(self.norm1(P.conv2d(x, self.conv1), train))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, P, train)
        return P.conv2d(x, self.conv2)


class MotionEncoder(nn.Module):
    def __init__(self, levels: int, radius: int):
        super().__init__()
        self.convc1 = nn.Conv2d(levels * (2 * radius + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, P: Precision):
        cor = F.relu(P.conv2d(F.relu(P.conv2d(corr, self.convc1)), self.convc2))
        flo = F.relu(P.conv2d(F.relu(P.conv2d(flow, self.convf1)), self.convf2))
        out = F.relu(P.conv2d(torch.cat([cor, flo], 1), self.conv))
        return torch.cat([out, flow], 1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        for d, (kernel, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), 1):
            for gate in "zrq":
                setattr(self, f"conv{gate}{d}", nn.Conv2d(hidden + cin, hidden, kernel, padding=pad))

    def forward(self, h, x, P: Precision):
        for d in (1, 2):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(P.conv2d(hx, getattr(self, f"convz{d}")))
            r = torch.sigmoid(P.conv2d(hx, getattr(self, f"convr{d}")))
            q = torch.tanh(P.conv2d(torch.cat([r * h, x], 1), getattr(self, f"convq{d}")))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x, P: Precision):
        return P.conv2d(F.relu(P.conv2d(x, self.conv1)), self.conv2)


class Aggregate(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, motion, P: Precision):
        b, c, h, w = motion.shape
        v = P.conv2d(motion, self.to_v).reshape(b, c, h * w).transpose(1, 2)
        out = P.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return motion + self.gamma * out


class UpdateBlock(nn.Module):
    def __init__(self, hidden: int, levels: int, radius: int):
        super().__init__()
        self.encoder = MotionEncoder(levels, radius)
        self.gru = SepConvGRU(hidden, 128 + hidden + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))
        self.aggregator = Aggregate(128)

    def upsample_mask(self, net, P: Precision):
        return 0.25 * P.conv2d(F.relu(P.conv2d(net, self.mask[0])), self.mask[2])


class AttentionQK(nn.Module):
    def __init__(self, dim: int, dim_head: int):
        super().__init__()
        self.dim_head = dim_head
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)


def corr_pyramid(f1, f2, levels: int, P: Precision) -> list[torch.Tensor]:
    """RAFT's ``CorrBlock`` pyramid, (B*H*W, 1, H_l, W_l) per level: the
    volume f1^T f2 / sqrt(C) and its 2x2 average poolings. The volume is
    linear in f2, so level l is taken as f1^T pool^l(f2) / sqrt(C), the
    features pooled (odd edges cropped) instead of the volume."""
    b, c, h, w = f1.shape
    a = f1.reshape(b, c, h * w).transpose(1, 2)
    pyramid = []
    for level in range(levels):
        if level:
            f2 = F.avg_pool2d(f2, 2, stride=2)
        hl, wl = f2.shape[-2:]
        corr = P.matmul(a, f2.reshape(b, c, hl * wl)) / c**0.5
        pyramid.append(corr.reshape(b * h * w, 1, hl, wl))
    return pyramid


def lookup(pyramid, coords, radius: int) -> torch.Tensor:
    """(B, H, W, 2) level-0 pixel coordinates -> (B, L*(2r+1)^2, H, W)."""
    b, h, w, _ = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    dx, dy = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], -1)[None]  # window (i, j) at offset (d_i, d_j): x-offset-major
    out = []
    for level, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        pts = coords.reshape(b * h * w, 1, 1, 2) / 2**level + delta
        grid = torch.stack([2 * pts[..., 0] / (wl - 1) - 1, 2 * pts[..., 1] / (hl - 1) - 1], -1)
        out.append(F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
                   .reshape(b, h, w, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2)


def convex_upsample(flow, mask) -> torch.Tensor:
    """RAFT's ``upsample_flow``: (B, 2, H, W), (B, 576, H, W) -> (B, 8H, 8W, 2)."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 2, 8 * h, 8 * w).permute(0, 2, 3, 1)


class GMA(nn.Module):
    def __init__(self, iters: int = 12, levels: int = 4, radius: int = 4, hidden: int = 128,
                 context: int = 128, fnet_dim: int = 256, dim_head: int = 128,
                 precision: Precision | None = None):
        super().__init__()
        self.iters, self.levels, self.radius = iters, levels, radius
        self.hidden, self.context = hidden, context
        self.P = precision or Precision()
        self.fnet = Encoder(fnet_dim, "instance")
        self.cnet = Encoder(hidden + context, "batch")
        self.update_block = UpdateBlock(hidden, levels, radius)
        self.att = AttentionQK(context, dim_head)

    @staticmethod
    def _prep(image):
        return (2.0 * (image / 255.0) - 1.0).permute(0, 3, 1, 2).float()

    def encode(self, image, train: bool = False):
        """The feature map (B, 256, H/8, W/8) of one frame."""
        return self.fnet(self._prep(image), self.P, train)

    def prepare(self, image1, image2, train: bool = False, fmap1=None) -> dict:
        """What every update reads: the pyramid, the context features, the
        attention, and the starting hidden state and pixel grid."""
        P = self.P
        if fmap1 is None:
            fmap1 = self.encode(image1, train)
        fmap2 = self.encode(image2, train)
        pyramid = corr_pyramid(fmap1, fmap2, self.levels, P)
        net, inp = torch.split(self.cnet(self._prep(image1), P, train), [self.hidden, self.context], 1)
        net, inp = torch.tanh(net), F.relu(inp)
        b, _, h, w = net.shape
        q, k = P.conv2d(inp, self.att.to_qk).chunk(2, 1)
        q = q.reshape(b, -1, h * w).transpose(1, 2) * self.att.dim_head**-0.5
        k = k.reshape(b, -1, h * w).transpose(1, 2)
        attn = torch.softmax(P.matmul(q, k.transpose(1, 2)), dim=-1)
        ys, xs = torch.meshgrid(torch.arange(h, device=net.device), torch.arange(w, device=net.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], -1).float()[None].expand(b, h, w, 2)
        return {"pyramid": pyramid, "inp": inp, "attn": attn, "net": net, "coords0": coords0}

    def step(self, ctx: dict, net, coords1):
        """One update from the hidden state ``net`` (B, 128, H/8, W/8) and
        the level-0 coordinates ``coords1`` (B, H/8, W/8, 2): (the new
        hidden state, the delta flow (B, 2, H/8, W/8))."""
        P, ub = self.P, self.update_block
        corr = lookup(ctx["pyramid"], coords1, self.radius)
        flow = (coords1 - ctx["coords0"]).permute(0, 3, 1, 2)
        motion = ub.encoder(flow, corr, P)
        motion_global = ub.aggregator(ctx["attn"], motion, P)
        net = ub.gru(net, torch.cat([ctx["inp"], motion, motion_global], 1), P)
        return net, ub.flow_head(net, P)

    def upsample(self, flow_low, net):
        """The (B, H, W, 2) flow of the low-resolution (B, H/8, W/8, 2) one,
        by the mask of the hidden state ``net``."""
        return convex_upsample(flow_low.permute(0, 3, 1, 2), self.update_block.upsample_mask(net, self.P))

    def forward(self, image1, image2, train: bool = False, fmap1=None, record: bool = False):
        """Test mode: (low-res flow (B, H/8, W/8, 2), flow (B, H, W, 2));
        train mode: the (iters, B, H, W, 2) stack. ``record`` keeps each
        update's hidden state in and delta flow out, and the last hidden
        state, in ``trajectory``."""
        ctx = self.prepare(image1, image2, train, fmap1)
        net, coords0 = ctx["net"], ctx["coords0"]
        coords1 = coords0
        preds = []
        self.first_delta = None
        self.trajectory = {"net_in": [], "delta": [], "net_out": None} if record else None
        for _ in range(self.iters):
            if train:
                coords1 = coords1.detach()
            net_in = net
            net, delta = self.step(ctx, net, coords1)
            if self.first_delta is None:
                self.first_delta = delta.detach()
            if record:
                self.trajectory["net_in"].append(net_in)
                self.trajectory["delta"].append(delta)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            if train:
                preds.append(self.upsample(coords1 - coords0, net))
        if train:
            return torch.stack(preds)
        if record:
            self.trajectory["net_out"] = net
        flow_low = coords1 - coords0
        return flow_low, self.upsample(flow_low, net)


def sequence_loss(preds, flow_gt, valid, gamma: float = 0.8, max_flow: float = 400.0) -> torch.Tensor:
    """GMA's training loss: sum_i gamma^(n-1-i) mean over valid pixels of
    |pred_i - gt|_1, pixels with |gt| >= max_flow left out."""
    n = preds.shape[0]
    vw = ((valid >= 0.5) & (torch.linalg.vector_norm(flow_gt, dim=-1) < max_flow)).float()
    denom = vw.sum() + 1e-8
    loss = preds.new_zeros(())
    for i in range(n):
        loss = loss + gamma ** (n - 1 - i) * ((preds[i] - flow_gt).abs().sum(-1) * vw).sum() / denom
    return loss
