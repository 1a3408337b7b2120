"""RAFTGMA: recurrent optical flow with global motion aggregation
(ref: GMA/core/network.py:26-129), in test mode and in train mode.

The public tensors keep the JAX package's layouts: NHWC images in
[0, 255], NHWC flows with channels (x, y), the feature-map cache NHWC.
Inside, the convolutions run NCHW in ``dtype`` (bf16 on the GPU when
``mixed_precision`` is on); the correlation volume is accumulated in
float32 and stored in ``dtype``; coordinates, the flow state and the
convex upsampling stay float32.

Per frame pair: the feature encoder (once per frame when the caller
passes the previous pair's ``fmap2`` back as ``fmap1``), the context
encoder, the correlation pyramid, then ``iters`` times the window
lookup (kernel K2) and the update block, and last the upsample-mask
head, once (with ``corr_nlanes`` the lookup of levels 1-3 is kernel
K2n). The attention follows the JAX package's schedule by token
count N = H/8 * W/8 (``network.py:349-364``), chosen once per pair by
``ops/attention.py`` ``gma_attention``: up to 8192 tokens the
probabilities are materialised once per pair (kernel K1); above, every
iteration attends anew, through the flash kernel K5 from 16384 tokens
on (2x KITTI, 752x2464, has 28952). The positional modes
(``position_only``, ``position_and_content``) add GMA's relative-position
bias to the scores, on the same schedule but without K1 or K5
(``models/flow/gma.py``), and are refused above 8192 tokens.

In test mode the stages are spans (``utils/profiling.py``):
``atdn::flow.encode`` (everything before the iterations; the features
alone with ``encode_only``), one ``atdn::flow.update`` per iteration
(the lookup and the update block) and ``atdn::flow.upsample``. The
row-split and train modes record none.

Row-split test mode (``mesh=``, ``parallel/flow_sharding.py``; the JAX
``spatial_mesh``): the ranks of the mesh axis split the H/8 rows into
bands (``parallel.distributed.band_bounds``). Every rank runs both
encoders on the whole frames (no N x N tensor there), then builds only
its band's share of the large tensors: the correlation pyramid of its
band's rows (plus the 2 rows its motion encoder reads beyond them)
against the whole second frame, and its band's K1 probabilities (or its
queries for K5 in every iteration). Each iteration computes the band's
motion features, gathers them from every band, the band's aggregate,
gathers it, runs the GRU and the flow head on the band's window
(``update.py``) and gathers the new hidden state and coordinates; the
upsampling runs whole. Every rank returns the same flows.

Train mode (``test_mode=False``, JAX ``network.py:372,417,433``): every
iteration detaches ``coords1`` first (the reference's
``coords1.detach()``), computes its upsample mask and upsamples its
flow; the forward returns the (iters, B, H, W, 2) stack. Gradients reach
the attention projections through K1's backward and the feature encoder
through K2's (``ops/attention.py``, ``ops/corr_lookup.py``). With
float32 parameters and a bf16 ``dtype`` (the training build of
``models/factory.py``) the forward runs under ``torch.autocast``: the
convolutions and matrix products compute in bf16 from the float32
parameters, as flax's ``dtype=bf16`` with float32 ``param_dtype``; the
norms, coordinates, lookup outputs and upsampling stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from atdn_vslam_torch.models.flow.extractor import BasicEncoder
from atdn_vslam_torch.models.flow.gma import AttentionQK
from atdn_vslam_torch.models.flow.update import ROW_REACH, GMAUpdateBlock, row_window
from atdn_vslam_torch.ops.attention import gma_attention
from atdn_vslam_torch.ops.bilinear import coords_grid
from atdn_vslam_torch.ops.corr_lookup import build_corr_pyramid, lookup_corr_pyramid
from atdn_vslam_torch.ops.corr_lookup_nlanes import (
    build_corr_pyramid_nlanes,
    lookup_corr_pyramid_nlanes,
)
from atdn_vslam_torch.ops.upsample import convex_upsample
from atdn_vslam_torch.parallel.distributed import band_bounds, gather_bands, group_rank, group_size
from atdn_vslam_torch.utils.helpers import full_float32
from atdn_vslam_torch.utils.profiling import span


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class RAFTGMA(nn.Module):
    """:param use_pallas: the JAX package's kernel switch
        (``network.py:155``). ``None``: the schedule by token count
        above, K3 not used (the pyramid is a plain ``torch.matmul`` per
        level, the JAX default). ``True``: the streaming path at every
        size: per-iteration attention through K5, and the pyramid built
        by kernel K3. ``False`` means "no Pallas kernel" in the JAX
        package; the port does not route around its kernels, so on a
        CUDA device it raises ``ValueError``, and on the CPU (whose
        kernel wrappers are the plain versions anyway) it acts like
        ``None``.
    :param corr_nlanes: the JAX package's ``corr_nlanes`` switch
        (``network.py:194-201``): levels 1-3 of the pyramid stored
        (B, Hl, Wl, N) and looked up by kernel K2n, which rounds the hat
        weights and row sums through the volume's type; level 0 keeps
        K2. The JAX flow net applies it in test mode only (``:307``),
        and so does the port: train mode takes K2 at every level.
    :param remat: recompute each training iteration in the backward pass
        (``torch.utils.checkpoint``, the JAX ``nn.remat`` of
        ``network.py:401-405``): less memory, the same values and
        gradients; K2's forward then launches twice per iteration.
    """

    #: the runtime's ``flow_warm_start`` passes the last pair's flow as ``flow_init``
    takes_flow_init = True

    def __init__(
        self,
        iters: int = 12,
        corr_levels: int = 4,
        corr_radius: int = 4,
        hidden_dim: int = 128,
        context_dim: int = 128,
        heads: int = 1,
        dtype: torch.dtype = torch.float32,
        position_only: bool = False,
        position_and_content: bool = False,
        use_pallas: bool | None = None,
        corr_nlanes: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.use_pallas = use_pallas
        self.corr_nlanes = corr_nlanes
        self.remat = remat
        self.iters, self.corr_levels, self.corr_radius = iters, corr_levels, corr_radius
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.dtype = dtype
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.position_only = position_only
        self.update_block = GMAUpdateBlock(hidden_dim, heads, corr_levels, corr_radius)
        self.att = AttentionQK(
            context_dim, heads, 128, position_only=position_only,
            position_and_content=position_and_content,
        )

    def _prep(self, image: torch.Tensor) -> torch.Tensor:
        return _nchw(2.0 * (image / 255.0) - 1.0).to(self.dtype)

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
        mesh=None,
        axis: str = "model",
    ):
        """Flow between an RGB frame pair.

        :param image1, image2: (B, H, W, 3) RGB in [0, 255]; H and W
            multiples of 8.
        :param fmap1: feature map (B, H/8, W/8, 256) of ``image1`` from a
            previous call's ``return_features`` or ``encode_only``: each
            video frame is then feature-encoded once.
        :param fmap2: feature map of ``image2`` (only together with fmap1).
        :param flow_init: (B, H/8, W/8, 2) initial low-res flow.
        :param test_mode: False: train mode, the (iters, B, H, W, 2)
            stack of every iteration's upsampled flow (batch norm follows
            the module's ``.train()`` / ``.eval()``; ``return_features``
            is ignored, as in the JAX package).
        :param mesh: split the rows over the mesh's ``axis`` (test mode
            on the two frames alone; see the module docstring). Its group
            of one process runs the same code through its collectives.
        :return: (low-res flow (B, H/8, W/8, 2), flow (B, H, W, 2)),
            plus image2's feature map with ``return_features``; with
            ``encode_only`` image1's feature map alone.
        """
        if image1.shape[-3] % 8 or image1.shape[-2] % 8:
            raise ValueError(f"Image size {tuple(image1.shape[-3:-1])} not divisible by 8")
        if self.use_pallas is False and image1.device.type == "cuda":
            raise ValueError(
                "RAFTGMA(use_pallas=False) asks for no kernel; on a CUDA device the "
                "port runs its kernels (use None or True)"
            )
        # float32 parameters computing in a narrower type: flax's param_dtype/dtype split
        mixed = self.dtype != torch.float32 and self.fnet.conv1.weight.dtype == torch.float32
        with full_float32(), torch.autocast(image1.device.type, self.dtype, enabled=mixed):
            if mesh is not None:
                if not test_mode or flow_init is not None or fmap1 is not None or return_features or encode_only:
                    raise ValueError("the row-split flow net takes two frames in test mode and nothing else")
                return self._forward_rows(image1, image2, mesh, axis)
            return self._forward(
                image1, image2, test_mode, flow_init, fmap1, fmap2, return_features, encode_only
            )

    def _forward(self, image1, image2, test_mode, flow_init, fmap1, fmap2, return_features, encode_only):
        if encode_only:
            with span("atdn::flow.encode"):
                return _nhwc(self.fnet(self._prep(image1)))
        if not test_mode:
            _, pyramid, lookup, net, inp, attn, coords0, coords1 = self._encode(
                image1, image2, test_mode, flow_init, fmap1, fmap2
            )
            preds = []
            for _ in range(self.iters):
                args = (lookup, pyramid, attn, inp, coords0, net, coords1)
                if self.remat:
                    net, coords1, flow_up = checkpoint(self._train_iteration, *args, use_reentrant=False)
                else:
                    net, coords1, flow_up = self._train_iteration(*args)
                preds.append(flow_up)
            return torch.stack(preds)
        with span("atdn::flow.encode"):
            f2, pyramid, lookup, net, inp, attn, coords0, coords1 = self._encode(
                image1, image2, test_mode, flow_init, fmap1, fmap2
            )
        for _ in range(self.iters):
            with span("atdn::flow.update"):
                net, coords1 = self._iteration(lookup, pyramid, attn, inp, coords0, net, coords1)

        with span("atdn::flow.upsample"):
            flow_low = coords1 - coords0
            mask = _nhwc(self.update_block.upsample_mask(net)).float()
            flow_up = convex_upsample(flow_low, mask)
        if return_features:
            return (flow_low, flow_up), _nhwc(f2)
        return flow_low, flow_up

    def _encode(self, image1, image2, test_mode, flow_init, fmap1, fmap2):
        """Everything before the iterations: the features, the volume, the
        context and the frame pair's attention (K1 where materialised);
        (f2, pyramid, lookup, net, inp, attn, coords0, coords1)."""
        x2 = self._prep(image2)
        if fmap1 is None:
            if fmap2 is not None:
                raise ValueError("fmap2 without fmap1 is not supported")
            fmaps = self.fnet(torch.cat([self._prep(image1), x2]))
            f1, f2 = fmaps.chunk(2)
        else:
            f1 = _nchw(fmap1)
            f2 = self.fnet(x2) if fmap2 is None else _nchw(fmap2)
        if self.corr_nlanes and test_mode:
            pyramid = build_corr_pyramid_nlanes(_nhwc(f1), _nhwc(f2), self.corr_levels, self.dtype)
            lookup = lookup_corr_pyramid_nlanes
        else:
            pyramid = build_corr_pyramid(
                _nhwc(f1), _nhwc(f2), self.corr_levels, dtype=self.dtype, use_pallas=self.use_pallas
            )
            lookup = lookup_corr_pyramid

        cnet = self.cnet(self._prep(image1))
        net, inp = torch.split(cnet, [self.hidden_dim, self.context_dim], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)
        q, k, bias = self.att(inp)
        b, _, h8, w8 = net.shape
        attn = gma_attention(q, k, bias, h8, w8, use_pallas=self.use_pallas, position_only=self.position_only)

        coords0 = coords_grid(h8, w8, device=net.device)[None]
        coords1 = coords0.expand(b, h8, w8, 2)
        if flow_init is not None:
            coords1 = coords1 + flow_init.float()
        return f2, pyramid, lookup, net, inp, attn, coords0, coords1

    def _forward_rows(self, image1, image2, mesh, axis):
        if self.corr_nlanes or self.position_only or self.att.pos_emb is not None:
            raise ValueError("the row-split flow net runs content-only attention and the K2 lookup")
        group = mesh.group(axis)
        fmaps = self.fnet(torch.cat([self._prep(image1), self._prep(image2)]))
        f1, f2 = fmaps.chunk(2)
        cnet = self.cnet(self._prep(image1))
        net, inp = torch.split(cnet, [self.hidden_dim, self.context_dim], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)
        q, k, _ = self.att(inp)
        b, _, h8, w8 = net.shape
        lo, hi = band_bounds(h8, group_size(group), group_rank(group))
        if hi <= lo:
            raise ValueError(f"{h8} rows do not give each of {group_size(group)} ranks a band")
        c_lo, c_hi = row_window(lo, hi, ROW_REACH["corr"], h8)
        pyramid = build_corr_pyramid(
            _nhwc(f1)[:, c_lo:c_hi], _nhwc(f2), self.corr_levels, dtype=self.dtype, use_pallas=self.use_pallas
        )
        attn = gma_attention(q, k, None, h8, w8, use_pallas=self.use_pallas, band=(lo, hi), mesh=mesh, axis=axis)

        def gather(x):
            return gather_bands(x, group, dim=2, n=h8)

        coords0 = coords_grid(h8, w8, device=net.device)[None]
        coords1 = coords0.expand(b, h8, w8, 2)
        for _ in range(self.iters):
            corr = lookup_corr_pyramid(pyramid, coords1[:, c_lo:c_hi].contiguous(), self.corr_radius)
            flow = _nchw(coords1 - coords0).to(self.dtype)
            net_band, delta = self.update_block.forward_rows(
                net, inp, _nchw(corr).to(self.dtype), flow, attn, (lo, hi), gather
            )
            net = gather(net_band)
            coords1 = _nhwc(gather(_nchw(coords1[:, lo:hi] + _nhwc(delta).float())))
        flow_low = coords1 - coords0
        mask = _nhwc(self.update_block.upsample_mask(net)).float()
        return flow_low, convex_upsample(flow_low, mask)

    def _iteration(self, lookup, pyramid, attn, inp, coords0, net, coords1):
        """One update, test mode and train mode alike: the window lookup,
        the update block, the new coordinates; (hidden state, coords1)."""
        corr = lookup(pyramid, coords1, self.corr_radius)
        flow = coords1 - coords0
        net, delta_flow = self.update_block(
            net, inp, _nchw(corr).to(self.dtype), _nchw(flow).to(self.dtype), attn
        )
        return net, coords1 + _nhwc(delta_flow).float()

    def _train_iteration(self, lookup, pyramid, attn, inp, coords0, net, coords1):
        """One train-mode iteration (JAX ``_UpdateStep`` with
        ``upsample_in_scan``): (hidden state, coords1, upsampled flow)."""
        net, coords1 = self._iteration(lookup, pyramid, attn, inp, coords0, net, coords1.detach())
        mask = _nhwc(self.update_block.upsample_mask(net)).float()
        return net, coords1, convex_upsample(coords1 - coords0, mask)
