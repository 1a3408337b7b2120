"""Global Motion Aggregation: q/k projection and value aggregation
(ref: GMA/core/gma.py:34-115), content-only or with the reference's
positional modes.

``position_and_content`` adds a relative-position bias to the scores,
``position_only`` takes the bias alone (ref: gma.py:62-71);
:class:`RelPosEmb` computes that bias from learned per-axis embeddings,
the JAX package's ``RelPosEmb`` (``models/flow/gma.py:30-68``). Both
modes materialise a (B*heads, N, N) float32 bias and attend through the
torch path (scores plus bias, softmax), never kernel K1 or K5.

Which kernel attends, and how often, is chosen once per frame pair by
``ops/attention.py`` :func:`~atdn_vslam_torch.ops.attention.gma_attention`
(which also refuses the positional modes above 8192 tokens, as the JAX
package does); :class:`Aggregate` calls what it returns.
"""

from __future__ import annotations

import torch
from torch import nn


class RelPosEmb(nn.Module):
    """2-D decomposed relative positional scores (ref: gma.py:6-31):
    per-axis embeddings indexed by the coordinate deltas, scored against
    q in float32. Weights under the reference's names, ``rel_height``
    and ``rel_width``, each (2 max_pos_size - 1, dim_head)."""

    def __init__(self, max_pos_size: int = 160, dim_head: int = 128):
        super().__init__()
        self.max_pos_size, self.dim_head = max_pos_size, dim_head
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)

    def forward(self, q: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """:param q: (B*heads, h*w, dim_head) queries, pre-scaled.
        :return: the (B*heads, h*w, h*w) float32 bias, bias[x, y, u, v] =
            <q[x, y], height_emb[x, u]> + <q[x, y], width_emb[y, v]>."""
        m = self.max_pos_size
        pos = torch.arange(m, device=q.device)
        deltas = pos[None, :] - pos[:, None] + m - 1  # deltas[i, j] = j - i + m - 1
        height_emb = self.rel_height(deltas[:h, :h].reshape(-1)).reshape(h, h, -1).float()
        width_emb = self.rel_width(deltas[:w, :w].reshape(-1)).reshape(w, w, -1).float()
        qg = q.reshape(-1, h, w, q.shape[-1]).float()
        hs = torch.einsum("bxyd,xud->bxyu", qg, height_emb)
        ws = torch.einsum("bxyd,yvd->bxyv", qg, width_emb)
        bias = hs[..., :, None] + ws[..., None, :]
        return bias.reshape(q.shape[0], h * w, h * w)


class AttentionQK(nn.Module):
    """1x1-conv q/k projections. Returns (q, k, bias): q and k as
    (B*heads, H*W, dim_head), q pre-scaled by dim_head**-0.5
    (ref: gma.py:50-60), and the positional bias of :class:`RelPosEmb`
    in the positional modes, None otherwise (JAX ``gma.py:117``)."""

    def __init__(
        self,
        dim: int = 128,
        heads: int = 1,
        dim_head: int = 128,
        position_only: bool = False,
        position_and_content: bool = False,
        max_pos_size: int = 160,
    ):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qk = nn.Conv2d(dim, 2 * heads * dim_head, 1, bias=False)
        self.pos_emb = (
            RelPosEmb(max_pos_size, dim_head) if position_only or position_and_content else None
        )

    def forward(self, fmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        b, _, h, w = fmap.shape
        q, k = self.to_qk(fmap).chunk(2, dim=1)

        def tokens(x):  # (b, heads*d, h, w) -> (b*heads, h*w, d)
            x = x.reshape(b, self.heads, self.dim_head, h * w).transpose(2, 3)
            return x.reshape(b * self.heads, h * w, self.dim_head)

        q = tokens(q) * self.dim_head**-0.5
        return q, tokens(k), None if self.pos_emb is None else self.pos_emb(q, h, w)


class Aggregate(nn.Module):
    """out = fmap + gamma * proj(attention @ to_v(fmap)), the learned
    gamma-gated residual (ref: gma.py:79-115); gamma starts at 0."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_v = nn.Conv2d(dim, inner, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = nn.Conv2d(inner, dim, 1, bias=False) if dim != inner else None

    def forward(self, attn, fmap: torch.Tensor, band: tuple[int, int] | None = None) -> torch.Tensor:
        """:param attn: the frame pair's ``attn(v) -> out`` of
            :func:`~atdn_vslam_torch.ops.attention.gma_attention`, out
            (B*heads, h, w, d) or (B*heads, h*w, d).
        :param band: rows [lo, hi) of ``fmap`` (B, C, H, W) whose aggregate
            ``attn`` gives (the row split); the values come from all of it.
        """
        b, _, h, w = fmap.shape
        v = self.to_v(fmap).reshape(b * self.heads, self.dim_head, h * w).transpose(1, 2)
        out = attn(v)
        if band is not None:
            fmap = fmap[:, :, band[0] : band[1]]
            h = band[1] - band[0]
        out = out.reshape(b, self.heads, h, w, self.dim_head).permute(0, 1, 4, 2, 3)
        out = out.reshape(b, self.heads * self.dim_head, h, w)
        if self.project is not None:
            out = self.project(out)
        return fmap + self.gamma.to(fmap.dtype) * out
