"""Global Motion Aggregation: q/k projection and value aggregation
(ref: GMA/core/gma.py:34-115), content-only attention.

The reference's positional modes (``position_only``,
``position_and_content``, its ``RelPosEmb``) are not ported yet
(ROADMAP M4); a reference checkpoint's unused ``att.pos_emb.*`` entries
are not parameters here.
"""

from __future__ import annotations

import torch
from torch import nn

from atdn_vslam_torch.ops.attention import apply_attention_probs


class AttentionQK(nn.Module):
    """1x1-conv q/k projections. Returns q and k as (B*heads, H*W,
    dim_head), q pre-scaled by dim_head**-0.5 (ref: gma.py:50-60)."""

    def __init__(
        self,
        dim: int = 128,
        heads: int = 1,
        dim_head: int = 128,
        position_only: bool = False,
        position_and_content: bool = False,
    ):
        super().__init__()
        if position_only or position_and_content:
            raise NotImplementedError(
                "positional GMA attention is not ported yet (ROADMAP M4)"
            )
        self.heads, self.dim_head = heads, dim_head
        self.to_qk = nn.Conv2d(dim, 2 * heads * dim_head, 1, bias=False)

    def forward(self, fmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, _, h, w = fmap.shape
        q, k = self.to_qk(fmap).chunk(2, dim=1)

        def tokens(x):  # (b, heads*d, h, w) -> (b*heads, h*w, d)
            x = x.reshape(b, self.heads, self.dim_head, h * w).transpose(2, 3)
            return x.reshape(b * self.heads, h * w, self.dim_head)

        return tokens(q) * self.dim_head**-0.5, tokens(k)


class Aggregate(nn.Module):
    """out = fmap + gamma * proj(P @ to_v(fmap)), the learned
    gamma-gated residual (ref: gma.py:79-115); gamma starts at 0."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_v = nn.Conv2d(dim, inner, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = nn.Conv2d(inner, dim, 1, bias=False) if dim != inner else None

    def forward(self, probs: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        """:param probs: (B*heads, H, W, N_pad) spatial probabilities."""
        b, _, h, w = fmap.shape
        v = self.to_v(fmap).reshape(b * self.heads, self.dim_head, h * w).transpose(1, 2)
        out = apply_attention_probs(probs, v)  # (b*heads, h, w, d)
        out = out.reshape(b, self.heads, h, w, self.dim_head).permute(0, 1, 4, 2, 3)
        out = out.reshape(b, self.heads * self.dim_head, h, w)
        if self.project is not None:
            out = self.project(out)
        return fmap + self.gamma.to(fmap.dtype) * out
