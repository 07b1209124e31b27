"""Spatial-attention transformer layers.

Counterparts of ``msr3d_tpu/nn/transformers.py`` in the flagship's
``cond`` fusion: a per-query language-conditioned linear over the 5-d
pairwise geometry, sigmoid-gated and fused as
``softmax(log(clamp(loc_attn, 1e-6)) + qk)``. The residual + LayerNorm sit
inside the attention block and the encoder layer adds a second residual
around it, exactly as in the reference. Masks are key-padding masks with
True = pad. Dropout (after the attention's output projection, inside the
FFN, and on both residual branches of the encoder layer) is active only in
``train()`` mode and draws from the ``generator`` the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from msr3d_tpu_torch.nn.layers import dropout, get_activation

_NEG_INF = -1e30


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, l, h = x.shape
    return x.reshape(b, l, n_head, h // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, nh, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, nh * d)


class MultiHeadAttentionSpatial(nn.Module):
    def __init__(self, d_model: int, n_head: int, spatial_multihead: bool = True,
                 spatial_dim: int = 5, spatial_attn_fusion: str = "cond",
                 dropout: float = 0.1, device=None):
        super().__init__()
        if spatial_attn_fusion != "cond":
            raise NotImplementedError(
                f"spatial_attn_fusion={spatial_attn_fusion!r}: only 'cond' is ported "
                "(the other fusions are queued in ROADMAP.md)"
            )
        if d_model % n_head:
            raise ValueError("d_model must be a multiple of n_head")
        self.n_head = n_head
        self.dropout = dropout
        self.spatial_n_head = n_head if spatial_multihead else 1
        self.spatial_dim = spatial_dim
        self.w_qs = nn.Linear(d_model, d_model, device=device)
        self.w_ks = nn.Linear(d_model, d_model, device=device)
        self.w_vs = nn.Linear(d_model, d_model, device=device)
        self.lang_cond_fc = nn.Linear(
            d_model, self.spatial_n_head * (spatial_dim + 1), device=device
        )
        self.fc = nn.Linear(d_model, d_model, device=device)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, pairwise_locs: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Self-attention of x (B, L, H) with pairwise geometry (B, L, L, S)."""
        d_head = x.shape[-1] // self.n_head
        q = _split_heads(self.w_qs(x), self.n_head)
        k = _split_heads(self.w_ks(x), self.n_head)
        v = _split_heads(self.w_vs(x), self.n_head)
        attn = torch.einsum("bhld,bhtd->bhlt", q, k) / math.sqrt(d_head)

        w = self.lang_cond_fc(x)
        b, l, _ = w.shape
        w = w.reshape(b, l, self.spatial_n_head, self.spatial_dim + 1).transpose(1, 2)
        if self.spatial_n_head == 1:
            w = w.expand(b, self.n_head, l, self.spatial_dim + 1)
        loc_attn = torch.einsum("bhld,bltd->bhlt", w[..., 1:], pairwise_locs) + w[..., :1]
        loc_attn = torch.sigmoid(loc_attn)

        if key_padding_mask is not None:
            kmask = key_padding_mask[:, None, None, :]
            attn = attn.masked_fill(kmask, _NEG_INF)
            loc_attn = loc_attn.masked_fill(kmask, 0.0)

        fused = torch.softmax(torch.log(loc_attn.clamp(min=1e-6)) + attn, dim=3)
        out = self.fc(_merge_heads(torch.einsum("bhlt,bhtv->bhlv", fused, v)))
        out = dropout(out, self.dropout, self.training, generator)
        return self.layer_norm(out + x), fused


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, activation: str = "relu",
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.act = get_activation(activation)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(self.act(self.linear1(x)), self.dropout, self.training, generator)
        return self.linear2(h)


class TransformerSpatialEncoderLayer(nn.Module):
    """Post-norm around the (already residual + LN'd) spatial attention,
    then FFN + residual + LN, with dropout on both residual branches."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "relu", spatial_multihead: bool = True,
                 spatial_dim: int = 5, spatial_attn_fusion: str = "cond",
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.self_attn = MultiHeadAttentionSpatial(
            d_model, nhead, spatial_multihead, spatial_dim, spatial_attn_fusion, dropout, device
        )
        self.ffn = FeedForward(d_model, dim_feedforward, activation, dropout, device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.dropout = dropout

    def forward(self, tgt: torch.Tensor, pairwise_locs: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        tgt2, attn_w = self.self_attn(tgt, pairwise_locs, key_padding_mask, generator)
        tgt = self.norm1(tgt + dropout(tgt2, self.dropout, self.training, generator))
        tgt2 = self.ffn(tgt, generator)
        tgt = self.norm2(tgt + dropout(tgt2, self.dropout, self.training, generator))
        return tgt, attn_w
