"""Transformer layers of the scene prompter.

Counterparts of ``msr3d_tpu/nn/transformers.py``:

  * ``MultiHeadAttention``: plain attention with ``q_proj``/``k_proj``/
    ``v_proj``/``out_proj`` and dropout on the attention weights;
  * ``MultiHeadAttentionSpatial``: self-attention fused with the pairwise
    geometry in one of five fusions. ``cond`` (the flagship's): a
    per-query language-conditioned linear over the geometry, sigmoid-gated
    and fused as ``softmax(log(clamp(loc_attn, 1e-6)) + qk)``; ``mul`` the
    same over a relu'd ``pairwise_loc_fc``; ``bias`` adds
    ``pairwise_loc_fc`` to the logits; ``add`` averages the two softmaxes;
    ``ctx`` dots q with a per-pair ``pairwise_loc_fc`` key. The residual +
    LayerNorm sit inside the attention block and the encoder layer adds a
    second residual around it, exactly as in the reference;
  * ``TransformerEncoderLayer`` (post-norm by default), the stack of
    ``use_spatial_attn: False``;
  * ``CrossAttentionLayer`` (prenorm by default; post-norm keeps the
    reference's quirk: the FFN reads the attention's output, not the
    normed stream) of ``as_cross_attention``;
  * ``DiTBlock``, the adaLN-Zero conditioning of ``as_dit_attention``.

Masks are key-padding masks with True = pad. Dropout is active only in
``train()`` mode and draws from the ``generator`` the caller passes. With
``MSR3D_NAN_CHECKS`` set, the spatial attention's fused weights are checked
for non-finite values (``utils/debug.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.nn.layers import dropout, get_activation
from msr3d_tpu_torch.utils.debug import assert_finite

_NEG_INF = -1e30
FUSIONS = ("mul", "bias", "add", "ctx", "cond")


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, l, h = x.shape
    return x.reshape(b, l, n_head, h // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, nh, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, nh * d)


class MultiHeadAttention(nn.Module):
    """``kv_dim`` is the width of the keys and values when it is not
    ``d_model`` (SRT's rays attending into the scene's tokens)."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.1, device=None,
                 kv_dim: Optional[int] = None):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        kv_dim = d_model if kv_dim is None else kv_dim
        self.q_proj = nn.Linear(d_model, d_model, device=device)
        self.k_proj = nn.Linear(kv_dim, d_model, device=device)
        self.v_proj = nn.Linear(kv_dim, d_model, device=device)
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        d_head = query.shape[-1] // self.n_head
        q = _split_heads(self.q_proj(query), self.n_head)
        k = _split_heads(self.k_proj(key), self.n_head)
        v = _split_heads(self.v_proj(value), self.n_head)
        attn = torch.einsum("bhld,bhtd->bhlt", q, k) / math.sqrt(d_head)
        if key_padding_mask is not None:
            attn = attn.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
        weights = dropout(torch.softmax(attn, dim=-1), self.dropout, self.training, generator)
        out = self.out_proj(_merge_heads(torch.einsum("bhlt,bhtd->bhld", weights, v)))
        return out, weights


class MultiHeadAttentionSpatial(nn.Module):
    """``loc_dim`` is the width of the pairwise geometry (``spatial_dim``,
    or 12 for ``pairwise_rel_type: mlp``)."""

    def __init__(self, d_model: int, n_head: int, spatial_multihead: bool = True,
                 spatial_dim: int = 5, spatial_attn_fusion: str = "cond",
                 dropout: float = 0.1, device=None, loc_dim: Optional[int] = None):
        super().__init__()
        if spatial_attn_fusion not in FUSIONS:
            raise NotImplementedError(f"unsupported spatial_attn_fusion {spatial_attn_fusion}")
        if d_model % n_head:
            raise ValueError("d_model must be a multiple of n_head")
        loc_dim = spatial_dim if loc_dim is None else loc_dim
        if spatial_attn_fusion == "cond" and loc_dim != spatial_dim:
            raise ValueError(
                f"cond fusion weighs spatial_dim={spatial_dim} channels, but the pairwise "
                f"geometry has {loc_dim} (the JAX package's einsum fails on this too)")
        self.n_head = n_head
        self.dropout = dropout
        self.fusion = spatial_attn_fusion
        self.spatial_n_head = n_head if spatial_multihead else 1
        self.spatial_dim = spatial_dim
        self.w_qs = nn.Linear(d_model, d_model, device=device)
        self.w_ks = nn.Linear(d_model, d_model, device=device)
        self.w_vs = nn.Linear(d_model, d_model, device=device)
        if spatial_attn_fusion == "cond":
            self.lang_cond_fc = nn.Linear(
                d_model, self.spatial_n_head * (spatial_dim + 1), device=device
            )
        else:
            out = d_model if spatial_attn_fusion == "ctx" else self.spatial_n_head
            self.pairwise_loc_fc = nn.Linear(loc_dim, out, device=device)
        self.fc = nn.Linear(d_model, d_model, device=device)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def _loc_attn(self, x: torch.Tensor, q: torch.Tensor,
                  pairwise_locs: torch.Tensor) -> torch.Tensor:
        """The geometry's (B, h, L, T) term of the chosen fusion."""
        b, l = x.shape[:2]
        if self.fusion == "cond":
            w = self.lang_cond_fc(x)
            w = w.reshape(b, l, self.spatial_n_head, self.spatial_dim + 1).transpose(1, 2)
            w = w.expand(b, self.n_head, l, self.spatial_dim + 1)
            loc = torch.einsum("bhld,bltd->bhlt", w[..., 1:], pairwise_locs) + w[..., :1]
            return torch.sigmoid(loc)
        if self.fusion == "ctx":
            d_head = q.shape[-1]
            loc = self.pairwise_loc_fc(pairwise_locs)
            t = loc.shape[2]
            loc = loc.reshape(b, l, t, self.n_head, d_head).permute(0, 3, 1, 2, 4)
            return torch.einsum("bhld,bhltd->bhlt", q, loc) / math.sqrt(d_head)
        loc = self.pairwise_loc_fc(pairwise_locs).permute(0, 3, 1, 2)
        if self.fusion == "mul":
            loc = F.relu(loc)
        return loc.expand(b, self.n_head, l, loc.shape[-1])

    def forward(self, x: torch.Tensor, pairwise_locs: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Self-attention of x (B, L, H) with pairwise geometry (B, L, L, ·)."""
        d_head = x.shape[-1] // self.n_head
        q = _split_heads(self.w_qs(x), self.n_head)
        k = _split_heads(self.w_ks(x), self.n_head)
        v = _split_heads(self.w_vs(x), self.n_head)
        attn = torch.einsum("bhld,bhtd->bhlt", q, k) / math.sqrt(d_head)
        loc_attn = self._loc_attn(x, q, pairwise_locs)

        gated = self.fusion in ("mul", "cond")
        if key_padding_mask is not None:
            kmask = key_padding_mask[:, None, None, :]
            attn = attn.masked_fill(kmask, _NEG_INF)
            loc_attn = loc_attn.masked_fill(kmask, 0.0 if gated else _NEG_INF)

        if self.fusion == "add":
            fused = (torch.softmax(attn, dim=3) + torch.softmax(loc_attn, dim=3)) / 2
        elif gated:
            fused = torch.softmax(torch.log(loc_attn.clamp(min=1e-6)) + attn, dim=3)
        else:
            fused = torch.softmax(loc_attn + attn, dim=3)
        # the reference's NaN assert on the fused attention, opt-in
        # (MSR3D_NAN_CHECKS); the identity otherwise
        fused = assert_finite(fused, "spatial fused_attn")
        out = self.fc(_merge_heads(torch.einsum("bhlt,bhtv->bhlv", fused, v)))
        out = dropout(out, self.dropout, self.training, generator)
        return self.layer_norm(out + x), fused


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, activation: str = "relu",
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        # glu halves the width
        hidden = dim_feedforward // 2 if activation == "glu" else dim_feedforward
        self.linear2 = nn.Linear(hidden, d_model, device=device)
        self.act = get_activation(activation)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(self.act(self.linear1(x)), self.dropout, self.training, generator)
        return self.linear2(h)


class TransformerEncoderLayer(nn.Module):
    """Self-attention and FFN, each with dropout on its residual branch,
    post-norm (``prenorm`` normalises each branch's input instead)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu", prenorm: bool = False,
                 device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, device)
        self.ffn = FeedForward(d_model, dim_feedforward, activation, dropout, device)
        self.dropout, self.prenorm = dropout, prenorm

    def forward(self, tgt: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.norm1(tgt) if self.prenorm else tgt
        tgt2, attn_w = self.self_attn(x, x, x, key_padding_mask, generator=generator)
        tgt = tgt + dropout(tgt2, self.dropout, self.training, generator)
        tgt = self.norm2(tgt) if self.prenorm else self.norm1(tgt)
        tgt = tgt + dropout(self.ffn(tgt, generator), self.dropout, self.training, generator)
        if not self.prenorm:
            tgt = self.norm2(tgt)
        return tgt, attn_w


class TransformerSpatialEncoderLayer(nn.Module):
    """Post-norm around the (already residual + LN'd) spatial attention,
    then FFN + residual + LN, with dropout on both residual branches."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "relu", spatial_multihead: bool = True,
                 spatial_dim: int = 5, spatial_attn_fusion: str = "cond",
                 dropout: float = 0.1, device=None, loc_dim: Optional[int] = None):
        super().__init__()
        self.self_attn = MultiHeadAttentionSpatial(
            d_model, nhead, spatial_multihead, spatial_dim, spatial_attn_fusion, dropout, device,
            loc_dim,
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


class CrossAttentionLayer(nn.Module):
    """Attention of ``tgt`` over ``memory`` (of width ``kv_dim``, by default
    ``d_model``), then FFN. (The reference's ``tgt_key_padding_mask`` is
    never read, so it is not taken here.)"""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu", prenorm: bool = True,
                 device=None, kv_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout, device, kv_dim)
        self.ffn = FeedForward(d_model, dim_feedforward, activation, dropout, device)
        self.dropout, self.prenorm = dropout, prenorm

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.norm1(tgt) if self.prenorm else tgt
        tgt2, attn_w = self.multihead_attn(x, memory, memory, memory_key_padding_mask,
                                           generator=generator)
        tgt = tgt + dropout(tgt2, self.dropout, self.training, generator)
        if self.prenorm:
            tgt2 = self.norm3(tgt)
        else:  # the FFN reads the attention's output, as the reference writes it
            tgt = self.norm1(tgt)
        tgt = tgt + dropout(self.ffn(tgt2, generator), self.dropout, self.training, generator)
        if not self.prenorm:
            tgt = self.norm3(tgt)
        return tgt, attn_w


class DiTBlock(nn.Module):
    """adaLN-Zero conditioning: ``Linear(6H)`` of ``silu(c)`` gives a shift,
    scale and gate for the attention and the MLP (4× wide, tanh gelu); the
    two LayerNorms have no scale or bias (eps 1e-6)."""

    def __init__(self, hidden_size: int, num_heads: int, device=None):
        super().__init__()
        self.adaLN_modulation = nn.Linear(hidden_size, 6 * hidden_size, device=device)
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-6, elementwise_affine=False,
                                  device=device)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-6, elementwise_affine=False,
                                  device=device)
        self.attn = MultiHeadAttention(hidden_size, num_heads, dropout=0.0, device=device)
        width = 4 * hidden_size
        self.mlp_fc1 = nn.Linear(hidden_size, width, device=device)
        self.mlp_fc2 = nn.Linear(width, hidden_size, device=device)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = torch.chunk(
            self.adaLN_modulation(F.silu(c)), 6, dim=-1)
        h = self.norm1(x) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn(h, h, h)[0]
        m = self.mlp_fc1(self.norm2(x) * (1 + scale_mlp) + shift_mlp)
        return x + gate_mlp * self.mlp_fc2(F.gelu(m, approximate="tanh"))
