"""PointBERT (PointTransformer) object encoder.

Counterpart of ``msr3d_tpu/nn/pointbert.py``. Pipeline: FPS centers
(kernel K1 at npoint = ``num_group``) → kNN grouping (center-relative xyz
‖ rgb) → mini-PointNet group embedding (Linear/BatchNorm stack, the
global-max concat) → ViT blocks with a per-block additive positional
embedding from the group centers → ``[cls ‖ max-pool]`` (2·trans_dim).

FPS seeds at index 0 and skips padding points (‖p‖² ≤ 1e-3), as K1 and the
JAX package's FPS do. ``knn_point`` orders neighbours by squared distance
with a stable sort, so that among equal distances the lower index comes
first, as ``jax.lax.top_k`` of the negated distances does. BatchNorm reads
its running statistics (``batch_stats``), as the JAX module's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.nn.pointnet import BatchNorm
from msr3d_tpu_torch.nn.transformers import MultiHeadAttention
from msr3d_tpu_torch.ops.pointnet2 import fps, gather_points, group_points


def knn_point(k: int, xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The k nearest points of each center: xyz (B, N, 3), centers (B, G, 3)
    → (B, G, k) int32, nearest first, the lower index first among equal
    squared distances."""
    diff = centers[:, :, None, :] - xyz[:, None, :, :]
    sq = diff * diff
    d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]  # (B, G, N)
    return torch.sort(d2, dim=-1, stable=True)[1][..., :k].to(torch.int32)


class GroupDivider(nn.Module):
    """FPS centers and kNN neighbourhoods, xyz relative to the center."""

    def __init__(self, num_group: int, group_size: int):
        super().__init__()
        self.num_group, self.group_size = num_group, group_size

    def forward(self, pts: torch.Tensor):
        xyz = pts[..., :3]
        centers = gather_points(xyz, fps(xyz, self.num_group))  # (B, G, 3)
        idx = knn_point(self.group_size, xyz, centers)  # (B, G, k)
        nb_xyz = group_points(xyz, idx) - centers[:, :, None, :]
        if pts.shape[-1] > 3:
            return torch.cat([nb_xyz, group_points(pts[..., 3:], idx)], dim=-1), centers
        return nb_xyz, centers


class MiniPointNet(nn.Module):
    """Group embedding: Linear → BN → ReLU → Linear, max over the group,
    concat with each point, Linear → BN → ReLU → Linear, max.
    (B, G, k, C) → (B, G, encoder_channel)."""

    def __init__(self, in_channels: int, encoder_channel: int, device=None):
        super().__init__()
        self.conv1a = nn.Linear(in_channels, 128, device=device)
        self.bn1 = BatchNorm(128, device=device)
        self.conv1b = nn.Linear(128, 256, device=device)
        self.conv2a = nn.Linear(512, 512, device=device)
        self.bn2 = BatchNorm(512, device=device)
        self.conv2b = nn.Linear(512, encoder_channel, device=device)

    def forward(self, groups: torch.Tensor) -> torch.Tensor:
        b, g, k, c = groups.shape
        h = self.conv1b(F.relu(self.bn1(self.conv1a(groups.reshape(b * g, k, c)))))
        global_feat = h.amax(dim=1, keepdim=True)
        h = torch.cat([global_feat.expand_as(h), h], dim=-1)
        h = self.conv2b(F.relu(self.bn2(self.conv2a(h))))
        return h.amax(dim=1).reshape(b, g, -1)


class ViTBlock(nn.Module):
    """Pre-LN block: attention (no dropout) and an exact-gelu MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, dropout=0.0, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio), device=device)
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.attn(h, h, h)[0]
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class PointTransformer(nn.Module):
    """pts (B, P, 3 or 6) → (B, 2·trans_dim)."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 group_size: int = 32, num_group: int = 64, encoder_dims: int = 256,
                 add_rgb: bool = True, device=None):
        super().__init__()
        self.add_rgb = add_rgb
        self.group_divider = GroupDivider(num_group, group_size)
        self.encoder = MiniPointNet(6 if add_rgb else 3, encoder_dims, device)
        self.reduce_dim = nn.Linear(encoder_dims, trans_dim, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim, device=device))
        self.cls_pos = nn.Parameter(torch.randn(1, 1, trans_dim, device=device))
        self.pos_embed_fc1 = nn.Linear(3, 128, device=device)
        self.pos_embed_fc2 = nn.Linear(128, trans_dim, device=device)
        self.block = nn.ModuleList(ViTBlock(trans_dim, num_heads, device=device)
                                   for _ in range(depth))
        self.norm = nn.LayerNorm(trans_dim, eps=1e-5, device=device)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        groups, centers = self.group_divider(pts)
        if not self.add_rgb:
            groups = groups[..., :3]
        tokens = self.reduce_dim(self.encoder(groups))
        b, _, d = tokens.shape
        pos = self.pos_embed_fc2(F.gelu(self.pos_embed_fc1(centers)))
        x = torch.cat([self.cls_token.expand(b, 1, d), tokens], dim=1)
        pos = torch.cat([self.cls_pos.expand(b, 1, d), pos], dim=1)
        for block in self.block:
            x = block(x + pos)  # the per-block additive position embedding
        x = self.norm(x)
        return torch.cat([x[:, 0], x[:, 1:].amax(dim=1)], dim=-1)


class PointBERTPcdObjEncoder(nn.Module):
    """Objects batched through ``PointTransformer``: (B, O, P, 6) → (embeds,
    embeds), each (B, O, 2·trans_dim). ``freeze`` detaches them."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 group_size: int = 32, num_group: int = 64, encoder_dims: int = 256,
                 add_rgb: bool = True, freeze: bool = False, device=None):
        super().__init__()
        self.freeze = freeze
        self.pcd_encoder = PointTransformer(trans_dim, depth, num_heads, group_size,
                                            num_group, encoder_dims, add_rgb, device)

    def forward(self, obj_pcds: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, o, p, d = obj_pcds.shape
        embeds = self.pcd_encoder(obj_pcds.reshape(b * o, p, d)).reshape(b, o, -1)
        if self.freeze:
            embeds = embeds.detach()
        return embeds, embeds
