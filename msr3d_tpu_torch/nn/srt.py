"""Scene Representation Transformer: the multi-view image encoder and the
novel-view ray decoder.

Counterpart of ``msr3d_tpu/nn/srt.py``: the octave positional encodings
(``positional_encoding``, ``ray_encoding`` of flat rays,
``ray_image_encoding`` of image-shaped rays), ``RayPredictor`` (encoded
rays cross-attending into the scene's tokens), ``SRTDecoder`` (the ray
predictor, then a render MLP to sigmoid RGB; ``HEADS_REGISTRY``) and
``SRTEncoder`` (pixels ‖ ray encoding → a strided conv pyramid → a
per-patch linear → a prenorm transformer over every view's patches;
``VISION_REGISTRY``). 180 = 3 coordinates × 15 octaves × 2 (sin, cos) × 2
(position, direction).

Tensors are channels-last at the boundary, as in JAX: images and rays
(B, Nv, H, W, 3). The convolutions run ``F.conv2d`` on NCHW copies with
OIHW weights (``convert.py`` turns flax's HWIO kernels into them).
Dropout of the transformer layers is active only in ``train()`` mode; the
JAX modules run deterministic by default, as these do in ``eval()``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.nn.transformers import CrossAttentionLayer, TransformerEncoderLayer
from msr3d_tpu_torch.registry import HEADS_REGISTRY, VISION_REGISTRY

RAY_QUERY_DIM = 180


def positional_encoding(coords: torch.Tensor, num_octaves: int = 8,
                        start_octave: int = 0) -> torch.Tensor:
    """(B, N, D) → (B, N, 2·D·octaves): sines, then cosines, each D-major."""
    b, n, d = coords.shape
    octaves = torch.arange(start_octave, start_octave + num_octaves, dtype=coords.dtype,
                           device=coords.device)
    scaled = coords[..., None] * (2.0 ** octaves * math.pi)
    sines = torch.sin(scaled).reshape(b, n, d * num_octaves)
    cosines = torch.cos(scaled).reshape(b, n, d * num_octaves)
    return torch.cat([sines, cosines], dim=-1)


def ray_encoding(pos: torch.Tensor, rays: torch.Tensor, pos_octaves: int = 15,
                 pos_start_octave: int = 0, ray_octaves: int = 15) -> torch.Tensor:
    """Concatenated position and direction encodings of flat rays."""
    return torch.cat([positional_encoding(pos, pos_octaves, pos_start_octave),
                      positional_encoding(rays, ray_octaves, 0)], dim=-1)


def ray_image_encoding(pos: torch.Tensor, rays: torch.Tensor, pos_octaves: int = 15,
                       pos_start_octave: int = 0, ray_octaves: int = 15) -> torch.Tensor:
    """``pos`` (B, 3), ``rays`` (B, H, W, 3) → (B, H, W, 2·3·(po+ro)): the
    camera position's encoding broadcast over the image, then each pixel's
    ray direction's."""
    b, h, w, _ = rays.shape
    pos_enc = positional_encoding(pos[:, None, :], pos_octaves, pos_start_octave)
    pos_enc = pos_enc[:, :, None, :].expand(b, h, w, pos_enc.shape[-1])
    ray_enc = positional_encoding(rays.reshape(b, h * w, 3), ray_octaves, 0)
    return torch.cat([pos_enc, ray_enc.reshape(b, h, w, ray_enc.shape[-1])], dim=-1)


class RayPredictor(nn.Module):
    """Encoded rays as queries cross-attending into the scene encoding."""

    def __init__(self, num_att_blocks: int = 2, pos_start_octave: int = 0, out_dims: int = 3,
                 z_dim: int = 768, input_mlp: bool = False, output_mlp: bool = True,
                 device=None):
        super().__init__()
        self.pos_start_octave = pos_start_octave
        self.input_mlp, self.output_mlp = input_mlp, output_mlp
        if input_mlp:
            self.input_fc1 = nn.Linear(RAY_QUERY_DIM, 2 * RAY_QUERY_DIM, device=device)
            self.input_fc2 = nn.Linear(2 * RAY_QUERY_DIM, RAY_QUERY_DIM, device=device)
        self.layer = nn.ModuleList(
            CrossAttentionLayer(RAY_QUERY_DIM, 12, dim_feedforward=z_dim * 2,
                                activation="gelu", prenorm=True, device=device, kv_dim=z_dim)
            for _ in range(num_att_blocks))
        if output_mlp:
            self.output_fc1 = nn.Linear(RAY_QUERY_DIM, 128, device=device)
            self.output_fc2 = nn.Linear(128, out_dims, device=device)

    def forward(self, z: torch.Tensor, x: torch.Tensor, rays: torch.Tensor,
                generator=None) -> torch.Tensor:
        queries = ray_encoding(x, rays, pos_start_octave=self.pos_start_octave)
        if self.input_mlp:
            queries = self.input_fc2(F.relu(self.input_fc1(queries)))
        for layer in self.layer:
            queries, _ = layer(queries, z, generator=generator)
        if self.output_mlp:
            queries = self.output_fc2(F.relu(self.output_fc1(queries)))
        return queries


@HEADS_REGISTRY.register(name="SRTDecoder")
class SRTDecoder(nn.Module):
    """Novel-view pixel decoder: the ray predictor, then a render MLP of
    four ``2·hidden_dim`` layers → sigmoid RGB."""

    def __init__(self, num_att_blocks: int = 2, hidden_dim: int = 768,
                 pos_start_octave: int = 0, device=None):
        super().__init__()
        self.allocation_transformer = RayPredictor(
            num_att_blocks=num_att_blocks, pos_start_octave=pos_start_octave,
            z_dim=hidden_dim, input_mlp=True, output_mlp=False, device=device)
        width = 2 * hidden_dim
        self.render_fc0 = nn.Linear(RAY_QUERY_DIM, width, device=device)
        self.render_fc1 = nn.Linear(width, width, device=device)
        self.render_fc2 = nn.Linear(width, width, device=device)
        self.render_fc3 = nn.Linear(width, width, device=device)
        self.render_out = nn.Linear(width, 3, device=device)

    def forward(self, features: torch.Tensor, query_points: torch.Tensor, rays: torch.Tensor,
                generator=None) -> torch.Tensor:
        """features (B, Np, hidden_dim), query_points and rays (B, N, 3) →
        (B, N, 3) in (0, 1)."""
        h = self.allocation_transformer(features, query_points, rays, generator)
        for fc in (self.render_fc0, self.render_fc1, self.render_fc2, self.render_fc3):
            h = F.relu(fc(h))
        return torch.sigmoid(self.render_out(h))


class SRTConvBlock(nn.Module):
    """Two bias-free 3×3 convolutions with ReLU, the second of stride 2."""

    def __init__(self, idim: int, hdim: int, odim: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(idim, hdim, 3, stride=1, padding=1, bias=False, device=device)
        self.conv2 = nn.Conv2d(hdim, odim, 3, stride=2, padding=1, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW → NCHW at half the height and width (rounded up)."""
        return F.relu(self.conv2(F.relu(self.conv1(x))))


@VISION_REGISTRY.register(name="SRTEncoder")
class SRTEncoder(nn.Module):
    """SRT's multi-view image encoder: per view, pixels ‖ 180-channel ray
    encoding → ``num_conv_blocks`` + 1 strided conv blocks (96 → 192, then
    doubling) → a per-patch linear → a prenorm gelu transformer over all
    views' patches jointly."""

    def __init__(self, num_conv_blocks: int = 3, num_att_blocks: int = 5,
                 pos_start_octave: int = 0, hidden_dim: int = 768, num_heads: int = 12,
                 mlp_dim: int = 1536, device=None):
        super().__init__()
        self.pos_start_octave = pos_start_octave
        self.hidden_dim = hidden_dim
        cur, blocks = 96, []
        blocks.append(SRTConvBlock(3 + RAY_QUERY_DIM, cur, 2 * cur, device))
        cur *= 2
        for _ in range(num_conv_blocks):
            blocks.append(SRTConvBlock(cur, cur, 2 * cur, device))
            cur *= 2
        self.conv_block = nn.ModuleList(blocks)
        self.per_patch_linear = nn.Linear(cur, hidden_dim, device=device)
        self.layer = nn.ModuleList(
            TransformerEncoderLayer(hidden_dim, num_heads, dim_feedforward=mlp_dim,
                                    activation="gelu", prenorm=True, device=device)
            for _ in range(num_att_blocks))

    def forward(self, images: torch.Tensor, camera_pos: torch.Tensor, rays: torch.Tensor,
                generator=None) -> torch.Tensor:
        """images (B, Nv, H, W, 3), camera_pos (B, Nv, 3), rays (B, Nv, H,
        W, 3) → (B, Nv·Np, hidden_dim)."""
        b, n_v = images.shape[:2]
        x = images.reshape((b * n_v,) + images.shape[2:])
        pos = camera_pos.reshape(b * n_v, 3)
        ray = rays.reshape((b * n_v,) + rays.shape[2:])
        ray_enc = ray_image_encoding(pos, ray, pos_octaves=15,
                                     pos_start_octave=self.pos_start_octave, ray_octaves=15)
        x = torch.cat([x, ray_enc], dim=-1).permute(0, 3, 1, 2)  # NCHW, 183 channels
        for block in self.conv_block:
            x = block(x)
        x = self.per_patch_linear(x.permute(0, 2, 3, 1))
        x = x.reshape(b, n_v * x.shape[1] * x.shape[2], self.hidden_dim)
        for layer in self.layer:
            x, _ = layer(x, generator=generator)
        return x
