"""3D geometry ops for situation modelling.

Counterparts of ``msr3d_tpu/ops/geometry.py``: the same conventions
(xyzw quaternions conjugated into the agent frame, the 5-d pairwise
geometry in "center" mode, Perceiver-style Fourier features).
"""

from __future__ import annotations

import math

import torch


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw quaternions → (..., 3, 3) rotation matrices. The xyz
    components are negated first: the rotation is *into* the agent frame."""
    x = -quaternions[..., 0]
    y = -quaternions[..., 1]
    z = -quaternions[..., 2]
    w = quaternions[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, xw = x * y, x * z, x * w
    yz, yw, zw = y * z, y * w, z * w
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy + zw), 2 * (xz - yw)], dim=-1)
    row1 = torch.stack([2 * (xy - zw), 1 - 2 * (xx + zz), 2 * (yz + xw)], dim=-1)
    row2 = torch.stack([2 * (xz + yw), 2 * (yz - xw), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def transform_to_agent_coor(
    obj_centers: torch.Tensor, anchor_loc: torch.Tensor, anchor_ori: torch.Tensor
) -> torch.Tensor:
    """obj_centers (B, N, 3), anchor_loc (B, 3), anchor_ori (B, 4) xyzw →
    centers in the agent frame (B, N, 3)."""
    centered = obj_centers - anchor_loc[:, None, :]
    return torch.einsum("bnd,bde->bne", centered, quaternion_to_matrix(anchor_ori))


def calc_pairwise_locs(
    obj_centers: torch.Tensor,
    obj_whls: torch.Tensor,
    eps: float = 1e-10,
    pairwise_rel_type: str = "center",
    spatial_dist_norm: bool = True,
    spatial_dim: int = 5,
) -> torch.Tensor:
    """obj_centers (B, N, 3) → (B, N, N, 5): [norm-dist, Δz/dist,
    dist2d/dist, Δy/dist2d, Δx/dist2d] ("center" mode, the flagship's)."""
    if pairwise_rel_type != "center" or spatial_dim != 5:
        raise NotImplementedError(
            f"pairwise_rel_type={pairwise_rel_type!r}, spatial_dim={spatial_dim} "
            "(only 'center' with 5 dims is ported; see ROADMAP.md)"
        )
    delta = obj_centers[:, :, None, :] - obj_centers[:, None, :, :]
    sq = delta * delta
    dist = torch.sqrt(sq.sum(dim=3) + eps)
    if spatial_dist_norm:
        norm_dist = dist / dist.flatten(1).amax(dim=1)[:, None, None]
    else:
        norm_dist = dist
    dist_2d = torch.sqrt(sq[..., :2].sum(dim=3) + eps)
    return torch.stack(
        [
            norm_dist,
            delta[..., 2] / dist,
            dist_2d / dist,
            delta[..., 1] / dist_2d,
            delta[..., 0] / dist_2d,
        ],
        dim=3,
    )


def generate_fourier_features(
    pos: torch.Tensor, num_bands: int = 10, max_freq: float = 15.0
) -> torch.Tensor:
    """pos (B, N, D) → (B, N, D + 2·D·num_bands): pos ‖ sin(π·pos·f) ‖
    cos(π·pos·f), bands f = linspace(1, max_freq, num_bands)."""
    b, n, d = pos.shape
    freq_bands = torch.linspace(1.0, max_freq, num_bands, dtype=pos.dtype, device=pos.device)
    per_pos = (pos[..., None] * freq_bands).reshape(b, n, d * num_bands)
    arg = math.pi * per_pos
    return torch.cat([pos, torch.sin(arg), torch.cos(arg)], dim=-1)
