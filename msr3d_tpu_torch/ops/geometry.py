"""3D geometry ops for situation modelling.

Counterparts of ``msr3d_tpu/ops/geometry.py``: the same conventions
(xyzw quaternions conjugated into the agent frame, the pairwise geometry in
every mode, Perceiver-style Fourier features).
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
    """obj_centers (B, N, 3), obj_whls (B, N, 3) → (B, N, N, spatial_dim).

    ``center``: [norm-dist, Δz/dist, dist2d/dist, Δy/dist2d, Δx/dist2d];
    ``vertical_bottom`` takes Δz, dist and dist2d between the objects'
    bottoms (z minus the whole height, as the JAX package does);
    ``spatial_dim`` 4 drops the distance, 1 keeps it alone; ``mlp`` is the
    12-d concatenation [loc_i ‖ loc_j]. The distance normaliser is the max
    over all N×N pairs of a scene, padded objects included."""
    if pairwise_rel_type == "mlp":
        locs = torch.cat([obj_centers, obj_whls], dim=2)
        b, n, d = locs.shape
        return torch.cat([locs[:, :, None, :].expand(b, n, n, d),
                          locs[:, None, :, :].expand(b, n, n, d)], dim=3)
    if pairwise_rel_type not in ("center", "vertical_bottom"):
        raise NotImplementedError(pairwise_rel_type)

    def distances(centers):
        delta = centers[:, :, None, :] - centers[:, None, :, :]
        sq = delta * delta
        return delta, torch.sqrt(sq.sum(dim=3) + eps), torch.sqrt(sq[..., :2].sum(dim=3) + eps)

    delta, dist, dist_2d = distances(obj_centers)
    if spatial_dist_norm:
        norm_dist = dist / dist.flatten(1).amax(dim=1)[:, None, None]
    else:
        norm_dist = dist
    if spatial_dim == 1:
        return norm_dist[..., None]
    if pairwise_rel_type == "center":
        zdelta, zdist, zdist_2d = delta, dist, dist_2d
    else:
        bottom = torch.cat([obj_centers[..., :2], obj_centers[..., 2:] - obj_whls[..., 2:]],
                           dim=-1)
        zdelta, zdist, zdist_2d = distances(bottom)
    pairwise = torch.stack(
        [
            norm_dist,
            zdelta[..., 2] / zdist,
            zdist_2d / zdist,
            delta[..., 1] / dist_2d,
            delta[..., 0] / dist_2d,
        ],
        dim=3,
    )
    return pairwise[..., 1:] if spatial_dim == 4 else pairwise


# jnp.linspace(1, 15, 10) in fp32, the frequency bands of every caller: XLA
# on the CPU lands one ulp below the fp32 arithmetic of its
# own formula on bands 5 and 7 (and torch.linspace one ulp away on bands 3,
# 7 and 8); the features scale a band by up to 15π·|pos|, so one ulp moves
# them by ~1e-5. The values, as JAX computes them:
_JAX_BANDS = {(10, 15.0): (1.0, 2.5555556, 4.111111, 5.6666665, 7.2222223, 8.777778,
                           10.333333, 11.888888, 13.444444, 15.0)}


def _linspace(start: float, stop: float, num: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace``'s values: the table above, else its formula
    ``start·(1 - s) + stop·s``, ``s = i / (num - 1)``, then ``stop``."""
    if start == 1.0 and (num, stop) in _JAX_BANDS:
        return torch.tensor(_JAX_BANDS[num, stop], dtype=dtype, device=device)
    step = torch.arange(num - 1, dtype=dtype, device=device) / (num - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def generate_fourier_features(
    pos: torch.Tensor, num_bands: int = 10, max_freq: float = 15.0,
    concat_pos: bool = True, sine_only: bool = False,
) -> torch.Tensor:
    """pos (B, N, D) → (B, N, [D +] D·num_bands·(1 or 2)): pos ‖ sin(π·pos·f)
    ‖ cos(π·pos·f), bands f = linspace(1, max_freq, num_bands)."""
    b, n, d = pos.shape
    freq_bands = _linspace(1.0, max_freq, num_bands, pos.dtype, pos.device)
    per_pos = (pos[..., None] * freq_bands).reshape(b, n, d * num_bands)
    arg = math.pi * per_pos
    feats = [torch.sin(arg)] if sine_only else [torch.sin(arg), torch.cos(arg)]
    return torch.cat(([pos] if concat_pos else []) + feats, dim=-1)


def fourier_feature_dim(d: int, num_bands: int = 10, concat_pos: bool = True,
                        sine_only: bool = False) -> int:
    return d * num_bands * (1 if sine_only else 2) + (d if concat_pos else 0)


def z_rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about +z by ``theta`` (radians): (...) → (..., 3, 3)."""
    c, s = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zeros], dim=-1),
            torch.stack([s, c, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
