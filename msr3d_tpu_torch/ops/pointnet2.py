"""PointNet++ point-cloud ops, channels-last.

Counterparts of ``msr3d_tpu/ops/pointnet2.py``: ``fps`` goes to kernel
K1 (``ops/fps.py``); ball query, the gathers and the feature-propagation
ops ``three_nn``/``three_interpolate`` are plain PyTorch, as they are plain
XLA in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from msr3d_tpu_torch.ops.fps import furthest_point_sample


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS entry used by the SA modules: (B, N, 3) → (B, npoint) int32."""
    return furthest_point_sample(xyz.float().contiguous(), npoint)


def ball_query(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3) → (B, M, nsample) int64.

    For each center, the first ``nsample`` point indices in point order
    with d² < radius²; the first of them backfills the remaining slots;
    an empty ball gives index 0."""
    xyz, new_xyz = xyz.float(), new_xyz.float()
    delta = new_xyz[:, :, None, :] - xyz[:, None, :, :]  # (B, M, N, 3)
    sq = delta * delta
    d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
    in_ball = d2 < radius * radius
    n = xyz.shape[1]
    # stable sort of "not in ball" puts in-ball points first, in point order
    order = torch.argsort((~in_ball).to(torch.uint8), dim=-1, stable=True)
    slot = torch.arange(nsample, device=xyz.device)
    picked = order[..., slot.clamp(max=n - 1)]
    count = in_ball.sum(dim=-1, keepdim=True)
    idx = torch.where(slot < count, picked, picked[..., :1])
    return torch.where(count > 0, idx, torch.zeros_like(idx))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) → (B, M, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[rows, idx.long()]


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, K) → (B, M, K, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[rows, idx.long()]


def query_and_group(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: Optional[torch.Tensor],
    radius: float,
    nsample: int,
) -> torch.Tensor:
    """Ball query + gather: center-relative xyz ‖ features,
    (B, M, nsample, 3 + C), as the JAX package's ``use_xyz=True``."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return grouped_xyz
    grouped_features = group_points(features, idx)
    return torch.cat([grouped_xyz, grouped_features.to(grouped_xyz.dtype)], dim=-1)


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor]) -> torch.Tensor:
    """One group of all points: (B, N, 3) ‖ (B, N, C) → (B, 1, N, 3 + C)."""
    grouped = xyz[:, None]
    if features is None:
        return grouped
    return torch.cat([grouped, features[:, None].to(grouped.dtype)], dim=-1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 3-NN: unknown (B, n, 3), known (B, m, 3) → (euclidean distance
    (B, n, 3), idx (B, n, 3) int32), nearest first. A stable sort of d²
    puts the lowest index first among equal distances, as ``lax.top_k``
    of -d² does."""
    diff = unknown[:, :, None, :] - known[:, None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    d2_sorted, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(d2_sorted[..., :3].clamp(min=0.0)), idx[..., :3].to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-point interpolation, channels-last: features (B, m, C),
    idx (B, n, 3), weight (B, n, 3) → (B, n, C)."""
    return (group_points(features, idx) * weight[..., None]).sum(dim=2)
