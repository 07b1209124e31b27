"""Axis-aligned 3D box utilities (numpy).

Copy of ``msr3d_tpu/data/box_utils.py``: boxes as (center, size), corner
sets of 8 points, and the IoU of two axis-aligned corner sets. The legacy
datasets match predicted instances to ground-truth boxes with them
(``pc_type: pred``), and the grounding evaluation scores a predicted box by
its IoU with the target's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def convert_pc_to_box(obj_pcd: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud (N, ≥3) → (center (3,), box_size (3,))."""
    xyz = obj_pcd[:, :3]
    mn, mx = xyz.min(0), xyz.max(0)
    return (mn + mx) / 2, mx - mn


def construct_bbox_corners(center, box_size) -> np.ndarray:
    """(center, size) → 8 corners (8, 3)."""
    cx, cy, cz = center
    sx, sy, sz = box_size
    xs = [cx - sx / 2, cx + sx / 2]
    ys = [cy - sy / 2, cy + sy / 2]
    zs = [cz - sz / 2, cz + sz / 2]
    return np.array([[x, y, z] for x in xs for y in ys for z in zs])


def box3d_iou_aligned(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """Axis-aligned IoU from corner sets (8, 3); 0 when both are empty."""
    mn1, mx1 = corners1.min(0), corners1.max(0)
    mn2, mx2 = corners2.min(0), corners2.max(0)
    inter = np.maximum(0.0, np.minimum(mx1, mx2) - np.maximum(mn1, mn2))
    vol_i = float(np.prod(inter))
    vol1 = float(np.prod(mx1 - mn1))
    vol2 = float(np.prod(mx2 - mn2))
    denom = vol1 + vol2 - vol_i
    return vol_i / denom if denom > 0 else 0.0


def eval_ref_one_sample(pred_corners: np.ndarray, gt_corners: np.ndarray) -> float:
    """IoU of a predicted box with the target's, both as corner sets."""
    return box3d_iou_aligned(pred_corners, gt_corners)


def rotate_z_axis_by_degrees(pcd: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate the xyz columns of ``pcd`` about +z; other columns stay."""
    theta = np.deg2rad(degrees)
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ],
        pcd.dtype,
    )
    out = pcd.copy()
    out[:, :3] = pcd[:, :3] @ rot.T
    return out
