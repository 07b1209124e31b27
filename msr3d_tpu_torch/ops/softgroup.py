"""SoftGroup instance-segmentation ops.

Counterpart of ``msr3d_tpu/ops/softgroup.py``, with its split:

  * host index plans over numpy (``ops/host_geometry.py``):
    ``voxelization_idx`` (modes 0-4), ``ballquery_batch_p``,
    ``bfs_cluster``;
  * device functions over torch tensors, on whatever device the tensors
    lie: ``voxelization`` (a masked gather and a sum, or mean),
    ``global_avg_pool`` and ``sec_mean``/``sec_min``/``sec_max`` (segment
    reductions by ``index_add``/``scatter_reduce``), the proposal × instance
    IoU tables ``get_mask_iou_on_cluster``/``get_mask_iou_on_pred`` (a
    segment sum of one-hot rows) and ``get_mask_label``. ``voxelization``
    and ``global_avg_pool`` take autograd's gradient, the one JAX's
    autodiff gives (the gradient broadcast to the contributing points, over
    the count for a mean).

Semantics are the JAX package's: voxel ids in first-occurrence order over
points 0..N-1 (not sorted, as a ``torch.unique`` would give), the ``+1e-5``
IoU denominator, the ``> 0.5`` mask threshold, ``get_mask_label``'s strict
greater-than argmax that skips ``-100`` classes, and rows of a segment
reduction outside ``offsets`` dropped, as ``jax.ops.segment_*`` drops them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from msr3d_tpu_torch.ops.host_geometry import (
    ballquery_packed,
    bfs_components,
    group_rows,
    pad_groups,
)

__all__ = [
    "voxelization_idx",
    "voxelization",
    "ballquery_batch_p",
    "bfs_cluster",
    "global_avg_pool",
    "sec_mean",
    "sec_min",
    "sec_max",
    "get_mask_iou_on_cluster",
    "get_mask_iou_on_pred",
    "get_mask_label",
]


def voxelization_idx(coords: np.ndarray, batchsize: int,
                     mode: int = 4) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The point → voxel plan of (N, 4) (batch, x, y, z) or (N, 3) integer
    coords → (output_coords (M, coords.shape[1]) — each voxel's first
    point's row —, input_map (N,) int32 voxel of each point, output_map
    (M, maxActive + 1) int32 rows ``[count, idx...]`` zero-padded). Modes 0,
    1 and 2 keep one index a voxel (coords asserted unique, the first point,
    the last); 3 and 4 keep every member (sum, mean)."""
    coords = np.asarray(coords)
    assert coords.ndim == 2 and coords.shape[1] in (3, 4), coords.shape
    n = coords.shape[0]
    keys = (coords.astype(np.int64) if coords.shape[1] == 4
            else np.concatenate([np.zeros((n, 1), np.int64), coords.astype(np.int64)], 1))
    input_map, m = group_rows(keys)
    if mode == 0:
        assert m == n, "mode 0 requires already-unique coords"
    members = pad_groups(input_map, m)  # (m, kmax) padded -1, input order
    counts = np.bincount(input_map, minlength=m).astype(np.int32)
    if mode in (0, 1, 2):
        output_map = np.ones((m, 2), np.int32)
        output_map[:, 1] = members[:, 0] if mode in (0, 1) else members[np.arange(m), counts - 1]
    else:
        output_map = np.zeros((m, members.shape[1] + 1), np.int32)
        output_map[:, 0] = counts
        output_map[:, 1:] = np.where(members >= 0, members, 0)
    output_coords = coords[members[:, 0].astype(np.int64)].copy()
    return output_coords, input_map, output_map


def voxelization(feats: torch.Tensor, output_map: torch.Tensor, mode: int = 4) -> torch.Tensor:
    """(N, C) point features → (M, C) voxel features, the sum (mode 4: the
    mean) of each voxel's members in ``output_map``."""
    counts = output_map[:, :1].to(feats.dtype)
    idx = output_map[:, 1:].long()
    pos = torch.arange(idx.shape[1], device=idx.device)[None, :]
    valid = pos < output_map[:, :1]
    # index_select's backward adds by index_add (advanced indexing's sorts
    # the indices: slow on the card for the padding's repeated row 0)
    rows = torch.index_select(feats, 0, idx.reshape(-1)).reshape(*idx.shape, feats.shape[-1])
    gathered = torch.where(valid[..., None], rows, feats.new_zeros(()))
    out = gathered.sum(dim=1)
    if mode == 4:
        out = out / counts.clamp_min(1.0)
    return out


def ballquery_batch_p(coords: np.ndarray, batch_idxs: np.ndarray, batch_offsets: np.ndarray,
                      radius: float, meanActive: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """Every same-batch point with d² < radius², self included, in index
    order → (idx (nActive,) int32, start_len (n, 2) int32). The host build
    is exact and has no capacity, so ``meanActive`` is taken and unused."""
    del meanActive
    return ballquery_packed(coords, batch_idxs, batch_offsets, radius)


def bfs_cluster(class_numpoint_mean: np.ndarray, ball_query_idxs: np.ndarray,
                start_len: np.ndarray, threshold: float,
                class_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Connected components of the ball-query graph (seeds 0..N-1, members
    in BFS dequeue order), kept where their size reaches ``threshold``, or
    ``threshold`` × the class's mean point count where that is not -1 →
    (cluster_idxs (sumNPoint, 2) int32 rows ``(cluster, point)``,
    cluster_offsets (nCluster + 1,) int32)."""
    mean = float(np.asarray(class_numpoint_mean, np.float32)[class_id])
    thr = threshold if mean == -1 else threshold * mean
    order, comp_offsets = bfs_components(ball_query_idxs, start_len)
    sizes = np.diff(comp_offsets)
    keep = np.nonzero(sizes >= thr)[0]
    offsets = np.zeros(len(keep) + 1, np.int32)
    rows = []
    for c, comp_id in enumerate(keep):
        members = order[comp_offsets[comp_id]:comp_offsets[comp_id + 1]]
        offsets[c + 1] = offsets[c] + len(members)
        rows.extend((c, int(p)) for p in members)
    return np.asarray(rows, np.int32).reshape(-1, 2), offsets


def _segment_ids(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """offsets (P+1,) → each row's segment (total,): the largest s with
    offsets[s] <= row; rows outside [offsets[0], offsets[P]) get P, the
    bucket that the reductions below drop."""
    num_seg = offsets.shape[0] - 1
    rows = torch.arange(total, device=offsets.device, dtype=offsets.dtype)
    seg = torch.searchsorted(offsets, rows, right=True) - 1
    return torch.where((seg >= 0) & (seg < num_seg), seg, num_seg)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, num_seg: int) -> torch.Tensor:
    out = x.new_zeros((num_seg + 1,) + x.shape[1:])
    return out.index_add(0, seg, x)[:num_seg]


def _segment_reduce(x: torch.Tensor, offsets: torch.Tensor, reduce: str) -> torch.Tensor:
    """``amin``/``amax`` of each segment; an empty one holds the reduction's
    identity (+inf/-inf, or the integer type's extreme), as in JAX."""
    num_seg = offsets.shape[0] - 1
    seg = _segment_ids(offsets, x.shape[0])
    if x.dtype.is_floating_point:
        fill = float("inf") if reduce == "amin" else float("-inf")
    else:
        info = torch.iinfo(x.dtype)
        fill = info.max if reduce == "amin" else info.min
    out = torch.full((num_seg + 1,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    index = seg.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce(0, index, x, reduce=reduce, include_self=True)[:num_seg]


def global_avg_pool(feats: torch.Tensor, proposals_offset: torch.Tensor) -> torch.Tensor:
    """Mean of each proposal's packed rows: (sumNPoint, C) → (nProposal, C)."""
    num_seg = proposals_offset.shape[0] - 1
    sums = _segment_sum(feats, _segment_ids(proposals_offset, feats.shape[0]), num_seg)
    counts = (proposals_offset[1:] - proposals_offset[:-1]).to(feats.dtype)
    return sums / counts.clamp_min(1.0)[:, None]


def sec_mean(inp: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return global_avg_pool(inp, offsets)


def sec_min(inp: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return _segment_reduce(inp, offsets, "amin")


def sec_max(inp: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return _segment_reduce(inp, offsets, "amax")


def _proposal_instance_intersection(proposals_idx, proposals_offset, instance_labels,
                                    n_instance: int, point_weight=None) -> torch.Tensor:
    """(nProposal, nInstance) fp32 intersection counts: each packed point's
    one-hot instance row (zeros for -100 and for labels past nInstance),
    summed over its proposal."""
    labels = instance_labels[proposals_idx.long()]
    classes = torch.arange(n_instance, device=labels.device, dtype=labels.dtype)
    onehot = (labels[:, None] == classes[None, :]).to(torch.float32)
    if point_weight is not None:
        onehot = onehot * point_weight[:, None]
    num_seg = proposals_offset.shape[0] - 1
    return _segment_sum(onehot, _segment_ids(proposals_offset, proposals_idx.shape[0]), num_seg)


def get_mask_iou_on_cluster(proposals_idx: torch.Tensor, proposals_offset: torch.Tensor,
                            instance_labels: torch.Tensor,
                            instance_pointnum: torch.Tensor) -> torch.Tensor:
    """IoU of each proposal's point set with each ground-truth instance."""
    inter = _proposal_instance_intersection(proposals_idx, proposals_offset, instance_labels,
                                            instance_pointnum.shape[0])
    prop_total = (proposals_offset[1:] - proposals_offset[:-1]).to(torch.float32)
    union = prop_total[:, None] + instance_pointnum.to(torch.float32)[None, :] - inter
    return inter / (union + 1e-5)


def get_mask_iou_on_pred(proposals_idx: torch.Tensor, proposals_offset: torch.Tensor,
                         instance_labels: torch.Tensor, instance_pointnum: torch.Tensor,
                         mask_scores_sigmoid: torch.Tensor) -> torch.Tensor:
    """The IoU with a proposal's points kept where the predicted mask is
    above 0.5."""
    member = (mask_scores_sigmoid > 0.5).to(torch.float32)
    inter = _proposal_instance_intersection(proposals_idx, proposals_offset, instance_labels,
                                            instance_pointnum.shape[0], member)
    num_seg = proposals_offset.shape[0] - 1
    prop_total = _segment_sum(member, _segment_ids(proposals_offset, proposals_idx.shape[0]),
                              num_seg)
    union = prop_total[:, None] + instance_pointnum.to(torch.float32)[None, :] - inter
    return inter / (union + 1e-5)


def get_mask_label(proposals_idx: torch.Tensor, proposals_offset: torch.Tensor,
                   instance_labels: torch.Tensor, instance_cls: torch.Tensor,
                   instance_pointnum: torch.Tensor, proposals_iou: torch.Tensor,
                   iou_thr: float) -> torch.Tensor:
    """Per packed point, fp32: -1 (ignored) unless its proposal's best IoU
    over instances whose class is not -100 reaches ``iou_thr``, then 1
    where the point's instance is that best one, else 0. The best is taken
    by strict greater-than from 0, so the first index wins ties and a row
    without a positive IoU takes instance 0."""
    del instance_pointnum  # taken for the signature, read by no kernel
    eligible = instance_cls != -100
    masked = torch.where(eligible[None, :], proposals_iou,
                         torch.full_like(proposals_iou, float("-inf")))
    row_max = masked.max(dim=1).values
    max_iou = row_max.clamp_min(0.0)
    max_ind = torch.where(row_max > 0.0, masked.argmax(dim=1),
                          torch.zeros_like(row_max, dtype=torch.long))
    # a point outside every proposal reads the last one, as JAX's gather
    # wraps segment -1 and clamps segment nProposal
    seg = _segment_ids(proposals_offset, proposals_idx.shape[0]).long()
    seg = seg.clamp_max(proposals_offset.shape[0] - 2)
    assigned = max_iou[seg] >= iou_thr
    point_inst = instance_labels[proposals_idx.long()]
    hit = (point_inst == max_ind[seg]).to(torch.float32)
    return torch.where(assigned, hit, torch.full_like(hit, -1.0))
