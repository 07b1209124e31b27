"""Swin3D sparse-voxel UNet: host index plans and the device modules.

Counterpart of ``msr3d_tpu/nn/swin3d.py``. Every piece of combinatorial
geometry (voxel dedup, plain and shifted window partitions, stride pooling
maps, kNN graphs, the representative nearest each coarse voxel's centroid,
inverse-distance up weights) is computed once a scene on the host as
integer plans, by the same numpy as JAX's and ``ops/host_geometry.py``, so
the plans are bit-equal to the JAX package's. The device modules are a
function (features, plans) → features of gathers, matmuls and masked
softmax.

Window attention with contextual relative signal encoding (cRSE): per
signal channel c (x, y, z in window-voxel units × quant_size; r, g, b in
[-1, 1] × 2·quant_size) the relative index of a (query, key) pair in a
window is ``clamp(floor((nc_q - nc_k) + L), 0, 2L - 1)``, formed in fp32 in
JAX's order; the logits are ``q·k + q·Σ_c Tq_c[idx] + k·Σ_c Tk_c[idx]``
(q scaled by head_dim^-0.5) and the values ``v + Σ_c Tv_c[idx]`` inside the
softmax average. JAX builds three (W, K, K, H, hd) bias tensors for that;
here no (W, K, K, ·) tensor wider than the heads exists: q·Tq[idx] is a
gather, at each pair's index, of the (W, H, K, 2L) products of q with each
table (k·Tk likewise, along the key), and the value term is the histogram
of the attention weights over the 2L table rows (``scatter_add``) times the
table. This reorders fp32 sums only. Both terms are autograd functions of
their own that keep only their inputs for the backward. The indices depend
on the plan alone, so one set of them serves every block that reads the
plan (``crse_indices``).

Defaults that flax and torch do not share are flax's here: LayerNorm's
epsilon 1e-6, BatchNorm's momentum (0.98 in the sparse convolutions, 0.99
in the classifier) and its biased batch variance (``nn/pointnet.py``'s
``BatchNorm``). ``train=True`` normalises with the batch's statistics and
moves the running ones, as ``apply(..., mutable=["batch_stats"])`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.device import resolve_device
from msr3d_tpu_torch.nn.pointnet import BatchNorm
from msr3d_tpu_torch.ops import host_geometry
from msr3d_tpu_torch.ops.softgroup import voxelization_idx

__all__ = [
    "build_swin3d_plans",
    "plans_to_torch",
    "crse_indices",
    "WindowAttentionCRSE",
    "SwinTransformerBlock3D",
    "BasicLayer3D",
    "Swin3DUNet",
    "PCDSwin3DEncoder",
]

# 3x3x3 neighbour offsets in a fixed order (the conv kernel's tap order)
_CONV_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)], np.int64)
LN_EPS = 1e-6  # flax nn.LayerNorm's default


# ---------------------------------------------------------------------------
# Host plans (numpy, the JAX package's)


def _window_partition(coords: np.ndarray, stride: int, window_size: int,
                      shift: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Voxels (N, 4) [batch, x, y, z] at tensor stride ``stride`` grouped into
    window_size³ cubes, ``shift`` voxel units added before flooring → (windows
    (W, K) int32 padded with -1, mask (W, K) bool, each voxel's cell inside
    its window (N, 3) int32)."""
    vox = coords[:, 1:] // stride + shift
    win = vox // window_size
    w_w_xyz = (vox - win * window_size).astype(np.int32)
    keys = np.concatenate([coords[:, :1], win], axis=1).astype(np.int64)
    group_of, n_groups = host_geometry.group_rows(keys)
    windows = host_geometry.pad_groups(group_of, n_groups)
    return windows, windows >= 0, w_w_xyz


def _conv_neighbor_plan(coords: np.ndarray, stride: int) -> np.ndarray:
    """(N, 27) neighbour of each voxel for a 3³ conv at ``stride``, -1
    where absent."""
    return host_geometry.conv_neighbors(coords.astype(np.int64), _CONV_OFFSETS * stride)


def _pool_groups(coords: np.ndarray, stride_in: int, factor: int = 2):
    """Coarse voxel = floor(voxel / factor) → (coarse coords (M, 4) at
    stride stride_in·factor, members (M, Kp) int32 padded with -1), coarse
    voxels in first-occurrence order."""
    vox = coords[:, 1:] // stride_in
    keys = np.concatenate([coords[:, :1], vox // factor], axis=1).astype(np.int64)
    group_of, n_groups = host_geometry.group_rows(keys)
    gidx = host_geometry.pad_groups(group_of, n_groups)
    first = gidx[:, 0].astype(np.int64)
    coarse = keys[first].copy()
    coarse[:, 1:] *= stride_in * factor
    return coarse, gidx


def _grid_coords_down(coords_f: np.ndarray, group_idx: np.ndarray) -> np.ndarray:
    """Per coarse voxel, the member whose continuous position is nearest
    the group's mean → (M,) fine indices."""
    m = group_idx.shape[0]
    xyz = coords_f[:, 1:4]
    valid = group_idx >= 0
    safe = np.where(valid, group_idx, 0)
    pts = xyz[safe]
    counts = valid.sum(1, keepdims=True).astype(np.float64)
    centers = np.where(valid[..., None], pts, 0.0).sum(1) / counts
    d = np.linalg.norm(pts - centers[:, None, :], axis=-1)
    d = np.where(valid, d, np.inf)
    return group_idx[np.arange(m), np.argmin(d, axis=1)].astype(np.int64)


def _knn(query_xyz, query_batch, support_xyz, support_batch, k: int) -> np.ndarray:
    """Per-batch brute-force kNN (nearest first; short batches repeat the
    nearest)."""
    return host_geometry.knn(query_xyz, query_batch, support_xyz, support_batch, k)


def _stage_window_plans(coords: np.ndarray, coords_f: np.ndarray, stride: int,
                        window_size: int, quant_size: int) -> Dict[str, Any]:
    """The plain and shifted window partitions of one resolution with the
    scaled cRSE signal coordinates."""
    local_xyz = coords_f[:, 1:4] / stride - coords[:, 1:4] / stride  # in [0, 1)
    colors = coords_f[:, 4:7]
    plans = {}
    for name, shift in (("win", 0), ("win_shift", window_size // 2)):
        windows, mask, w_w_xyz = _window_partition(coords, stride, window_size, shift)
        n_xyz = (w_w_xyz + local_xyz) * quant_size
        n_rgb = colors * (2 * quant_size)  # the colour quant size is 2·quant_size
        plans[name] = {
            "windows": windows,
            "mask": mask,
            "n_coords": np.concatenate([n_xyz, n_rgb], axis=1).astype(np.float32),
        }
    return plans


def build_swin3d_plans(coords: np.ndarray, coords_f: np.ndarray, *,
                       window_sizes: Sequence[int], quant_size: int, num_layers: int,
                       stem_transformer: bool = True, first_down_stride: int = 2,
                       knn_k: int = 16, up_k: int = 3) -> Dict[str, Any]:
    """Every index plan of the UNet for one batch of scenes: coords (N, 4)
    int64 unique voxels [batch, x, y, z] at stride 1, coords_f (N, 7)
    float32 [batch, x, y, z, r, g, b] continuous signal."""
    plans: Dict[str, Any] = {"stem_conv": _conv_neighbor_plan(coords, 1), "stages": []}
    stride = 1
    layer_start = 0
    fine_history: List[tuple] = []
    if not stem_transformer:
        # the stem ResBlock shares the stride-1 conv plan, then a downsample
        # comes before the first stage; the stem's resolution is the last
        # upsample's target
        fine_history.append((coords, coords_f, stride))
        coarse, gidx = _pool_groups(coords, stride, first_down_stride)
        reps = _grid_coords_down(coords_f, gidx)
        knn_idx = _knn(coords_f[reps][:, 1:4], coarse[:, 0], coords_f[:, 1:4], coords[:, 0],
                       knn_k)
        plans["pre_down"] = {"knn": knn_idx, "reps": reps}
        coords, coords_f = coarse, coords_f[reps]
        stride *= first_down_stride
        layer_start = 1

    n_stages = num_layers - layer_start
    for s in range(n_stages):
        ws = window_sizes[layer_start + s]
        stage = _stage_window_plans(coords, coords_f, stride, ws, quant_size)
        fine_history.append((coords, coords_f, stride))
        if s < n_stages - 1:
            factor = first_down_stride if (layer_start + s) == 0 else 2
            coarse, gidx = _pool_groups(coords, stride, factor)
            reps = _grid_coords_down(coords_f, gidx)
            knn_idx = _knn(coords_f[reps][:, 1:4], coarse[:, 0], coords_f[:, 1:4],
                           coords[:, 0], knn_k)
            stage["down"] = {"knn": knn_idx, "reps": reps}
            coords, coords_f = coarse, coords_f[reps]
            stride *= factor
        plans["stages"].append(stage)

    ups = []
    for s in range(len(fine_history) - 1, 0, -1):
        c_coords, c_f, _ = fine_history[s]
        f_coords, f_f, _ = fine_history[s - 1]
        idx = _knn(f_f[:, 1:4], f_coords[:, 0], c_f[:, 1:4], c_coords[:, 0], up_k)
        d = np.linalg.norm(f_f[:, None, 1:4] - c_f[idx][:, :, 1:4], axis=-1)
        w = 1.0 / (d + 1e-8)
        ups.append({"knn": idx, "weights": (w / w.sum(1, keepdims=True)).astype(np.float32)})
    plans["ups"] = ups
    return plans


def plans_to_torch(plans: Any, device) -> Any:
    """The plan tree with each array as a tensor on ``device`` (integer plans
    as int64, for indexing)."""
    if isinstance(plans, dict):
        return {k: plans_to_torch(v, device) for k, v in plans.items()}
    if isinstance(plans, (list, tuple)):
        return [plans_to_torch(v, device) for v in plans]
    arr = np.asarray(plans)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.dtype.kind in "iu":
        t = t.long()
    return t.to(device)


# ---------------------------------------------------------------------------
# Device modules


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for rows ``idx`` in range, by ``index_select``: its
    backward is an ``index_add``, where advanced indexing's sorts the
    indices and adds each row's repeats in turn (seconds on the card for a
    plan's repeated rows)."""
    return torch.index_select(x, 0, idx.reshape(-1)).reshape(*idx.shape, *x.shape[1:])


def _masked_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x by idx, zeros where idx < 0. An absent entry reads a row of
    its own position (``where`` zeroes it and its gradient), so their
    gradients' zeros spread over the rows instead of piling on row 0."""
    spread = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape) % x.shape[0]
    out = _rows(x, torch.where(idx >= 0, idx, spread))
    return torch.where((idx >= 0)[..., None], out, out.new_zeros(()))


def _crse_groups(crse: str, window_size: int, quant_size: int):
    """(name, quant grid length L, channel slice) of each signal group."""
    if "NORM" in crse:
        raise ValueError("cRSE NORM needs normals, which the plans do not carry "
                         "(the JAX module fails on it too)")
    groups = []
    if "XYZ" in crse:
        groups.append(("xyz", window_size * quant_size, slice(0, 3)))
    if "RGB" in crse:
        groups.append(("rgb", 2 * (2 * quant_size), slice(3, 6)))
    return groups


def crse_indices(plan: Dict[str, torch.Tensor], window_size: int, quant_size: int,
                 crse: str = "XYZ_RGB") -> Dict[str, torch.Tensor]:
    """Each group's table rows of every (query, key) pair of every window:
    name → (3, W, K, K) int64, ``clamp(floor((nc_q - nc_k) + L), 0, 2L - 1)``
    in fp32, the JAX module's order."""
    nc = _masked_gather(plan["n_coords"], plan["windows"])  # (W, K, 6)
    out = {}
    for name, length, sl in _crse_groups(crse, window_size, quant_size):
        axes = []
        for c in range(sl.start, sl.stop):
            rel = nc[:, :, None, c] - nc[:, None, :, c]
            axes.append(torch.floor(rel + length).clamp(0, 2 * length - 1).long())
        out[name] = torch.stack(axes)
    return out


def _pair_index(idx: torch.Tensor, h: int, transpose: bool = False) -> torch.Tensor:
    """(W, K, K) table rows → a (W, H, K, K) view over the heads (the key's
    row first with ``transpose``), for ``gather``/``scatter_add`` along the
    last axis."""
    w, k, _ = idx.shape
    return (idx.transpose(1, 2) if transpose else idx)[:, None].expand(w, h, k, k)


class _TableLogits(torch.autograd.Function):
    """``Σ_a q_i·Tq_a[idx_a,ij] + k_j·Tk_a[idx_a,ij]`` for every (i, j) of
    every window: qg, kg (W, H, K, hd), tq, tk (3, 2L, H, hd), idx (3, W,
    K, K) → (W, H, K, K). Keeps only its inputs for the backward (autograd
    would keep each axis's (W, H, K, 2L) products); the backward scatters
    the logits' gradient into those rows and multiplies back."""

    @staticmethod
    def forward(ctx, qg, kg, tq, tk, idx):
        h = qg.shape[1]
        out = None
        for a in range(3):
            term = torch.gather(torch.einsum("whid,lhd->whil", qg, tq[a]), -1,
                                _pair_index(idx[a], h))
            out = term if out is None else out.add_(term)
            # k_j · Tk[idx_ij], gathered along the key's row, then transposed
            out.add_(torch.gather(torch.einsum("whjd,lhd->whjl", kg, tk[a]), -1,
                                  _pair_index(idx[a], h, True)).transpose(-1, -2))
        ctx.save_for_backward(qg, kg, tq, tk, idx)
        return out

    @staticmethod
    def backward(ctx, grad):
        qg, kg, tq, tk, idx = ctx.saved_tensors
        w, h, k, _ = qg.shape
        dq, dk = torch.zeros_like(qg), torch.zeros_like(kg)
        dtq, dtk = torch.zeros_like(tq), torch.zeros_like(tk)
        grad_t = grad.transpose(-1, -2)
        for a in range(3):
            rows = grad.new_zeros(w, h, k, tq.shape[1])
            rows.scatter_add_(-1, _pair_index(idx[a], h), grad)
            dq += torch.einsum("whil,lhd->whid", rows, tq[a])
            dtq[a] = torch.einsum("whil,whid->lhd", rows, qg)
            rows.zero_().scatter_add_(-1, _pair_index(idx[a], h, True), grad_t)
            dk += torch.einsum("whjl,lhd->whjd", rows, tk[a])
            dtk[a] = torch.einsum("whjl,whjd->lhd", rows, kg)
        return dq, dk, dtq, dtk, None


class _TableValues(torch.autograd.Function):
    """``Σ_a Σ_j attn_ij Tv_a[idx_a,ij]`` = ``Σ_a hist_a · Tv_a`` with
    ``hist_a`` the attention weights summed by table row (``scatter_add``):
    attn (W, H, K, K), tv (3, 2L, H, hd), idx (3, W, K, K) → (W, H, K, hd).
    Keeps attn (which the value product keeps anyway) and recomputes the
    histograms in the backward."""

    @staticmethod
    def forward(ctx, attn, tv, idx):
        w, h, k, _ = attn.shape
        out = None
        for a in range(3):
            hist = attn.new_zeros(w, h, k, tv.shape[1]).scatter_add_(-1, _pair_index(idx[a], h),
                                                                      attn)
            term = torch.einsum("whil,lhd->whid", hist, tv[a])
            out = term if out is None else out.add_(term)
        ctx.save_for_backward(attn, tv, idx)
        return out

    @staticmethod
    def backward(ctx, grad):
        attn, tv, idx = ctx.saved_tensors
        w, h, k, _ = attn.shape
        dattn, dtv = torch.zeros_like(attn), torch.zeros_like(tv)
        for a in range(3):
            index = _pair_index(idx[a], h)
            dattn += torch.gather(torch.einsum("whid,lhd->whil", grad, tv[a]), -1, index)
            hist = attn.new_zeros(w, h, k, tv.shape[1]).scatter_add_(-1, index, attn)
            dtv[a] = torch.einsum("whil,whid->lhd", hist, grad)
        return dattn, dtv, None


class WindowAttentionCRSE(nn.Module):
    """W-MSA with contextual relative signal encoding."""

    def __init__(self, dim: int, window_size: int, quant_size: int, num_heads: int,
                 qkv_bias: bool = True, cRSE: str = "XYZ_RGB", device=None):
        super().__init__()
        self.dim, self.window_size, self.quant_size = dim, window_size, quant_size
        self.num_heads, self.crse = num_heads, cRSE
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.groups = _crse_groups(cRSE, window_size, quant_size)
        for name, length, _ in self.groups:
            for pname in ("query", "key", "value"):
                table = torch.empty(3, 2 * length, num_heads, head_dim, device=device)
                nn.init.trunc_normal_(table, std=0.02, a=-0.04, b=0.04)
                self.register_parameter(f"{pname}_{name}_table", nn.Parameter(table))
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, feats: torch.Tensor, plan: Dict[str, torch.Tensor],
                indices: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """feats (N, dim), plan ``windows``/``mask``/``n_coords``; ``indices``
        from ``crse_indices(plan, ...)`` where the caller shares them."""
        if indices is None:
            indices = crse_indices(plan, self.window_size, self.quant_size, self.crse)
        h = self.num_heads
        hd = self.dim // h
        windows, mask = plan["windows"], plan["mask"]
        w, k = windows.shape
        qkv = self.qkv(feats).reshape(-1, 3, h, hd)
        q = qkv[:, 0] * hd ** -0.5
        key, val = qkv[:, 1], qkv[:, 2]
        # (W, H, K, hd)
        qg, kg, vg = (_masked_gather(t.reshape(-1, h * hd), windows).reshape(w, k, h, hd)
                      .permute(0, 2, 1, 3) for t in (q, key, val))

        logits = qg @ kg.transpose(-1, -2)  # (W, H, K_q, K_k)
        for name, _, _ in self.groups:
            logits = logits + _TableLogits.apply(
                qg, kg, getattr(self, f"query_{name}_table"), getattr(self, f"key_{name}_table"),
                indices[name])
        neg = torch.finfo(logits.dtype).min
        logits = torch.where(mask[:, None, None, :], logits, logits.new_full((), neg))
        # JAX zeroes the attention of the padded query cells too; their rows
        # go to the dropped row n in the scatter below, so leaving them is
        # the same result and keeps one (W, H, K, K) tensor less
        attn = torch.softmax(logits, dim=-1)

        out = attn @ vg  # (W, H, K, hd)
        for name, _, _ in self.groups:
            out = out + _TableValues.apply(attn, getattr(self, f"value_{name}_table"),
                                           indices[name])
        out = out.permute(0, 2, 1, 3).reshape(w * k, self.dim)

        # back to the voxels: each voxel sits in exactly one window cell
        n = feats.shape[0]
        flat_idx = torch.where(mask, windows, n).reshape(-1)
        scattered = out.new_zeros(n + 1, self.dim).index_put((flat_idx,), out)[:n]
        return self.proj(scattered)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock3D(nn.Module):
    """norm → W-MSA → residual; norm → MLP (exact gelu) → residual.
    Stochastic depth is left out, as in JAX."""

    def __init__(self, dim: int, num_heads: int, window_size: int, quant_size: int,
                 mlp_ratio: float = 4.0, cRSE: str = "XYZ_RGB", device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = WindowAttentionCRSE(dim, window_size, quant_size, num_heads, cRSE=cRSE,
                                        device=device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), device)

    def forward(self, feats, plan, indices=None):
        feats = feats + self.attn(self.norm1(feats), plan, indices)
        return feats + self.mlp(self.norm2(feats))


class GridKNNDownsample(nn.Module):
    """Max over each coarse voxel's k nearest fine voxels of LayerNorm →
    bias-free Linear."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(in_channels, eps=LN_EPS, device=device)
        self.linear = nn.Linear(in_channels, out_channels, bias=False, device=device)

    def forward(self, feats, knn_idx):
        return self.linear(self.norm(_rows(feats, knn_idx))).amax(dim=1)


class Upsample3D(nn.Module):
    """linear1(LN(skip)) + the inverse-distance kNN interpolation of
    linear2(LN(coarse)); with ``attn``, a Swin block over the skip's
    windows after."""

    def __init__(self, coarse_channels: int, skip_channels: int, out_channels: int,
                 num_heads: int = 0, window_size: int = 0, quant_size: int = 1,
                 attn: bool = False, cRSE: str = "XYZ_RGB", device=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(skip_channels, eps=LN_EPS, device=device)
        self.linear1 = nn.Linear(skip_channels, out_channels, device=device)
        self.ln2 = nn.LayerNorm(coarse_channels, eps=LN_EPS, device=device)
        self.linear2 = nn.Linear(coarse_channels, out_channels, device=device)
        self.block = (SwinTransformerBlock3D(out_channels, num_heads, window_size, quant_size,
                                             cRSE=cRSE, device=device) if attn else None)

    def forward(self, coarse_feats, skip_feats, up_plan, win_plan=None, indices=None):
        a = self.linear1(self.ln1(skip_feats))
        b = self.linear2(self.ln2(coarse_feats))
        feats = a + (_rows(b, up_plan["knn"]) * up_plan["weights"][..., None]).sum(dim=1)
        if self.block is not None and win_plan is not None:
            feats = self.block(feats, win_plan, indices)
        return feats


class SparseConvBNRelu(nn.Module):
    """3³ submanifold convolution (a neighbour-plan gather and a product
    with the (27, Cin, Cout) taps) + BatchNorm (momentum 0.98) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, relu: bool = True, device=None):
        super().__init__()
        weight = torch.empty(27, in_channels, out_channels, device=device)
        nn.init.normal_(weight, std=(2.0 / (27 * in_channels)) ** 0.5)
        self.weight = nn.Parameter(weight)
        self.bn = BatchNorm(out_channels, eps=1e-5, device=device, momentum=0.98)
        self.relu = relu

    def forward(self, feats, neighbor_idx, train: bool = False):
        g = _masked_gather(feats, neighbor_idx)  # (N, 27, Cin)
        out = g.reshape(g.shape[0], -1) @ self.weight.reshape(-1, self.weight.shape[-1])
        out = self.bn(out, batch_stats=train)
        return F.relu(out) if self.relu else out


class SparseResBlock(nn.Module):
    """conv-bn-relu, conv-bn, + input, relu."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv1 = SparseConvBNRelu(channels, channels, device=device)
        self.conv2 = SparseConvBNRelu(channels, channels, relu=False, device=device)

    def forward(self, feats, neighbor_idx, train: bool = False):
        h = self.conv1(feats, neighbor_idx, train)
        h = self.conv2(h, neighbor_idx, train)
        return F.relu(feats + h)


class BasicLayer3D(nn.Module):
    """One resolution: ``depth`` blocks over the plain and the shifted
    windows in turn, then the kNN downsample unless it is the last."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 quant_size: int, out_channels: Optional[int] = None, cRSE: str = "XYZ_RGB",
                 device=None):
        super().__init__()
        self.window_size, self.quant_size, self.crse = window_size, quant_size, cRSE
        self.blocks = nn.ModuleList(
            SwinTransformerBlock3D(dim, num_heads, window_size, quant_size, cRSE=cRSE,
                                   device=device) for _ in range(depth))
        self.downsample = (GridKNNDownsample(dim, out_channels, device)
                           if out_channels is not None else None)

    def forward(self, feats, stage_plan):
        plans = [stage_plan["win"], stage_plan["win_shift"]]
        indices = [crse_indices(p, self.window_size, self.quant_size, self.crse)
                   for p in plans[:len(self.blocks)]]
        for i, block in enumerate(self.blocks):
            feats = block(feats, plans[i % 2], indices[i % 2])
        if self.downsample is not None and "down" in stage_plan:
            return feats, self.downsample(feats, stage_plan["down"]["knn"])
        return feats, feats


class Swin3DUNet(nn.Module):
    """Encoder-decoder over the voxel stages, then a classifier (Linear →
    BatchNorm (momentum 0.99) → ReLU → Linear). → (features of the finest
    stage (N, channels[0]), logits (N, num_classes))."""

    def __init__(self, depths: Sequence[int], channels: Sequence[int],
                 num_heads: Sequence[int], window_sizes: Sequence[int], quant_size: int,
                 num_layers: int = 4, num_classes: int = 13, stem_transformer: bool = True,
                 up_k: int = 3, up_attn: bool = False, cRSE: str = "XYZ_RGB",
                 in_channels: int = 6, device=None):
        super().__init__()
        if up_attn and not stem_transformer:
            raise ValueError("up_attn with a conv stem is not supported")
        self.num_layers, self.stem_transformer, self.up_attn = num_layers, stem_transformer, up_attn
        self.window_sizes, self.quant_size, self.crse = tuple(window_sizes), quant_size, cRSE
        c = list(channels)
        self.stem = SparseConvBNRelu(in_channels, c[0], device=device)
        layer_start = 0
        if not stem_transformer:
            self.stem_res = SparseResBlock(c[0], device)
            self.pre_down = GridKNNDownsample(c[0], c[1], device)
            layer_start = 1
        self.layers = nn.ModuleList()
        for s in range(num_layers - layer_start):
            i = layer_start + s
            last = i == num_layers - 1
            self.layers.append(BasicLayer3D(
                c[i], depths[i], num_heads[i], window_sizes[i], quant_size,
                out_channels=None if last else c[i + 1], cRSE=cRSE, device=device))
        self.upsamples = nn.ModuleList()
        for u in range(num_layers - 1):
            i = num_layers - 1 - u
            self.upsamples.append(Upsample3D(
                c[i], c[i - 1], c[i - 1], num_heads=num_heads[i - 1],
                window_size=window_sizes[i - 1], quant_size=quant_size, attn=up_attn,
                cRSE=cRSE, device=device))
        self.cls_fc1 = nn.Linear(c[0], c[0], device=device)
        self.cls_bn = BatchNorm(c[0], eps=1e-5, device=device, momentum=0.99)
        self.cls_fc2 = nn.Linear(c[0], num_classes, device=device)

    def forward(self, feats: torch.Tensor, plans: Dict[str, Any],
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.stem(feats, plans["stem_conv"], train)
        skips = []
        if not self.stem_transformer:
            feats = self.stem_res(feats, plans["stem_conv"], train)
            skips.append(feats)
            feats = self.pre_down(feats, plans["pre_down"]["knn"])
        for s, layer in enumerate(self.layers):
            kept, feats = layer(feats, plans["stages"][s])
            skips.append(kept)

        feats = skips.pop()
        for u, up_plan in enumerate(plans["ups"]):
            skip = skips.pop()
            win_plan, indices = None, None
            if self.up_attn:
                i = self.num_layers - 1 - u
                win_plan = plans["stages"][len(skips)]["win"]
                indices = crse_indices(win_plan, self.window_sizes[i - 1], self.quant_size,
                                       self.crse)
            feats = self.upsamples[u](feats, skip, up_plan, win_plan, indices)

        h = F.relu(self.cls_bn(self.cls_fc1(feats), batch_stats=train))
        return feats, self.cls_fc2(h)


class PCDSwin3DEncoder(nn.Module):
    """The registry's encoder: packed points → voxel dedup (the first point
    of each voxel kept) → plans → UNet. ``prepare`` is the host half,
    ``forward`` the whole: feats (N, 3) colours in [-1, 1], xyz (N, 4) [x,
    y, z, batch] in voxel units (the integer part is the voxel, the rest
    the offset inside it) → (per-voxel features (M, channels[0]), logits
    (M, num_classes), keep (M,) indices of the kept points). Built on the
    GPU unless ``device`` says otherwise."""

    def __init__(self, depths: Sequence[int], channels: Sequence[int],
                 num_heads: Sequence[int], window_sizes: Sequence[int], up_k: int = 3,
                 quant_size: int = 4, num_layers: int = 4, num_classes: int = 13,
                 stem_transformer: bool = True, upsample: str = "deconv",
                 down_stride: int = 2, signal: bool = True, in_channels: int = 6,
                 use_offset: bool = False, cRSE: str = "XYZ_RGB", device=None, **_: Any):
        super().__init__()
        device = resolve_device(device)
        # taken as JAX's encoder takes it and read nowhere: the stem takes
        # the 6 channels ``prepare`` assembles (colours and xyz)
        del in_channels
        self.signal, self.use_offset = signal, use_offset
        self.unet = Swin3DUNet(
            depths=tuple(depths), channels=tuple(channels), num_heads=tuple(num_heads),
            window_sizes=tuple(window_sizes), quant_size=quant_size, num_layers=num_layers,
            num_classes=num_classes, stem_transformer=stem_transformer, up_k=up_k,
            up_attn="attn" in upsample, cRSE=cRSE, in_channels=6, device=device)
        self._cfg = dict(window_sizes=tuple(window_sizes), quant_size=quant_size,
                         num_layers=num_layers, stem_transformer=stem_transformer,
                         first_down_stride=down_stride, up_k=up_k)

    @property
    def device(self) -> torch.device:
        return self.unet.cls_fc1.weight.device

    def prepare(self, feats: np.ndarray, xyz: np.ndarray):
        """Host preprocessing → (signal features (M, 6), numpy plans, keep)."""
        feats = np.asarray(feats, np.float32)
        xyz = np.asarray(xyz, np.float32)
        coords = np.concatenate([xyz[:, -1:], xyz[:, :3]], axis=1)  # (N, 4) b, x, y, z
        full = np.concatenate([feats, xyz[:, :3]], axis=1)  # (N, 6)
        if self.use_offset:
            full[:, -3:] = xyz[:, :3] - np.floor(xyz[:, :3])
        coords_int = np.floor(coords).astype(np.int64)
        _, _, out_map = voxelization_idx(coords_int, int(coords_int[:, 0].max()) + 1, mode=1)
        keep = out_map[:, 1].astype(np.int64)  # the first point of each voxel
        coords_int, full, coords = coords_int[keep], full[keep], coords[keep]
        colors = full[:, 0:3] / 1.001
        coords_f = np.concatenate([coords, colors], axis=1).astype(np.float32)  # (M, 7)
        sig = full if self.signal else np.ones_like(full)
        plans = build_swin3d_plans(coords_int, coords_f, **self._cfg)
        return sig, plans, keep

    def forward(self, feats: np.ndarray, xyz: np.ndarray, train: bool = False):
        sig, plans, keep = self.prepare(feats, xyz)
        dev = self.device
        out, logits = self.unet(torch.from_numpy(sig).to(dev), plans_to_torch(plans, dev),
                                train=train)
        return out, logits, keep
