"""PointNet++ set-abstraction encoder, channels-last.

Counterpart of ``msr3d_tpu/nn/pointnet.py``: FPS (kernel K1) → gather →
ball query → group → shared MLP (per-point Linear + BatchNorm + ReLU) →
max-pool per group, three stages, then flatten + fc, and the semantic head
on request. BatchNorm reads its running statistics, except in an unfrozen
encoder in ``train()`` mode (batch statistics, flax's training BatchNorm).
The MLPs run in ``compute_dtype`` (bfloat16 in the flagship config); FPS
and ball-query geometry stay fp32 so the sampled indices do not depend on
it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.nn.layers import MLPHead
from msr3d_tpu_torch.ops.pointnet2 import fps, gather_points, group_all, query_and_group


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the trailing channel axis, in fp32:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast back to the
    input's dtype.

    By default (the encoder frozen, or in ``eval()``) mean and var are the
    running statistics. With ``batch_stats`` they are the batch's, over every
    axis but the channel axis (padded objects included): ``mean = E[x]`` and
    flax's biased ``var = max(0, E[x²] - E[x]²)``, not torch's unbiased
    running variance; the running statistics then move in place to ``0.9 ·
    running + 0.1 · batch``, what ``apply(..., mutable=["batch_stats"])``
    returns in the JAX package."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        if batch_stats:
            x32 = x.float().reshape(-1, x.shape[-1])
            mean = x32.mean(dim=0)
            var = torch.clamp_min(x32.square().mean(dim=0) - mean.square(), 0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(x.dtype)


class SharedMLP(nn.Module):
    """Per-point Linear (no bias) + BatchNorm + ReLU stack on the trailing
    channel dim, in ``dtype``."""

    def __init__(self, in_channels: int, widths: Sequence[int], dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        dims = [in_channels, *widths]
        self.dense = nn.ModuleList(
            nn.Linear(a, b, bias=False, device=device) for a, b in zip(dims[:-1], dims[1:])
        )
        self.bn = nn.ModuleList(BatchNorm(w, device=device) for w in widths)

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        for dense, bn in zip(self.dense, self.bn):
            x = F.relu(bn(F.linear(x, dense.weight.to(self.dtype)), batch_stats))
        return x


class PointnetSAModule(nn.Module):
    """One single-scale set-abstraction stage; ``npoint=None`` groups all."""

    def __init__(self, npoint: Optional[int], nsample: Optional[int],
                 radius: Optional[float], in_channels: int, mlp: Sequence[int],
                 dtype=torch.float32, device=None):
        super().__init__()
        self.npoint, self.nsample, self.radius = npoint, nsample, radius
        self.mlp = SharedMLP(in_channels, mlp, dtype, device)

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor], batch_stats: bool = False
    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        if self.npoint is not None:
            new_xyz = gather_points(xyz, fps(xyz, self.npoint))
            grouped = query_and_group(xyz, new_xyz, features, self.radius, self.nsample)
        else:
            new_xyz = None
            grouped = group_all(xyz, features)
        return new_xyz, self.mlp(grouped, batch_stats).amax(dim=2)


class PointNetPP(nn.Module):
    """Stacked SA stages + flatten + fc: (B, P, 3 + C) → (B, sa_mlps[-1][-1])."""

    def __init__(self, sa_n_points, sa_n_samples, sa_radii, sa_mlps, in_features: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        stages = []
        feat = in_features
        for npoint, nsample, radius, widths in zip(sa_n_points, sa_n_samples, sa_radii, sa_mlps):
            # use_xyz: each stage's input is center-relative xyz ‖ features
            stages.append(PointnetSAModule(npoint, nsample, radius, 3 + feat,
                                           list(widths[1:]), dtype, device))
            feat = widths[-1]
        self.sa = nn.ModuleList(stages)
        self.fc = nn.Linear(feat, sa_mlps[-1][-1], device=device)

    def forward(self, pc: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        xyz = pc[..., :3]
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        for stage in self.sa:
            xyz, features = stage(xyz, features, batch_stats)
        # fc runs in fp32 on the upcast features, as flax promotes bf16 × fp32
        return self.fc(features.reshape(features.shape[0], -1).float())


class PcdObjEncoder(nn.Module):
    """Object-centric point-cloud encoder: (B, O, P, 6) → (B, O, D).

    ``freeze`` (the flagship's) runs it without autograd, the counterpart of
    the JAX module's ``stop_gradient``, and BatchNorm always reads its
    running statistics. Unfrozen, in ``train()`` mode, BatchNorm normalises
    by batch statistics and updates its running ones (JAX's
    ``use_running_average = freeze or deterministic``); in ``eval()`` it
    reads the running ones and gradients flow. The semantic-class head ``sem_head`` (607 classes) runs only
    when asked (``return_sem=True``): every path of the package discards its
    output."""

    def __init__(self, sa_n_points=(32, 16, None), sa_n_samples=(32, 32, None),
                 sa_radii=(0.2, 0.4, None),
                 sa_mlps=((3, 64, 64, 128), (128, 128, 128, 256), (256, 256, 512, 768)),
                 compute_dtype=torch.float32, freeze: bool = True, device=None):
        super().__init__()
        self.freeze = freeze
        self.pcd_net = PointNetPP(sa_n_points, sa_n_samples, sa_radii, sa_mlps,
                                  in_features=sa_mlps[0][0], dtype=compute_dtype,
                                  device=device)
        self.sem_head = MLPHead(sa_mlps[-1][-1], 384, 607, dropout=0.3, device=device)

    def forward(self, obj_pcds: torch.Tensor, return_sem: bool = False,
                generator: Optional[torch.Generator] = None):
        b, o, p, d = obj_pcds.shape
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze):
            embeds = self.pcd_net(obj_pcds.reshape(b * o, p, d),
                                  batch_stats=self.training and not self.freeze)
        embeds = embeds.reshape(b, o, -1)
        if not return_sem:
            return embeds
        return embeds, self.sem_head(embeds, generator)
