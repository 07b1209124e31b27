"""Furthest-point sampling: kernel K1 and its plain PyTorch version.

Replaces ``msr3d_tpu/ops/pallas/fps.py::_fps_kernel`` (wrapper
``furthest_point_sample_pallas``) with ``csrc/fps.cu``. The kernel is
bound by its npoint - 1 dependent rounds, not by bytes or arithmetic. It
is sized to N and B (one warp a cloud and several clouds a block for
N <= 64; above, 8, 4 or 2 warps a cloud, fewer as the batch grows), keeps the cloud in shared memory and the
points and running distances in registers, and reduces one 32-bit key a
point with ``redux.sync``, with at most one barrier a round (see the
source for the design). It is bit-identical to
:func:`furthest_point_sample_reference`, the loop of
``msr3d_tpu/ops/pointnet2.py:42-64`` batched.
"""

from __future__ import annotations

import ctypes

import torch

from msr3d_tpu_torch.ops._build import CudaKernel

_FPS_PAD_EPS = 1e-3
MAX_POINTS = 4096

FPS_KERNEL = CudaKernel(
    "fps", "fps_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)


def furthest_point_sample_reference(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) → (B, npoint) int32. Seed index 0; points with
    ‖p‖² ≤ 1e-3 are padding and never picked; each round takes the first
    index of the largest running min squared distance."""
    xyz = xyz.float()
    b, n, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    valid = (x * x + y * y + z * z) > _FPS_PAD_EPS
    min_d2 = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    neg_inf = torch.tensor(float("-inf"), device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    idxs = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        lx, ly, lz = xyz[rows, last].unbind(-1)
        d2 = (x - lx[:, None]) ** 2 + (y - ly[:, None]) ** 2 + (z - lz[:, None]) ** 2
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.where(valid, min_d2, neg_inf).argmax(dim=1)
        idxs[:, j] = last.to(torch.int32)
    return idxs


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Batched FPS, (B, N, 3) fp32 → (B, npoint) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches K1 or
    raises."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_reference(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: unsupported device {xyz.device}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"furthest_point_sample: xyz must be float32, got {xyz.dtype}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample: xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("furthest_point_sample: xyz must be contiguous")
    b, n, _ = xyz.shape
    if not 0 < n <= MAX_POINTS:
        raise ValueError(f"furthest_point_sample: N={n} outside 1..{MAX_POINTS}")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0 or npoint == 0:
        return out
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    with torch.cuda.device(xyz.device):
        FPS_KERNEL(xyz.data_ptr(), out.data_ptr(), b, n, npoint, stream)
    return out
