"""A plain-PyTorch model of the reduction of the CUDA kernel K1
(``msr3d_tpu_torch/csrc/fps.cu``), for the CPU tests. It imports no JAX, so
``tests/test_torch_kernels.py`` can use it on the GPU host too.

The kernel gives a cloud W warps of 32 lanes; lane t of the cloud (t = 32 ·
warp + lane) holds the points i = t + 32·W·k for k < P, with 32·W·P ≥ N,
and a slot past N is padding at the origin. Each point keeps its running
min squared distance md (from 1e10, a padding point at -1 for good), and
its key is md's bit pattern read as an int32: non-negative for a valid
point, negative for padding. A round takes, in order: each lane's largest
key and the first of its points that holds it; the warp's largest key
(``__reduce_max_sync``) and the smallest index among its lanes that hold it
(``__reduce_min_sync``); and the same two over the cloud's W warps, read
from shared slots. The winner is the next round's last pick.
"""

import numpy as np
import torch

_PAD_EPS = 1e-3
_FAR = 1e10
_PAD_MIN = -1.0
_NO_INDEX = np.iinfo(np.int64).max  # above every index, like the kernel's 0xffffffff
MAX_PER_LANE = 32


def launch_shape(n: int, warps: int):
    """(W, P) as ``fps_launch_config`` takes them: W raised (to at most 8)
    while a lane would hold more than 32 points, then P the least power of
    two with 32·W·P ≥ N."""
    while warps < 8 and -(-n // (32 * warps)) > MAX_PER_LANE:
        warps *= 2
    p = 1
    while 32 * warps * p < n:
        p *= 2
    return warps, p


def tie_clouds(seed: int, n: int) -> np.ndarray:
    """Seven (n, 3) fp32 clouds from ``seed`` that make the reduction's ties
    and padding rules bite:
    0. points on a lattice of step 0.25 (exact squares, so many equal
       distances across lanes and warps; the origin is padding);
    1. every point a copy of one of two lattice positions: after two rounds
       every valid point is at distance 0 and the first of them wins;
    2. all padding (all zeros): every pick is index 0;
    3. lattice points with every third scaled into the padding radius;
    4. the lattice with its second half zeros (trailing padding);
    5. normal points, scale 0.5;
    6. normal directions at |p|^2 within 1e-3 of the padding threshold on
       both sides."""
    r = np.random.default_rng(seed)
    lattice = (r.integers(-3, 4, size=(n, 3)) * 0.25).astype(np.float32)
    clouds = np.zeros((7, n, 3), dtype=np.float32)
    clouds[0] = lattice
    pair = np.array([[0.5, -0.25, 0.75], [-1.0, 0.5, 0.25]], dtype=np.float32)
    clouds[1] = pair[r.integers(0, 2, size=n)]
    clouds[3] = lattice
    clouds[3, ::3] *= 1e-3
    clouds[4, : (n + 1) // 2] = lattice[: (n + 1) // 2]
    clouds[5] = r.normal(size=(n, 3)) * 0.5
    direction = r.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    radius = np.sqrt(1e-3 * (1.0 + r.uniform(-1e-3, 1e-3, size=(n, 1))))
    clouds[6] = direction * radius
    return clouds


def _arg_max_then_min(keys, idx, dim):
    """The largest key along ``dim`` and the smallest index holding it."""
    best = keys.amax(dim=dim, keepdim=True)
    held = torch.where(keys == best, idx, torch.full_like(idx, _NO_INDEX))
    return best.squeeze(dim), held.amin(dim=dim)


def kernel_model_fps(xyz: torch.Tensor, npoint: int, warps: int) -> torch.Tensor:
    """(B, N, 3) fp32 → (B, npoint) int32, as K1 computes it with ``warps``
    warps a cloud."""
    b, n, _ = xyz.shape
    warps, p = launch_shape(n, warps)
    slots = 32 * warps * p
    pts = torch.zeros((b, slots, 3), dtype=torch.float32)
    pts[:, :n] = xyz.float()
    x, y, z = pts.unbind(-1)
    valid = (x * x + y * y + z * z) > _PAD_EPS
    valid[:, n:] = False
    md = torch.where(valid, torch.tensor(_FAR), torch.tensor(_PAD_MIN))
    # slot s = t + 32·W·k lies at [k, warp, lane] once viewed as (P, W, 32)
    index = torch.arange(slots, dtype=torch.int64).view(p, warps, 32).expand(b, -1, -1, -1)
    rows = torch.arange(b)
    out = torch.zeros((b, npoint), dtype=torch.int32)
    last = torch.zeros(b, dtype=torch.int64)
    for j in range(1, npoint):
        lx, ly, lz = pts[rows, last].unbind(-1)
        dx, dy, dz = x - lx[:, None], y - ly[:, None], z - lz[:, None]
        d = (dx * dx + dy * dy) + dz * dz  # each product and sum rounded on its own
        md = torch.fmin(md, d)
        keys = md.view(torch.int32).to(torch.int64).view(b, p, warps, 32)
        # a lane: its largest key, the first k (smallest index) holding it
        lane_key, lane_idx = _arg_max_then_min(keys, index, dim=1)  # (B, W, 32)
        warp_key, warp_idx = _arg_max_then_min(lane_key, lane_idx, dim=2)  # (B, W)
        _, last = _arg_max_then_min(warp_key, warp_idx, dim=1)  # (B,)
        out[:, j] = last.to(torch.int32)
    return out
