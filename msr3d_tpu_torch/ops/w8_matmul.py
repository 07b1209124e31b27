"""int8 weight-only matrix product: kernel K3 and its plain PyTorch version,
and the launch plumbing that K3 and K4 share.

Replaces ``msr3d_tpu/ops/pallas/w8_matmul.py::_kernel`` (wrapper
``matmul_w8``) with ``csrc/w8_matmul.cu`` (the int8 instance of
``csrc/wq_matmul.cuh``)::

    y[b, n] = bf16((Σ_k bf16(x)[b, k] · wq[k, n]) · scale[n]),  fp32 accumulator

The scale goes on the fp32 sum, once. That is not ``LoraDense``'s int8
order, which rounds ``bf16(wq) · bf16(scale)`` to bf16 before the product:
the JAX package never calls its kernel from the serving path, and neither
does the port (``models/llm/llama.py`` computes ``LoraDense`` as JAX does).
The TPU kernel's 128-aligned blocks and its row padding are TPU tiling; the
CUDA kernel takes any shape.

The kernel runs its products on the tensor cores (``mma.sync`` over the
weight converted to bf16 in registers), streams the weight through a
``cp.async`` ring and splits K across blocks; the splits' fp32 partial sums
go to a workspace allocated here, and the last block of each column tile
adds them in split order (a counter a tile, :func:`split_counters`), so two
calls give the same bits. :func:`plan_w8` picks the split, the column tile
and the ring's stages for a shape (from ``scripts/w8_variants.py``'s
measurements, ``PERF.md``); :func:`matmul_w8_config` launches any of them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from msr3d_tpu_torch.ops._build import CudaKernel

W8_MATMUL_KERNEL = CudaKernel(
    "w8_matmul", "w8_matmul_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

SMS = 132  # streaming multiprocessors of an H100 SXM
ROW_TILE = 16  # rows of x a block (one m16 tile)
STAGE_BYTES = 8192  # weight bytes a stage of the ring: k rows = STAGE_BYTES // tile
TILES = (32, 64, 128)
STAGES = (2, 3, 4)
MAX_SPLIT = 16


def plan_w8(b: int, k: int, n: int) -> Tuple[int, int, int]:
    """(split, column tile, stages) for x (b, k) and wq (k, n): K split so
    that the grid has about two blocks an SM (each split with at least two
    k tiles), with 64-column tiles and a 3-stage ring or 128-column tiles
    and a 4-stage ring, whichever comes nearer. On an H100 that is the
    fastest instance, or within 1 % of it, at each 7B shape at B 4 and 16
    (``scripts/w8_variants.py``, PERF.md)."""
    target, best = 2 * SMS, None
    for tile, stages in ((64, 3), (128, 4)):
        blocks = -(-n // tile) * -(-b // ROW_TILE)
        k_tiles = -(-k // (STAGE_BYTES // tile))
        split = max(1, min(MAX_SPLIT, round(target / blocks), k_tiles // 2))
        miss = abs(blocks * split - target)
        if best is None or miss < best[0]:
            best = (miss, split, tile, stages)
    return best[1:]


def check_shapes(x: torch.Tensor, kdim2: int, n: int, scale: torch.Tensor, what: str) -> None:
    """The TPU wrappers' shape errors (``ValueError``) for a weight whose
    contraction side covers ``kdim2`` inputs and whose outputs are ``n``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (B, K), got shape {tuple(x.shape)}")
    if x.shape[1] != kdim2:
        raise ValueError(f"x K dim {x.shape[1]} != {what} {kdim2}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({n},)")


def dequant_operands(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, fn: str):
    """K3's or K4's operands on the card, checked: (bf16 x, fp32 scale, the
    empty bf16 output); raises on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if wq.device != x.device or scale.device != x.device:
        raise ValueError(f"{fn}: x, wq and scale must lie on one device")
    if wq.dtype != torch.int8:
        raise TypeError(f"{fn}: wq must be int8, got {wq.dtype}")
    if not wq.is_contiguous():
        raise ValueError(f"{fn}: wq must be contiguous")
    y = torch.empty((x.shape[0], wq.shape[1]), dtype=torch.bfloat16, device=x.device)
    return x.to(torch.bfloat16).contiguous(), scale.to(torch.float32).contiguous(), y


def matmul_w8_reference(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math in fp32: bf16(x) · wq (exact products, fp32
    sums), times ``scale`` on the sum, rounded to bf16."""
    acc = x.to(torch.bfloat16).float() @ wq.float()
    return (acc * scale.float()).to(torch.bfloat16)


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def split_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """The int32 counters a split launch of K3 or K4 needs, one a column and
    row tile: zero when made, and the kernel sets each back to zero when its
    tile's last split has added the partials, so one buffer a device serves
    every launch of both kernels (launches of one stream run one after
    another)."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < tiles:
        buf = _COUNTERS[device] = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
    return buf


def launch_instance(kernel: CudaKernel, fn: str, x: torch.Tensor, wq: torch.Tensor,
                    scale: torch.Tensor, split: int, tile: int, stages: int) -> torch.Tensor:
    """K3 or K4 (``kernel``, wrapper name ``fn``) on CUDA tensors with K split
    ``split`` ways, ``tile`` output columns a block and a ring of ``stages``;
    raises on what it does not take. The split's counters are
    :func:`split_counters`' buffer, which both kernels share."""
    if not (1 <= split <= MAX_SPLIT and tile in TILES and stages in STAGES):
        raise ValueError(f"{fn}: no instance for split {split}, tile {tile}, stages {stages}")
    xb, s, y = dequant_operands(x, wq, scale, fn)
    (b, k), n = xb.shape, y.shape[1]
    if b == 0 or n == 0:
        return y
    ws = cnt = None  # the tensors stay referenced until the launch is queued
    if split > 1:
        ws = torch.empty(split * b * n, dtype=torch.float32, device=x.device)
        cnt = split_counters(x.device, -(-n // tile) * -(-b // ROW_TILE))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        kernel(xb.data_ptr(), wq.data_ptr(), s.data_ptr(), y.data_ptr(),
               ws.data_ptr() if split > 1 else None, cnt.data_ptr() if split > 1 else None,
               b, k, n, split, tile, stages, stream)
    return y


def matmul_w8_config(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, split: int,
                     tile: int, stages: int) -> torch.Tensor:
    """K3 on CUDA tensors with K split ``split`` ways, ``tile`` output
    columns a block and a ring of ``stages``; raises on what it does not
    take."""
    return launch_instance(W8_MATMUL_KERNEL, "matmul_w8", x, wq, scale, split, tile, stages)


def matmul_w8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) bf16/fp32, wq (K, N) int8, scale (N,) per output channel →
    (B, N) bf16. A CPU tensor takes the plain version; a CUDA tensor
    launches K3 (at :func:`plan_w8`'s instance) or raises."""
    check_shapes(x, wq.shape[0], wq.shape[1], scale, "wq K dim")
    if x.device.type == "cpu":
        return matmul_w8_reference(x, wq, scale)
    return matmul_w8_config(x, wq, scale, *plan_w8(x.shape[0], x.shape[1], wq.shape[1]))
