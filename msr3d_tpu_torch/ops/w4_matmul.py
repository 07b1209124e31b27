"""int4 weight-only matrix product: kernel K4, its plain PyTorch version and
the kernel's packing.

Replaces ``msr3d_tpu/ops/pallas/w4_matmul.py::_kernel`` (wrapper
``matmul_w4``) with ``csrc/w4_matmul.cu`` (the int4 instance of
``csrc/wq_matmul.cuh``, the design K3 runs on too).

Packing (``pack_w4``): ``wq`` is int8 (K/2, N); the byte at packed row r
holds input row r in its low nibble, biased by +8, and input row r + K/2 in
its high nibble, two's complement::

    byte = (hi << 4) | (lo + 8)

That is not ``LoraDense``'s int4 layout, whose low nibble is two's
complement too (``models/llm/convert.py::pack_int4``);
:func:`repack_from_splitnibble` converts, and K4 must be fed only through
it.

The plain version follows the TPU kernel's biased formula,
``y = ((x_lo · lo_u + x_hi · hi) − 8 · rowsum(x_lo)) · scale`` with
``lo_u = lo + 8`` and fp32 sums; the CUDA kernel converts each nibble to its
signed value instead, so the two sum different terms: besides the order
of the fp32 sums, they differ by the rounding of the biased sum before the
−8 · rowsum cancels. The TPU kernel's three ``unpack`` modes give identical
results and are not ported; there is one kernel.

The kernel runs its products on the tensor cores (``mma.sync``, two a packed
k16 step: the low nibbles against x's first half, the high ones against its
second), streams the weight and both halves of x through warp-private
``cp.async`` rings and splits the packed rows across blocks, the partials
added in split order by the last block of each column tile (the counters are
:func:`~msr3d_tpu_torch.ops.w8_matmul.split_counters`' buffer, shared with
K3: launches of one stream run one after another), so two calls give the
same bits. :func:`plan_w4` picks the instance for a shape (from
``scripts/w4_variants.py``'s measurements, ``PERF.md``);
:func:`matmul_w4_config` launches any of them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from msr3d_tpu_torch.ops._build import CudaKernel
from msr3d_tpu_torch.ops.w8_matmul import (
    MAX_SPLIT,
    ROW_TILE,
    SMS,
    STAGE_BYTES,
    check_shapes,
    launch_instance,
)

W4_MATMUL_KERNEL = CudaKernel(
    "w4_matmul", "w4_matmul_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
W4_STAGE_BYTES = 2 * STAGE_BYTES  # weight bytes a block stage: twice K3's
# What K4's instances cost on an H100, fitted to scripts/w4_variants.py's
# times (PERF.md): the cp.async copies move about 2.1 TB/s over the card and
# 15 GB/s a block; x's two slices (4 bytes a row of x a packed row, from L2)
# cost a quarter of the weight's bytes (from HBM); a split adds 0.4 us
COPY_BYTES_PER_US, BLOCK_BYTES_PER_US, X_SHARE, SPLIT_US = 2.1e6, 1.5e4, 0.25, 0.4


def _to_int8_bytes(byte: torch.Tensor) -> torch.Tensor:
    """Integer values 0..255 → the int8 tensor with those bytes."""
    return byte.to(torch.uint8).view(torch.int8)


def pack_w4(w4: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued [-8, 7] → (K/2, N) int8 in the kernel layout
    (hi = rows [K/2, K) two's complement, lo = rows [0, K/2) biased +8)."""
    k = w4.shape[0]
    if k % 2:
        raise ValueError(f"pack_w4: K must be even, got {k}")
    w = w4.to(torch.int16)
    if w.numel() and (w.min() < -8 or w.max() > 7):
        raise ValueError("pack_w4: values outside int4 range")
    lo, hi = w[: k // 2] + 8, w[k // 2:]
    return _to_int8_bytes(((hi & 0xF) << 4) | lo)


def repack_from_splitnibble(packed_tc: torch.Tensor) -> torch.Tensor:
    """``LoraDense``'s int4 layout (both nibbles two's complement) → this
    kernel's layout (lo biased +8). Runs on the tensor's device."""
    b = packed_tc.view(torch.uint8).to(torch.int16)
    lo = b & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)  # sign-extend
    hi = b >> 4
    hi = torch.where(hi >= 8, hi - 16, hi)
    return _to_int8_bytes(((hi & 0xF) << 4) | (lo + 8))


def matmul_w4_reference(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math in fp32: the byte s read signed, hi = s >> 4,
    lo_u = s − 16·hi ∈ [0, 15]; fp32 sums of the exact products; the +8 bias
    folded out as −8 · rowsum(x_lo); ``scale`` on the sum; bf16 out."""
    half = wq.shape[0]
    xb = x.to(torch.bfloat16).float()
    s16 = wq.to(torch.int16)
    hi = s16 >> 4
    lo_u = s16 - 16 * hi
    acc = xb[:, :half] @ lo_u.float() + xb[:, half:] @ hi.float()
    rs = xb[:, :half].sum(dim=1, keepdim=True)
    return ((acc - 8.0 * rs) * scale.float()).to(torch.bfloat16)


def plan_w4(b: int, k: int, n: int) -> Tuple[int, int, int]:
    """(split, column tile, stages) for x (b, k) and wq (k/2, n): the split and
    tile (64 or 128 columns) whose estimated time is least, with a 2-stage
    ring. A block copies its packed rows' weight and both slices of x; the
    estimate is the larger of all blocks' bytes at the card's copy rate and
    a block's bytes at a block's rate times the waves of blocks over the
    SMs, plus the splits' epilogue. On an H100 its instance is within 3 % of
    the fastest at each 7B shape at B 4 and 16 (``scripts/w4_variants.py``,
    PERF.md)."""
    half, rows, best = k // 2, min(b, ROW_TILE), None
    for tile in (64, 128):
        tiles = -(-n // tile) * -(-b // ROW_TILE)
        k_tiles = -(-half // (W4_STAGE_BYTES // tile))
        for split in range(1, max(1, min(MAX_SPLIT, k_tiles // 2)) + 1):
            blocks = tiles * split
            per_block = half / split * (tile + X_SHARE * 4 * rows)
            est = max(blocks * per_block / COPY_BYTES_PER_US,
                      -(-blocks // SMS) * per_block / BLOCK_BYTES_PER_US) + SPLIT_US * split
            if best is None or est < best[0]:
                best = (est, split, tile)
    return best[1], best[2], 2


def matmul_w4_config(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, split: int,
                     tile: int, stages: int) -> torch.Tensor:
    """K4 on CUDA tensors with the packed rows split ``split`` ways, ``tile``
    output columns a block and a ring of ``stages``; raises on what it does
    not take."""
    return launch_instance(W4_MATMUL_KERNEL, "matmul_w4", x, wq, scale, split, tile, stages)


def matmul_w4(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) bf16/fp32, wq (K/2, N) int8 in :func:`pack_w4`'s layout,
    scale (N,) per output channel → (B, N) bf16. A CPU tensor takes the
    plain version; a CUDA tensor launches K4 (at :func:`plan_w4`'s instance)
    or raises."""
    check_shapes(x, 2 * wq.shape[0], wq.shape[1], scale, "2 * packed rows")
    if x.device.type == "cpu":
        return matmul_w4_reference(x, wq, scale)
    return matmul_w4_config(x, wq, scale, *plan_w4(x.shape[0], x.shape[1], wq.shape[1]))
