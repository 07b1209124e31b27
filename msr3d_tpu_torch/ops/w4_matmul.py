"""int4 weight-only matrix product: kernel K4, its plain PyTorch version and
the kernel's packing.

Replaces ``msr3d_tpu/ops/pallas/w4_matmul.py::_kernel`` (wrapper
``matmul_w4``) with ``csrc/w4_matmul.cu`` (design in
``csrc/dequant_matmul.cuh``).

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
``lo_u = lo + 8`` and fp32 sums; the CUDA kernel unpacks the low nibble to
its signed value instead, so the two sum different terms: besides the order
of the fp32 sums, they differ by the rounding of the biased sum before the
−8 · rowsum cancels. The TPU kernel's three ``unpack`` modes give identical
results and are not ported; there is one kernel.
"""

from __future__ import annotations

import ctypes

import torch

from msr3d_tpu_torch.ops._build import CudaKernel
from msr3d_tpu_torch.ops.w8_matmul import check_shapes, dequant_operands

W4_MATMUL_KERNEL = CudaKernel(
    "w4_matmul", "w4_matmul_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


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


def matmul_w4(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) bf16/fp32, wq (K/2, N) int8 in :func:`pack_w4`'s layout,
    scale (N,) per output channel → (B, N) bf16. A CPU tensor takes the
    plain version; a CUDA tensor launches K4 or raises."""
    check_shapes(x, 2 * wq.shape[0], wq.shape[1], scale, "2 * packed rows")
    if x.device.type == "cpu":
        return matmul_w4_reference(x, wq, scale)
    xb, s, y = dequant_operands(x, wq, scale, "matmul_w4")
    b, n = y.shape
    if b == 0 or n == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        W4_MATMUL_KERNEL(xb.data_ptr(), wq.data_ptr(), s.data_ptr(), y.data_ptr(), b, x.shape[1],
                         n, stream)
    return y
