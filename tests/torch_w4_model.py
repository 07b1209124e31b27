"""A plain-PyTorch model of the arithmetic of the CUDA kernel K4
(``msr3d_tpu_torch/csrc/w4_matmul.cu``), for the CPU tests. It imports no
JAX, so ``tests/test_torch_kernels.py`` can use it on the GPU host too.

The kernel reads the (K/2, N) packed weight as K/2 packed rows, cuts them
into tiles of ``16384 // tile`` rows (16 KB stages, twice K3's; the last
tile padded with zeros) and the tiles into ``split`` contiguous ranges,
range p taking tiles [p·T/split, (p+1)·T/split) (``torch_w8_model.k_ranges``
over K/2 rows).
Inside a range, warp w of the block's four takes the k16 steps w, w + 4, ...
of each tile, tile after tile. A step over packed rows [p, p + 16) adds two
16-term products (two ``mma.sync``) to the warp's fp32 sum: the signed low
nibbles against x[:, p:p + 16], then the high nibbles against
x[:, K/2 + p:K/2 + p + 16]. The four warps' sums are added in warp order, the
ranges' partials in range order, and the total is scaled once and rounded
to bf16. The +8 bias of the low nibble is taken off in the conversion and
never enters a sum.

The order of the 16 products inside one ``mma.sync`` is the tensor core's
and is not modelled: the model and the kernel still differ there, by fp32
rounding, which one bf16 ulp of the result covers.
"""

import torch

from torch_w8_model import STAGE_BYTES, WARPS, k_ranges

W4_STAGE_BYTES = 2 * STAGE_BYTES


def signed_nibbles(wq: torch.Tensor):
    """(lo, hi) of :func:`pack_w4`'s bytes as fp32 values in [-8, 7]: the low
    nibble less its +8 bias, the high nibble two's complement."""
    byte = wq.view(torch.uint8).to(torch.int16)
    lo = (byte & 0xF) - 8
    hi = byte >> 4
    return lo.float(), torch.where(hi >= 8, hi - 16, hi).float()


def kernel_model_w4(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, split: int,
                    tile: int) -> torch.Tensor:
    """K4's output at ``split`` ranges and column tile ``tile``: x (B, K),
    wq (K/2, N) int8 in ``pack_w4``'s layout, scale (N,) → (B, N) bf16."""
    b, half, n = x.shape[0], wq.shape[0], wq.shape[1]
    kt = W4_STAGE_BYTES // tile
    padded = -(-half // kt) * kt
    xb = x.to(torch.bfloat16).float()
    xs = [torch.zeros((b, padded)), torch.zeros((b, padded))]
    xs[0][:, :half], xs[1][:, :half] = xb[:, :half], xb[:, half:]
    lo, hi = signed_nibbles(wq)
    ws = [torch.zeros((padded, n)), torch.zeros((padded, n))]
    ws[0][:half], ws[1][:half] = lo, hi
    total = None
    for start, end in k_ranges(half, split, tile, W4_STAGE_BYTES):
        warps = [torch.zeros((b, n)) for _ in range(WARPS)]
        for step, kk in enumerate(range(start, end, 16)):
            w = step % WARPS  # a tile holds a multiple of 4 steps, so this is (kk // 16) % 4
            for side in (0, 1):  # the low nibbles' product, then the high ones'
                warps[w] = warps[w] + xs[side][:, kk:kk + 16] @ ws[side][kk:kk + 16]
        part = ((warps[0] + warps[1]) + warps[2]) + warps[3]
        total = part if total is None else total + part
    return (total * scale.float()).to(torch.bfloat16)
