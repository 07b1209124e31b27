"""A plain-PyTorch model of the arithmetic of the CUDA kernel K3
(``msr3d_tpu_torch/csrc/w8_matmul.cu``), for the CPU tests. It imports no
JAX, so ``tests/test_torch_kernels.py`` can use it on the GPU host too.

The kernel cuts K into tiles of ``8192 // tile`` rows (the last one padded
with zeros) and the tiles into ``split`` contiguous ranges, range p taking
tiles [p·T/split, (p+1)·T/split). Inside a range, warp w of the block's four
takes the k16 steps w, w + 4, w + 8, ... of each tile, tile after tile, and
adds each step's 16-term product (an ``mma.sync``) to its fp32 sum. The four
warps' sums are added in warp order, the ranges' partials in range order,
and the total is scaled once and rounded to bf16.

The order of the 16 products inside one step is the tensor core's and is
not modelled: the model and the kernel still differ there, by fp32
rounding, which one bf16 ulp of the result covers.
"""

import torch

STAGE_BYTES = 8192
WARPS = 4


def k_ranges(k: int, split: int, tile: int, stage_bytes: int = STAGE_BYTES):
    """The k rows [start, end) of each of the ``split`` ranges (the last
    tile's rows past K included, as zeros), for tiles of ``stage_bytes //
    tile`` rows."""
    kt = stage_bytes // tile
    tiles = -(-k // kt)
    return [((p * tiles // split) * kt, ((p + 1) * tiles // split) * kt) for p in range(split)]


def kernel_model_w8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, split: int,
                    tile: int) -> torch.Tensor:
    """K3's output at ``split`` ranges and column tile ``tile``: x (B, K),
    wq (K, N) int8, scale (N,) → (B, N) bf16."""
    b, k = x.shape
    kt = STAGE_BYTES // tile
    padded = -(-k // kt) * kt
    xf = torch.zeros((b, padded), dtype=torch.float32)
    xf[:, :k] = x.to(torch.bfloat16).float()
    wf = torch.zeros((padded, wq.shape[1]), dtype=torch.float32)
    wf[:k] = wq.float()
    total = None
    for start, end in k_ranges(k, split, tile):
        warps = [torch.zeros((b, wq.shape[1])) for _ in range(WARPS)]
        for step, kk in enumerate(range(start, end, 16)):
            w = step % WARPS  # a tile holds a multiple of 4 steps, so this is (kk // 16) % 4
            warps[w] = warps[w] + xf[:, kk:kk + 16] @ wf[kk:kk + 16]
        part = ((warps[0] + warps[1]) + warps[2]) + warps[3]
        total = part if total is None else total + part
    return (total * scale.float()).to(torch.bfloat16)
