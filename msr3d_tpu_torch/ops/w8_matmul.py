"""int8 weight-only matrix product: kernel K3 and its plain PyTorch version.

Replaces ``msr3d_tpu/ops/pallas/w8_matmul.py::_kernel`` (wrapper
``matmul_w8``) with ``csrc/w8_matmul.cu`` (design in
``csrc/dequant_matmul.cuh``)::

    y[b, n] = bf16((Σ_k bf16(x)[b, k] · wq[k, n]) · scale[n]),  fp32 accumulator

The scale goes on the fp32 sum, once. That is not ``LoraDense``'s int8
order, which rounds ``bf16(wq) · bf16(scale)`` to bf16 before the product:
the JAX package never calls its kernel from the serving path, and neither
does the port (``models/llm/llama.py`` computes ``LoraDense`` as JAX does).
The TPU kernel's 128-aligned blocks and its row padding are TPU tiling; the
CUDA kernel takes any shape.
"""

from __future__ import annotations

import ctypes

import torch

from msr3d_tpu_torch.ops._build import CudaKernel

W8_MATMUL_KERNEL = CudaKernel(
    "w8_matmul", "w8_matmul_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


def check_shapes(x: torch.Tensor, kdim2: int, n: int, scale: torch.Tensor, what: str) -> None:
    """The TPU wrappers' shape errors (``ValueError``) for a weight whose
    contraction side covers ``kdim2`` inputs and whose outputs are ``n``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (B, K), got shape {tuple(x.shape)}")
    if x.shape[1] != kdim2:
        raise ValueError(f"x K dim {x.shape[1]} != {what} {kdim2}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({n},)")


def launch_dequant_matmul(kernel: CudaKernel, x: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor, kdim: int, fn: str) -> torch.Tensor:
    """Launch K3 or K4 on CUDA tensors, or raise on what they do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if wq.device != x.device or scale.device != x.device:
        raise ValueError(f"{fn}: x, wq and scale must lie on one device")
    if wq.dtype != torch.int8:
        raise TypeError(f"{fn}: wq must be int8, got {wq.dtype}")
    if not wq.is_contiguous():
        raise ValueError(f"{fn}: wq must be contiguous")
    b, n = x.shape[0], wq.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    s = scale.to(torch.float32).contiguous()
    y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    if b == 0 or n == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        kernel(xb.data_ptr(), wq.data_ptr(), s.data_ptr(), y.data_ptr(), b, kdim, n, stream)
    return y


def matmul_w8_reference(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math in fp32: bf16(x) · wq (exact products, fp32
    sums), times ``scale`` on the sum, rounded to bf16."""
    acc = x.to(torch.bfloat16).float() @ wq.float()
    return (acc * scale.float()).to(torch.bfloat16)


def matmul_w8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) bf16/fp32, wq (K, N) int8, scale (N,) per output channel →
    (B, N) bf16. A CPU tensor takes the plain version; a CUDA tensor
    launches K3 or raises."""
    check_shapes(x, wq.shape[0], wq.shape[1], scale, "wq K dim")
    if x.device.type == "cpu":
        return matmul_w8_reference(x, wq, scale)
    return launch_dequant_matmul(W8_MATMUL_KERNEL, x, wq, scale, x.shape[1], "matmul_w8")
