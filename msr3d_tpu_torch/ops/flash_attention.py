"""Flash-attention forward: kernel K2f and its plain PyTorch version.

Replaces ``msr3d_tpu/ops/flash_attention.py::_fwd_kernel`` (wrapper
``flash_attention`` → ``_flash`` / ``_fwd_call``) with
``csrc/flash_attn_fwd.cu``. At the 7B prefill shape the kernel is bound
by bytes (q, k, v and o cross device memory once), so the design keeps
the (T, S) scores and probabilities on chip: one block per (64-row query
tile, head, batch) streams 64-key tiles of K/V through shared memory with
an online softmax, skips tiles above the causal diagonal and runs both
products on the tensor cores (see the source).

Contract (the Pallas kernel's, as the model calls it): causal by absolute
row/col index ∧ ``key_valid`` (B, S), scale 1/√D; scores and accumulators fp32; probabilities cast to
the value dtype for p·v; a query row with no valid key gives output 0 and
lse 0. Layouts are the model's: q (B, T, Hq, D), k/v (B, S, Hkv, D),
output (B, T, Hq, D) in q's dtype, lse (B, Hq, T) fp32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from msr3d_tpu_torch.ops._build import CudaKernel

_NEG_INF = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
HEAD_DIMS = (64, 128)

FLASH_FWD_KERNEL = CudaKernel(
    "flash_attn_fwd", "flash_attn_fwd_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense causal attention with the kernel's contract: the math of
    ``msr3d_tpu/ops/flash_attention.py::dense_attention_reference`` plus
    the lse. Scores are taken from q and k upcast to fp32, as the kernel
    accumulates them (the same thing in fp32; in bf16 it is the kernel's
    rounding, not the dense path's)."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(d))
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril().expand(b, 1, t, s)
    if key_valid is not None:
        mask = mask & key_valid[:, None, None, :].bool()
    logits = logits.masked_fill(~mask, _NEG_INF)
    weights = torch.softmax(logits, dim=-1).masked_fill(~mask, 0.0)
    out = torch.einsum("bhts,bshd->bthd", weights.to(v.dtype), v).to(q.dtype)
    m = logits.amax(dim=-1)
    l = (torch.exp(logits - m[..., None]) * mask).sum(dim=-1)
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-37)), torch.zeros_like(l))
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal softmax attention → (out (B, T, Hq, D), lse (B, Hq, T)).

    A CPU tensor takes the plain version; a CUDA tensor launches K2f or
    raises."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_valid=key_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q/k/v must share bfloat16 or float16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in HEAD_DIMS or k.shape != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} (head dim must be one of {HEAD_DIMS})"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous, 16-byte "
                             "aligned and on q's device")
    if key_valid is None:
        key_valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    if key_valid.shape != (b, s) or key_valid.device != q.device:
        raise ValueError(f"flash_attention: key_valid must be ({b}, {s}) on q's device")
    key_valid = key_valid.to(torch.bool).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        FLASH_FWD_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, t, s, hq, hkv, d, 1.0 / math.sqrt(d),
            _DTYPE_CODES[q.dtype], stream,
        )
    return out, lse
