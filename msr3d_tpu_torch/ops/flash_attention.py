"""Flash attention: the forward kernel K2f, the backward kernels K2dq and
K2dkv, their plain PyTorch versions and the autograd Function around them.

Replaces ``msr3d_tpu/ops/flash_attention.py``: ``_fwd_kernel`` (wrapper
``flash_attention`` → ``_flash`` / ``_fwd_call``) with
``csrc/flash_attn_fwd.cu``, and the FlashAttention-2 backward
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` (``_flash_bwd``) with
``csrc/flash_attn_bwd.cu``. At the 7B shapes the kernels are bound by bytes
(q, k, v, o and their gradients cross device memory once), so the designs
keep the (T, S) scores and probabilities on chip: one block per 64-row
query tile (K2f, K2dq) or 64-key tile (K2dkv) streams the other side's
tiles through shared memory and skips tiles above the causal diagonal. All
three run their products on the tensor cores (``mma.sync``) with the scores
kept in registers: K2f's q·kᵀ and p·v, with p rounded to the value dtype as
the TPU kernel rounds it, and the five products of the backward, with p and
ds split into hi + lo 16-bit parts so they keep fp32's accuracy (see the
sources).

Contract (the Pallas kernel's, as the model calls it): causal by absolute
row/col index ∧ ``key_valid`` (B, S), scale 1/√D; scores and accumulators fp32; probabilities cast to
the value dtype for p·v; a query row with no valid key gives output 0 and
lse 0. Layouts are the model's: q (B, T, Hq, D), k/v (B, S, Hkv, D),
output (B, T, Hq, D) in q's dtype, lse (B, Hq, T) fp32.

The backward recomputes p from the saved lse: ``p = exp(where(mask, s,
-1e30) - lse)·mask``, ``dp = do·vᵀ``, ``ds = p·(dp - delta)·scale`` with
``delta = rowsum(do·o)`` (fp32, a plain op, as the JAX package computes it
in XLA); ``dq = ds·k``, and per q head ``dv = pᵀ·do``, ``dk = dsᵀ·q``, all
accumulated in fp32 and returned in the inputs' dtype; the GQA group-sum
of dk/dv is a plain op too.
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
FLASH_BWD_DQ_KERNEL = CudaKernel(
    "flash_attn_bwd", "flash_attn_bwd_dq_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
FLASH_BWD_DKV_KERNEL = CudaKernel(
    "flash_attn_bwd", "flash_attn_bwd_dkv_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)


def _causal_mask(q: torch.Tensor, k: torch.Tensor,
                 key_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, 1, T, S) bool: causal by absolute row/col ∧ key_valid."""
    t, s = q.shape[1], k.shape[1]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril()
    mask = mask.expand(q.shape[0], 1, t, s)
    if key_valid is not None:
        mask = mask & key_valid[:, None, None, :].bool()
    return mask


def _per_q_head(x: torch.Tensor, hq: int) -> torch.Tensor:
    """(B, S, Hkv, D) → (B, S, Hq, D), q head h reading kv head h // n_rep."""
    n_rep = hq // x.shape[2]
    return x.repeat_interleave(n_rep, dim=2) if n_rep > 1 else x


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
    hq, d = q.shape[2], q.shape[3]
    k, v = _per_q_head(k, hq), _per_q_head(v, hq)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(d))
    mask = _causal_mask(q, k, key_valid)
    logits = logits.masked_fill(~mask, _NEG_INF)
    weights = torch.softmax(logits, dim=-1).masked_fill(~mask, 0.0)
    out = torch.einsum("bhts,bshd->bthd", weights.to(v.dtype), v).to(q.dtype)
    m = logits.amax(dim=-1)
    l = (torch.exp(logits - m[..., None]) * mask).sum(dim=-1)
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-37)), torch.zeros_like(l))
    return out, lse


def _check_cuda_args(fn: str, q, k, v, key_valid, **extra) -> torch.Tensor:
    """Refuse what the kernels do not take; returns key_valid as contiguous
    bools on q's device. ``extra`` are further 16-bit inputs shaped like q
    (the backward's ``do``)."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    tensors = {"q": q, "k": k, "v": v, **extra}
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in tensors.values()):
        raise TypeError(
            f"{fn}: q/k/v{'/' + '/'.join(extra) if extra else ''} must share bfloat16 or "
            f"float16, got {[x.dtype for x in tensors.values()]}"
        )
    if (d not in HEAD_DIMS or hq % hkv or k.shape != (b, s, hkv, d) or v.shape != k.shape
            or any(x.shape != q.shape for x in extra.values())):
        raise ValueError(
            f"{fn}: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} (head dim must be one of {HEAD_DIMS})"
        )
    for name, x in tensors.items():
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous, 16-byte aligned and on "
                             "q's device")
    if key_valid is None:
        key_valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    if key_valid.shape != (b, s) or key_valid.device != q.device:
        raise ValueError(f"{fn}: key_valid must be ({b}, {s}) on q's device")
    return key_valid.to(torch.bool).contiguous()


def _check_rows(fn: str, q: torch.Tensor, **rows: torch.Tensor) -> None:
    """lse / delta: fp32 (B, Hq, T), contiguous, on q's device."""
    b, t, hq, _ = q.shape
    for name, x in rows.items():
        if (x.dtype != torch.float32 or x.shape != (b, hq, t) or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous float32 ({b}, {hq}, {t}) "
                             "on q's device")


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
    key_valid = _check_cuda_args("flash_attention", q, k, v, key_valid)
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


def _bwd_probs(q, k, lse, key_valid):
    """fp32 p (B, Hq, T, S) recomputed from the saved lse, and the scale."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = _causal_mask(q, k, key_valid)
    s = torch.einsum("bthd,bshd->bhts", q.float(), _per_q_head(k, q.shape[2]).float()) * scale
    p = torch.exp(s.masked_fill(~mask, _NEG_INF) - lse[..., None]) * mask
    return p, scale


def _bwd_ds(p, v, do, delta, scale):
    dp = torch.einsum("bthd,bshd->bhts", do.float(), _per_q_head(v, do.shape[2]).float())
    return p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, *, key_valid=None):
    """Plain version of K2dq: dq (B, T, Hq, D) in q's dtype, fp32 inside."""
    p, scale = _bwd_probs(q, k, lse, key_valid)
    ds = _bwd_ds(p, v, do, delta, scale)
    dq = torch.einsum("bhts,bshd->bthd", ds, _per_q_head(k, q.shape[2]).float())
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, *, key_valid=None):
    """Plain version of K2dkv: per-q-head (dk, dv), each (B, S, Hq, D) in
    k's dtype, fp32 inside."""
    p, scale = _bwd_probs(q, k, lse, key_valid)
    ds = _bwd_ds(p, v, do, delta, scale)
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, key_valid=None) -> torch.Tensor:
    """K2dq: dq (B, T, Hq, D). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, key_valid=key_valid)
    key_valid = _check_cuda_args("flash_attention_bwd_dq", q, k, v, key_valid, do=do)
    _check_rows("flash_attention_bwd_dq", q, lse=lse, delta=delta)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        FLASH_BWD_DQ_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, s, hq, hkv, d,
            1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype], stream,
        )
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *,
                            key_valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2dkv: per-q-head (dk, dv), each (B, S, Hq, D). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, key_valid=key_valid)
    key_valid = _check_cuda_args("flash_attention_bwd_dkv", q, k, v, key_valid, do=do)
    _check_rows("flash_attention_bwd_dkv", q, lse=lse, delta=delta)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, s, hq, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        FLASH_BWD_DKV_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, s, hq, hkv,
            d, 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype], stream,
        )
    return dk, dv


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """Per-q-head (B, S, Hq, D) → (B, S, Hkv, D): the GQA group-sum."""
    b, s, hq, d = x.shape
    return x if hq == hkv else x.view(b, s, hkv, hq // hkv, d).sum(dim=3)


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do·o) in fp32, (B, Hq, T)."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_backward_reference(q, k, v, out, lse, do, key_valid=None):
    """The plain backward of :func:`flash_attention` (K2dq + K2dkv plus the
    plain delta and GQA group-sum): (dq, dk, dv) in q's and k's layouts."""
    delta = _delta(out, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, key_valid=key_valid)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, key_valid=key_valid)
    hkv = k.shape[2]
    return dq, _group_sum(dk, hkv), _group_sum(dv, hkv)


class FlashAttention(torch.autograd.Function):
    """Differentiable causal flash attention: forward K2f, backward K2dq and
    K2dkv (each wrapper takes its plain version for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        out, lse = flash_attention(q, k, v, key_valid=key_valid)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = _delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, key_valid=key_valid)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, key_valid=key_valid)
        hkv = k.shape[2]
        return dq, _group_sum(dk, hkv), _group_sum(dv, hkv), None


def flash_attention_train(q, k, v, *, key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention → out (B, T, Hq, D), differentiable in q, k and v
    through :class:`FlashAttention`."""
    if key_valid is None:
        key_valid = torch.ones((q.shape[0], k.shape[1]), dtype=torch.bool, device=q.device)
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                key_valid.bool())
