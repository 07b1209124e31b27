"""A plain-PyTorch model of the arithmetic of the CUDA kernels K2dq and K2dkv
(``msr3d_tpu_torch/csrc/flash_attn_bwd.cu``), for the CPU tests. It imports
no JAX, so ``tests/test_torch_kernels.py`` can use it on the GPU host too.

The kernels multiply p and ds on the tensor cores, which take 16-bit
operands. To keep the fp32 contract of the TPU kernels they split each fp32
value x into ``hi = round16(x)`` and ``lo = round16(x - hi)`` and add both
products into one fp32 accumulator; the other operand (k, do, q) is 16-bit
already, so every term is exact in fp32. The model does the same with
matrix products in fp32 and rounds each gradient once.
"""

import math

import numpy as np
import torch

from msr3d_tpu_torch.ops.flash_attention import (
    _causal_mask,
    _per_q_head,
    flash_attention_reference,
)

# (id, dtype, D, B, T, S, Hq, Hkv, left padding per batch row)
CASES = [
    ("bf16-D128-nrep1", torch.bfloat16, 128, 2, 40, 40, 2, 2, (0, 7)),
    ("bf16-D128-nrep4", torch.bfloat16, 128, 2, 33, 33, 4, 1, (0, 5)),
    ("fp16-D64-ragged-leftpad", torch.float16, 64, 2, 24, 40, 2, 2, (3, 11)),
    ("bf16-D64-row-without-valid-key", torch.bfloat16, 64, 2, 20, 20, 2, 1, (4, 20)),
    # left padding over a whole 64-key tile: rows whose first key tile is all
    # masked, then valid keys in the next
    ("bf16-D64-pad-over-a-tile", torch.bfloat16, 64, 2, 150, 150, 2, 1, (70, 0)),
]
CASE_IDS = [c[0] for c in CASES]


def make_case(case, seed=21):
    """numpy inputs of one case: fp32 arrays already rounded to the case's
    dtype (so JAX and PyTorch cast them without loss), and key_valid."""
    _, dtype, d, b, t, s, hq, hkv, pads = case
    r = np.random.default_rng(seed)

    def rounded(*shape):
        x = torch.from_numpy(r.normal(size=shape).astype(np.float32))
        return x.to(dtype).float().numpy()

    q, do = rounded(b, t, hq, d), rounded(b, t, hq, d)
    k, v = rounded(b, s, hkv, d), rounded(b, s, hkv, d)
    valid = np.ones((b, s), bool)
    for row, p in enumerate(pads):
        valid[row, :p] = False
    return q, k, v, do, valid


def torch_inputs(case, arrays, out=None):
    """(q, k, v, do, lse, delta, valid) as the backward kernels take them:
    16-bit tensors, lse from the plain forward, delta = rowsum(do · o) with
    o the plain forward's output, or ``out`` (another forward's, so that both
    backwards start from the same 16-bit o)."""
    dtype = case[1]
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in arrays[:4])
    valid = torch.from_numpy(arrays[4])
    plain_out, lse = flash_attention_reference(q, k, v, key_valid=valid)
    out = plain_out if out is None else torch.from_numpy(np.array(out)).to(dtype)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, valid


def split16(x: torch.Tensor, dtype: torch.dtype):
    """fp32 x as hi + lo, both of ``dtype``: hi = round(x), lo = round(x - hi)."""
    hi = x.to(dtype)
    lo = (x - hi.float()).to(dtype)
    return hi, lo


def _split_product(eq: str, x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """einsum(x, other) with fp32 x taken as its hi and lo parts in other's
    16-bit dtype, both products accumulated in fp32."""
    hi, lo = split16(x, other.dtype)
    return torch.einsum(eq, hi.float(), other.float()) + torch.einsum(eq, lo.float(), other.float())


def kernel_model_backward(q, k, v, do, lse, delta, valid):
    """(dq, dk, dv) as K2dq and K2dkv compute them: dq (B, T, Hq, D), dk and
    dv per q head (B, S, Hq, D), in the inputs' dtype."""
    hq, d = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    kq, vq = _per_q_head(k, hq), _per_q_head(v, hq)
    mask = _causal_mask(q, k, valid)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kq.float())
    # the kernels take the exponential in base 2: exp2(s·scale·log2e − lse·log2e)
    log2e = math.log2(math.e)
    p = torch.where(mask, torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None]),
                    torch.zeros(()))
    dp = torch.einsum("bthd,bshd->bhts", do.float(), vq.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = _split_product("bhts,bshd->bthd", ds, kq)
    dv = _split_product("bhts,bthd->bshd", p, do)
    dk = _split_product("bhts,bthd->bshd", ds, q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
