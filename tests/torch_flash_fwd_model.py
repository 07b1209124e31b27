"""A plain-PyTorch model of the arithmetic of the CUDA kernel K2f
(``msr3d_tpu_torch/csrc/flash_attn_fwd.cu``), for the CPU tests. It imports
no JAX, so ``tests/test_torch_kernels.py`` can use it on the GPU host too.

The kernel walks the keys in tiles of 64 with a running max m and sum l per
query row. It works in base 2: m is the max of s·scale·log2(e), the
probabilities are p = 2^(s·scale·log2(e) − m) against the max so far, a
masked score is −inf so its p is exactly 0, l sums the fp32 p, and p is
rounded to the value dtype, tile by tile, before p·v accumulates in fp32.
Then o = acc / l and lse = m·ln 2 + log l, both 0 for a row whose l is 0.
"""

import math

import numpy as np
import torch

from msr3d_tpu_torch.ops.flash_attention import _causal_mask, _per_q_head

TILE = 64  # keys a tile
_NEG_INF = -1e30  # the running max before any valid key


def forward_inputs(case, arrays):
    """(q, k, v, valid) of one case as K2f takes them: 16-bit tensors."""
    dtype = case[1]
    q, k, v = (torch.from_numpy(x).to(dtype) for x in arrays[:3])
    return q, k, v, torch.from_numpy(arrays[4])


def kernel_model_forward(q, k, v, valid):
    """(out (B, T, Hq, D) in q's dtype, lse (B, Hq, T) fp32) as K2f computes
    them."""
    hq, d = q.shape[2], q.shape[3]
    # the kernel gets scale as fp32 and folds log2(e) in with one fp32 multiply
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = scale * np.float32(math.log2(math.e))
    kq, vq = _per_q_head(k, hq), _per_q_head(v, hq)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kq.float())
    s = s.masked_fill(~_causal_mask(q, k, valid), -math.inf)
    m = torch.full(s.shape[:3], _NEG_INF)
    l = torch.zeros(s.shape[:3])
    acc = torch.zeros(s.shape[:3] + (d,))
    for k0 in range(0, s.shape[-1], TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1) * scale_log2)  # -inf leaves m
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st * scale_log2 - m_new[..., None])  # 2^-inf = 0
        l = alpha * l + p.sum(-1)
        pv = torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(), vq[:, k0:k0 + TILE].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    live = l > 0
    out = torch.where(live[..., None], acc / l.clamp(min=1e-37)[..., None], torch.zeros(()))
    lse = torch.where(live, m * math.log(2.0) + torch.log(l.clamp(min=1e-37)), torch.zeros(()))
    return out.transpose(1, 2).to(q.dtype), lse
