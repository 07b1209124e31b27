"""Sequence parallelism: exact softmax attention with the sequence split over
the ranks of the sp group, its key/value blocks passed around a ring.

Counterpart of ``msr3d_tpu/parallel/ring_attention.py``. Q, K and V are
split along the sequence (dim 1 of (B, S, H, D)) into one block a rank of
the sp group (``parallel/mesh.py``). Each rank starts from its own key and
value block; at step i it holds the block that came from rank ``(my - i) %
n``, attends to it, merges the running softmax (max, denominator,
numerator), and passes the block one step on to ``my + 1``; after n steps
every query has seen every key. Causality is by global index (``q_pos >=
k_pos``) and ``key_valid`` masks padded keys; a query row with no valid key
gives 0, as the flash kernel gives, not the dense route's uniform average.

The roundings are JAX's, for bf16 parity: q·k is computed in the input dtype
and then cast to fp32, times the Python float ``1/sqrt(D)`` (an fp32
multiply); p is fp32 for the denominator and rounded to v's dtype for the
numerator's product; the numerator accumulates in fp32, and the output is
``num / max(den, 1e-30)`` cast to q's dtype.

Where the port's schedule differs from JAX's, the values do not:

* the ring passes the un-repeated key/value heads and each rank repeats
  them for its query heads (GQA), fewer bytes a hop for the same values;
* a block wholly in a query block's causal future is masked everywhere, and
  JAX's merge adds exactly nothing for it (its weight is 0 and the running
  stats stay as they were), so the port skips its products; it still passes
  the block on;
* the key mask is the whole sequence's on every rank, so it is sliced, not
  passed around;
* the last hop of the forward, which JAX makes and throws away, is not
  made.

Collectives are not differentiable, so the backward is written out
(``_Ring``): each block's p is recomputed from the forward's saved row max
and denominator, as a flash backward does, and its dq, dk and dv follow;
the key/value blocks travel the ring again together with their dk/dv
accumulators (fp32), and after n hops each block's dk/dv is back at its
owner. The block products are plain PyTorch, as JAX's are plain einsums: no
Pallas kernel is behind them.

The hops go through ``parallel/pipeline.py``'s ``exchange`` (a CUDA tensor
under gloo, ranks sharing a card, through the host). ``COMM`` counts them,
and ``sum_over_sp``'s all-reduces (the per-sequence loss's token sums):
transfers, bytes sent and the host seconds spent in them (a host-routed hop
waits for the card, so its seconds hold the copies).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from msr3d_tpu_torch.parallel import mesh, pipeline

__all__ = ["COMM", "ring_attention", "sequence_block", "sum_over_sp"]

COMM = {"calls": 0, "seconds": 0.0, "bytes": 0}


def _ring(group):
    """(ranks n, this rank's index, the global rank sent to, the one received
    from) of ``group``; one rank without a group."""
    if group is None:
        return 1, 0, None, None
    n, my = dist.get_world_size(group), dist.get_rank(group)
    return (n, my, dist.get_global_rank(group, (my + 1) % n),
            dist.get_global_rank(group, (my - 1) % n))


@pipeline.counted(COMM)
def _hop(t: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    return pipeline.exchange(t, dst, src, group)


def sequence_block(x: torch.Tensor, n: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``n`` equal blocks of ``x`` (B, T, ...) along the
    sequence; a length that does not divide by ``n`` raises, as JAX asserts
    (no quiet padding)."""
    length = x.shape[1]
    if length % n:
        raise ValueError(f"sequence length {length} not divisible by sp={n}")
    size = length // n
    return x.narrow(1, index * size, size)


def _heads_first(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, h, D) → (B, h·n_rep, S, D), each head repeated n_rep times in
    place (``repeat_interleave``, the model's GQA ``rep``)."""
    x = x.transpose(1, 2)
    return x.repeat_interleave(n_rep, dim=1) if n_rep > 1 else x


def _block_mask(key_valid, src, s, q_pos, causal):
    """(B, 1, t, s) bool: block ``src``'s valid keys, and with ``causal``
    those at or before each query's global index."""
    k_pos = src * s + torch.arange(s, device=key_valid.device)
    mask = key_valid[:, src * s:(src + 1) * s][:, None, None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])[None, None]
    return mask


def _scores(q, k, mask, scale: float) -> torch.Tensor:
    """fp32 (B, H, t, s) scores: q·k in the input dtype, then fp32 times the
    Python float ``scale``; masked entries -inf."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    return logits.masked_fill(~mask, float("-inf"))


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def _skipped(causal: bool, src: int, my: int) -> bool:
    # a block wholly after this rank's queries: masked everywhere
    return causal and src > my


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, causal, group):
        n, my, dst, src_rank = _ring(group)
        b, s, h, d = q.shape
        n_rep = h // k.shape[2]
        scale = 1.0 / float(d) ** 0.5
        qh = q.transpose(1, 2)  # (B, H, s, D)
        q_pos = my * s + torch.arange(s, device=q.device)
        num = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
        den = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
        mx = torch.full((b, h, s), float("-inf"), dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])  # one buffer a hop
        for i in range(n):
            src = (my - i) % n
            if not _skipped(causal, src, my):
                kb, vb = _heads_first(kv[0], n_rep), _heads_first(kv[1], n_rep)
                logits = _scores(qh, kb, _block_mask(key_valid, src, s, q_pos, causal), scale)
                bm = logits.amax(dim=-1)
                p = torch.exp(logits - _safe(bm)[..., None])
                bd = p.sum(dim=-1)
                bn = torch.matmul(p.to(v.dtype), vb).float()
                new_m = torch.maximum(mx, bm)
                alpha = torch.exp(_safe(mx) - _safe(new_m)) * torch.isfinite(mx)
                beta = torch.exp(_safe(bm) - _safe(new_m)) * torch.isfinite(bm)
                num = num * alpha[..., None] + bn * beta[..., None]
                den = den * alpha + bd * beta
                mx = new_m
            if i < n - 1:
                kv = _hop(kv, dst, src_rank, group)
        out = (num / torch.clamp_min(den, 1e-30)[..., None]).to(q.dtype).transpose(1, 2)
        ctx.save_for_backward(q, k, v, key_valid, out, mx, den)
        ctx.causal, ctx.group = causal, group
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, key_valid, out, mx, den = ctx.saved_tensors
        causal, group = ctx.causal, ctx.group
        n, my, dst, src_rank = _ring(group)
        b, s, h, d = q.shape
        hkv = k.shape[2]
        n_rep = h // hkv
        scale = 1.0 / float(d) ** 0.5
        qh = q.transpose(1, 2)
        q32 = qh.float()
        do = grad.transpose(1, 2).float()  # (B, H, s, D)
        delta = (do * out.transpose(1, 2).float()).sum(dim=-1)  # (B, H, s)
        m_safe = _safe(mx)
        inv = 1.0 / torch.clamp_min(den, 1e-30)
        q_pos = my * s + torch.arange(s, device=q.device)
        dq = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2, b, s, hkv, d), dtype=torch.float32, device=q.device)
        for i in range(n):
            src = (my - i) % n
            if not _skipped(causal, src, my):
                kb, vb = _heads_first(kv[0], n_rep), _heads_first(kv[1], n_rep)
                logits = _scores(qh, kb, _block_mask(key_valid, src, s, q_pos, causal), scale)
                p = torch.exp(logits - m_safe[..., None]) * inv[..., None]  # masked: 0
                dv = torch.matmul(p.transpose(-1, -2), do)  # (B, H, s, D)
                ds = p * (torch.matmul(do, vb.float().transpose(-1, -2)) - delta[..., None])
                dq += torch.matmul(ds, kb.float()) * scale
                dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
                # the repeated heads' gradients summed into their kv head
                for j, g in enumerate((dk, dv)):
                    dkv[j] += g.view(b, hkv, n_rep, s, d).sum(dim=2).transpose(1, 2)
            if n > 1:
                if i < n - 1:
                    kv = _hop(kv, dst, src_rank, group)
                # the accumulators travel with their block, and the n-th hop
                # brings each home
                dkv = _hop(dkv, dst, src_rank, group)
        dq = dq.transpose(1, 2).to(q.dtype)
        return dq, dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                   key_valid: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Exact softmax attention of this rank's sequence block.

    ``q`` (B, s, H, D), ``k`` and ``v`` (B, s, Hkv, D) with H a multiple of
    Hkv (the un-repeated kv heads) are the block of this rank's index in
    ``group`` (the mesh's sp group when None; one rank without one), whose n
    ranks hold the n consecutive blocks of a sequence of n·s. ``key_valid``
    (B, n·s) bool, the whole sequence's key mask (all valid when None).
    Returns (B, s, H, D) in q's dtype, differentiable in q, k and v; every
    rank of the group must call it together."""
    if group is None:
        group = mesh.sp_group()
    n = 1 if group is None else dist.get_world_size(group)
    b, s = q.shape[:2]
    if key_valid is None:
        key_valid = torch.ones((b, n * s), dtype=torch.bool, device=q.device)
    elif key_valid.shape != (b, n * s):
        raise ValueError(f"key_valid {tuple(key_valid.shape)} is not the whole sequence's "
                         f"({b}, {n * s}) of {n} blocks of {s}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads are not a multiple of {k.shape[2]} kv heads")
    return _Ring.apply(q, k, v, key_valid.bool(), causal, group)


@pipeline.counted(COMM)
def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    return mesh.all_reduce_sum_(x.detach().contiguous().clone(), group=mesh.sp_group())


class _SumOverSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def sum_over_sp(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the mesh's sp group (the identity at sp = 1);
    the gradient passes as it is: every sp rank computes the same loss from
    the sum, and each backpropagates it through its own part."""
    return _SumOverSP.apply(x) if mesh.sp_size() > 1 else x
