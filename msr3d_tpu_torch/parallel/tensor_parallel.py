"""The megatron operators of tensor parallelism, as explicit collectives over
the tp group.

JAX writes sharding annotations and lets XLA insert the collectives
(``msr3d_tpu/parallel/sharding.py``); the port writes them itself, as
``torch.autograd.Function``s over the tp group of ``parallel/mesh.py``:

* ``copy_to_tp``: the identity forward, an all-reduce of the gradient in
  the backward. It stands where a replicated activation enters the
  column-parallel projections, whose per-rank input gradients are partial
  sums;
* ``reduce_from_tp``: an all-reduce forward, the identity backward. It ends
  a row-parallel projection, whose per-rank outputs are partial sums;
* ``gather_last_dim``: an all-gather along the last dim forward (rank 0's
  slice first), the rank's slice of the gradient backward. It joins the
  vocab-parallel logits;
* ``vocab_parallel_embed``: the ids outside the rank's vocab range masked,
  the rest looked up in the rank's rows, the rows summed over the tp group;
* ``max_over_tp`` and ``sum_int_over_tp``: s8×s8's per-token absmax and its
  int32 partial products over a row-parallel layer's ranks.

A CUDA tensor under a gloo group (tp ranks that share a card) goes through
the host, as ``mesh.all_reduce_sum_`` does. ``COMM`` counts the collectives
of the forward and backward operators and the host seconds spent in them
(a host-routed one waits for the card, so its seconds hold the copies).
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from msr3d_tpu_torch.parallel import mesh


COMM = {"calls": 0, "seconds": 0.0}


def _counted(fn):
    def run(x, *args):
        t0 = time.perf_counter()
        out = fn(x, *args)
        COMM["calls"] += 1
        COMM["seconds"] += time.perf_counter() - t0
        return out
    return run


@_counted
def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    return mesh.all_reduce_sum_(x.contiguous().clone(), group=mesh.tp_group())


@_counted
def _all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    # fp32 on the wire: a max of bf16 values is exact in fp32 and back
    out = mesh.all_reduce_(x.detach().float().contiguous(), group=mesh.tp_group(),
                           op=dist.ReduceOp.MAX)
    return out.to(x.dtype)


def gather_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The tp ranks' ``x`` joined along ``dim``, rank 0's first (no autograd);
    a CPU tensor goes over the tp group's gloo twin."""
    group = mesh.tp_group() if x.device.type == "cuda" else mesh.tp_control_group()
    n = dist.get_world_size(group)
    via_host = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    src = (x.detach().cpu() if via_host else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if via_host else out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.width = x.shape[-1]
        return _counted(gather_along)(x, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        start = mesh.tp_rank() * ctx.width
        return grad[..., start:start + ctx.width].contiguous()


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient summed over the tp group."""
    return _CopyToTP.apply(x) if torch.is_grad_enabled() and x.requires_grad else x


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The sum over the tp group; the gradient passes as it is."""
    return _ReduceFromTP.apply(x)


def gather_last_dim(x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' slices joined along the last dim, rank 0's first; the
    gradient's own slice goes back."""
    return _GatherLastDim.apply(x)


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the tp group (no autograd: s8×s8's
    per-token absmax)."""
    return _all_reduce_max(x)


def sum_int_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The sum over the tp group of an integer tensor (s8×s8's int32 partial
    products): exact, so every rank holds the whole product."""
    return _all_reduce(x)


def vocab_parallel_embed(ids: torch.Tensor, weight: torch.Tensor,
                         vocab_start: int) -> torch.Tensor:
    """The embedding rows of ``ids`` from the rank's rows ``weight`` (rows
    ``vocab_start .. vocab_start + len(weight)`` of the table): a row this
    rank does not hold is 0 here and comes from its owner in the sum."""
    local = ids - vocab_start
    mine = (local >= 0) & (local < weight.shape[0])
    rows = F.embedding(torch.where(mine, local, torch.zeros_like(local)), weight)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return reduce_from_tp(rows)


def sum_over_tp_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the tp group in place (the identity at tp = 1)."""
    if mesh.tp_size() > 1:
        mesh.all_reduce_sum_(t, group=mesh.tp_group())
    return t


def check_tp_agree(digest: str, what: str) -> Optional[str]:
    """Raise unless every tp rank holds the same ``digest`` (a string);
    nothing at tp = 1."""
    if mesh.tp_size() == 1:
        return None
    digests = mesh.process_allgather_objects([digest], mesh.tp_control_group())
    if len(set(digests)) > 1:
        raise RuntimeError(f"{what} differ between the tp ranks: digests {digests}")
    return digest
