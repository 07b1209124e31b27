"""The training step: gradient accumulation, clipping and the optimizer.

Counterpart of ``msr3d_tpu/trainer/train_state.py``. Gradients exist only
for the trainable parameters (``requires_grad``; the frozen base never
gets any). One step runs forward and backward per micro-batch, averages the
gradients and the losses over the group's real micro-batches, reports the
global gradient norm before clipping, clips it as optax does and applies
the optimizer. It reads nothing back from the device: the loss and the
norm it returns are device tensors, which the trainer fetches
``train_metrics_lag`` steps later.

With ``data_parallel`` ranks (each its own shard of the global batch) the
step averages the trainable gradients and the loss over the ranks before the
norm, the clip and the optimizer, so all three see the global batch's, as
the all-reduce that JAX's ``jit`` inserts for the dp sharding does: one flat
fp32 buffer of every gradient and the loss, one ``all_reduce(SUM)``, a
divide by the rank count, over the dp group. Every rank then applies the
same update to the same parameters. With one rank no collective runs.

Under tensor parallelism (``tp_dims``: the trainable parameters split over
the tp group, ``tp_partial``: the replicated ones whose per-rank gradient is
a partial sum) the partial gradients are first summed over the tp group
(one flat buffer), and the global norm is the norm of the full gradients:
the sharded parameters' squares summed over the tp group, the replicated
ones counted once. The optimizer's moments follow their parameters'
shards.

Under pipeline parallelism (``pp_local``: the trainable parameters of this
rank's stage, its blocks'; the others are on every stage) the loss function
runs the pipelined forward and backward itself (``parallel/llm_pp.py``) and
returns the loss detached. The parameters outside the blocks get their
gradient on stage 0 alone, so after the tp sum it is broadcast from stage 0
over the pp group (one flat buffer) before the dp average, the norm and the
clip; the global norm sums each stage's block gradients over pp (their
tp-split ones over tp first) and adds the others once.

Under sequence parallelism (the mesh's sp > 1: the sp ranks of a dp
index compute one batch, each its block of every sequence) every trainable
gradient on a rank is the part its block's tokens contribute, so all of
them are summed over the sp group (one flat buffer), after the tp sum and
before the dp average, the norm and the clip; the loss is already the whole
sequence's on every sp rank.

The JAX step scans a fixed number of micro-batches, so it pads an epoch's
tail group with weight-0 duplicates to keep one compiled program and then
divides by the sum of the weights. Running just the real micro-batches
gives the same average, so the port does not pad.

``filter_learnable`` / ``merge_learnable`` are the learnable-only
checkpoint helpers, by parameter name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import torch

from msr3d_tpu_torch.optim.build import Optimizer, clip_by_global_norm, global_norm
from msr3d_tpu_torch.parallel import mesh
from msr3d_tpu_torch.parallel.mesh import all_reduce_sum_
from msr3d_tpu_torch.parallel.tensor_parallel import sum_over_tp_


class TrainStep:
    """``step(micro_batches) → {"loss", "grad_norm", "step"}``, the loss and
    the norm as fp32 device scalars.

    ``loss_fn(micro_batch)`` returns the scalar mean loss of one micro-batch
    with its autograd graph. ``params`` are the trainable parameters by
    name, the ones ``optimizer`` updates. ``data_parallel`` is the number of
    ranks (of the dp group) that each run this step on their own
    micro-batches. ``tp_sharded`` and ``tp_partial`` name the trainable
    parameters split over the tp group and the replicated ones whose
    gradient is a partial sum over it (none at tp = 1). ``pp_local`` names
    this pipeline stage's own trainable parameters; given (pp > 1, maybe
    empty), the
    loss function does its own backward and the others' gradients come
    from stage 0. Where the mesh has sp > 1, every gradient is summed
    over the sp group.
    """

    def __init__(self, loss_fn: Callable[[Any], torch.Tensor],
                 params: Mapping[str, torch.nn.Parameter], optimizer: Optimizer,
                 grad_norm: Optional[float], data_parallel: int = 1,
                 tp_sharded: Iterable[str] = (), tp_partial: Iterable[str] = (),
                 pp_local: Optional[Iterable[str]] = None):
        self.loss_fn = loss_fn
        self.params = dict(params)
        self.optimizer = optimizer
        self.max_norm = grad_norm
        self.data_parallel = data_parallel
        self.tp_sharded = [n for n in self.params if n in set(tp_sharded)]
        self.tp_partial = [n for n in self.params if n in set(tp_partial)]
        self.pipelined = pp_local is not None
        self.pp_local = [n for n in self.params if n in set(pp_local or ())]
        self.pp_replicated = ([n for n in self.params if n not in set(self.pp_local)]
                              if self.pipelined else [])
        # a per-tensor norm of the optimizer (Lamb's trust ratio) of a split
        # parameter is its whole tensor's
        optimizer.tp_sharded = frozenset(self.tp_sharded)
        self.step_count = 0

    def __call__(self, micro_batches: List[Any]) -> Dict[str, Any]:
        if not micro_batches:
            raise ValueError("a training step needs at least one micro-batch")
        for p in self.params.values():
            p.grad = None
        loss_sum = None
        for mb in micro_batches:
            loss = self.loss_fn(mb)
            if not self.pipelined:  # the pipelined loss took its backward
                loss.backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        scale = 1.0 / len(micro_batches)
        names = list(self.params)
        # a trainable parameter no loss reached has a zero gradient, as in JAX
        grads = [
            self.params[n].grad * scale if self.params[n].grad is not None
            else torch.zeros_like(self.params[n])
            for n in names
        ]
        loss = loss_sum * scale
        if self.tp_partial:
            grads = self._sum_partial_over_tp(names, grads)
        if mesh.sp_size() > 1:
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            grads = _unflatten(all_reduce_sum_(flat, group=mesh.sp_group()), grads)
        if self.pp_replicated:
            grads = self._broadcast_from_stage0(names, grads)
        if self.data_parallel > 1:
            grads, loss = self._average_over_ranks(grads, loss)
        norm = self._global_norm(names, grads)
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm, norm)
        self.optimizer.step(dict(zip(names, grads)))
        for p in self.params.values():
            p.grad = None
        self.step_count += 1
        return {"loss": loss, "grad_norm": norm, "step": self.step_count}

    def _average_over_ranks(self, grads: List[torch.Tensor], loss: torch.Tensor):
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1)])
        all_reduce_sum_(flat, group=mesh.dp_group()).div_(self.data_parallel)
        out = _unflatten(flat, grads)
        return out, flat[-1]

    def _sum_partial_over_tp(self, names: List[str], grads: List[torch.Tensor]):
        at = {n: i for i, n in enumerate(names)}
        part = [grads[at[n]] for n in self.tp_partial]
        summed = _unflatten(sum_over_tp_(torch.cat([g.reshape(-1).float() for g in part])), part)
        grads = list(grads)
        for n, g in zip(self.tp_partial, summed):
            grads[at[n]] = g
        return grads

    def _broadcast_from_stage0(self, names: List[str], grads: List[torch.Tensor]):
        at = {n: i for i, n in enumerate(names)}
        part = [grads[at[n]] for n in self.pp_replicated]
        flat = torch.cat([g.reshape(-1).float() for g in part])
        mesh.broadcast_(flat, mesh.global_rank("pp", 0), mesh.pp_group())
        grads = list(grads)
        for n, g in zip(self.pp_replicated, _unflatten(flat, part)):
            grads[at[n]] = g
        return grads

    def _global_norm(self, names: List[str], grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the full gradients: a sharded parameter's squares
        summed over the tp group, a replicated one's counted once; under pp
        a stage's own parameters' summed over the pp group, the others'
        counted once."""
        if not self.tp_sharded and not self.pipelined:
            return global_norm(grads)
        sharded, local = set(self.tp_sharded), set(self.pp_local)

        def squares(keep) -> torch.Tensor:
            sq = [g.float().square().sum() for n, g in zip(names, grads) if keep(n)]
            return torch.stack(sq).sum() if sq else torch.zeros((), device=grads[0].device)

        if not self.pipelined:
            return torch.sqrt(sum_over_tp_(squares(lambda n: n in sharded).reshape(1))[0]
                              + squares(lambda n: n not in sharded))

        def over_tp(on_stage: bool) -> torch.Tensor:
            return (sum_over_tp_(squares(lambda n: n in sharded and (n in local) == on_stage)
                                 .reshape(1))[0]
                    + squares(lambda n: n not in sharded and (n in local) == on_stage))

        stages = all_reduce_sum_(over_tp(True).reshape(1), group=mesh.pp_group())[0]
        return torch.sqrt(stages + over_tp(False))


def _unflatten(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    """``flat``'s leading elements as tensors shaped and typed like ``like``."""
    out, at = [], 0
    for g in like:
        out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
        at += g.numel()
    return out


def filter_learnable(module: torch.nn.Module, names) -> Dict[str, torch.Tensor]:
    """The named (trainable) parameters of ``module``, detached, on the CPU,
    for a weights-only save."""
    params = dict(module.named_parameters())
    return {n: params[n].detach().cpu().clone() for n in names}


@torch.no_grad()
def merge_learnable(module: torch.nn.Module, learnable: Mapping[str, torch.Tensor]) -> None:
    """Overlay saved learnable parameters on ``module`` in place (the
    reference's ``load_state_dict(strict=False)``); an unknown name raises."""
    params = dict(module.named_parameters())
    unknown = sorted(set(learnable) - set(params))
    if unknown:
        raise KeyError(f"learnable weights name unknown parameters: {unknown[:5]}")
    for name, value in learnable.items():
        params[name].copy_(value)
