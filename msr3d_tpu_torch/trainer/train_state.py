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
divide by the rank count. Every rank then applies the same update to the
same parameters. With one rank no collective runs.

The JAX step scans a fixed number of micro-batches, so it pads an epoch's
tail group with weight-0 duplicates to keep one compiled program and then
divides by the sum of the weights. Running just the real micro-batches
gives the same average, so the port does not pad.

``filter_learnable`` / ``merge_learnable`` are the learnable-only
checkpoint helpers, by parameter name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from msr3d_tpu_torch.optim.build import Optimizer, clip_by_global_norm, global_norm
from msr3d_tpu_torch.parallel.mesh import all_reduce_sum_


class TrainStep:
    """``step(micro_batches) → {"loss", "grad_norm", "step"}``, the loss and
    the norm as fp32 device scalars.

    ``loss_fn(micro_batch)`` returns the scalar mean loss of one micro-batch
    with its autograd graph. ``params`` are the trainable parameters by
    name, the ones ``optimizer`` updates. ``data_parallel`` is the number of
    ranks that each run this step on their own micro-batches.
    """

    def __init__(self, loss_fn: Callable[[Any], torch.Tensor],
                 params: Mapping[str, torch.nn.Parameter], optimizer: Optimizer,
                 grad_norm: Optional[float], data_parallel: int = 1):
        self.loss_fn = loss_fn
        self.params = dict(params)
        self.optimizer = optimizer
        self.max_norm = grad_norm
        self.data_parallel = data_parallel
        self.step_count = 0

    def __call__(self, micro_batches: List[Any]) -> Dict[str, Any]:
        if not micro_batches:
            raise ValueError("a training step needs at least one micro-batch")
        for p in self.params.values():
            p.grad = None
        loss_sum = None
        for mb in micro_batches:
            loss = self.loss_fn(mb)
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
        if self.data_parallel > 1:
            grads, loss = self._average_over_ranks(grads, loss)
        norm = global_norm(grads)
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm, norm)
        self.optimizer.step(dict(zip(names, grads)))
        for p in self.params.values():
            p.grad = None
        self.step_count += 1
        return {"loss": loss, "grad_norm": norm, "step": self.step_count}

    def _average_over_ranks(self, grads: List[torch.Tensor], loss: torch.Tensor):
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1)])
        all_reduce_sum_(flat).div_(self.data_parallel)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return out, flat[at]


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
