"""Pipeline parallelism over this rank's pp group: the GPipe schedule as
point-to-point sends between adjacent stages.

Counterpart of ``msr3d_tpu/parallel/pipeline.py``. JAX rolls the schedule
into one ``shard_map`` over the mesh's pp axis: every device runs every
tick, the bubble ticks compute on zeros and their results are thrown away,
and ``lax.ppermute`` moves the activations one stage down the ring. Here
each stage is a process and runs only its real work, in GPipe's order:

* forward: micro-batches 0 .. M-1 in turn; stage 0 takes its inputs from
  the caller, stage s > 0 receives each from stage s-1 (``recv``); the stage
  runs ``stage_fn`` and sends the output on to stage s+1 (``send``), and the
  last stage turns it into its micro-batch's loss;
* backward, once every forward is done, in reverse: the last stage
  backpropagates each loss, every other stage receives the gradient of its
  output from stage s+1, backpropagates it, and sends the gradient of its
  input to stage s-1; stage 0 hands its inputs' gradients to the caller.

Every micro-batch passes through every stage in order, so the numbers are
those of the blocks run one after another (JAX's as well). Side inputs that
every stage needs (a micro-batch's attention mask) travel with the
activations. The shapes are known on both sides (every rank of a pipeline
holds the batch), so a transfer is one tensor with no header.

A CUDA tensor under a ``gloo`` group (pp ranks that share a card; NCCL
refuses two ranks on one device) goes through the host. ``COMM`` counts the
transfers, their bytes and the host seconds spent in them (a host-routed
send waits for the card, so its seconds hold the copies). ``exchange`` is
the same host-routed transfer for a ring of ranks that each send and
receive at once (ring attention's hops, ``parallel/ring_attention.py``,
which keeps its own count).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from msr3d_tpu_torch.parallel import mesh

COMM = {"calls": 0, "seconds": 0.0, "bytes": 0}


def counted(counter: dict):
    """A decorator that adds each call of a transfer ``fn(t, ...)`` to
    ``counter``: one call, ``t``'s bytes, the host seconds."""
    def wrap(fn):
        def run(t: torch.Tensor, *args):
            t0 = time.perf_counter()
            out = fn(t, *args)
            counter["calls"] += 1
            counter["bytes"] += t.numel() * t.element_size()
            counter["seconds"] += time.perf_counter() - t0
            return out
        return run
    return wrap


def _via_host(t: torch.Tensor, group=None) -> bool:
    group = mesh.pp_group() if group is None else group
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


@counted(COMM)
def send(t: torch.Tensor, stage: int) -> None:
    """Send ``t`` to pipeline stage ``stage`` of this rank's pp group."""
    t = t.detach().contiguous()
    dist.send(t.cpu() if _via_host(t) else t, dst=mesh.global_rank("pp", stage),
              group=mesh.pp_group())


@counted(COMM)
def recv_into(t: torch.Tensor, stage: int) -> torch.Tensor:
    """Receive into ``t`` (its shape and dtype are the sender's) from stage
    ``stage``; returns ``t``."""
    host = torch.empty(t.shape, dtype=t.dtype) if _via_host(t) else t
    dist.recv(host, src=mesh.global_rank("pp", stage), group=mesh.pp_group())
    if host is not t:
        t.copy_(host)
    return t


def exchange(t: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``t`` to global rank ``dst`` and return a tensor like it received
    from global rank ``src``, over ``group``. The two are posted as one batch
    (NCCL groups them), so every rank of a ring may call it at once; a CUDA
    tensor under gloo goes through the host."""
    via_host = _via_host(t, group)
    out = t.detach().contiguous()
    out = out.cpu() if via_host else out
    into = torch.empty_like(out)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.irecv, into, src, group),
                                       dist.P2POp(dist.isend, out, dst, group)]):
        req.wait()
    return into.to(t.device) if via_host else into


def recv(shape, dtype: torch.dtype, device, stage: int) -> torch.Tensor:
    """A new tensor of ``shape`` and ``dtype`` received from stage ``stage``."""
    return recv_into(torch.empty(shape, dtype=dtype, device=device), stage)


def broadcast_from_last(t: torch.Tensor) -> torch.Tensor:
    """The last stage's ``t`` on every stage of the pipeline, in place."""
    if mesh.pp_size() == 1:
        return t
    return mesh.broadcast_(t, mesh.global_rank("pp", mesh.pp_size() - 1), mesh.pp_group())


def gpipe(stage_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
          inputs: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
          shape: Tuple[int, ...], dtype: torch.dtype, side_dtype: torch.dtype, device,
          n_micro: int, loss_fn: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
          ) -> Tuple[Optional[List[torch.Tensor]], Optional[List[torch.Tensor]]]:
    """Run ``n_micro`` micro-batches through this rank's stage.

    ``inputs`` (stage 0 only): each micro-batch's (x, side), x of ``shape``
    and ``dtype``, side (``shape[:2]``, ``side_dtype``) its side input;
    ``stage_fn(x, side)`` returns a tensor like x.

    Without ``loss_fn`` (a forward): returns (the last stage's outputs,
    None), None elsewhere. With it (training): the last stage's
    ``loss_fn(y, m)`` is micro-batch m's scalar loss, the schedule runs the
    backward too, and it returns (the last stage's detached losses, stage
    0's gradients of its x's); None where a stage has neither."""
    stage, stages = mesh.pp_rank(), mesh.pp_size()
    first, last = stage == 0, stage == stages - 1
    train = loss_fn is not None
    xs, ys, outs = [], [], []
    for m in range(n_micro):
        if first:
            x, side = inputs[m]
        else:
            x = recv(shape, dtype, device, stage - 1)
            side = recv(shape[:2], side_dtype, device, stage - 1)
        if train and not first:
            x.requires_grad_(True)
        y = stage_fn(x, side)
        if not last:
            send(y, stage + 1)
            send(side, stage + 1)
        xs.append(x)
        ys.append(y)
        outs.append(loss_fn(y, m) if train and last else y)
    if not train:
        return (outs if last else None), None
    losses = [o.detach() for o in outs] if last else None
    for m in reversed(range(n_micro)):
        if last:
            outs[m].backward()
        else:
            torch.autograd.backward(ys[m], recv(shape, dtype, device, stage + 1))
        ys[m] = outs[m] = None  # free the micro-batch's graph
        if not first:
            grad = xs[m].grad
            send(grad if grad is not None else torch.zeros(shape, dtype=dtype, device=device),
                 stage - 1)
    return losses, ([x.grad for x in xs] if first else None)
