"""Data parallelism over ``torch.distributed``: one process a rank.

Counterpart of ``msr3d_tpu/parallel/mesh.py``. JAX lays one mesh over the
devices and lets XLA insert the collectives; here each rank is a process
that holds the whole model, loads its own shard of the data and averages
the trainable gradients with the others (``trainer/train_state.py``).

The env contract is torch's own, as ``torchrun`` and the port's launcher
(``msr3d_tpu_torch/launch.py``) set it: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``.
``MSR3D_DIST_TIMEOUT_S`` sets the process group's timeout in seconds
(torch's default when unset); a rank that cannot reach the group raises
after it.

The backend is a rule, not a knob: ``nccl`` when each rank of a node has a
card of its own, ``gloo`` when ranks share a card (NCCL refuses two ranks on
one device) and on the CPU. Beside the default group a ``gloo`` group over
the same ranks carries the host-side traffic (object gathers, barriers,
flags), so none of it waits on a card; with a ``gloo`` default group it is
that group.

tp, pp and sp above 1 are not ported: ``data_parallel_size`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

_NOT_PORTED = "ROADMAP.md, queue: parallelism"
_CONTROL_GROUP = None  # the gloo group of host-side collectives, once initialised


def data_parallel_size(parallel: Mapping) -> int:
    """dp over the ranks of the group: every rank, as JAX's ``MeshConfig``
    resolves ``dp=-1`` at tp = pp = sp = 1. ``parallel`` is the config's
    ``parallel`` section; tp, pp and sp above 1 raise (not ported)."""
    for axis in ("tp", "pp", "sp"):
        if int(parallel.get(axis, 1)) > 1:
            raise NotImplementedError(f"parallel.{axis} > 1 is not ported yet ({_NOT_PORTED})")
    return world_size()


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if _initialised() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if _initialised() else 0


def is_main_process() -> bool:
    """Rank 0: the one rank that writes the run's files."""
    return rank() == 0


def backend_for(device_type: str, local_world_size: int, device_count: int) -> str:
    """``nccl`` when each of the node's ranks has a card of its own, else
    ``gloo`` (ranks that share a card, or the CPU)."""
    if device_type == "cuda" and 0 < local_world_size <= device_count:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device) -> torch.device:
    """The rank's device: ``cuda:(LOCAL_RANK % device_count)`` for CUDA,
    the device as it is otherwise."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def initialize_distributed_from_env(device_type: str = "cuda",
                                    timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group the env contract describes; ``False`` (and
    nothing done) when ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
    are unset. ``device_type`` is the device the run computes on; for
    ``cuda`` the rank's card becomes the current device."""
    env = os.environ
    if not all(env.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return False
    world = int(env["WORLD_SIZE"])
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = backend_for(device_type, int(env.get("LOCAL_WORLD_SIZE", world)), count)
    if timeout is None and env.get("MSR3D_DIST_TIMEOUT_S"):
        timeout = datetime.timedelta(seconds=float(env["MSR3D_DIST_TIMEOUT_S"]))
    kw = {} if timeout is None else {"timeout": timeout}
    if device_type == "cuda":
        device = rank_device(torch.device("cuda"))
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            world_size=world, rank=int(env["RANK"]), **kw)
    global _CONTROL_GROUP
    _CONTROL_GROUP = (dist.group.WORLD if backend == "gloo"
                      else dist.new_group(backend="gloo", **({"timeout": timeout} if timeout else {})))
    return True


def destroy() -> None:
    """Leave the process group (after ``initialize_distributed_from_env``)."""
    global _CONTROL_GROUP
    _CONTROL_GROUP = None
    if _initialised():
        dist.destroy_process_group()


def _control_group():
    # a group set up by someone else (a test, torchrun's caller) gets its
    # gloo twin at first use
    global _CONTROL_GROUP
    if _CONTROL_GROUP is None:
        _CONTROL_GROUP = (dist.group.WORLD if dist.get_backend() == "gloo"
                          else dist.new_group(backend="gloo"))
    return _CONTROL_GROUP


def process_allgather_objects(objs: list) -> list:
    """Every rank's ``objs``, rank 0's first, then rank 1's, and so on (the
    JAX package's order); the identity with one process. Pickles: the
    objects are the program's own."""
    n = world_size()
    if n == 1:
        return list(objs)
    gathered: List[Optional[list]] = [None] * n
    dist.all_gather_object(gathered, list(objs), group=_control_group())
    return [obj for part in gathered for obj in part]


def barrier() -> None:
    """Wait for every rank (a no-op with one process)."""
    if world_size() > 1:
        dist.barrier(group=_control_group())


def all_reduce_max(values: Sequence[int]) -> List[int]:
    """The elementwise max of ``values`` over the ranks, on the host."""
    if world_size() == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_control_group())
    return t.tolist()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place through the default group; a CUDA
    tensor under ``gloo`` (ranks sharing a card) goes through the host."""
    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def tensors_digest(tensors: Mapping[str, torch.Tensor]) -> str:
    """sha256 over the names and the bytes of ``tensors`` in name order."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(t.reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def check_replicas_equal(tensors: Mapping[str, torch.Tensor], what: str) -> str:
    """Raise unless ``tensors`` are bit-equal on every rank (one gather of a
    digest); returns the digest."""
    digest = tensors_digest(tensors)
    digests = process_allgather_objects([digest])
    if len(set(digests)) > 1:
        raise RuntimeError(f"{what} differ between ranks: digests {digests}")
    return digest
