"""The process mesh over ``torch.distributed``: one process a rank, dp × tp.

Counterpart of ``msr3d_tpu/parallel/mesh.py``. JAX lays one mesh over the
devices and lets XLA insert the collectives; here each rank is a process.
``MeshConfig.resolve`` is JAX's arithmetic (dp is what tp·pp·sp leave of
the ranks), and the ranks are laid out as JAX reshapes its device array,
``(dp, tp, pp, sp)``: tp is the fastest-varying rank index, so rank
``d·tp + t`` is tp rank ``t`` of dp group ``d``. ``init_mesh`` builds a tp
group over each run of ``tp`` consecutive ranks and a dp group over the
ranks that share a tp index. Each dp rank loads its own shard of the data
and averages the trainable gradients over its dp group
(``trainer/train_state.py``); the tp ranks of one dp group hold one shard
each of the LLM's weights (``parallel/sharding.py``) and meet in the
collectives of ``parallel/tensor_parallel.py``.

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
that group. The dp and tp groups take the default group's backend, each
with a gloo twin for its host-side traffic when that backend is ``nccl``.

pp and sp above 1 are not ported: ``MeshConfig.resolve`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_NOT_PORTED = "ROADMAP.md, queue: parallelism"
_CONTROL_GROUP = None  # the gloo group of host-side collectives, once initialised


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The config's ``parallel`` axes; ``dp = -1`` takes what the others leave."""

    dp: int = -1
    tp: int = 1
    pp: int = 1
    sp: int = 1

    @classmethod
    def from_parallel(cls, parallel: Optional[Mapping]) -> "MeshConfig":
        """The config's ``parallel`` section (tp, pp, sp; dp inferred, as the
        JAX trainer builds its mesh)."""
        parallel = parallel or {}
        return cls(tp=int(parallel.get("tp", 1)), pp=int(parallel.get("pp", 1)),
                   sp=int(parallel.get("sp", 1)))

    def resolve(self, n_ranks: int) -> Tuple[int, int, int, int]:
        """(dp, tp, pp, sp) over ``n_ranks``, as JAX's ``MeshConfig.resolve``
        computes it; pp and sp above 1 raise (not ported)."""
        for axis in ("pp", "sp"):
            if getattr(self, axis) > 1:
                raise NotImplementedError(
                    f"parallel.{axis} > 1 is not ported yet ({_NOT_PORTED})")
        tp, pp, sp, dp = self.tp, self.pp, self.sp, self.dp
        if min(tp, pp, sp) < 1:
            raise ValueError(f"mesh axes must be >= 1, got tp={tp} pp={pp} sp={sp}")
        if dp == -1:
            if n_ranks % (tp * pp * sp):
                raise ValueError(f"{n_ranks} ranks not divisible by tp*pp*sp={tp * pp * sp}")
            dp = n_ranks // (tp * pp * sp)
        if dp * tp * pp * sp != n_ranks:
            raise ValueError(f"mesh {dp}x{tp}x{pp}x{sp} != {n_ranks} ranks")
        return dp, tp, pp, sp


@dataclasses.dataclass(frozen=True)
class _Mesh:
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: object  # the compute group of this rank's dp ranks
    tp_group: object
    dp_control: object  # its gloo twin (the group itself under gloo)
    tp_control: object


_MESH: Optional[_Mesh] = None  # set by init_mesh


def data_parallel_size(parallel: Optional[Mapping]) -> int:
    """dp over the ranks of the group, as JAX's ``MeshConfig`` resolves it
    from the config's ``parallel`` section; pp and sp above 1 raise."""
    return MeshConfig.from_parallel(parallel).resolve(world_size())[0]


def init_mesh(parallel: Optional[Mapping]) -> Tuple[int, int]:
    """Resolve the config's ``parallel`` section over the ranks and build the
    dp and tp groups (every rank builds every group, in one order); returns
    (dp, tp). Idempotent for one layout; another layout raises."""
    global _MESH
    dp, tp, _, _ = MeshConfig.from_parallel(parallel).resolve(world_size())
    if _MESH is not None:
        if (_MESH.dp, _MESH.tp) != (dp, tp):
            raise RuntimeError(f"the mesh is dp={_MESH.dp} x tp={_MESH.tp} already, "
                               f"not dp={dp} x tp={tp}")
        return dp, tp
    r = rank()
    if world_size() == 1:  # nothing to build: dp = tp = 1
        return dp, tp
    gloo = dist.get_backend() == "gloo"

    def groups(ranks_list):
        mine = None
        for ranks in ranks_list:
            compute = dist.new_group(ranks)
            control = compute if gloo else dist.new_group(ranks, backend="gloo")
            if r in ranks:
                mine = (compute, control)
        return mine

    tp_ranks, dp_ranks = mesh_groups(dp, tp)
    tp_groups, dp_groups = groups(tp_ranks), groups(dp_ranks)
    _MESH = _Mesh(dp, tp, r // tp, r % tp, dp_groups[0], tp_groups[0], dp_groups[1],
                  tp_groups[1])
    return dp, tp


def mesh_groups(dp: int, tp: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The ranks of each tp group (the rows of JAX's (dp, tp) device array:
    ``tp`` consecutive ranks) and of each dp group (its columns: the ranks
    of one tp index)."""
    return ([list(range(d * tp, (d + 1) * tp)) for d in range(dp)],
            [list(range(t, dp * tp, tp)) for t in range(tp)])


def _mesh() -> _Mesh:
    return _MESH if _MESH is not None else _Mesh(world_size(), 1, rank(), 0, None, None,
                                                 None, None)


def dp_size() -> int:
    """Ranks in this rank's dp group (every rank before ``init_mesh``)."""
    return _mesh().dp


def dp_rank() -> int:
    """This rank's index in its dp group."""
    return _mesh().dp_rank


def tp_size() -> int:
    """Ranks in this rank's tp group (1 before ``init_mesh``)."""
    return _mesh().tp


def tp_rank() -> int:
    """This rank's index in its tp group."""
    return _mesh().tp_rank


def tp_group():
    """The tp group's compute group (None at tp = 1)."""
    return _mesh().tp_group if tp_size() > 1 else None


def dp_group():
    """The dp group's compute group: the default group at tp = 1."""
    m = _mesh()
    return m.dp_group if m.tp > 1 else None


def dp_control_group():
    """The gloo group of the dp ranks' host-side traffic (None with one
    process)."""
    if world_size() == 1:
        return None
    m = _mesh()
    return m.dp_control if m.tp > 1 else _control_group()


def tp_control_group():
    """The gloo group of the tp ranks' host-side traffic."""
    return _mesh().tp_control


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
    global _CONTROL_GROUP, _MESH
    _CONTROL_GROUP = _MESH = None
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


def process_allgather_objects(objs: list, group=None) -> list:
    """Every rank's ``objs``, rank 0's first, then rank 1's, and so on (the
    JAX package's order), over ``group`` (a gloo group; every rank when
    None); the identity with one process. Pickles: the objects are the
    program's own."""
    n = world_size() if group is None else dist.get_world_size(group)
    if n == 1:
        return list(objs)
    gathered: List[Optional[list]] = [None] * n
    dist.all_gather_object(gathered, list(objs), group=group or _control_group())
    return [obj for part in gathered for obj in part]


def tp_broadcast_object(obj):
    """Tp rank 0's ``obj`` on every rank of its tp group (the identity at tp
    = 1): the tp ranks of a dp group must compute on the same batch, and a
    loader draws its points and answers from each process's own global
    generators."""
    m = _mesh()
    if m.tp == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=m.dp_rank * m.tp, group=m.tp_control)
    return box[0]


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


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group``'s ranks (the default group when None) in
    place; a CUDA tensor under ``gloo`` (ranks sharing a card) goes through
    the host."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
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


def check_replicas_equal(tensors: Mapping[str, torch.Tensor], what: str,
                         group=None) -> str:
    """Raise unless ``tensors`` are bit-equal on every rank of ``group`` (a
    gloo group; every rank when None), by one gather of a digest; returns
    the digest."""
    digest = tensors_digest(tensors)
    digests = process_allgather_objects([digest], group)
    if len(set(digests)) > 1:
        raise RuntimeError(f"{what} differ between ranks: digests {digests}")
    return digest
