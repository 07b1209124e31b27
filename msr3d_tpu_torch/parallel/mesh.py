"""The process mesh over ``torch.distributed``: one process a rank, dp × tp × pp × sp.

Counterpart of ``msr3d_tpu/parallel/mesh.py``. JAX lays one mesh over the
devices and lets XLA insert the collectives; here each rank is a process.
``MeshConfig.resolve`` is JAX's arithmetic (dp is what tp·pp·sp leave of
the ranks), and the ranks are laid out as JAX reshapes its device array,
``(dp, tp, pp, sp)`` row-major: sp is the fastest-varying rank index, then
pp, then tp, then dp, so rank ``((d·tp + t)·pp + p)·sp + s`` is sp rank
``s`` of pp rank ``p`` of tp rank ``t`` of dp group ``d`` (at sp = pp = 1,
``d·tp + t``). ``init_mesh`` builds, over every rank in one order:

* an sp group over each run of ``sp`` consecutive ranks (the sequence
  blocks of one (d, t, p)), around which ring attention passes its key and
  value blocks (``parallel/ring_attention.py``);
* a pp group over the ranks of one (d, t, s), strided by sp (the stages),
  which hands activations down the pipeline (``parallel/pipeline.py``);
* a tp group over the ranks of one (d, p, s), strided by pp·sp, whose ranks
  hold one shard each of the LLM's weights (``parallel/sharding.py``) and
  meet in the collectives of ``parallel/tensor_parallel.py``;
* a dp group over the ranks of one (t, p, s), strided by tp·pp·sp, over
  which the trainable gradients are averaged (``trainer/train_state.py``);
* the model-parallel group of a dp index: its tp·pp·sp consecutive ranks,
  over which the first of them broadcasts each batch.

pp and sp together raise ``NotImplementedError``, as JAX's pipeline asserts
("pp × sp composition not supported yet", ``msr3d_tpu/parallel/llm_pp.py``).

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
that group. The dp, tp, pp, sp and model-parallel groups take the default
group's backend, each with a gloo twin for its host-side traffic when that
backend is ``nccl``.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_CONTROL_GROUP = None  # the gloo group of host-side collectives, once initialised
AXES = ("dp", "tp", "pp", "sp", "mp")  # mp: the tp·pp·sp ranks of one dp index


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
        computes it; pp and sp both above 1 raise, as JAX's pipeline does."""
        tp, pp, sp, dp = self.tp, self.pp, self.sp, self.dp
        if min(tp, pp, sp) < 1:
            raise ValueError(f"mesh axes must be >= 1, got tp={tp} pp={pp} sp={sp}")
        if dp == -1:
            if n_ranks % (tp * pp * sp):
                raise ValueError(f"{n_ranks} ranks not divisible by tp*pp*sp={tp * pp * sp}")
            dp = n_ranks // (tp * pp * sp)
        if dp * tp * pp * sp != n_ranks:
            raise ValueError(f"mesh {dp}x{tp}x{pp}x{sp} != {n_ranks} ranks")
        if pp > 1 and sp > 1:
            raise NotImplementedError(
                f"parallel.pp={pp} with parallel.sp={sp}: the JAX package's pipeline asserts "
                "'pp × sp composition not supported yet' (msr3d_tpu/parallel/llm_pp.py), and "
                "the port refuses it as well")
        return dp, tp, pp, sp


@dataclasses.dataclass(frozen=True)
class _Mesh:
    dp: int
    tp: int
    pp: int
    sp: int
    dp_rank: int
    tp_rank: int
    pp_rank: int
    sp_rank: int
    # axis → (the compute group of this rank's ranks on it, its gloo twin:
    # the group itself under gloo)
    groups: Dict[str, Tuple[object, object]]


_MESH: Optional[_Mesh] = None  # set by init_mesh


def data_parallel_size(parallel: Optional[Mapping]) -> int:
    """dp over the ranks of the group, as JAX's ``MeshConfig`` resolves it
    from the config's ``parallel`` section."""
    return MeshConfig.from_parallel(parallel).resolve(world_size())[0]


def init_mesh(parallel: Optional[Mapping]) -> Tuple[int, int]:
    """Resolve the config's ``parallel`` section over the ranks and build the
    dp, tp, pp, sp and model-parallel groups (every rank builds every group,
    in one order); returns (dp, tp). Idempotent for one layout; another
    layout raises."""
    global _MESH
    dp, tp, pp, sp = MeshConfig.from_parallel(parallel).resolve(world_size())
    if _MESH is not None:
        have = (_MESH.dp, _MESH.tp, _MESH.pp, _MESH.sp)
        if have != (dp, tp, pp, sp):
            raise RuntimeError("the mesh is dp={} x tp={} x pp={} x sp={} already, not "
                               "dp={} x tp={} x pp={} x sp={}".format(*have, dp, tp, pp, sp))
        return dp, tp
    r = rank()
    if world_size() == 1:  # nothing to build: dp = tp = pp = sp = 1
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

    layout = mesh_groups(dp, tp, pp, sp)
    sizes = {"dp": dp, "tp": tp, "pp": pp, "sp": sp, "mp": tp * pp * sp}
    # an axis of one rank needs no group (its accessors answer without one)
    mine = {axis: groups(layout[axis]) for axis in AXES if axis == "dp" or sizes[axis] > 1}
    _MESH = _Mesh(dp, tp, pp, sp, r // (tp * pp * sp), r // (pp * sp) % tp, r // sp % pp,
                  r % sp, mine)
    return dp, tp


def mesh_groups(dp: int, tp: int, pp: int = 1, sp: int = 1) -> Dict[str, List[List[int]]]:
    """axis → the ranks of each of its groups, from JAX's (dp, tp, pp, sp)
    device array (rank ``((d·tp + t)·pp + p)·sp + s``): ``tp`` the ranks of
    one (d, p, s), ``dp`` of one (t, p, s), ``pp`` of one (d, t, s), ``sp``
    of one (d, t, p), ``mp`` (the model-parallel ranks) of one d."""
    at = lambda d, t, p, s: ((d * tp + t) * pp + p) * sp + s  # noqa: E731
    cells = [(d, t, p, s) for d in range(dp) for t in range(tp) for p in range(pp)
             for s in range(sp)]

    def along(axis: int, size: int) -> List[List[int]]:
        # the groups of one axis: every other index fixed, in row-major order
        return [[at(*c[:axis], i, *c[axis + 1:]) for i in range(size)]
                for c in cells if c[axis] == 0]

    return {"tp": along(1, tp), "dp": along(0, dp), "pp": along(2, pp), "sp": along(3, sp),
            "mp": [list(range(d * tp * pp * sp, (d + 1) * tp * pp * sp)) for d in range(dp)]}


def _mesh() -> _Mesh:
    if _MESH is not None:
        return _MESH
    return _Mesh(world_size(), 1, 1, 1, rank(), 0, 0, 0, {})


def _group(axis: str, control: bool = False):
    pair = _mesh().groups.get(axis)
    return None if pair is None else pair[int(control)]


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


def pp_size() -> int:
    """Stages in this rank's pipeline (1 before ``init_mesh``)."""
    return _mesh().pp


def pp_rank() -> int:
    """This rank's stage: its index in its pp group."""
    return _mesh().pp_rank


def sp_size() -> int:
    """Sequence blocks in this rank's ring (1 before ``init_mesh``)."""
    return _mesh().sp


def sp_rank() -> int:
    """This rank's sequence block: its index in its sp group."""
    return _mesh().sp_rank


def mp_size() -> int:
    """The model-parallel ranks of a dp index: tp · pp · sp."""
    m = _mesh()
    return m.tp * m.pp * m.sp


def tp_group():
    """The tp group's compute group (None at tp = 1)."""
    return _group("tp") if tp_size() > 1 else None


def pp_group():
    """The pp group's compute group (None at pp = 1)."""
    return _group("pp") if pp_size() > 1 else None


def sp_group():
    """The sp group's compute group (None at sp = 1)."""
    return _group("sp") if sp_size() > 1 else None


def sp_control_group():
    """The gloo group of the sp ranks' host-side traffic (None at sp = 1)."""
    return _group("sp", control=True) if sp_size() > 1 else None


def pp_control_group():
    """The gloo group of the pp ranks' host-side traffic (None at pp = 1)."""
    return _group("pp", control=True) if pp_size() > 1 else None


def dp_group():
    """The dp group's compute group: the default group at tp = pp = sp = 1."""
    return _group("dp") if mp_size() > 1 else None


def dp_control_group():
    """The gloo group of the dp ranks' host-side traffic (None with one
    process)."""
    if world_size() == 1:
        return None
    return _group("dp", control=True) if mp_size() > 1 else _control_group()


def tp_control_group():
    """The gloo group of the tp ranks' host-side traffic."""
    return _group("tp", control=True)


def mp_control_group():
    """The gloo group of the model-parallel ranks of this dp index."""
    return _group("mp", control=True)


def global_rank(axis: str, index: int) -> int:
    """The rank of the ``index``-th member of this rank's ``axis`` group."""
    m = _mesh()
    at = {"dp": 0, "tp": 1, "pp": 2, "sp": 3}[axis]
    d, t, p, s = (index if i == at else v
                  for i, v in enumerate((m.dp_rank, m.tp_rank, m.pp_rank, m.sp_rank)))
    return ((d * m.tp + t) * m.pp + p) * m.sp + s


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


def broadcast_from_first(obj, axis: str = "mp"):
    """The ``obj`` of the first rank of this rank's ``axis`` group on every
    rank of it (the identity where the group has one rank). ``mp``: rank
    (d, 0, 0, 0)'s on the tp × pp × sp ranks of dp index d, which must
    compute on the same batch (a loader draws its points and answers from
    each process's own global generators); ``tp``: tp rank 0's."""
    if first_group_size(axis) == 1:
        return obj
    src = _mesh().dp_rank * mp_size() if axis == "mp" else global_rank("tp", 0)
    return broadcast_object(obj, src, _group(axis, control=True))


def first_group_size(axis: str) -> int:
    """Ranks in this rank's ``axis`` group of ``broadcast_from_first``:
    ``mp`` (the tp × pp × sp ranks of its dp index) or ``tp``."""
    return {"mp": mp_size, "tp": tp_size}[axis]()


def broadcast_object(obj, src: int, group):
    """Rank ``src``'s ``obj`` (a global rank of ``group``, a gloo group) on
    every rank of ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
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


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` by ``op`` over ``group``'s ranks (the default group when
    None) in place; a CUDA tensor under ``gloo`` (ranks sharing a card) goes
    through the host."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group``'s ranks (the default group when None) in
    place, as ``all_reduce_``."""
    return all_reduce_(t, group)


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank of ``group``) on every rank of
    ``group``, in place; a CUDA tensor under ``gloo`` goes through the host."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
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
