"""Dataset and data-loader builders from the YAML task table.

Counterpart of ``msr3d_tpu/data/build.py``: ``build_dataloader_leo(cfg,
dataset_name, wrapper_name, wrapper_args, loader_args, split)`` builds the
dataset, chains the wrapper and returns a host ``DataLoader`` (a seeded
shuffling sampler, the wrapper's collate, a prefetch thread or fork
workers); ``build_task_loaders(cfg)`` builds every task × split loader.

The loaders yield numpy and strings and never touch CUDA: the trainer moves
each batch to the card. With ``torch.distributed`` initialised over more
than one dp rank each dp rank's loader takes its own shard of the split
(``num_shards``/``shard_id``, below); the tp ranks of one dp group load the
same rows. The JAX package's ``grain`` backend
is not ported.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from msr3d_tpu_torch.data.datasets import dataset_wrapper as _dw  # noqa: F401 (registers)
from msr3d_tpu_torch.data.datasets import default as _default  # noqa: F401 (registers)
from msr3d_tpu_torch.data.datasets import msr3d as _msr3d  # noqa: F401 (registers)
from msr3d_tpu_torch.data.datasets import nmr as _nmr  # noqa: F401 (registers)
from msr3d_tpu_torch.data.datasets import one_step_navi as _osn  # noqa: F401 (registers)
from msr3d_tpu_torch.data.datasets import scannet_legacy as _legacy  # noqa: F401 (registers)
from msr3d_tpu_torch.data.datasets import scannet_mv as _mv  # noqa: F401 (registers)
from msr3d_tpu_torch.data.datasets import sqa3d as _sqa  # noqa: F401 (registers)
from msr3d_tpu_torch.parallel.mesh import dp_rank, dp_size
from msr3d_tpu_torch.registry import DATASET_REGISTRY, DATASETWRAPPER_REGISTRY

# worker-process globals (fork start method: the dataset is inherited by
# reference, never pickled)
_WORKER_DATASET = None
_WORKER_COLLATE = None


def _worker_init(dataset, collate_fn):
    global _WORKER_DATASET, _WORKER_COLLATE
    _WORKER_DATASET = dataset
    _WORKER_COLLATE = collate_fn


def _worker_load(chunk: List[int]):
    return _WORKER_COLLATE([_WORKER_DATASET[i] for i in chunk])


class DataLoader:
    """Host data loader: sampler + collate, with a prefetch thread
    (``prefetch`` batches ahead) or ``num_workers`` fork workers.

    The order is ``np.random.default_rng(seed + epoch)``'s permutation when
    ``shuffle`` (``epoch`` stays 0 unless ``set_epoch`` is called, as in
    the JAX trainer); ``drop_last`` drops the short tail batch. An iterator
    left early stops its prefetch thread.

    Sharded (``num_shards`` > 1, one shard a rank): every rank draws the
    same global order and takes the strided slice ``shard_id::num_shards``
    of it, as torch's ``DistributedSampler`` and the JAX loader do. Train
    (``drop_last``) truncates the order to a multiple of ``num_shards``;
    eval wrap-pads it to one, and ``padded_tail`` says how many of this
    shard's last samples are wrap-around duplicates (0 or 1), which the
    eval loop drops. So every shard yields the same number of batches, and
    no rank waits on a collective that another never reaches.
    """

    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = False,
                 drop_last: bool = False, collate_fn=None, seed: int = 42,
                 prefetch: int = 2, num_workers: int = 0, num_shards: int = 1,
                 shard_id: int = 0):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside num_shards {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or (lambda x: x)
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_id = shard_id

    def _shard_samples(self) -> int:
        """Samples this shard yields an epoch (the same for every shard)."""
        n = len(self.dataset)
        if self.num_shards <= 1:
            return n
        if self.drop_last:
            return n // self.num_shards
        return -(-n // self.num_shards)

    @property
    def padded_tail(self) -> int:
        """How many of this shard's last samples are wrap-around duplicates."""
        n = len(self.dataset)
        if self.num_shards <= 1 or self.drop_last or n % self.num_shards == 0:
            return 0
        return 1 if self.shard_id >= n % self.num_shards else 0

    def __len__(self) -> int:
        n = self._shard_samples()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> List[int]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        k = self.num_shards
        if k > 1:
            if self.drop_last:
                idx = idx[:(n // k) * k]
            elif n % k:
                # the order repeated from its start; JAX's loader pads with
                # idx[:k - n % k], which falls short when n < k - n % k
                idx = np.resize(idx, -(-n // k) * k)
            idx = idx[self.shard_id::k]
        return idx.tolist()

    def _batches(self) -> Iterator[List[int]]:
        idx = self._indices()
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _load(self, chunk: List[int]):
        return self.collate_fn([self.dataset[i] for i in chunk])

    def __iter__(self):
        if self.num_workers > 0:
            yield from self._iter_workers()
            return
        if self.prefetch <= 0:
            for chunk in self._batches():
                yield self._load(chunk)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # an exception reaches the consumer: a dead producer must not
            # end the epoch early in silence
            try:
                for chunk in self._batches():
                    if not put(self._load(chunk)):
                        return
                put(sentinel)
            except BaseException as exc:  # noqa: BLE001 (re-raised below)
                put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def _iter_workers(self):
        """Fork workers, each loading and collating whole batches; ``imap``
        keeps the batch order. The workers inherit the dataset and the
        global generators as they are at the fork."""
        ctx = multiprocessing.get_context("fork")
        with ctx.Pool(self.num_workers, initializer=_worker_init,
                      initargs=(self.dataset, self.collate_fn)) as pool:
            yield from pool.imap(_worker_load, self._batches())


def build_dataloader_leo(cfg, dataset_name: str, dataset_wrapper_name: str,
                         dataset_wrapper_args, dataloader_args, split: str) -> DataLoader:
    """Build the dataset, chain the wrapper, and a DataLoader with the
    wrapper's collate (shuffled and dropping the tail for ``train``); with
    more than one rank, this rank's shard of it."""
    if dataloader_args.get("backend", "") == "grain":
        raise NotImplementedError("the grain loader backend is not ported")
    dataset = DATASET_REGISTRY.get(dataset_name)(cfg, split)
    wrapper = dataset
    if dataset_wrapper_name:
        wrapper = DATASETWRAPPER_REGISTRY.get(dataset_wrapper_name)(
            cfg, dataset, dataset_wrapper_args)
    shards = {}
    if dp_size() > 1:  # by dp rank: the tp ranks of a dp group load the same rows
        shards = dict(num_shards=dp_size(), shard_id=dp_rank())
    return DataLoader(
        wrapper,
        batch_size=dataloader_args.get("batchsize", 4),
        shuffle=(split == "train"),
        drop_last=(split == "train"),
        collate_fn=getattr(wrapper, "collate_fn", None),
        seed=int(cfg.get("rng_seed", 42)),
        num_workers=dataloader_args.get("num_workers", 0),
        **shards,
    )


def build_task_loaders(cfg) -> Dict[str, Dict[str, DataLoader]]:
    """Every task × split loader of the config's task table: ``train``
    modes get train loaders, ``val``/``test`` modes eval loaders."""
    loaders: Dict[str, Dict[str, DataLoader]] = {}
    for task_name, task_cfg in cfg.get("task", {}).items():
        modes = list(task_cfg.get("mode", []))
        wrapper_name = task_cfg.get("dataset_wrapper", "")
        wrapper_args = task_cfg.get("dataset_wrapper_args", {})
        loaders[task_name] = {}
        for mode in modes:
            args_key = "train_dataloader_args" if mode == "train" else "eval_dataloader_args"
            loader_args = task_cfg.get(args_key, {"batchsize": 4})
            loaders[task_name][mode] = build_dataloader_leo(
                cfg, task_cfg.dataset, wrapper_name, wrapper_args, loader_args, mode)
    return loaders
