"""The port's sharded ``DataLoader`` against the JAX package's
(``msr3d_tpu/data/build.py``): every shard's order, ``len`` and
``padded_tail`` equal JAX's over a grid of split lengths, shard counts,
batch sizes, shuffle, ``drop_last`` and seeds; the shards cover a split
exactly once after the eval duplicates are dropped (as
``tests/test_multihost.py`` checks JAX's); and ``build_dataloader_leo``
under a real two-rank gloo group gives each rank its shard."""

import numpy as np
import pytest

from msr3d_tpu.data.build import DataLoader as JaxDataLoader
from msr3d_tpu_torch.data.build import DataLoader

import torch_dp_worker as worker

SPLITS = (1, 2, 5, 10, 12, 13)
BATCHES = (1, 2, 3)
SEEDS = (7, 42)


class _Toy:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"sample_id": i}


def _orders(loader):
    return [[d["sample_id"] for d in b] for b in loader]


@pytest.mark.parametrize("drop_last", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_shards_equal_jax(k, shuffle, drop_last):
    for n in SPLITS:
        for batch in BATCHES:
            for seed in SEEDS:
                covered = []
                for s in range(k):
                    kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=seed,
                              prefetch=0, num_shards=k, shard_id=s)
                    got, want = DataLoader(_Toy(n), **kw), JaxDataLoader(_Toy(n), **kw)
                    case = (n, k, s, batch, shuffle, drop_last, seed)
                    assert len(got) == len(want) == len(_orders(got)), case
                    assert got.padded_tail == want.padded_tail, case
                    assert got._shard_samples() == want._shard_samples(), case
                    if drop_last or n >= k - n % k:
                        assert got._indices() == want._indices(), case
                        assert _orders(got) == _orders(want), case
                    else:  # JAX's pad falls short (test_jax_pad_falls_short_of_a_tiny_split);
                        # what it yields, the port's shard yields first
                        assert got._indices()[:len(want._indices())] == want._indices(), case
                    ids = [i for b in _orders(got) for i in b]
                    covered.extend(ids[:len(ids) - got.padded_tail])
                if drop_last:  # disjoint shards, the global tail dropped
                    assert len(set(covered)) == len(covered)
                else:  # every sample exactly once after the trim
                    assert sorted(covered) == list(range(n)), (n, k, batch)


def test_shards_interleave_one_global_order():
    for n, k in ((12, 4), (13, 3)):
        full = [i for b in _orders(DataLoader(_Toy(n), batch_size=1, shuffle=True, seed=7,
                                              prefetch=0)) for i in b]
        shards = [[i for b in _orders(DataLoader(_Toy(n), batch_size=1, shuffle=True, seed=7,
                                                 prefetch=0, num_shards=k, shard_id=s))
                   for i in b] for s in range(k)]
        assert [shards[j % k][j // k] for j in range(n)] == full
    with pytest.raises(ValueError, match="shard_id"):
        DataLoader(_Toy(3), num_shards=2, shard_id=2)


def test_jax_pad_falls_short_of_a_tiny_split():
    """A split shorter than its wrap-pad (1 sample, 3 shards): JAX's loader
    pads with ``idx[:k - n % k]``, one sample short, so its shard 2 yields
    no batch against a ``len`` of 1, and a rank would wait on a collective
    that another never reaches. The port repeats the order instead: every
    shard yields its ``len``, each a duplicate where ``padded_tail`` says."""
    jax_shard = JaxDataLoader(_Toy(1), batch_size=1, prefetch=0, num_shards=3, shard_id=2)
    assert len(jax_shard) == 1 and _orders(jax_shard) == []
    for s in range(3):
        shard = DataLoader(_Toy(1), batch_size=1, prefetch=0, num_shards=3, shard_id=s)
        assert _orders(shard) == [[0]] and len(shard) == 1
        assert shard.padded_tail == (0 if s == 0 else 1)


def test_prefetch_keeps_the_shard():
    kw = dict(batch_size=2, shuffle=True, seed=3, num_shards=3, shard_id=1)
    want = _orders(DataLoader(_Toy(11), prefetch=0, **kw))
    assert want == _orders(JaxDataLoader(_Toy(11), prefetch=0, **kw))
    assert _orders(DataLoader(_Toy(11), prefetch=2, **kw)) == want


def test_build_dataloader_leo_takes_the_ranks_shard(tmp_path):
    cfg = {"rng_seed": 5, "toy_len": {"train": 9, "val": 7}}
    splits = {"train": {"batchsize": 2}, "val": {"batchsize": 2}}
    outs = worker.run_ranks({"kind": "loaders", "cfg": cfg, "splits": splits}, tmp_path)
    for r, out in enumerate(outs):
        assert out["rank"] == r
        for split, got in out["loaders"].items():
            train = split == "train"
            want = JaxDataLoader(_Toy(cfg["toy_len"][split]), batch_size=2, shuffle=train,
                                 drop_last=train, seed=5, prefetch=0, num_shards=2, shard_id=r)
            assert (got["num_shards"], got["shard_id"]) == (2, r)
            assert got["order"] == _orders(want)
            assert got["len"] == len(want) and got["padded_tail"] == want.padded_tail
    # train: 9 → 8 samples, 4 a rank; val: 7 → 8 with one duplicate on rank 1
    assert [len(o["loaders"]["train"]["order"]) for o in outs] == [2, 2]
    assert [o["loaders"]["val"]["padded_tail"] for o in outs] == [0, 1]
    seen = [i for o in outs for b in o["loaders"]["train"]["order"] for i in b]
    assert len(set(seen)) == 8
    val = [[i for b in o["loaders"]["val"]["order"] for i in b] for o in outs]
    assert sorted(val[0] + val[1][:-1]) == list(range(7))
    np.testing.assert_equal(len(val[0]), len(val[1]))
