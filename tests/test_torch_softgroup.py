"""Parity of the port's host geometry (``msr3d_tpu_torch/ops/host_geometry.py``)
and SoftGroup ops (``msr3d_tpu_torch/ops/softgroup.py``) with the JAX
package.

Host functions: the port's native path, its numpy path and the JAX
package's (native) give equal arrays, on inputs with ties (lattice points
at equal distances), short batches and a batch without support. Device
functions: the same numpy inputs through torch on the CPU and through JAX,
forward and, for ``voxelization`` and ``global_avg_pool``, the gradient of
a random cotangent. Tolerances: counts, indices and labels equal; fp32
values within 1e-6 relative to their scale (sums of a few terms in another
order).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msr3d_tpu.ops.host_geometry as jhg
from msr3d_tpu.ops import softgroup as jsg
from msr3d_tpu_torch.ops import host_geometry as hg
from msr3d_tpu_torch.ops import softgroup as sg

TOL = 1e-6


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    scale = max(1.0, float(np.abs(want[fin]).max(initial=0.0)))
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol * scale)
    np.testing.assert_array_equal(got[~fin], want[~fin])


def three_ways(fn_name, *args):
    """The port's native and numpy results and the JAX package's, each
    equal to the first."""
    assert hg.native_loaded() and jhg.get_lib() is not None
    native = getattr(hg, fn_name)(*args)
    with mock.patch.object(hg, "get_lib", lambda: None):
        plain = getattr(hg, fn_name)(*args)
    jax_out = getattr(jhg, fn_name)(*args)
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    for out in (plain, jax_out):
        for a, b in zip(as_tuple(native), as_tuple(out), strict=True):
            np.testing.assert_array_equal(a, b)
    return native


def lattice_points(rng, n, batches):
    """Points on a coarse lattice (many equal distances) in ``batches``."""
    xyz = rng.integers(0, 4, (n, 3)).astype(np.float32) * 0.5
    batch = np.sort(rng.integers(0, batches, n)).astype(np.int32)
    return xyz, batch


# ---------------------------------------------------------------------------
# host geometry


def test_group_rows_and_pad_groups():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(0, 2, (300, 1)), rng.integers(-3, 3, (300, 3))], 1)
    group_of, m = three_ways("group_rows", keys)
    assert m < 300 and group_of[0] == 0 and np.all(np.diff(np.maximum.accumulate(group_of)) <= 1)
    np.testing.assert_array_equal(hg.pad_groups(group_of, m), jhg.pad_groups(group_of, m))
    assert hg.group_rows(np.zeros((0, 4), np.int64))[1] == 0


def test_conv_neighbors():
    rng = np.random.default_rng(1)
    coords = np.unique(np.concatenate([rng.integers(0, 2, (200, 1)),
                                       rng.integers(0, 6, (200, 3))], 1), axis=0)
    rng.shuffle(coords)
    offsets = np.array([(dx, dy, dz) for dx in (-2, 0, 2) for dy in (-2, 0, 2)
                        for dz in (-2, 0, 2)], np.int64)
    out = three_ways("conv_neighbors", coords, offsets)
    assert (out[:, 13] == np.arange(len(coords))).all() and (out == -1).any()


@pytest.mark.parametrize("k", [1, 5, 40])
def test_knn_ties_short_batches_and_empty_support(k):
    """Lattice ties resolved by the lower index; a batch of fewer than k
    points repeats the nearest; a query batch without support gives -1."""
    rng = np.random.default_rng(2 + k)
    s_xyz, s_batch = lattice_points(rng, 60, 2)
    q_xyz, q_batch = lattice_points(rng, 25, 3)  # batch 2 has no support
    out = three_ways("knn", q_xyz, q_batch, s_xyz, s_batch, k)
    assert (out[q_batch == 2] == -1).all() and (out[q_batch < 2] >= 0).all()


def test_ballquery_and_bfs_components():
    rng = np.random.default_rng(3)
    xyz, batch = lattice_points(rng, 120, 3)
    offsets = np.searchsorted(batch, np.arange(4)).astype(np.int64)
    idx, start_len = three_ways("ballquery_packed", xyz, batch, offsets, 0.6)
    assert start_len[:, 1].min() >= 1  # self included
    order, comp = three_ways("bfs_components", idx, start_len)
    assert sorted(order.tolist()) == list(range(120)) and comp[-1] == 120


# ---------------------------------------------------------------------------
# host plans of SoftGroup


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_voxelization_idx(mode):
    rng = np.random.default_rng(10 + mode)
    coords = np.concatenate([rng.integers(0, 2, (80, 1)), rng.integers(0, 3, (80, 3))], 1)
    if mode == 0:  # unique coords, in no sorted order
        coords = np.unique(coords[:, 1:], axis=0)
        coords = coords[rng.permutation(len(coords))]
    for c in (coords, coords[:, 1:]) if mode else (coords,):
        for a, b in zip(sg.voxelization_idx(c, 2, mode), jsg.voxelization_idx(c, 2, mode)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ballquery_batch_p_and_bfs_cluster():
    rng = np.random.default_rng(4)
    xyz = np.concatenate([rng.normal(size=(40, 3)) * 0.3 + c for c in (0.0, 3.0, 6.0)])
    xyz = xyz.astype(np.float32)
    batch = np.repeat([0, 0, 1], 40).astype(np.int32)
    offsets = np.array([0, 80, 120], np.int32)
    got = sg.ballquery_batch_p(xyz, batch, offsets, 0.5)
    want = jsg.ballquery_batch_p(xyz, batch, offsets, 0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for mean, thr in (([-1.0, 5.0], 10), ([-1.0, 5.0], 1000), ([8.0, 5.0], 2.0)):
        for cls in (0, 1):
            a = sg.bfs_cluster(np.array(mean, np.float32), *got, thr, cls)
            b = jsg.bfs_cluster(np.array(mean, np.float32), *want, thr, cls)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# device functions


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_voxelization_and_its_gradient(mode):
    rng = np.random.default_rng(20 + mode)
    coords = np.concatenate([np.zeros((60, 1), np.int64), rng.integers(0, 3, (60, 3))], 1)
    feats = rng.normal(size=(60, 6)).astype(np.float32)
    _, _, output_map = sg.voxelization_idx(coords, 1, mode=mode)
    cot = rng.normal(size=(output_map.shape[0], 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jsg.voxelization(f, jnp.asarray(output_map), mode),
                        jnp.asarray(feats))
    x = T(feats).requires_grad_()
    got = sg.voxelization(x, T(output_map), mode)
    close(got, want)
    (got * T(cot)).sum().backward()
    close(x.grad, vjp(jnp.asarray(cot))[0])


def segments():
    """Packed rows in segments of 4, 0 (empty), 9 and 7."""
    rng = np.random.default_rng(30)
    return rng.normal(size=(20, 5)).astype(np.float32), np.array([0, 4, 4, 13, 20], np.int32)


def test_global_avg_pool_and_its_gradient():
    feats, offsets = segments()
    cot = np.random.default_rng(31).normal(size=(4, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jsg.global_avg_pool(f, jnp.asarray(offsets)),
                        jnp.asarray(feats))
    x = T(feats).requires_grad_()
    got = sg.global_avg_pool(x, T(offsets))
    close(got, want)
    assert (got[1] == 0).all()
    (got * T(cot)).sum().backward()
    close(x.grad, vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("fn", ["sec_mean", "sec_min", "sec_max"])
def test_segment_reductions(fn):
    """The empty segment holds the reduction's identity (inf for min, -inf
    for max, 0 for the mean), as in JAX; rows past the last offset are
    dropped."""
    feats, offsets = segments()
    for off in (offsets, np.array([0, 4, 4, 13, 18], np.int32)):
        close(getattr(sg, fn)(T(feats), T(off)), getattr(jsg, fn)(jnp.asarray(feats),
                                                                  jnp.asarray(off)))


def proposals(seed):
    """Packed proposals over 60 labelled points (-100 unlabelled), 5
    instances, one instance with no point."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, 4, 60).astype(np.int64)
    labels[labels == -1] = -100
    pointnum = np.array([np.sum(labels == i) for i in range(5)], np.int32)
    sizes = [15, 9, 1, 20]
    pidx = np.concatenate([rng.permutation(60)[:s] for s in sizes]).astype(np.int32)
    poff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return pidx, poff, labels, pointnum


def test_mask_iou_on_cluster_and_on_pred():
    pidx, poff, labels, pointnum = proposals(40)
    args = (pidx, poff, labels, pointnum)
    close(sg.get_mask_iou_on_cluster(*map(T, args)),
          jsg.get_mask_iou_on_cluster(*map(jnp.asarray, args)))
    scores = np.random.default_rng(41).uniform(size=len(pidx)).astype(np.float32)
    scores[:3] = 0.5  # on the threshold: not a member
    close(sg.get_mask_iou_on_pred(*map(T, args + (scores,))),
          jsg.get_mask_iou_on_pred(*map(jnp.asarray, args + (scores,))))


def test_get_mask_label():
    """A random IoU table with a -100 class, and the JAX tests' cases: the
    ignored class skipped, a row under the threshold, an all-zero row."""
    pidx, poff, labels, pointnum = proposals(50)
    cls = np.array([3, -100, 7, 1, 2], np.int64)
    iou = np.array(jsg.get_mask_iou_on_cluster(*map(jnp.asarray, (pidx, poff, labels,
                                                                    pointnum))))
    iou[2] = 0.0  # an all-zero row
    cases = [(pidx, poff, labels, cls, pointnum, iou, thr) for thr in (0.0, 0.1, 0.3)]
    cases.append((np.arange(6, dtype=np.int32), np.array([0, 4, 6], np.int32),
                  np.array([0, 0, 1, 1, 2, -100], np.int64), np.array([3, -100, 7], np.int64),
                  np.array([2, 2, 1], np.int32),
                  np.array([[0.6, 0.9, 0.0], [0.1, 0.2, 0.3]], np.float32), 0.5))
    cases.append((np.arange(2, dtype=np.int32), np.array([0, 2], np.int32),
                  np.array([0, 1], np.int64), np.array([3, 4], np.int64),
                  np.array([1, 1], np.int32), np.zeros((1, 2), np.float32), 0.0))
    for *args, thr in cases:
        got = sg.get_mask_label(*map(T, args), thr)
        want = jsg.get_mask_label(*map(jnp.asarray, args), thr)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sg.get_mask_label(*map(T, cases[-2][:-1]), 0.5).numpy(),
                                  [1, 1, 0, 0, -1, -1])
    np.testing.assert_array_equal(sg.get_mask_label(*map(T, cases[-1][:-1]), 0.0).numpy(),
                                  [1, 0])
