"""Host geometry plans: the repo's native C++ library, with numpy versions.

Counterpart of ``msr3d_tpu/ops/host_geometry.py``: the primitives the
sparse-voxel index plans are built from (``group_rows`` voxel and window
dedup, ``pad_groups``, ``conv_neighbors``, ``knn``, ``ballquery_packed``,
``bfs_components``). They run on the host over numpy arrays and build
*plans* for the device code of ``ops/softgroup.py`` and ``nn/swin3d.py``.

The fast path is the repo's ``native/geometry.cc``, the source the JAX
package binds, so both packages order ties alike. The port compiles its own
copy with ``g++`` at the first call into ``build/native/``, named by a hash
of the source and the flags (``data/native.py::build_library``); it never
writes into ``native/`` and never loads a library found there. Where the
build fails (no compiler) each function takes its numpy version, the JAX
package's fallback, with the same results; ``native_loaded()`` says which
ran.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from collections import deque
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from msr3d_tpu_torch.data.native import build_library

SRC = Path(__file__).resolve().parents[2] / "native" / "geometry.cc"

_logger = logging.getLogger("msr3d_tpu_torch.host_geometry")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded at the first call; None (and a
    warning, once) where it cannot be built."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build_library(SRC, "libmsr3d_geometry")))
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            _logger.warning("native geometry library unavailable (%s); using the numpy "
                            "versions (slower, same results)", exc)
            _load_failed = True
            return None
        lib.msr3d_group_rows.restype = ctypes.c_int64
        lib.msr3d_group_rows.argtypes = [_i64p, ctypes.c_int64, _i32p]
        lib.msr3d_conv_neighbors.restype = None
        lib.msr3d_conv_neighbors.argtypes = [_i64p, ctypes.c_int64, _i64p, ctypes.c_int64,
                                             _i32p]
        lib.msr3d_knn.restype = None
        lib.msr3d_knn.argtypes = [_f32p, _i32p, ctypes.c_int64, _f32p, _i32p, ctypes.c_int64,
                                  ctypes.c_int64, _i32p]
        lib.msr3d_ballquery.restype = ctypes.c_int64
        lib.msr3d_ballquery.argtypes = [_f32p, _i32p, ctypes.c_int64, _i64p, ctypes.c_int64,
                                        ctypes.c_float, ctypes.c_int32, _i32p, _i32p]
        lib.msr3d_bfs_components.restype = ctypes.c_int64
        lib.msr3d_bfs_components.argtypes = [_i32p, _i32p, ctypes.c_int64, _i32p, _i32p]
        _lib = lib
    return _lib


def native_loaded() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def group_rows(keys: np.ndarray) -> Tuple[np.ndarray, int]:
    """(n, 4) int64 keys → (group_of (n,) int32, n_groups), group ids in
    first-occurrence order."""
    keys = np.ascontiguousarray(keys, np.int64)
    n = keys.shape[0]
    lib = get_lib()
    if lib is not None and n:
        out = np.empty(n, np.int32)
        m = lib.msr3d_group_rows(_ptr(keys, _i64p), n, _ptr(out, _i32p))
        return out, int(m)
    if n == 0:
        return np.zeros(0, np.int32), 0
    _, first_idx, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    inverse = np.asarray(inverse).reshape(-1)  # numpy 2.0.x: a non-flat inverse
    # np.unique sorts; relabel so that ids follow the first occurrence
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    return remap[inverse].astype(np.int32), int(len(order))


def pad_groups(group_of: np.ndarray, n_groups: int) -> np.ndarray:
    """(n,) group ids → (n_groups, Kmax) int32 member matrix padded with
    -1, members in input order."""
    n = group_of.shape[0]
    if n_groups == 0:
        return np.zeros((0, 1), np.int32)
    counts = np.bincount(group_of, minlength=n_groups)
    kmax = max(int(counts.max()), 1)
    order = np.argsort(group_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - np.repeat(starts, counts)
    out = np.full((n_groups, kmax), -1, np.int32)
    out[group_of[order], pos] = order
    return out


def conv_neighbors(coords: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """coords (n, 4) int64, offsets (t, 3) int64 (scaled by the stride) →
    (n, t) int32 neighbour indices, -1 where absent."""
    coords = np.ascontiguousarray(coords, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n, t = coords.shape[0], offsets.shape[0]
    lib = get_lib()
    if lib is not None and n:
        out = np.empty((n, t), np.int32)
        lib.msr3d_conv_neighbors(_ptr(coords, _i64p), n, _ptr(offsets, _i64p), t,
                                 _ptr(out, _i32p))
        return out
    table = {tuple(c): i for i, c in enumerate(coords.tolist())}
    out = np.full((n, t), -1, np.int32)
    for i in range(n):
        b, x, y, z = coords[i]
        for ti, (dx, dy, dz) in enumerate(offsets.tolist()):
            j = table.get((b, x + dx, y + dy, z + dz))
            if j is not None:
                out[i, ti] = j
    return out


def knn(query_xyz: np.ndarray, query_batch: np.ndarray, support_xyz: np.ndarray,
        support_batch: np.ndarray, k: int) -> np.ndarray:
    """Per-batch brute-force kNN, nearest first, the lower index first
    among ties; short batches repeat the nearest, batches without support
    give -1. (nq, k) int32."""
    q = np.ascontiguousarray(query_xyz, np.float32)
    s = np.ascontiguousarray(support_xyz, np.float32)
    qb = np.ascontiguousarray(query_batch, np.int32)
    sb = np.ascontiguousarray(support_batch, np.int32)
    nq, ns = q.shape[0], s.shape[0]
    lib = get_lib()
    if lib is not None and nq and ns:
        out = np.empty((nq, k), np.int32)
        lib.msr3d_knn(_ptr(q, _f32p), _ptr(qb, _i32p), nq, _ptr(s, _f32p), _ptr(sb, _i32p),
                      ns, k, _ptr(out, _i32p))
        return out
    out = np.zeros((nq, k), np.int32)
    for b in np.unique(qb):
        qm = np.nonzero(qb == b)[0]
        sm = np.nonzero(sb == b)[0]
        if len(sm) == 0:
            out[qm] = -1
            continue
        d = np.linalg.norm(q[qm][:, None, :] - s[sm][None, :, :], axis=-1)
        take = np.argsort(d, axis=1, kind="stable")[:, :k]
        if take.shape[1] < k:
            take = np.concatenate([take, np.repeat(take[:, :1], k - take.shape[1], axis=1)],
                                  axis=1)
        out[qm] = sm[take]
    return out


def ballquery_packed(coords: np.ndarray, batch_idxs: np.ndarray, batch_offsets: np.ndarray,
                     radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Every same-batch neighbour with d² < r², in index order, self
    included → (idx (nActive,) int32, start_len (n, 2) int32)."""
    xyz = np.ascontiguousarray(coords, np.float32)
    bi = np.ascontiguousarray(batch_idxs, np.int32)
    bo = np.ascontiguousarray(batch_offsets, np.int64)
    n = xyz.shape[0]
    lib = get_lib()
    if lib is not None and n:
        dummy = np.zeros(1, np.int32)
        n_active = lib.msr3d_ballquery(_ptr(xyz, _f32p), _ptr(bi, _i32p), n, _ptr(bo, _i64p),
                                       len(bo) - 1, radius, 1, _ptr(dummy, _i32p),
                                       _ptr(dummy, _i32p))
        idx = np.empty(int(n_active), np.int32)
        start_len = np.empty((n, 2), np.int32)
        lib.msr3d_ballquery(_ptr(xyz, _f32p), _ptr(bi, _i32p), n, _ptr(bo, _i64p),
                            len(bo) - 1, radius, 0, _ptr(idx, _i32p), _ptr(start_len, _i32p))
        return idx, start_len
    r2 = float(radius) ** 2
    idx_chunks, start_len = [], np.zeros((n, 2), np.int32)
    cursor = 0
    for b in range(len(bo) - 1):
        s, e = int(bo[b]), int(bo[b + 1])
        seg = xyz[s:e]
        within = np.sum((seg[:, None, :] - seg[None, :, :]) ** 2, axis=-1) < r2
        for i in range(s, e):
            nbrs = s + np.nonzero(within[i - s])[0]
            start_len[i] = (cursor, len(nbrs))
            cursor += len(nbrs)
            idx_chunks.append(nbrs.astype(np.int32))
    idx = np.concatenate(idx_chunks) if idx_chunks else np.zeros(0, np.int32)
    return idx, start_len


def bfs_components(nbr_idx: np.ndarray, start_len: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Connected components of the CSR graph, seeds scanning 0..n-1,
    members in BFS dequeue order → (order (n,) int32, comp_offsets
    (n_comps + 1,) int32)."""
    nbr_idx = np.ascontiguousarray(nbr_idx, np.int32)
    start_len = np.ascontiguousarray(start_len, np.int32)
    n = start_len.shape[0]
    lib = get_lib()
    if lib is not None and n:
        order = np.empty(n, np.int32)
        offsets = np.empty(n + 1, np.int32)
        m = lib.msr3d_bfs_components(_ptr(nbr_idx, _i32p), _ptr(start_len, _i32p), n,
                                     _ptr(order, _i32p), _ptr(offsets, _i32p))
        return order, offsets[: int(m) + 1].copy()
    visited = np.zeros(n, bool)
    order, offsets = [], [0]
    for seed in range(n):
        if visited[seed]:
            continue
        visited[seed] = True
        order.append(seed)
        q = deque([seed])
        while q:
            cur = q.popleft()
            s, l = start_len[cur]
            for j in nbr_idx[s:s + l]:
                if not visited[j]:
                    visited[j] = True
                    order.append(int(j))
                    q.append(int(j))
        offsets.append(len(order))
    return np.asarray(order, np.int32), np.asarray(offsets, np.int32)
