"""ctypes binding of the native point-cloud preprocessing library.

Counterpart of ``msr3d_tpu/data/native.py``: the same C++ source,
``native/preprocess.cc`` (a fused rotate → center/size → resample →
unit-sphere normalize pass over a scene's objects), compiled with ``g++``
at first use. The port builds its own copy into ``build/native/`` at the
repository root (never into ``native/``), named by a hash of the source and
the flags, as ``ops/_build.py`` names the CUDA kernels; an edited source is
rebuilt, an unchanged one loaded as it is. On a host without a compiler
``available()`` is False and the datasets take their numpy path, as in the
JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC = _REPO_ROOT / "native" / "preprocess.cc"
BUILD_DIR = _REPO_ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmsr3d_data-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not SRC.exists():
            _load_failed = True
            return None
        out = library_path()
        if not out.exists() and not _build(out):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _load_failed = True
            return None
        lib.msr3d_preprocess_objects.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # pcds
            ctypes.POINTER(ctypes.c_int64),   # offsets
            ctypes.c_int64,                   # n_objs
            ctypes.c_int64,                   # num_points
            ctypes.POINTER(ctypes.c_float),   # rot or NULL
            ctypes.c_uint64,                  # seed
            ctypes.POINTER(ctypes.c_float),   # out_fts
            ctypes.POINTER(ctypes.c_float),   # out_locs
        ]
        lib.msr3d_preprocess_objects.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def preprocess_objects(
    obj_pcds: List[np.ndarray],
    num_points: int,
    rot_matrix: Optional[np.ndarray],
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused rotate + stats + resample + normalize of (Ni, 6) clouds →
    (obj_fts (O, num_points, 6), obj_locs (O, 6)). Raises RuntimeError when
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native preprocessing library unavailable")

    n_objs = len(obj_pcds)
    offsets = np.zeros(n_objs + 1, np.int64)
    for i, p in enumerate(obj_pcds):
        offsets[i + 1] = offsets[i] + len(p)
    flat = (
        np.concatenate([np.ascontiguousarray(p, np.float32) for p in obj_pcds])
        if n_objs
        else np.zeros((0, 6), np.float32)
    )
    out_fts = np.empty((n_objs, num_points, 6), np.float32)
    out_locs = np.empty((n_objs, 6), np.float32)

    rot_ptr = None
    if rot_matrix is not None:
        rot = np.ascontiguousarray(rot_matrix, np.float32)
        rot_ptr = rot.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    lib.msr3d_preprocess_objects(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_objs,
        num_points,
        rot_ptr,
        np.uint64(seed),
        out_fts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_locs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out_fts, out_locs
