"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points (every pointer and
the stream as ``void*``) and is compiled on its own with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the repository root. The library
name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is. Nothing is built when a
module is imported: the first launch builds, or :func:`build_all` builds
every kernel at once with one ``nvcc`` process per source, all started
together.

Every C entry returns ``cudaGetLastError()`` after its launch; a launch
the card refused (too many threads, too much shared memory) raises here
instead of passing silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> subprocess.Popen:
    out = _library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    out = _library_path(name)
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)


def build_all(names: Iterable[str]) -> List[Path]:
    """Build every named kernel not built yet, one ``nvcc`` each, in
    parallel. Returns the library paths."""
    names = list(names)
    procs = {n: _start_build(n) for n in names if not _library_path(n).exists()}
    for n, proc in procs.items():
        _finish_build(n, proc)
    return [_library_path(n) for n in names]


def load_library(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            path = _library_path(name)
            if not path.exists():
                _finish_build(name, _start_build(name))
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]


class CudaKernel:
    """One C entry point of one ``csrc`` source, with its launch count.

    ``launches`` rises by one for each launch and nowhere else, so a run
    can show that its path went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(load_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self._bind()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.source}.cu:{self.symbol} launch failed with CUDA error {err}"
            )
        self.launches += 1
