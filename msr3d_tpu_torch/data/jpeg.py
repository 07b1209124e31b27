"""JPEG decoding of the object crops, with no image library.

``decode_jpeg`` runs ``msr3d_tpu_torch/csrc/jpeg_decode.cc``, a baseline
decoder whose output is bit-equal to Pillow's ``Image.open(p).convert("RGB")``
over libjpeg-turbo 3.1 (the accurate integer IDCT, fancy chroma upsampling,
libjpeg's YCbCr -> RGB tables). The source is compiled with ``g++`` at first
use into ``build/native/``, named by a hash of the source and the flags, as
``data/native.py`` builds its library, and bound with ``ctypes``.

There is no fallback: without ``g++``, or when the build fails, the first
call raises with the compiler's log. Files the decoder does not handle
(progressive, lossless or arithmetic-coded frames, 12-bit samples, CMYK,
subsamplings other than 4:4:4, 4:2:2 and 4:2:0) and truncated or corrupt
data raise ``ValueError`` with the file's name and the reason.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np

from msr3d_tpu_torch.data.native import build_library

SRC = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.cc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The decoder library, built and loaded at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(SRC, "libmsr3d_jpeg")))
            err = [ctypes.c_char_p, ctypes.c_int]
            lib.msr3d_jpeg_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), *err]
            lib.msr3d_jpeg_dims.restype = ctypes.c_int
            lib.msr3d_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32, ctypes.c_int32, *err]
            lib.msr3d_jpeg_decode.restype = ctypes.c_int
            _lib = lib
    return _lib


def decode_jpeg(src: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """A JPEG file (path) or its bytes -> (H, W, 3) uint8 RGB, grayscale
    replicated to three channels."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        name, data = "<bytes>", bytes(src)
    else:
        name = os.fspath(src)
        data = Path(name).read_bytes()
    lib = get_lib()
    msg = ctypes.create_string_buffer(256)
    height, width = ctypes.c_int32(), ctypes.c_int32()
    if lib.msr3d_jpeg_dims(data, len(data), ctypes.byref(height), ctypes.byref(width),
                           msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}")
    out = np.empty((height.value, width.value, 3), np.uint8)
    if lib.msr3d_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             height, width, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}")
    return out
