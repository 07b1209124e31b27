"""PNG reading and writing of the NMR renders, with no image library.

``read_png`` is the counterpart of ``np.asarray(PIL.Image.open(path))`` on
the files NMR holds: 8-bit, non-interlaced truecolour, with alpha (colour
type 6, (H, W, 4)) or without (colour type 2, (H, W, 3)). It checks every
chunk's CRC, inflates the ``IDAT`` chunks with ``zlib`` and undoes the five
row filters: None, Sub and Up in numpy, Average and Paeth (serial along a
row) in ``msr3d_tpu_torch/csrc/png_unfilter.cc``, which ``g++`` builds at
the first call into ``build/native/`` (``data/native.py::build_library``:
no fallback, the build's failure raises with the compiler's log). Ancillary
chunks are skipped, as Pillow skips them when it loads (no gamma, no
transparency key). Everything else raises ``ValueError``: palette and grey
images, bit depths other than 8, Adam7 interlacing, bad CRCs, truncated or
malformed data.

``encode_png`` writes such files with ``zlib`` and ``struct``, one filter
type a row (cycling through the list it is given), so that fixtures
exercise every filter without Pillow.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from msr3d_tpu_torch.data.native import build_library

SRC = Path(__file__).resolve().parents[1] / "csrc" / "png_unfilter.cc"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> bytes a pixel at bit depth 8

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The Average/Paeth library, built and loaded at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(SRC, "libmsr3d_png")))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.msr3d_png_unfilter_row.argtypes = [ctypes.c_int32, u8, u8, ctypes.c_int64,
                                                   ctypes.c_int64]
            lib.msr3d_png_unfilter_row.restype = ctypes.c_int
            _lib = lib
    return _lib


def _chunks(data: bytes, name: str):
    """(type, payload) of each chunk up to ``IEND``, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{name}: truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{name}: bad CRC in the {ctype.decode('latin-1')} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length


def read_png(src: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """A PNG file (path) or its bytes -> (H, W, 3) or (H, W, 4) uint8."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        name, data = "<bytes>", bytes(src)
    else:
        name = os.fspath(src)
        data = Path(name).read_bytes()
    header, idat = None, []
    for ctype, payload in _chunks(data, name):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"{name}: IHDR of {len(payload)} bytes")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype in (b"IEND", b"PLTE") or ctype[0:1].islower():
            continue  # a suggested palette of a truecolour image, or ancillary
        else:
            raise ValueError(f"{name}: unknown critical chunk {ctype!r}")
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT")
    width, height, depth, colour, compression, filter_method, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"{name}: colour type {colour} at bit depth {depth} is not read "
                         "(only 8-bit RGB and RGBA)")
    if interlace:
        raise ValueError(f"{name}: Adam7 interlacing is not read")
    if compression or filter_method or not width or not height:
        raise ValueError(f"{name}: compression {compression}, filter method {filter_method}, "
                         f"size {width} x {height}")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{name}: {exc}") from exc
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{name}: {len(raw)} bytes of image data for {height} rows of "
                         f"{stride + 1}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        cur = out[y]
        if kind == 0:
            cur[:] = line
        elif kind == 1:  # Sub: a running sum a channel along the row, mod 256
            cur[:] = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            np.add(line, prior, out=cur)
        elif kind in (3, 4):
            cur[:] = line
            get_lib().msr3d_png_unfilter_row(kind, cur.ctypes.data_as(u8),
                                             prior.ctypes.data_as(u8), stride, bpp)
        else:
            raise ValueError(f"{name}: row {y} has filter type {kind}")
        prior = cur
    return out.reshape(height, width, bpp)


def _filter_row(kind: int, raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline filtered with ``kind`` (uint8 wrap-around arithmetic)."""
    a = np.concatenate([np.zeros(bpp, np.int32), raw[:-bpp].astype(np.int32)])
    b = prior.astype(np.int32)
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(b)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"filter type {kind}")
    return ((raw.astype(np.int32) - pred) & 0xFF).astype(np.uint8)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png(img: np.ndarray, filters: Sequence[int] = (0, 1, 2, 3, 4),
               idat_size: int = 1 << 16) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8 -> the bytes of a PNG file; row ``y``
    is filtered with ``filters[y % len(filters)]``, and the deflated data
    is split into ``IDAT`` chunks of ``idat_size`` bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes (H, W, 3|4) uint8, not {img.shape}")
    height, width, bpp = img.shape
    flat = img.reshape(height, width * bpp)
    prior = np.zeros(width * bpp, np.uint8)
    body = bytearray()
    for y in range(height):
        kind = filters[y % len(filters)]
        body.append(kind)
        body += _filter_row(kind, flat[y], prior, bpp).tobytes()
        prior = flat[y]
    packed = zlib.compress(bytes(body), 9)
    header = struct.pack(">IIBBBBB", width, height, 8, 6 if bpp == 4 else 2, 0, 0, 0)
    parts = [SIGNATURE, _chunk(b"IHDR", header)]
    parts += [_chunk(b"IDAT", packed[i:i + idat_size])
              for i in range(0, max(len(packed), 1), idat_size)]
    parts.append(_chunk(b"IEND", b""))
    return b"".join(parts)
