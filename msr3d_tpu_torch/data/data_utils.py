"""Data-side utilities of the MSQA path (numpy).

Copy of the parts of ``msr3d_tpu/data/data_utils.py`` that the MSQA
datasets call: the rotation augmentation (0/90/180/270° about z, drawn from
Python's ``random``), face-vector → quaternion, the quaternion co-rotation
of the situation, 2D image preprocessing (a copy of Pillow's bilinear
resample, then ImageNet statistics), tensor padding and the SQA3D question
type. The legacy-task helpers stay in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
import random
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from msr3d_tpu_torch.data.native import build_library

PIX_MEAN = (0.485, 0.456, 0.406)
PIX_STD = (0.229, 0.224, 0.225)

ROTATE_ANGLES = [0, np.pi / 2, np.pi, np.pi * 3 / 2]


def build_rotate_mat(
    split: str, rot_aug: bool = True, rand_angle: str = "axis"
) -> Optional[np.ndarray]:
    """Random z-rotation for training augmentation
    . Returns None when no rotation applies."""
    if rand_angle == "random":
        theta = np.random.rand() * np.pi * 2
    else:
        theta = random.choice(ROTATE_ANGLES)
    if rot_aug and split == "train" and theta is not None and theta != 0:
        return np.array(
            [
                [np.cos(theta), -np.sin(theta), 0],
                [np.sin(theta), np.cos(theta), 0],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )
    return None


def face_vector_in_xy_to_quaternion(face_vec) -> np.ndarray:
    """Forward direction in the xy-plane → xyzw quaternion (yaw-only)
    ."""
    face_vec = np.asarray(face_vec, dtype=np.float64)
    face_vec = face_vec / np.linalg.norm(face_vec)
    angle = np.arctan2(face_vec[1], face_vec[0])
    # R.from_euler('xyz', [0, 0, angle]).as_quat() == yaw-only quaternion
    return np.array([0.0, 0.0, np.sin(angle / 2), np.cos(angle / 2)])


def quaternion_rotate_z(quat: np.ndarray, rot_matrix: np.ndarray) -> np.ndarray:
    """Co-rotate a situation quaternion by a scene rotation matrix
    (R_new = rot @ R(quat))."""
    rot_q = _matrix_to_quat(rot_matrix @ _quat_to_matrix(quat))
    return rot_q


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """xyzw quaternion → rotation matrix (scipy 'from_quat' convention)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix → xyzw quaternion."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


# Pillow's fixed-point weights (src/libImaging/Resample.c, 8 bits a channel)
PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for the bilinear filter (support 1) and
    ``normalize_coeffs_8bpc``: each output pixel's first input pixel and
    number of taps (out_size,), and the fixed-point weights (out_size,
    ksize), zero past each output's taps. The double arithmetic keeps
    Resample.c's order, operation by operation, so the weights are Pillow's to
    the bit: a loop over the taps, vectorised over the outputs only."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    taps = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    kk = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):
        t = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        w = np.where((x < taps) & (t < 1.0), 1.0 - t, 0.0)
        kk[:, x] = w
        ww += w
    kk = np.where(ww[:, None] != 0.0, kk / np.where(ww == 0.0, 1.0, ww)[:, None], kk)
    scaled = kk * float(1 << PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, taps, fixed.astype(np.int64)


_RESAMPLE_SRC = Path(__file__).resolve().parents[1] / "csrc" / "resample.cc"
_resample_lock = threading.Lock()
_resample_lib: Optional[ctypes.CDLL] = None


def _resample_library() -> ctypes.CDLL:
    """``csrc/resample.cc``, built with ``g++`` into ``build/native/`` at the
    first call (``native.build_library``: raises with the compiler's log)."""
    global _resample_lib
    with _resample_lock:
        if _resample_lib is None:
            lib = ctypes.CDLL(str(build_library(_RESAMPLE_SRC, "libmsr3d_resample")))
            u8, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
            i32, n = ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
            lib.msr3d_resample_rows.argtypes = [u8, n, i64, i64, i32, n, n, u8]
            lib.msr3d_resample_cols.argtypes = [u8, n, n, i64, i64, i32, n, n, u8]
            lib.msr3d_resample_rows.restype = lib.msr3d_resample_cols.restype = None
            _resample_lib = lib
    return _resample_lib


def _resample_pass(img: np.ndarray, first: np.ndarray, taps: np.ndarray, kk: np.ndarray,
                   axis: int) -> np.ndarray:
    """One pass of ``ImagingResample{Vertical,Horizontal}_8bpc`` (``axis`` 0
    or 1) of (H, W, 3) uint8 (``csrc/resample.cc``)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resample takes (H, W, 3) images, not {img.shape}")
    first = np.ascontiguousarray(first, np.int64)
    taps = np.ascontiguousarray(taps, np.int64)
    kk = np.ascontiguousarray(kk, np.int32)
    if first.min() < 0 or (first + taps).max() > img.shape[axis] or taps.max() > kk.shape[1]:
        raise ValueError("resample taps outside the image")
    shape = list(img.shape)
    shape[axis] = len(first)
    out = np.empty(shape, np.uint8)
    u8, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
    coeffs = (first.ctypes.data_as(i64), taps.ctypes.data_as(i64),
              kk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(first), kk.shape[1])
    lib = _resample_library()
    if axis == 0:
        lib.msr3d_resample_rows(img.ctypes.data_as(u8), img.shape[1] * img.shape[2], *coeffs,
                                out.ctypes.data_as(u8))
    else:
        lib.msr3d_resample_cols(img.ctypes.data_as(u8), *img.shape[:2], *coeffs,
                                out.ctypes.data_as(u8))
    return out


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's ``Image.resize(size, Image.BILINEAR)`` of an (H, W, 3) uint8
    image, bit for bit (``ImagingResampleInner``): ``size`` is (width,
    height); the horizontal pass runs first, over the rows the vertical pass
    reads, and a pass whose axis keeps its size is skipped."""
    img = np.ascontiguousarray(img, np.uint8)
    out_w, out_h = size
    in_h, in_w = img.shape[:2]
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize to {size}: sizes must be positive")
    ymin, ytaps, ky = _bilinear_coeffs(in_h, out_h)
    if out_w != in_w:
        # the rows the vertical pass reads (ybox_first .. ybox_last)
        first, last = int(ymin[0]), int(ymin[-1] + ytaps[-1])
        xmin, xtaps, kx = _bilinear_coeffs(in_w, out_w)
        img = _resample_pass(img[first:last], xmin, xtaps, kx, axis=1)
        ymin = ymin - first
    if out_h != in_h:
        img = _resample_pass(img, ymin, ytaps, ky, axis=0)
    return img


def preprocess_2d(img: np.ndarray, size: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Resize (Pillow's bilinear, ``resize_bilinear``) + ImageNet-normalize an
    image.

    Input (H, W, 3) uint8; output (H', W', 3) float32 NHWC (TPU layout;
    the layout of the port's image encoder too).
    """
    out = resize_bilinear(np.asarray(img).astype(np.uint8), size).astype(np.float32)
    for i in range(3):
        out[:, :, i] = (out[:, :, i] / 255.0 - PIX_MEAN[i]) / PIX_STD[i]
    return np.ascontiguousarray(out)


def pad_tensors(arr: np.ndarray, lens: int, pad: float = 0.0) -> np.ndarray:
    """Pad along axis 0 to ``lens`` with ``pad``."""
    assert arr.shape[0] <= lens
    if arr.shape[0] == lens:
        return arr
    shape = list(arr.shape)
    shape[0] = lens - arr.shape[0]
    fill = np.full(shape, pad, dtype=arr.dtype)
    return np.concatenate([arr, fill], axis=0)


SQA_TYPES = ["what", "is", "how", "can", "which", "others"]


def get_sqa_question_type(question: str) -> int:
    """SQA3D question-type tag, an index into ``SQA_TYPES``."""
    question = question.lstrip()
    if question[:4].lower() == "what":
        return 0
    if question[:2].lower() == "is":
        return 1
    if question[:3].lower() == "how":
        return 2
    if question[:3].lower() == "can":
        return 3
    if question[:5].lower() == "which":
        return 4
    return 5
