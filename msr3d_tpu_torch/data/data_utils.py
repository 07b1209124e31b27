"""Data-side utilities of the MSQA path (numpy).

Copy of the parts of ``msr3d_tpu/data/data_utils.py`` that the MSQA
datasets call: the rotation augmentation (0/90/180/270° about z, drawn from
Python's ``random``), face-vector → quaternion, the quaternion co-rotation
of the situation, 2D image preprocessing (ImageNet statistics; PIL imported
where it is used), tensor padding and the SQA3D question type. The
legacy-task helpers stay in the JAX package.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

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


def preprocess_2d(img: np.ndarray, size: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Resize (PIL bilinear) + ImageNet-normalize an image.

    Input (H, W, 3) uint8; output (H', W', 3) float32 NHWC (TPU layout;
    the layout of the port's image encoder too).
    """
    from PIL import Image

    pil = Image.fromarray(img.astype(np.uint8))
    pil = pil.resize(size, Image.BILINEAR)
    out = np.asarray(pil).astype(np.float32)
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
