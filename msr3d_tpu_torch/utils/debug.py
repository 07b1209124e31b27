"""Numeric debugging hooks.

Counterpart of ``msr3d_tpu/utils/debug.py``. The reference asserts that the
fused spatial attention is free of NaNs on every forward; the JAX package
makes that an opt-in host check. Set ``MSR3D_NAN_CHECKS=1`` (read at
import; ``""``, ``"0"`` and ``"false"`` leave it off) and every guarded
tensor is checked with one host read. Off by default: the read waits for the
device, once a guarded call.
"""

from __future__ import annotations

import os

import torch

_ENABLED = os.environ.get("MSR3D_NAN_CHECKS", "") not in ("", "0", "false")


def assert_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity, without a device sync, unless ``MSR3D_NAN_CHECKS`` is on;
    then ``FloatingPointError`` names the count of non-finite values."""
    if not _ENABLED:
        return x
    bad = int(x.numel() - torch.isfinite(x).sum())
    if bad:
        raise FloatingPointError(f"{name}: {bad}/{x.numel()} non-finite values")
    return x
