"""Shared building blocks (counterpart of ``msr3d_tpu/nn/layers.py``)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``gelu`` is the exact erf form (torch's default); ``gelu_new`` the
    tanh approximation."""
    return {
        "relu": F.relu,
        "gelu": F.gelu,
        "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
    }[name]
