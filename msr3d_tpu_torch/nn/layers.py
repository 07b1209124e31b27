"""Shared building blocks (counterpart of ``msr3d_tpu/nn/layers.py``)."""

from __future__ import annotations

from typing import Callable, Optional

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


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``. Active only when ``training``, and
    then it draws from ``generator`` (never from PyTorch's global RNG)."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train() mode draws from an explicit torch.Generator: "
                         "pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
