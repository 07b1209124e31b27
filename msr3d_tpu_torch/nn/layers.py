"""Shared building blocks (counterpart of ``msr3d_tpu/nn/layers.py``):
the activations, flax-style dropout, ``MLPHead`` (the point encoder's
semantic head), ``FC``/``MLP``/``AttFlat`` (the attention-flatten pooling of
the object tokens) and ``ObjColorEncoder``. Dropout in these modules is
active only in ``train()`` mode and draws from the ``generator`` the caller
passes."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``gelu`` is the exact erf form (torch's default); ``gelu_new`` the
    tanh approximation."""
    return {
        "relu": F.relu,
        "gelu": F.gelu,
        "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
        "glu": F.glu,
        "silu": F.silu,
    }[name]


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            slice_of: Optional[Tuple[int, int]] = None,
            rows_of: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``. Active only when ``training``, and
    then it draws from ``generator`` (never from PyTorch's global RNG).
    ``slice_of`` (width, start): x is the last-dim slice ``start ..`` of a
    tensor ``width`` wide (a tensor-parallel rank's part); ``rows_of``
    (length, start): x is the dim-1 slice ``start ..`` of a tensor ``length``
    long (a sequence-parallel rank's block). The mask is drawn whole and
    sliced, so the draws and the mask are the whole's."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train() mode draws from an explicit torch.Generator: "
                         "pass generator=")
    shape = list(x.shape)
    if slice_of is not None:
        shape[-1] = slice_of[0]
    if rows_of is not None:
        shape[1] = rows_of[0]
    keep = torch.rand(shape, generator=generator, device=x.device)
    if slice_of is not None:
        keep = keep[..., slice_of[1]:slice_of[1] + x.shape[-1]]
    if rows_of is not None:
        keep = keep[:, rows_of[1]:rows_of[1] + x.shape[1]]
    keep = keep < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class MLPHead(nn.Module):
    """Linear → ReLU → LayerNorm (eps 1e-12) → dropout → Linear."""

    def __init__(self, in_features: int, hidden_size: int, output_size: int,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_size, device=device)
        self.norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.fc2 = nn.Linear(hidden_size, output_size, device=device)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm(F.relu(self.fc1(x)))
        return self.fc2(dropout(x, self.dropout, self.training, generator))


class FC(nn.Module):
    """Linear → exact gelu → dropout."""

    def __init__(self, in_features: int, out_size: int, pdrop: float = 0.0, device=None):
        super().__init__()
        self.linear = nn.Linear(in_features, out_size, device=device)
        self.pdrop = pdrop

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(F.gelu(self.linear(x)), self.pdrop, self.training, generator)


class MLP(nn.Module):
    def __init__(self, in_features: int, mid_size: int, out_size: int, pdrop: float = 0.0,
                 device=None):
        super().__init__()
        self.fc = FC(in_features, mid_size, pdrop, device)
        self.linear = nn.Linear(mid_size, out_size, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(self.fc(x, generator))


class AttFlat(nn.Module):
    """Attention-flatten pooling: a softmax over the tokens per glimpse.
    x (B, N, H), mask True = pad → (pooled (B, flat_out_size), att (B, N, G));
    padded tokens get the logit -1e9."""

    def __init__(self, in_features: int, flat_mlp_size: int = 512, flat_glimpses: int = 1,
                 flat_out_size: int = 1024, pdrop: float = 0.1, device=None):
        super().__init__()
        self.mlp = MLP(in_features, flat_mlp_size, flat_glimpses, pdrop, device=device)
        self.linear_merge = nn.Linear(in_features * flat_glimpses, flat_out_size,
                                      device=device)
        self.flat_glimpses = flat_glimpses

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        att = self.mlp(x, generator)
        if x_mask is not None:
            att = att.masked_fill(x_mask[..., None], -1e9)
        att = torch.softmax(att, dim=1)
        pooled = torch.cat([(att[:, :, i:i + 1] * x).sum(dim=1)
                            for i in range(self.flat_glimpses)], dim=1)
        return self.linear_merge(pooled), att


class ObjColorEncoder(nn.Module):
    """The GMM colour embedding: (B, N, 3, 4) = three components of (weight
    ‖ mean RGB) → the weight-summed Linear → ReLU → LayerNorm (eps 1e-12) →
    dropout of the means, (B, N, hidden)."""

    def __init__(self, hidden_size: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.fc = nn.Linear(3, hidden_size, device=device)
        self.norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.dropout = dropout

    def forward(self, obj_colors: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.norm(F.relu(self.fc(obj_colors[..., 1:])))
        h = dropout(h, self.dropout, self.training, generator)
        return (h * obj_colors[..., :1]).sum(dim=2)
