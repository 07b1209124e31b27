"""IO helpers: the scan data's torch pickles as numpy.

Counterpart of ``load_torch_pickle`` in ``msr3d_tpu/utils/io.py``.
"""

from __future__ import annotations

from typing import Any

import torch


def load_torch_pickle(path, weights_only: bool = True) -> Any:
    """A ``torch.save`` pickle (the scan ``.pth`` files) with every tensor
    turned into a numpy array, inside dicts, lists and tuples too."""
    obj = torch.load(path, map_location="cpu", weights_only=weights_only)

    def to_np(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, dict):
            return {k: to_np(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_np(v) for v in x)
        return x

    return to_np(obj)
