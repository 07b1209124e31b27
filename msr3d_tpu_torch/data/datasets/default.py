"""The registered base dataset ``DefaultDataset``.

Counterpart of ``msr3d_tpu/data/datasets/default.py``: it concatenates the
registered datasets named by ``cfg.data.pretrain.dataset``, each a
``DATASET-SOURCE1-SOURCE2-...`` string resolved as the registry entry
``{DATASET}{cfg.task}`` with the source list as an argument.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Sequence

from msr3d_tpu_torch.registry import DATASET_REGISTRY


class ConcatDataset:
    """Plain index-offset concatenation (torch ConcatDataset semantics)."""

    def __init__(self, datasets: Sequence[Any]):
        assert len(datasets) > 0, "ConcatDataset needs at least one dataset"
        self.datasets = list(datasets)
        self.cumulative_sizes: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        offset = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - offset]


def get_dataset_dicts(names, task, cfg, split: str = "train",
                      filter_empty: bool = True) -> ConcatDataset:
    """Resolve ``{name-prefix}{task}`` registry entries and concatenate
    them. ``filter_empty`` is accepted and not read, as in the JAX
    package."""
    if isinstance(names, str):
        names = [names]
    assert len(names), names
    datasets = []
    for name in names:
        cls = DATASET_REGISTRY.get(f"{name.split('-')[0]}{task}")
        sources = name.split("-")[1:]
        # only source-aware datasets (e.g. SpatialRefer) take the third arg
        datasets.append(cls(cfg, split, sources) if sources else cls(cfg, split))
    for name, ds in zip(names, datasets):
        assert len(ds), f"Dataset '{name}' is empty!"
    return ConcatDataset(datasets)


@DATASET_REGISTRY.register(name="DefaultDataset")
class DefaultDataset:
    def __init__(self, cfg, split: str = "train"):
        self.data_dict = get_dataset_dicts(
            cfg.data.pretrain.dataset,
            cfg.task,
            cfg,
            split,
            filter_empty=cfg.dataloader.filter_empty_annotations,
        )

    def __len__(self) -> int:
        return len(self.data_dict)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.data_dict[index]
