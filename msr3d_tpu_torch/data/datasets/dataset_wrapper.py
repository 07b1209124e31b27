"""Dataset wrapper + collate of the MSQA path.

Counterpart of ``LeoScanFamilyDatasetWrapper`` in
``msr3d_tpu/data/datasets/dataset_wrapper.py``: it pads per-item ragged
fields to fixed shapes (obj_fts → max_obj_len with pad=1.0, msr3d_imgs →
msr3d_max_img_num) and the collate stacks into batch-first numpy arrays,
keeping strings as lists. The legacy tasks' wrappers are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from msr3d_tpu_torch.data.data_utils import pad_tensors
from msr3d_tpu_torch.registry import DATASETWRAPPER_REGISTRY


@DATASETWRAPPER_REGISTRY.register(name="LeoScanFamilyDatasetWrapper")
class LeoScanFamilyDatasetWrapper:
    def __init__(self, cfg, dataset, dataset_wrapper_args):
        self.dataset = dataset
        self.max_obj_len = dataset_wrapper_args.get("max_obj_len", 60)
        self.msr3d_max_img_num = dataset_wrapper_args.get("msr3d_max_img_num", 10)
        img_args = cfg.data.get("process_args", {}).get("img_process_args", {}) if cfg else {}
        self.img_size = tuple(img_args.get("tgt_img_size", [224, 224]))

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        data_dict = self.dataset[idx]

        if "obj_fts" in data_dict:
            n_real = len(data_dict["obj_locs"])
            data_dict["obj_fts"] = pad_tensors(
                np.asarray(data_dict["obj_fts"], np.float32), self.max_obj_len, pad=1.0
            )
            data_dict["obj_masks"] = np.arange(self.max_obj_len) < n_real
            data_dict["obj_locs"] = pad_tensors(
                np.asarray(data_dict["obj_locs"], np.float32), self.max_obj_len, pad=0.0
            )
        if "obj_labels" in data_dict:
            data_dict["obj_labels"] = pad_tensors(
                np.asarray(data_dict["obj_labels"], np.int64), self.max_obj_len, pad=-100
            )
        if "obj_boxes" in data_dict:
            data_dict["obj_boxes"] = pad_tensors(
                np.asarray(data_dict["obj_boxes"], np.float32), self.max_obj_len, pad=0.0
            )

        if "msr3d_imgs" in data_dict:
            imgs = data_dict["msr3d_imgs"]
            data_dict["msr3d_img_masks"] = np.arange(self.msr3d_max_img_num) < len(imgs)
            h, w = self.img_size
            if len(imgs) == 0:
                data_dict["msr3d_imgs"] = np.zeros(
                    (self.msr3d_max_img_num, h, w, 3), np.float32
                )
            else:
                stacked = np.stack([np.asarray(im, np.float32) for im in imgs], 0)
                data_dict["msr3d_imgs"] = pad_tensors(
                    stacked, self.msr3d_max_img_num, pad=0.0
                )
        return data_dict

    @staticmethod
    def collate_fn(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Stack arrays batch-first (ragged 1-D sequences right-padded with
        0), keep strings/objects as lists."""
        out: Dict[str, Any] = {}
        for key in batch[0].keys():
            values = [item[key] for item in batch]
            first = values[0]
            if isinstance(first, np.ndarray):
                if first.ndim == 0:
                    out[key] = np.stack(values)
                elif all(v.shape == first.shape for v in values):
                    out[key] = np.stack(values)
                else:  # ragged along axis 0 → right-pad
                    max_len = max(v.shape[0] for v in values)
                    out[key] = np.stack(
                        [pad_tensors(v, max_len, pad=0) for v in values]
                    )
            elif isinstance(first, (bool, np.bool_)):
                out[key] = np.asarray(values)
            elif isinstance(first, (int, float, np.integer, np.floating)):
                out[key] = np.asarray(values)
            elif isinstance(first, str):
                out[key] = values
            elif isinstance(first, list) and first and isinstance(first[0], (int, float)):
                max_len = max(len(v) for v in values)
                out[key] = np.asarray(
                    [v + [0] * (max_len - len(v)) for v in values]
                )
            else:
                out[key] = values
        return out
