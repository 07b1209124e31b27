"""MSNN next-step navigation datasets (reference data/datasets/one_step_navi.py
+ MSR3DMSNN view, msr3d.py:851-871).

Annotation: {msnn_base}/msnn_scannet.json — {scan_id: {sample_id: record}}
with location/orientation(quat)/situation_multimodal/situation_text/
interaction/insts/action{four_direction:[code,text], eight_direction:[...]}.
The GT action maps through the direction table onto a reserved Vicuna token
(data/constants.py).

Counterpart of ``msr3d_tpu/data/datasets/one_step_navi.py``, drawing from
the global ``random`` and ``np.random`` in the JAX package's order."""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from msr3d_tpu_torch.data.constants import ONESTEPNAVI_ACTION_SPACE_TOKENIZE
from msr3d_tpu_torch.data.datasets.msr3d import MSR3DBase
from msr3d_tpu_torch.data.scan_loader import ScanCache, ScanDataLoader
from msr3d_tpu_torch.registry import DATASET_REGISTRY

NAVI_ACTION_POOL = ["What action should I take next step?"]

ACTION_MAPPING = {
    "four_direction": {0: 0, 1: 1, 2: 2, 3: 3, 4: 0},
    "eight_direction": {0: 0, 2: 1, 4: 2, 6: 3, 8: 0, 1: 4, 3: 5, 5: 6, 7: 7},
}


@DATASET_REGISTRY.register(name="ScanNetOneStepNavi")
class ScanNetOneStepNavi:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = "val" if split == "test" else split
        args = cfg.data.next_step_navigation.args
        self.num_points = args.get("num_points", 1024)
        self.max_obj_len = args.get("max_obj_len", 60)
        self.action_type = args.get("action_type", "four_direction")
        self.modality_type = args.get("modality_type", "multimodal")
        self.use_rotate = True  # reference always passes rot_aug=True here
        self.loader = ScanDataLoader(cfg, dataset="ScanNet")

        anno_path = Path(cfg.data.msnn_base) / "msnn_scannet.json"
        with open(anno_path) as f:
            anno_all = json.load(f)

        split_ids = self._load_split(cfg, self.split)
        self.data: List[Dict] = []
        for scan_id, samples in anno_all.items():
            if split_ids is not None and scan_id not in split_ids:
                continue
            for one in samples.values():
                one["insts"] = [int(x) for x in one.get("insts", [])]
                one.setdefault("scan_id", scan_id)
                self.data.append(one)
        debug = cfg.get("debug", {})
        if debug.get("flag", False):
            self.data = self.data[: debug.get("debug_size", 20)]

    def _load_split(self, cfg, split):
        base = Path(cfg.data.get("scan_family_base", ""))
        split_file = base / "annotations" / "splits" / f"scannetv2_{split}.txt"
        if split_file.exists():
            return {x.strip() for x in open(split_file, encoding="utf-8")}
        return None  # no split file: keep all scans

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        one = self.data[index]
        situation = (
            one["situation_multimodal"]
            if self.modality_type == "multimodal"
            else one["situation_text"]
        )
        question = one["interaction"] + " " + random.choice(NAVI_ACTION_POOL)
        scan_id = one["scan_id"]

        scan_data = ScanCache.get(self.loader, "ScanNet", scan_id, ["obj_pcds"])
        obj_pcds = scan_data["obj_pcds"]

        code, action_text = one["action"][self.action_type][:2]
        code = ACTION_MAPPING[self.action_type][code]
        action_gt = ONESTEPNAVI_ACTION_SPACE_TOKENIZE[code]

        base = MSR3DBase.__new__(MSR3DBase)
        base.split = self.split
        base.num_points = self.num_points
        base.max_obj_len = self.max_obj_len
        base.use_rotate = self.use_rotate
        enc = MSR3DBase._get_scene_encoder_input(
            base, {"obj_pcds": obj_pcds}, one["insts"],
            situation=(one["location"], one["orientation"]),
        )
        pos, ori = enc["situation"]

        return {
            "situation": situation,
            "situation_pos": np.asarray(pos, np.float32),
            "situation_rot": np.asarray(ori, np.float32),
            "question": question,
            "action_token_list": [action_gt],
            "action_text_list": [action_text],
            "obj_fts": enc["obj_fts"],
            "obj_locs": enc["obj_locs"],
            "scan_id": scan_id,
            "index": index,
            "type": "one_step_navi",
        }


@DATASET_REGISTRY.register(name="MSR3DMSNN")
class MSR3DMSNN(ScanNetOneStepNavi):
    """MSR3D view: prompt build + action token as the answer
    (msr3d.py:851-871)."""

    def __getitem__(self, index: int) -> Dict[str, Any]:
        data_dict = super().__getitem__(index)
        prompt = MSR3DBase.get_text_prompts(
            instruction=data_dict["question"], situation=data_dict["situation"]
        )
        prompt, _ = MSR3DBase.parse_place_holder(prompt)
        data_dict.update(
            {
                "msr3d_prompt": prompt,
                "msr3d_imgs": [],
                "text_output": random.choice(data_dict["action_token_list"]),
                "source": "scannet",
                "img_fts": np.zeros((224, 224, 3), np.float32),
                "img_masks": np.array([False]),
                "anchor_locs": data_dict["situation_pos"],
                "anchor_orientation": data_dict["situation_rot"],
                "task": "one_step_navi",
            }
        )
        return MSR3DBase.check_output_and_fill_dummy(data_dict)
