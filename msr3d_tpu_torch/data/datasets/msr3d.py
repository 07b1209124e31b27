"""MSQA datasets (the MSR3D data layer).

Counterpart of ``msr3d_tpu/data/datasets/msr3d.py``: one generic
``MSQADataset`` over the three scan domains (ScanNet / 3RScan /
ARKitScenes differ only in annotation filename, scan-loader branch and
config node), registered under the names the YAML task tables use, and the
``MSR3DMix`` mixture. The random draws (rotation augmentation, the answer,
the object-crop shuffles and the native resampling seed) come from Python's
``random`` and numpy's global generator in the JAX package's order, so both
packages give the same samples from the same seeds.

Annotation format (msqa_{domain}_{split}.json): list of records with
question / answers / situation / location / orientation (face vector) /
type / index / scan_id / raw_thought ("label-id, ..." → relevant instance
ids).
"""

from __future__ import annotations

import json
import random
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from msr3d_tpu_torch.data import native
from msr3d_tpu_torch.data.data_utils import (
    build_rotate_mat,
    face_vector_in_xy_to_quaternion,
    quaternion_rotate_z,
)
from msr3d_tpu_torch.data.scan_loader import ScanCache, ScanDataLoader
from msr3d_tpu_torch.registry import DATASET_REGISTRY
from msr3d_tpu_torch.utils.logging import get_logger

logger = get_logger("msr3d_tpu_torch.data")
_numpy_path_logged = False

MSR3D_REQUIRED_KEYS = [
    "msr3d_prompt",
    "msr3d_imgs",
    "obj_fts",
    "obj_locs",
    "img_fts",
    "img_masks",
    "text_output",
    "anchor_orientation",
    "anchor_locs",
    "source",
    "scan_id",
    "prompt_before_obj",
    "prompt_middle_1",
    "prompt_middle_2",
    "prompt_after_obj",
    "index",
    "type",
]

PLACE_HOLDER_DICT = {"IMG": "图", "PCD": "物", "SCENE": "景"}


class MSR3DBase:
    """Prompt templates, the placeholder protocol and the point-cloud
    preprocessing. ``preprocess_path`` records the path the last
    preprocessing took: ``"native"`` or ``"numpy"``."""

    prompt_dict = {
        "role_prompt": "You are an AI visual assistant situated in a 3D scene. ",
        "situation_prompt": "You are at a selected location in the 3D scene. {situation}",
        "scene_prompt": "Objects (including you) in the scene: <SCENE> ",
        "task_prompt": "USER: {instruction} ASSISTANT:",
        "context_templete": "USER: {Q} ASSISTANT: {A}",
    }
    prompt_combine_list = ["role_prompt", "situation_prompt", "scene_prompt", "task_prompt"]

    def __init__(self, cfg, dataset: str):
        self.scan_data_loader = ScanDataLoader(cfg, dataset=dataset)
        self.scan_dataset_name = dataset
        self.preprocess_path: Optional[str] = None

    # -- prompts ---------------------------------------------------------

    @classmethod
    def get_text_prompts(cls, instruction: str, situation: str = "") -> str:
        out = ""
        for key in cls.prompt_combine_list:
            if key == "situation_prompt":
                out += cls.prompt_dict[key].format(situation=situation)
            elif key == "task_prompt":
                out += cls.prompt_dict[key].format(instruction=instruction)
            else:
                out += cls.prompt_dict[key]
        return out

    @classmethod
    def get_prompts(cls, instruction: str, situation: str = "", dialogue=None) -> Dict[str, str]:
        return {
            "prompt_before_obj": cls.prompt_dict["role_prompt"]
            + cls.prompt_dict["situation_prompt"].format(situation=situation),
            "prompt_middle_1": "Ego-view image:",
            "prompt_middle_2": "Objects (including you) in the scene:",
            "prompt_after_obj": cls.prompt_dict["task_prompt"].format(
                instruction=instruction
            )
            if dialogue is None
            else dialogue,
        }

    @staticmethod
    def parse_place_holder(text: str) -> Tuple[str, List[str]]:
        """``<label-instid-IMG>`` → 图, ``<SCENE>`` → 景; returns (text,
        raw matches)."""
        matches = re.findall(r"<(.*?)>", text)
        for match in matches:
            kind = match.split("-")[-1]
            if kind in PLACE_HOLDER_DICT:
                text = text.replace(f"<{match}>", PLACE_HOLDER_DICT[kind])
        return text, matches

    @staticmethod
    def replace_all_imgs_with_txt(text: str) -> str:
        return re.sub(r"<([^<>-]+)-\d+-IMG>", lambda m: m.group(1), text)

    @staticmethod
    def replace_img_with_txt(text: str, inst_id) -> str:
        return re.sub(rf"<([^<>-]+)-{inst_id}-IMG>", lambda m: m.group(1), text)

    @staticmethod
    def transfer_leo_to_msr3d(data_dict: Dict[str, Any]) -> Dict[str, Any]:
        prompt = (
            f"{data_dict['prompt_before_obj']} {data_dict['prompt_middle_2']}"
            f"{PLACE_HOLDER_DICT['SCENE']}. {data_dict['prompt_after_obj']}"
        )
        data_dict.update({"msr3d_prompt": prompt, "msr3d_imgs": []})
        return data_dict

    @staticmethod
    def check_output_and_fill_dummy(data_dict: Dict[str, Any]) -> Dict[str, Any]:
        if "anchor_orientation" not in data_dict:
            data_dict["anchor_orientation"] = np.array([0, 0, 0, 1], np.float32)
        if "anchor_locs" not in data_dict:
            data_dict["anchor_locs"] = np.zeros(3, np.float32)
        data_dict.setdefault("scan_id", "")
        data_dict.setdefault("source", "")
        data_dict.setdefault("index", -1)
        data_dict.setdefault("type", "")
        for key in ("prompt_before_obj", "prompt_middle_1", "prompt_middle_2", "prompt_after_obj"):
            data_dict.setdefault(key, "")
        for key in MSR3D_REQUIRED_KEYS:
            if key not in data_dict:
                raise ValueError(f"Key {key} is missing in data_dict.")
        return data_dict

    def _split_sentence(self, sentence: str, max_length: int, prefix: str = "") -> List[str]:
        """Split long captions into ≤max_length chunks on sentence bounds,
        train split only."""
        if self.split == "train" and len(prefix + sentence) > max_length:
            chunks = []
            sents = sentence.split(". ")
            current = prefix
            for sent in sents:
                if len(current + sent + ". ") > max_length:
                    chunks.append(current)
                    current = prefix
                current += sent + ". "
            chunks.append(current)
            return [c for c in chunks if len(c) <= max_length]
        return [prefix + sentence]

    @staticmethod
    def cluster_data_with_type(data: List[Dict]) -> Dict[str, Dict[str, List]]:
        clustered: Dict[str, Dict[str, List]] = {}
        for d in data:
            clustered.setdefault(d["scan_id"], {}).setdefault(d["type"], []).append(d)
        return clustered

    # -- geometry --------------------------------------------------------

    def prepare_data_loading_with_cache(
        self, dataset_name: str, scan_id: str, data_type_list: List[str]
    ) -> Dict[str, Any]:
        return ScanCache.get(self.scan_data_loader, dataset_name, scan_id, data_type_list)

    def preprocess_pcd(
        self,
        obj_pcds: Sequence[np.ndarray],
        return_anchor: bool = False,
        rot_aug: bool = True,
        situation: Optional[Tuple] = None,
    ) -> Dict[str, Any]:
        """Rotation aug + per-object center/size + resample to num_points +
        unit-sphere normalize + situation co-rotation. Takes the fused native
        (C++) path when the library builds, the numpy path otherwise (logged
        once), drawing from the global generators in the JAX package's
        order."""
        global _numpy_path_logged
        rot_matrix = build_rotate_mat(self.split, rot_aug=rot_aug)

        if not return_anchor and obj_pcds:
            if native.available():
                self.preprocess_path = "native"
                fts, locs = native.preprocess_objects(
                    list(obj_pcds), self.num_points, rot_matrix,
                    seed=np.random.randint(0, 2**63 - 1),
                )
                out = {
                    "obj_fts": fts,
                    "obj_locs": locs,
                    "anchor_loc": np.zeros(3, np.float32),
                }
                if situation is not None:
                    out["situation"] = self._co_rotate_situation(
                        situation, rot_matrix
                    )
                return out

        if not _numpy_path_logged:
            logger.info("point-cloud preprocessing takes the numpy path (the native "
                        "library did not build)")
            _numpy_path_logged = True
        self.preprocess_path = "numpy"
        obj_fts, obj_locs = [], []
        anchor_loc = np.zeros(3, np.float32)
        for i, obj_pcd in enumerate(obj_pcds):
            obj_pcd = np.array(obj_pcd, np.float32)
            if rot_matrix is not None:
                obj_pcd[:, :3] = obj_pcd[:, :3] @ rot_matrix.T
            center = obj_pcd[:, :3].mean(0)
            size = obj_pcd[:, :3].max(0) - obj_pcd[:, :3].min(0)
            obj_locs.append(np.concatenate([center, size], 0))
            if return_anchor and i == 0:
                anchor_loc = obj_pcd[:, :3].min(0) + np.random.rand(3) * size

            idxs = np.random.choice(
                len(obj_pcd), size=self.num_points, replace=len(obj_pcd) < self.num_points
            )
            obj_pcd = obj_pcd[idxs]
            obj_pcd[:, :3] = obj_pcd[:, :3] - obj_pcd[:, :3].mean(0)
            max_dist = np.sqrt((obj_pcd[:, :3] ** 2).sum(1)).max()
            if max_dist < 1e-6:  # tiny/padding point clouds
                max_dist = 1
            obj_pcd[:, :3] = obj_pcd[:, :3] / max_dist
            obj_fts.append(obj_pcd)

        out = {
            "obj_fts": np.stack(obj_fts, 0).astype(np.float32),
            "obj_locs": np.array(obj_locs, np.float32),
            "anchor_loc": anchor_loc.astype(np.float32),
        }
        if situation is not None:
            out["situation"] = self._co_rotate_situation(situation, rot_matrix)
        return out

    @staticmethod
    def _co_rotate_situation(situation: Tuple, rot_matrix) -> Tuple:
        pos, ori = situation
        pos = np.asarray(pos, np.float64)
        ori = np.asarray(ori, np.float64)
        if rot_matrix is not None:
            pos = (pos.reshape(1, 3) @ rot_matrix.T.astype(np.float64)).reshape(-1)
            ori = quaternion_rotate_z(ori, rot_matrix.astype(np.float64))
        return (pos.astype(np.float32), ori.astype(np.float32))

    def _get_scene_encoder_input(
        self, scan_data: Dict[str, Any], scan_insts: List[int], situation=None
    ) -> Dict[str, Any]:
        """Relevant-objects-first crop to max_obj_len."""
        obj_pcds = dict(scan_data["obj_pcds"])
        if len(obj_pcds) <= self.max_obj_len:
            selected = list(obj_pcds.values())
        else:
            selected = [obj_pcds[i] for i in scan_insts if i in obj_pcds]
            if len(selected) >= self.max_obj_len:
                random.shuffle(selected)
                selected = selected[: self.max_obj_len]
            else:
                remained = [i for i in obj_pcds.keys() if i not in scan_insts]
                random.shuffle(remained)
                for i in remained[: self.max_obj_len - len(selected)]:
                    selected.append(obj_pcds[i])
            assert len(selected) == self.max_obj_len
        return self.preprocess_pcd(
            selected, return_anchor=False, rot_aug=self.use_rotate, situation=situation
        )


_DOMAIN_TABLE = {
    # registry name: (scan-loader dataset, cfg.data node, annotation stem, source tag)
    "MSQAScanNet": ("ScanNet", "msqa_scannet", "msqa_scannet", "msqa_scannet"),
    "MSQA3RScan": ("3RScan", "msqa_3rscan", "msqa_rscan", "msqa_3rscan"),
    "MSQAARkitScenes": ("ARkit", "msqa_arkitscenes", "msqa_arkitscenes", "msqa_arkitscenes"),
}


class MSQADataset(MSR3DBase):
    """Situated QA over one scan domain."""

    registry_name: str = "MSQAScanNet"

    def __init__(self, cfg, split: str):
        domain, cfg_node, anno_stem, source = _DOMAIN_TABLE[self.registry_name]
        super().__init__(cfg, dataset=domain)
        self.split = split
        self.cfg = cfg
        self.source = source
        self.anno_stem = anno_stem
        self.dataset_cfg = cfg.data[cfg_node].args

        self.num_points = self.dataset_cfg.get("num_points", 1024)
        self.max_obj_len = self.dataset_cfg.get("max_obj_len", 60)
        self.val_num = self.dataset_cfg.get("val_num", 1000)
        self.few_shot_num = self.dataset_cfg.get("few_shot_num", 0)
        self.use_rotate = self.dataset_cfg.get("use_rotate", True) and split == "train"

        self.data = self.load_lang(self.dataset_cfg.anno_dir, split)
        debug = cfg.get("debug", {})
        if debug.get("flag", False):
            self.data = self.data[: debug.get("debug_size", 20)]
        self.data_dict_with_type = self.cluster_data_with_type(self.data)

    def load_lang(self, anno_dir: str, split: str) -> List[Dict]:
        out = []
        with open(Path(anno_dir) / f"{self.anno_stem}_{split}.json") as f:
            json_data = json.load(f)
        for meta in json_data:
            insts = meta.get("raw_thought", "").split(", ")
            try:
                insts = [int(s.split("-")[-1]) for s in insts]
            except (ValueError, IndexError):
                insts = []
            meta["insts"] = insts
            out.append(meta)
        return out

    def __len__(self) -> int:
        return len(self.data)

    def _get_context_prompt(self, one_sample: Dict, scan_id: str) -> str:
        """Few-shot in-context sampling from the same scene/type
        (few_shot_num=0 in the shipped configs)."""
        context_list = self.data_dict_with_type[scan_id][one_sample["type"]]
        idxs = [i for i, s in enumerate(context_list) if s is not one_sample]
        chosen = random.sample(idxs, min(len(idxs), self.few_shot_num))
        context = ""
        for idx in chosen:
            context += self.prompt_dict["context_templete"].format(
                Q=context_list[idx]["question"],
                A=random.choice(context_list[idx]["answers"]),
            )
        return context

    def __getitem__(self, index: int) -> Dict[str, Any]:
        one = self.data[index]
        question = one["question"]
        answer_list = one["answers"]
        situation = one["situation"]
        anchor_loc = one["location"]
        anchor_ori = face_vector_in_xy_to_quaternion(one["orientation"])
        scan_id = one["scan_id"]

        prompt = self.get_text_prompts(instruction=question, situation=situation)
        _, place_holders = self.parse_place_holder(prompt)

        scan_data = self.prepare_data_loading_with_cache(
            self.scan_dataset_name, scan_id, ["obj_pcds"]
        )
        enc = self._get_scene_encoder_input(
            scan_data, one["insts"], situation=(anchor_loc, anchor_ori)
        )
        anchor_loc, anchor_ori = enc["situation"]

        # interleaved object images: fall back to text when a crop is missing
        img_list: List[np.ndarray] = []
        for ph in place_holders:
            info = ph.split("-")
            if info[-1] == "SCENE" or len(info) != 3:
                continue
            cls_label, inst_id, holder_type = info
            if holder_type != "IMG":
                raise NotImplementedError(f"holder type {holder_type}")
            img = self.scan_data_loader.get_one_certain_img(
                scan_id, int(inst_id), cls_label
            )
            if img is None:
                prompt = self.replace_img_with_txt(prompt, inst_id)
            else:
                img_list.append(img)
        if prompt.count("IMG") != len(img_list):
            img_list = []
            prompt = self.replace_all_imgs_with_txt(prompt)
        prompt, _ = self.parse_place_holder(prompt)
        assert prompt.count("图") == len(img_list)

        data_dict = {
            "source": self.source,
            "scan_id": scan_id,
            "obj_fts": enc["obj_fts"],
            "obj_locs": enc["obj_locs"],
            "img_fts": np.zeros((224, 224, 3), np.float32),
            "img_masks": np.array([False]),
            "text_output": random.choice(answer_list),
            "answer_list": "[answer_seq]".join(answer_list),
            "msr3d_prompt": prompt,
            "msr3d_imgs": img_list,
            "anchor_orientation": np.asarray(anchor_ori, np.float32),
            "anchor_locs": np.asarray(anchor_loc, np.float32),
            "index": one.get("index", index),
            "type": one["type"],
        }
        return self.check_output_and_fill_dummy(data_dict)


@DATASET_REGISTRY.register(name="MSQAScanNet")
class MSQAScanNet(MSQADataset):
    registry_name = "MSQAScanNet"


@DATASET_REGISTRY.register(name="MSQA3RScan")
class MSQA3RScan(MSQADataset):
    registry_name = "MSQA3RScan"


@DATASET_REGISTRY.register(name="MSQAARkitScenes")
class MSQAARkitScenes(MSQADataset):
    registry_name = "MSQAARkitScenes"


@DATASET_REGISTRY.register(name="MSR3DMix")
class MSR3DMix:
    """Concat-with-ratio mixture over the task datasets: the three MSQA
    domains, SQA3D and MSNN."""

    def __init__(self, cfg, split: str):
        from msr3d_tpu_torch.data.datasets.one_step_navi import MSR3DMSNN
        from msr3d_tpu_torch.data.datasets.sqa3d import SQA3DScanNet

        mapping = {
            "msqa_scannet": MSQAScanNet,
            "msqa_3rscan": MSQA3RScan,
            "msqa_arkitscenes": MSQAARkitScenes,
            "sqa3d": SQA3DScanNet,
            "scannet_one_step_navi": MSR3DMSNN,
        }
        args = cfg.data.msr3dmix.args
        self.ratio = args.get("ratio", 1.0)
        self.dataset_list = list(args.mix)
        self.datasets = [mapping[name](cfg, split) for name in self.dataset_list]

        if isinstance(self.ratio, (int, float)):
            sizes = [int(len(d) * self.ratio) for d in self.datasets]
        else:
            sizes = [int(len(d) * r) for d, r in zip(self.datasets, self.ratio)]
        self.index_range = [0] + list(np.cumsum(sizes))

    def __len__(self) -> int:
        return int(self.index_range[-1])

    @staticmethod
    def streamline_output(data_dict: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for key in MSR3D_REQUIRED_KEYS:
            if key not in data_dict:
                raise ValueError(f"Key {key} is missing in data_dict.")
            out[key] = data_dict[key]
        # evaluation extras survive when present
        for key in ("answer_list", "data_idx", "sqa_type"):
            if key in data_dict:
                out[key] = data_dict[key]
        return out

    def __getitem__(self, index: int) -> Dict[str, Any]:
        for i in range(len(self.index_range) - 1):
            if self.index_range[i] <= index < self.index_range[i + 1]:
                data_dict = self.datasets[i][index - self.index_range[i]]
                if data_dict.get("prompt_before_obj", ""):
                    data_dict = MSR3DBase.transfer_leo_to_msr3d(data_dict)
                return self.streamline_output(data_dict)
        raise IndexError(index)
