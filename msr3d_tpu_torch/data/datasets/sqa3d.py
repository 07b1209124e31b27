"""SQA3D dataset over ScanNet (reference data/datasets/scannet.py:997-1299
+ the MSR3D view SQA3DScanNet, msr3d.py:487-524).

Counterpart of ``msr3d_tpu/data/datasets/sqa3d.py``: the random draws
(situation, rotation, answer, object crop, the native resampling seed)
come from Python's ``random`` and numpy's global generator in the JAX
package's order.

File layout ({scan_family_base}):
  annotations/sqa_task/answer_dict.json                       answer vocab
  annotations/sqa_task/balanced/v1_balanced_questions_{split}_scannetv2.json
  annotations/sqa_task/balanced/v1_balanced_sqa_annotations_{split}_scannetv2.json
  annotations/meta_data/scannetv2_raw_categories.json         category list
  scan_data/pcd_with_global_alignment/{scan}.pth              aligned pcd
  scan_data/instance_id_to_name/{scan}.json                   per-inst label
  scans/{scan}/{scan}.txt                                     axisAlignment
"""

from __future__ import annotations

import collections
import json
import random
import re
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from msr3d_tpu_torch.data.data_utils import (
    _matrix_to_quat,
    _quat_to_matrix,
    get_sqa_question_type,
)
from msr3d_tpu_torch.data.datasets.msr3d import MSR3DBase
from msr3d_tpu_torch.data.scan_loader import ScanCache, ScanDataLoader
from msr3d_tpu_torch.registry import DATASET_REGISTRY

# The only live entry of the reference's text_pool.py: the multi-entry
# situation pool is commented out there (text_pool.py:182-183), and the
# objcap/scenecap/plan instruction pools have zero consumers anywhere in
# the reference tree — dead code, deliberately not carried over.
Leo_situation_pool = ["You are at a selected location in the 3D scene."]

_BACKGROUND = ("wall", "floor", "ceiling")

_PRONOUN_FORMS = {"i": "you", "me": "you", "my": "your", "mine": "yours", "am": "are"}


def convert_person_view(sentence: str) -> str:
    """First→second person (msr3d.py:491-498; word-punct tokenization)."""
    tokens = re.findall(r"\w+|[^\w\s]+", sentence)
    out = [_PRONOUN_FORMS.get(t.lower(), t) for t in tokens]
    return " ".join(out)


class SQA3DAnswerVocab:
    def __init__(self, answers):
        self.itos = list(answers)
        self._stoi = {a: i for i, a in enumerate(self.itos)}

    def stoi(self, answer: str) -> int:
        return self._stoi.get(answer, -1)

    def __len__(self):
        return len(self.itos)


@DATASET_REGISTRY.register(name="ScanNetSQA3D")
class ScanNetSQA3D:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        self.base_dir = Path(cfg.data.scan_family_base)
        args = cfg.data.sqa3d.args
        self.max_obj_len = args.get("max_obj_len", 60) - 1
        self.num_points = args.get("num_points", 1024)
        self.filter_lang = args.get("filter_lang", False)
        self.use_unanswer = args.get("use_unanswer", True)
        self.use_rotate = split == "train"

        self.loader = ScanDataLoader(cfg, dataset="ScanNet")

        # category table for background filtering
        cat_file = self.base_dir / "annotations" / "meta_data" / "scannetv2_raw_categories.json"
        if cat_file.exists():
            cats = json.load(open(cat_file, encoding="utf-8"))
            self.int2cat = list(cats)
            self.cat2int = {c: i for i, c in enumerate(self.int2cat)}
        else:
            self.int2cat, self.cat2int = [], {}

        self.num_answers, self.answer_vocab, self.answer_cands = self._build_answer()
        self.lang_data, self.scan_ids = self._load_lang()
        debug = cfg.get("debug", {})
        if debug.get("flag", False):
            self.lang_data = self.lang_data[: debug.get("debug_size", 20)]
        self.questions_map = self._load_question()

    # -- annotation loading ---------------------------------------------

    def _build_answer(self):
        path = self.base_dir / "annotations" / "sqa_task" / "answer_dict.json"
        answer_data = json.load(open(path))[0]
        answer_counter = collections.Counter(sorted(answer_data.keys()))
        vocab = SQA3DAnswerVocab(answer_counter.keys())
        return len(answer_counter), vocab, list(answer_counter.keys())

    def _load_lang(self):
        path = (
            self.base_dir / "annotations" / "sqa_task" / "balanced"
            / f"v1_balanced_sqa_annotations_{self.split}_scannetv2.json"
        )
        lang_data, scan_ids = [], set()
        for item in json.load(open(path, encoding="utf-8"))["annotations"]:
            answers = [a["answer"] for a in item["answers"]]
            if self.use_unanswer or set(answers) & set(self.answer_cands):
                scan_ids.add(item["scene_id"])
                lang_data.append(item)
        return lang_data, scan_ids

    def _load_question(self):
        path = (
            self.base_dir / "annotations" / "sqa_task" / "balanced"
            / f"v1_balanced_questions_{self.split}_scannetv2.json"
        )
        qmap: Dict[str, Dict[int, Dict]] = {}
        for item in json.load(open(path, encoding="utf-8"))["questions"]:
            qmap.setdefault(item["scene_id"], {})[item["question_id"]] = {
                "situation": [item["situation"]] + item.get("alternative_situation", []),
                "question": item["question"],
            }
        return qmap

    def _load_inst_labels(self, scan_id: str) -> List[int]:
        path = self.base_dir / "scan_data" / "instance_id_to_name" / f"{scan_id}.json"
        if not path.exists():
            return []
        names = json.load(open(path, encoding="utf-8"))
        return [self.cat2int.get(n, -1) for n in names]

    def __len__(self) -> int:
        return len(self.lang_data)

    # -- situation alignment ---------------------------------------------

    def transform_situation(self, scan_id: str, scene_center, pos, ori):
        """Mesh-frame situation → aligned-pcd frame via the scan's
        axisAlignment matrix (scannet.py:1220-1256)."""
        if isinstance(pos, dict):
            pos = [pos["x"], pos["y"], pos["z"]]
        pos = np.asarray(pos, np.float64)
        if isinstance(ori, dict):
            ori = [ori["_x"], ori["_y"], ori["_z"], ori["_w"]]
        ori = np.asarray(ori, np.float64)

        meta = self.base_dir / "scans" / scan_id / f"{scan_id}.txt"
        values = None
        for line in open(meta, encoding="utf-8"):
            if "axisAlignment" in line:
                values = line.split("=")[1].strip().split()
                break
        assert values is not None and len(values) == 16
        rot = np.array([float(v) for v in values]).reshape(4, 4)

        pos_new = (pos.reshape(1, 3) @ rot[:3, :3].T + scene_center).reshape(-1)
        ori_new = _matrix_to_quat(rot[:3, :3] @ _quat_to_matrix(ori))
        return pos_new, ori_new

    # -- item -------------------------------------------------------------

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.lang_data[index]
        item_id = item["question_id"]
        scan_id = item["scene_id"]
        answer_list = [a["answer"] for a in item["answers"]]

        qrec = self.questions_map[scan_id][item_id]
        if self.split == "train":
            situation = random.choice(qrec["situation"])
        else:
            situation = qrec["situation"][0]
        question = qrec["question"]
        question_type = get_sqa_question_type(question)

        scan_data = ScanCache.get(self.loader, "ScanNet", scan_id, ["obj_pcds"])
        obj_pcds_dict = scan_data["obj_pcds"]
        obj_labels = self._load_inst_labels(scan_id)

        # filter background categories
        keep = [
            i
            for i in sorted(obj_pcds_dict.keys())
            if not obj_labels
            or i >= len(obj_labels)
            or (0 <= obj_labels[i] < len(self.int2cat)
                and self.int2cat[obj_labels[i]] not in _BACKGROUND)
            or obj_labels[i] == -1
        ]
        obj_pcds = [obj_pcds_dict[i] for i in keep]

        # crop to max_obj_len (random beyond; no tgt objects in MSR3D path)
        if len(obj_pcds) > self.max_obj_len:
            idxs = list(range(len(obj_pcds)))
            random.shuffle(idxs)
            obj_pcds = [obj_pcds[i] for i in idxs[: self.max_obj_len]]

        # situation into the aligned frame
        all_points = np.concatenate([p[:, :3] for p in obj_pcds_dict.values()], 0)
        scene_center = (all_points.max(0) + all_points.min(0)) / 2
        pos, ori = self.transform_situation(
            scan_id, scene_center, item["position"], item["rotation"]
        )

        base = MSR3DBase.__new__(MSR3DBase)  # reuse preprocess_pcd unbound
        base.split = self.split
        base.num_points = self.num_points
        enc = MSR3DBase.preprocess_pcd(
            base, obj_pcds, return_anchor=False, rot_aug=self.use_rotate,
            situation=(pos, ori),
        )
        pos, ori = enc["situation"]

        return {
            "situation": situation,
            "situation_pos": np.asarray(pos, np.float32),
            "situation_rot": np.asarray(ori, np.float32),
            "question": question,
            "scan_id": scan_id,
            "answer_list": "[answer_seq]".join(answer_list),
            "obj_fts": enc["obj_fts"],
            "obj_locs": enc["obj_locs"],
            "data_idx": item_id,
            "sqa_type": question_type,
            "index": index,
            "type": f"sqa_type_{question_type}",
        }


@DATASET_REGISTRY.register(name="SQA3DScanNet")
class SQA3DScanNet(ScanNetSQA3D):
    """MSR3D view: SQA3D + LEO prompt parts + person-view conversion
    (msr3d.py:487-524)."""

    situation_pool = Leo_situation_pool

    def __getitem__(self, index: int) -> Dict[str, Any]:
        data_dict = super().__getitem__(index)
        extra = MSR3DBase.get_prompts(
            instruction=data_dict["question"],
            situation=random.choice(self.situation_pool)
            + " "
            + convert_person_view(data_dict["situation"]),
        )
        data_dict.update(extra)
        data_dict.update(
            {
                "source": "scannet",
                "text_output": random.choice(
                    data_dict["answer_list"].split("[answer_seq]")
                ),
                "img_fts": np.zeros((224, 224, 3), np.float32),
                "img_masks": np.array([False]),
                "anchor_locs": data_dict["situation_pos"],
                "anchor_orientation": data_dict["situation_rot"],
                "task": "sqa3d",
            }
        )
        data_dict = MSR3DBase.transfer_leo_to_msr3d(data_dict)
        return MSR3DBase.check_output_and_fill_dummy(data_dict)


@DATASET_REGISTRY.register(name="ScanNetSQA3DInstruction")
class ScanNetSQA3DInstruction(ScanNetSQA3D):
    """Instruction-following SQA3D format (scannet.py:1302-1320).

    Prompt: ``<holistic prompt> Here are the object tokens in the scene:
    <objs>. Situation: <situation> Question: <question> Answer:`` — pairs
    with ``SQA3DInstructionEval`` (generation-mode EM).
    """

    holistic_prompt = (
        "Assume you are an AI visual assistant situated in a 3D scene. You "
        "receive a sequence of object tokens in the scene, each representing "
        "the feature of a corresponding object. And you receive a situation "
        "specifying where you are in the 3D scene. Next you will receive a "
        "question to answer based on the visual information embedded in the "
        "object tokens."
    )

    def __getitem__(self, index: int) -> Dict[str, Any]:
        data_dict = super().__getitem__(index)
        data_dict.update(
            {
                "prompt_before_obj": f"{self.holistic_prompt} Here are the "
                "object tokens in the scene: ",
                "prompt_after_obj": f". Situation: {data_dict['situation']} "
                f"Question: {data_dict['question']} Answer: ",
                "text_output": random.choice(
                    data_dict["answer_list"].split("[answer_seq]")
                ),
            }
        )
        return data_dict
