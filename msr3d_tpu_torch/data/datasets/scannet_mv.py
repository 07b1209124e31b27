"""Multi-view (RGB-D frame) ScanNet datasets: ScanNetMVPretrain and
ScanNetMVReferit3D.

Counterpart of ``msr3d_tpu/data/datasets/scannet_mv.py``, registered under
the same names. They read the precomputed ``ScanNetV2-RGBD/
MultiViewInfo_numpy`` trees: per scan a ``multiview_info_refined.json``
(frames → instance_info entries with ``org_inst_id``/``is_need_process``
and a feature-row index) and the ``{inst_feat_type}.npy`` feature table the
indices point into.

Two views of the data:
  - pooled (``is_pool_obj_feature``): per-object features averaged across
    the frames that see the object, emitted like the grounding obj_fts;
  - per-frame: fixed (max_frame_num × max_inst_per_frame) feature/mask/
    loc/camera-pose grids flattened frame-major.

Frames and instances are sampled with Python's ``random``.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from msr3d_tpu_torch.data.box_utils import convert_pc_to_box
from msr3d_tpu_torch.data.data_utils import build_rotate_mat, is_explicitly_view_dependent
from msr3d_tpu_torch.data.datasets.scannet_legacy import (
    BACKGROUND_CATS,
    ScanNetLegacyBase,
    _load_jsonl,
)
from msr3d_tpu_torch.registry import DATASET_REGISTRY


class _MVMixin:
    """Multiview-info loading shared by the MV datasets."""

    def _mv_dir(self, scan_id: str) -> Path:
        return (
            self.base_dir / "ScanNetV2-RGBD" / "MultiViewInfo_numpy" / scan_id
        )

    def _load_multiview_info(self, scan_id: str) -> Dict[str, Any]:
        """Frame table + feature-hash resolution:
        instance entries store a row index into {inst_feat_type}.npy."""
        args = self.cfg.data.mvdatasettings
        info = json.load(open(self._mv_dir(scan_id) / "multiview_info_refined.json"))
        mv_info = info["multiview_info"]
        feats = np.load(self._mv_dir(scan_id) / f"{args.inst_feat_type}.npy")
        for frame in mv_info.values():
            for inst in frame["instance_info"]:
                if not inst.get("is_need_process", False):
                    continue
                inst[args.inst_feat_type] = feats[inst[args.inst_feat_type]]
        return mv_info

    # 1-based org instance ids → 0-based
    @staticmethod
    def _org_to_id(org_inst_id: int) -> int:
        return -100 if org_inst_id == 0 else org_inst_id - 1

    def _get_multiview_info(self, scan_id: str) -> Dict[Any, Any]:
        args = self.cfg.data.mvdatasettings
        mv_info = self._load_multiview_info(scan_id)
        frame_names = list(mv_info.keys())
        if args.get("frame_sample_mode", "even") != "even":
            raise ValueError(args.frame_sample_mode)
        max_frames = min(args.max_frame_num, len(frame_names))
        sampled = random.sample(frame_names, max_frames)
        if args.get("is_pool_obj_feature", True):
            return self._pooled_obj_features(args, mv_info, sampled, scan_id)
        return self._per_frame_features(args, mv_info, sampled, scan_id)

    def _pooled_obj_features(self, args, mv_info, sampled, scan_id):
        """Average each object's features over its frames; locations/boxes
        from the (optionally rotated) gt point clouds."""
        scan = self._scan(scan_id)
        rot = build_rotate_mat(self.split)
        obj_dict: Dict[int, Dict[str, Any]] = {}
        for name in sampled:
            for inst in mv_info[name]["instance_info"]:
                if not inst.get("is_need_process", False):
                    continue
                feat = np.asarray(inst[args.inst_feat_type])
                feat = feat[0] if feat.ndim > 1 and feat.shape[0] == 1 else feat
                inst_id = self._org_to_id(inst["org_inst_id"])
                if inst_id in obj_dict:
                    obj_dict[inst_id]["feat"].append(feat)
                    continue
                obj_pcd = np.array(scan["obj_pcds"][inst_id], copy=True)
                if rot is not None:
                    obj_pcd[:, :3] = obj_pcd[:, :3] @ rot.T
                center = obj_pcd[:, :3].mean(0)
                size = obj_pcd[:, :3].max(0) - obj_pcd[:, :3].min(0)
                box_center = (obj_pcd[:, :3].max(0) + obj_pcd[:, :3].min(0)) / 2
                obj_dict[inst_id] = {
                    "feat": [feat],
                    "location": np.concatenate([center, size], 0),
                    "label": scan["inst_labels"][inst_id],
                    "box": np.concatenate([box_center, size], 0),
                }
        if args.get("pooling_strategy", "average_all") == "average_all":
            for rec in obj_dict.values():
                rec["feat"] = np.mean(np.asarray(rec["feat"]), axis=0)
        return obj_dict

    def _per_frame_features(self, args, mv_info, sampled, scan_id):
        """Fixed-size frame×instance grids, flattened frame-major."""
        scan = self._scan(scan_id)
        F, I, L = args.max_frame_num, args.max_inst_per_frame, args.inst_feat_len
        feat = np.zeros((F, I, L), np.float32)
        mask = np.zeros((F, I), np.float32)
        loc = np.zeros((F, I, 3), np.float32)
        pose = np.zeros((F, I, 16), np.float32)
        cls = np.full((F, I), -100.0, np.float32)
        for i, name in enumerate(sampled):
            frame = mv_info[name]
            inst_all = [x for x in frame["instance_info"] if x.get("is_need_process")]
            n = min(I, len(inst_all))
            for j, inst in enumerate(random.sample(inst_all, n)):
                f = np.asarray(inst[args.inst_feat_type])
                feat[i, j] = f[0] if f.ndim > 1 and f.shape[0] == 1 else f
                mask[i, j] = 1
                if args.get("inst_position_type", "pc_gt") == "pc_gt":
                    inst_id = self._org_to_id(inst["org_inst_id"])
                    loc[i, j] = convert_pc_to_box(scan["obj_pcds"][inst_id])[0]
                    cls[i, j] = scan["inst_labels"][inst_id]
            pose[i, :, :] = np.tile(np.asarray(frame["camera_pose"], np.float32), (I, 1))
        return {
            "mv_inst_feats": feat.reshape(F * I, L),
            "mv_inst_masks": mask.reshape(F * I),
            "mv_inst_locs": loc.reshape(F * I, 3),
            "mv_camera_pose": pose.reshape(F * I, 16),
            "mv_inst_labels": cls.reshape(F * I),
        }


@DATASET_REGISTRY.register(name="ScanNetMVPretrain")
class ScanNetMVPretrain(_MVMixin, ScanNetLegacyBase):
    """Scene captions + multiview features."""

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        self.scan_ids = self._load_split(split)
        self.lang_data = self._load_lang()

    def _load_lang(self) -> List:
        lang = []
        for anno_type in self.cfg.data.mvpretrain.scan_caption.get("anno_type", ["gpt"]):
            f = self.base_dir / "annotations" / "refer" / f"ssg_caption_{anno_type}.json"
            if not f.exists():
                continue
            for item in json.load(open(f, encoding="utf-8")):
                if item["scan_id"] in self.scan_ids:
                    lang.append(("scannet", item["scan_id"], item["utterance"]))
        return lang

    def __len__(self):
        return len(self.lang_data)

    def __getitem__(self, index):
        source, scan_id, sentence = self.lang_data[index]
        mv = self._get_multiview_info(scan_id)
        data_dict = {"source": source, "scan_id": scan_id, "sentence": sentence}
        if self.cfg.data.mvdatasettings.get("is_pool_obj_feature", True):
            data_dict["vis_obj_feats"] = [mv[k]["feat"] for k in mv]
            data_dict["vis_obj_locs"] = [mv[k]["location"] for k in mv]
            data_dict["vis_obj_labels"] = [mv[k]["label"] for k in mv]
        else:
            data_dict.update(mv)
        return data_dict


@DATASET_REGISTRY.register(name="ScanNetMVReferit3D")
class ScanNetMVReferit3D(_MVMixin, ScanNetLegacyBase):
    """Referit3D grounding over pooled multiview object features: the
    object stream is 2D-feature-based instead of
    point clouds; targets/crop/iou flags follow the pcd variant."""

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        args = cfg.data.mvreferit3d.args
        self.max_obj_len = args.max_obj_len
        self.filter_lang = args.get("filter_lang", False)
        self.anno_type = args.anno_type
        assert self.anno_type in ("nr3d", "sr3d")
        eff_split = "val" if split == "test" else split
        split_scan_ids = set(self._load_split(eff_split))
        self.lang_data = [
            it
            for it in _load_jsonl(
                self.base_dir / "annotations" / "refer" / f"{self.anno_type}.jsonl"
            )
            if it["scan_id"] in split_scan_ids and len(it["tokens"]) <= 24
        ]

    def __len__(self):
        return len(self.lang_data)

    def __getitem__(self, index):
        item = self.lang_data[index]
        scan_id = item["scan_id"]
        tgt_object_id = int(item["target_id"])
        tgt_object_name = item["instance_type"]
        sentence = item["utterance"]

        mv = self._get_multiview_info(scan_id)
        inst_ids = list(mv.keys())

        selected = [
            i
            for i in inst_ids
            if self.int2cat[mv[i]["label"]] not in BACKGROUND_CATS
            and (not self.filter_lang or self.int2cat[mv[i]["label"]] in sentence)
        ]
        if self.filter_lang and tgt_object_id not in selected:
            selected.append(tgt_object_id)

        assert tgt_object_id in inst_ids
        tgt_object_label = mv[tgt_object_id]["label"]
        assert self.int2cat[tgt_object_label] == tgt_object_name
        iou25, iou50 = [tgt_object_id], [tgt_object_id]

        # target-first crop
        if self.max_obj_len < len(selected):
            keep = list(dict.fromkeys([tgt_object_id] + iou25 + iou50))
            remained = []
            for kobj in selected:
                if kobj not in keep:
                    if mv[kobj]["label"] == tgt_object_label:
                        keep.append(kobj)
                    else:
                        remained.append(kobj)
                if len(keep) == self.max_obj_len:
                    break
            if len(keep) < self.max_obj_len:
                random.shuffle(remained)
                keep += remained[: self.max_obj_len - len(keep)]
            selected = keep
        elif tgt_object_id not in selected:
            selected.append(tgt_object_id)

        tgt_idx = selected.index(tgt_object_id)
        iou25_hot = np.zeros(len(selected), np.int64)
        iou50_hot = np.zeros(len(selected), np.int64)
        iou25_hot[tgt_idx] = 1
        iou50_hot[tgt_idx] = 1

        count = self._label_count(scan_id)[
            self.label_converter.id_to_scannetid[tgt_object_label]
        ]
        data_dict = {
            "sentence": sentence,
            "tgt_object_id": np.asarray([tgt_idx], np.int64),
            "tgt_object_label": np.asarray([tgt_object_label], np.int64),
            "data_idx": item["item_id"],
            "tgt_object_id_iou25": iou25_hot,
            "tgt_object_id_iou50": iou50_hot,
            "is_multiple": count > 1,
            "is_view_dependent": is_explicitly_view_dependent(item["tokens"]),
            "is_hard": count > 2,
            "obj_fts": np.asarray([mv[i]["feat"] for i in selected], np.float32),
            "obj_locs": np.asarray([mv[i]["location"] for i in selected], np.float32),
            "obj_labels": np.asarray([mv[i]["label"] for i in selected], np.int64),
            "obj_boxes": np.asarray([mv[i]["box"] for i in selected], np.float32),
        }
        assert data_dict["obj_labels"][tgt_idx] == tgt_object_label
        return data_dict
