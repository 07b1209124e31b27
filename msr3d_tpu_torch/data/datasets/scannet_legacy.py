"""Legacy ScanNet task datasets: ScanNetPretrain, ScanNetScanRefer,
ScanNetReferit3D, ScanNetSpatialRefer, ScanNetScanQA (and its instruction
form) and ScanNetSGQA.

Counterpart of ``msr3d_tpu/data/datasets/scannet_legacy.py``, registered
under the same names. These feed the grounding, QA and pretraining heads
(``nn/grounding.py``, ``optim/losses.py``) rather than the LLM path; items
are numpy dicts that ``ScanFamilyDatasetWrapper`` / ``MaskDatasetWrapper``
tokenize and pad. Scans load through ``ScanDataLoader``/``ScanCache`` and
each dataset keeps its own per-scan record, keyed ``scan_id:pc_type``.
Rotations, the crop's fill and the point resampling draw from Python's
``random`` and numpy's global generator, as the JAX package's do.
"""

from __future__ import annotations

import collections
import json
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from msr3d_tpu_torch.data.box_utils import (
    construct_bbox_corners,
    convert_pc_to_box,
    eval_ref_one_sample,
)
from msr3d_tpu_torch.data.data_utils import (
    IdentityLabelConverter,
    LabelConverter,
    ScanQAAnswer,
    _matrix_to_quat,
    _quat_to_matrix,
    build_rotate_mat,
    face_vector_in_xy_to_quaternion,
    get_sqa_question_type,
    is_explicitly_view_dependent,
)
from msr3d_tpu_torch.data.scan_loader import ScanCache, ScanDataLoader
from msr3d_tpu_torch.registry import DATASET_REGISTRY

BACKGROUND_CATS = ("wall", "floor", "ceiling")


def _load_jsonl(path) -> List[Dict]:
    items = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
    return items


class ScanNetLegacyBase:
    """Shared substrate: category tables, split lists, cached per-scan object
    loads, and the post-processing that turns raw object clouds into
    fixed-size arrays."""

    def __init__(self, cfg, split: str):
        assert split in ("train", "val", "test")
        self.cfg = cfg
        self.split = split
        self.base_dir = Path(cfg.data.scan_family_base)

        cats = json.load(
            open(
                self.base_dir / "annotations" / "meta_data" / "scannetv2_raw_categories.json",
                encoding="utf-8",
            )
        )
        self.int2cat = list(cats)
        self.cat2int = {c: i for i, c in enumerate(self.int2cat)}

        tsv = self.base_dir / "annotations" / "meta_data" / "scannetv2-labels.combined.tsv"
        self.label_converter = LabelConverter(tsv) if tsv.exists() else IdentityLabelConverter()

        self.loader = ScanDataLoader(cfg, dataset="ScanNet")
        self._scan_cache: Dict[str, Dict[str, Any]] = {}

    # -- split / scan loading -------------------------------------------

    def _load_split(self, split: str) -> List[str]:
        split_file = self.base_dir / "annotations" / "splits" / f"scannetv2_{split}.txt"
        scan_ids = sorted({x.strip() for x in open(split_file, encoding="utf-8") if x.strip()})
        debug = self.cfg.get("debug", {})
        if debug.get("flag", False) and debug.get("debug_size", -1) != -1:
            scan_ids = scan_ids[: debug.get("debug_size")]
        return scan_ids

    def _scan(self, scan_id: str, pc_type: str = "gt") -> Dict[str, Any]:
        """Per-scan record: obj_pcds (list), inst_labels (list of cat ids) and,
        for pred, matched labels + boxes."""
        key = f"{scan_id}:{pc_type}"
        if key in self._scan_cache:
            return self._scan_cache[key]
        raw = ScanCache.get(self.loader, "ScanNet", scan_id, ["obj_pcds"], pc_type=pc_type)
        pcds_dict = raw["obj_pcds"]
        obj_pcds = [pcds_dict[i] for i in sorted(pcds_dict.keys())]

        name_file = self.base_dir / "scan_data" / "instance_id_to_name" / f"{scan_id}.json"
        names = json.load(open(name_file, encoding="utf-8")) if name_file.exists() else []
        inst_labels = [self.cat2int.get(n, -1) for n in names]

        rec: Dict[str, Any] = {"obj_pcds": obj_pcds, "inst_labels": inst_labels}
        boxes = [convert_pc_to_box(p) for p in obj_pcds]
        rec["obj_center"] = [c for c, _ in boxes]
        rec["obj_box_size"] = [s for _, s in boxes]

        if pc_type == "pred":
            rec["obj_pcds_pred"] = raw.get("obj_pcds_pred", [])
            rec["inst_labels_pred"] = list(raw.get("inst_labels_pred", []))
            pboxes = [convert_pc_to_box(p) for p in rec["obj_pcds_pred"]]
            rec["obj_center_pred"] = [c for c, _ in pboxes]
            rec["obj_box_size_pred"] = [s for _, s in pboxes]
            # label matching by IoU≥0.25 against gt boxes
            for i in range(len(rec["obj_pcds_pred"])):
                for j in range(len(obj_pcds)):
                    if eval_ref_one_sample(
                        construct_bbox_corners(rec["obj_center"][j], rec["obj_box_size"][j]),
                        construct_bbox_corners(
                            rec["obj_center_pred"][i], rec["obj_box_size_pred"][i]
                        ),
                    ) >= 0.25:
                        rec["inst_labels_pred"][i] = inst_labels[j]
                        break

        self._scan_cache[key] = rec
        return rec

    def _label_count(self, scan_id: str) -> collections.Counter:
        """Unique/multiple lookup in the 18-class space."""
        labels = self._scan(scan_id)["inst_labels"]
        return collections.Counter(self.label_converter.id_to_scannetid[l] for l in labels)

    # -- item post-processing --------------------------------------------

    def _filter_idxs(
        self,
        obj_labels: Sequence[int],
        pc_type: str,
        sentence: Optional[str] = None,
        filter_lang: bool = False,
        keep_ids: Sequence[int] = (),
    ) -> List[int]:
        """Background (+ optional language) filtering:
        only meaningful for gt labels; pred keeps everything."""
        if pc_type != "gt":
            return list(range(len(obj_labels)))
        if filter_lang and sentence is not None:
            sel = [
                i
                for i, l in enumerate(obj_labels)
                if self.int2cat[l] not in BACKGROUND_CATS and self.int2cat[l] in sentence
            ]
            for _id in keep_ids:
                if _id not in sel:
                    sel.append(_id)
            return sel
        return [
            i for i, l in enumerate(obj_labels) if self.int2cat[l] not in BACKGROUND_CATS
        ]

    def _crop_target_first(
        self,
        obj_pcds: List[np.ndarray],
        obj_labels: List[int],
        max_obj_len: int,
        tgt_ids: List[int],
        tgt_labels: List[int],
    ) -> Tuple[List[np.ndarray], List[int], List[int]]:
        """Crop to ``max_obj_len`` keeping targets, then same-class objects,
        then a random fill. Returns (pcds, labels,
        remapped target ids)."""
        if len(obj_pcds) <= max_obj_len:
            return obj_pcds, obj_labels, list(tgt_ids)
        selected = list(dict.fromkeys([i for i in tgt_ids if i >= 0]))
        remained = []
        for kobj, klabel in enumerate(obj_labels):
            if kobj not in selected:
                if klabel in tgt_labels:
                    selected.append(kobj)
                else:
                    remained.append(kobj)
            if len(selected) == max_obj_len:
                break
        selected = selected[:max_obj_len]
        if len(selected) < max_obj_len:
            random.shuffle(remained)
            selected += remained[: max_obj_len - len(selected)]
        new_pcds = [obj_pcds[i] for i in selected]
        new_labels = [obj_labels[i] for i in selected]
        new_tgt = [selected.index(i) if i in selected else -1 for i in tgt_ids]
        return new_pcds, new_labels, new_tgt

    def obj_processing_post(
        self,
        obj_pcds: List[np.ndarray],
        obj_labels: List[int],
        is_need_bbox: bool = False,
        rot_aug: bool = True,
        situation=None,
    ):
        """Rotate-augment, per-object center+size locs, ``num_points``
        resample, unit-sphere normalize. numpy-out:
        the wrapper pads and the device step consumes fixed shapes."""
        rot_matrix = build_rotate_mat(self.split, rot_aug)
        obj_fts, obj_locs, obj_boxes = [], [], []
        for obj_pcd in obj_pcds:
            obj_pcd = np.array(obj_pcd, copy=True)
            if rot_matrix is not None:
                obj_pcd[:, :3] = obj_pcd[:, :3] @ rot_matrix.T
            center = obj_pcd[:, :3].mean(0)
            size = obj_pcd[:, :3].max(0) - obj_pcd[:, :3].min(0)
            obj_locs.append(np.concatenate([center, size], 0))
            if is_need_bbox:
                box_center = (obj_pcd[:, :3].max(0) + obj_pcd[:, :3].min(0)) / 2
                obj_boxes.append(np.concatenate([box_center, size], 0))
            idxs = np.random.choice(
                len(obj_pcd), size=self.num_points, replace=len(obj_pcd) < self.num_points
            )
            obj_pcd = obj_pcd[idxs]
            obj_pcd[:, :3] -= obj_pcd[:, :3].mean(0)
            max_dist = np.sqrt((obj_pcd[:, :3] ** 2).sum(1)).max()
            if max_dist < 1e-6:
                max_dist = 1
            obj_pcd[:, :3] /= max_dist
            obj_fts.append(obj_pcd)

        out = (
            np.stack(obj_fts, 0).astype(np.float32),
            np.asarray(obj_locs, np.float32),
            np.asarray(obj_boxes, np.float32) if obj_boxes else np.zeros((0, 6), np.float32),
            np.asarray(obj_labels, np.int64),
        )
        if situation is None:
            return out
        pos, ori = situation
        if rot_matrix is not None:
            pos = (np.asarray(pos).reshape(1, 3) @ rot_matrix.T).reshape(-1)
            ori = _matrix_to_quat(rot_matrix @ _quat_to_matrix(np.asarray(ori)))
        return out + ((np.asarray(pos, np.float32), np.asarray(ori, np.float32)),)


# ---------------------------------------------------------------------------


@DATASET_REGISTRY.register(name="ScanNetPretrain")
class ScanNetPretrain(ScanNetLegacyBase):
    """Scene-caption pretraining items: random object crop,
    no targets; pairs with ``MaskDatasetWrapper`` for MLM + object masking."""

    def __init__(self, cfg, split, sources=None):
        super().__init__(cfg, split)
        args = cfg.data.pretrain.args
        self.pc_type = args.get("pc_type", "gt")
        self.max_obj_len = args.get("max_obj_len", 60)
        self.num_points = args.get("num_points", 1024)
        self.scan_ids = self._load_split(split)
        self.lang_data = self._load_lang(sources)

    def _load_lang(self, sources) -> List[Tuple[str, str, str]]:
        """('scannet', scan_id, caption) triples from the ssg captions."""
        lang = []
        split_key = "scannet_train" if self.split == "train" else "scannet_val"
        split_cfg = self.cfg.data.pretrain.args.get(split_key, {})
        for anno_type in split_cfg.get("anno_type", ["gpt"]):
            anno_file = self.base_dir / "annotations" / "refer" / f"ssg_caption_{anno_type}.json"
            if not anno_file.exists():
                continue
            for item in json.load(open(anno_file, encoding="utf-8")):
                if item["scan_id"] in self.scan_ids:
                    lang.append(("scannet", item["scan_id"], item["utterance"]))
        return lang

    def __len__(self):
        return len(self.lang_data)

    def __getitem__(self, index):
        source, scan_id, sentence = self.lang_data[index]
        scan = self._scan(scan_id, self.pc_type)
        if self.pc_type == "gt":
            obj_pcds, obj_labels = scan["obj_pcds"], scan["inst_labels"]
        else:
            obj_pcds, obj_labels = scan["obj_pcds_pred"], scan["inst_labels_pred"]

        sel = self._filter_idxs(obj_labels, "gt")
        obj_pcds = [obj_pcds[i] for i in sel]
        obj_labels = [obj_labels[i] for i in sel]
        if len(obj_pcds) > self.max_obj_len:
            idxs = list(range(len(obj_pcds)))
            random.shuffle(idxs)
            idxs = idxs[: self.max_obj_len]
            obj_pcds = [obj_pcds[i] for i in idxs]
            obj_labels = [obj_labels[i] for i in idxs]

        obj_fts, obj_locs, _, obj_labels = self.obj_processing_post(obj_pcds, obj_labels)
        return {
            "source": source,
            "scan_id": scan_id,
            "sentence": sentence,
            "obj_fts": obj_fts,
            "obj_locs": obj_locs,
            "obj_labels": obj_labels,
        }


class _ReferBase(ScanNetLegacyBase):
    """Shared grounding item builder for ScanRefer / Referit3D / SpatialRefer
    (the same item modulo the annotation source)."""

    def _build_item(self, item, *, is_view_dependent=None, extra=None):
        item_id = item["item_id"]
        scan_id = item["scan_id"]
        tgt_object_id = int(item["target_id"])
        tgt_object_name = item["instance_type"]
        sentence = item["utterance"]

        scan = self._scan(scan_id, self.pc_type)
        if self.pc_type == "gt":
            obj_pcds, obj_labels = scan["obj_pcds"], list(scan["inst_labels"])
        else:
            obj_pcds, obj_labels = scan["obj_pcds_pred"], list(scan["inst_labels_pred"])

        sel = self._filter_idxs(
            obj_labels, self.pc_type, sentence, self.filter_lang, [tgt_object_id]
        )
        obj_pcds = [obj_pcds[i] for i in sel]
        obj_labels = [obj_labels[i] for i in sel]

        if self.pc_type == "gt":
            tgt_object_id = sel.index(tgt_object_id)
            tgt_object_label = obj_labels[tgt_object_id]
            iou25, iou50 = [tgt_object_id], [tgt_object_id]
            assert self.int2cat[tgt_object_label] == tgt_object_name
        else:
            # match pred instances to the gt target box
            gt_pcd = scan["obj_pcds"][tgt_object_id] if tgt_object_id < len(scan["obj_pcds"]) else None
            gt_center, gt_size = convert_pc_to_box(gt_pcd) if gt_pcd is not None else (None, None)
            tgt_object_id, iou25, iou50 = -1, [], []
            tgt_object_label = self.cat2int.get(tgt_object_name, 0)
            if gt_center is not None:
                gt_corners = construct_bbox_corners(gt_center, gt_size)
                for i, p in enumerate(obj_pcds):
                    c, s = convert_pc_to_box(p)
                    iou = eval_ref_one_sample(construct_bbox_corners(c, s), gt_corners)
                    if iou >= 0.25:
                        tgt_object_id = i
                        iou25.append(i)
                    if iou >= 0.5:
                        iou50.append(i)

        obj_pcds, obj_labels, remap = self._crop_target_first(
            obj_pcds, obj_labels, self.max_obj_len,
            [tgt_object_id] + iou25 + iou50, [tgt_object_label],
        )
        if len(remap) > 0:
            tgt_object_id = remap[0]
            iou25 = [i for i in remap[1 : 1 + len(iou25)] if i >= 0]
            iou50 = [i for i in remap[1 + len(iou25) :] if i >= 0]
        if tgt_object_id == -1:
            tgt_object_id = len(obj_pcds)

        obj_fts, obj_locs, obj_boxes, obj_labels_arr = self.obj_processing_post(
            obj_pcds, obj_labels, is_need_bbox=True
        )
        iou25_hot = np.zeros(len(obj_fts) + 1, np.int64)
        iou50_hot = np.zeros(len(obj_fts) + 1, np.int64)
        iou25_hot[list(set(iou25))] = 1
        iou50_hot[list(set(iou50))] = 1

        scannetid = self.label_converter.id_to_scannetid[tgt_object_label]
        count = self._label_count(scan_id)[scannetid]

        data_dict = {
            "sentence": sentence,
            "tgt_object_id": np.asarray([tgt_object_id], np.int64),
            "tgt_object_label": np.asarray([tgt_object_label], np.int64),
            "obj_fts": obj_fts,
            "obj_locs": obj_locs,
            "obj_labels": obj_labels_arr,
            "obj_boxes": obj_boxes,
            "data_idx": item_id,
            "tgt_object_id_iou25": iou25_hot,
            "tgt_object_id_iou50": iou50_hot,
            "is_multiple": count > 1,
        }
        if is_view_dependent is not None:
            data_dict["is_view_dependent"] = is_view_dependent
            data_dict["is_hard"] = count > 2
        if extra:
            data_dict.update(extra)
        return data_dict

    def __len__(self):
        return len(self.lang_data)


@DATASET_REGISTRY.register(name="ScanNetScanRefer")
class ScanNetScanRefer(_ReferBase):
    """ScanRefer grounding: refer/scanrefer.jsonl."""

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        args = cfg.data.scanrefer.args
        self.pc_type = args.pc_type if split != "train" else "gt"
        self.max_obj_len = args.max_obj_len - 1
        self.num_points = args.num_points
        self.filter_lang = args.filter_lang
        eff_split = "val" if split == "test" else split
        split_scan_ids = set(self._load_split(eff_split))
        self.lang_data = [
            it
            for it in _load_jsonl(self.base_dir / "annotations" / "refer" / "scanrefer.jsonl")
            if it["scan_id"] in split_scan_ids
        ]
        self.scan_to_item_idxs = collections.defaultdict(list)
        for i, it in enumerate(self.lang_data):
            self.scan_to_item_idxs[it["scan_id"]].append(i)

    def __getitem__(self, index):
        return self._build_item(self.lang_data[index])


@DATASET_REGISTRY.register(name="ScanNetReferit3D")
class ScanNetReferit3D(_ReferBase):
    """Nr3D/Sr3D grounding: ≤24-token filter, optional
    sr3d+ augmentation, view-dependence/hardness flags."""

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        args = cfg.data.referit3d.args
        self.pc_type = args.pc_type if split != "train" else "gt"
        self.max_obj_len = args.max_obj_len - 1
        self.num_points = args.num_points
        self.filter_lang = args.filter_lang
        self.anno_type = args.anno_type
        assert self.anno_type in ("nr3d", "sr3d")
        eff_split = "val" if split == "test" else split
        split_scan_ids = set(self._load_split(eff_split))

        files = [self.base_dir / "annotations" / "refer" / f"{self.anno_type}.jsonl"]
        if args.get("sr3d_plus_aug", False):
            files.append(self.base_dir / "annotations" / "refer" / "sr3d+.jsonl")
        self.lang_data = [
            it
            for f in files
            for it in _load_jsonl(f)
            if it["scan_id"] in split_scan_ids and len(it["tokens"]) <= 24
        ]

    def __getitem__(self, index):
        item = self.lang_data[index]
        return self._build_item(
            item, is_view_dependent=is_explicitly_view_dependent(item["tokens"])
        )


@DATASET_REGISTRY.register(name="ScanNetSpatialRefer")
class ScanNetSpatialRefer(_ReferBase):
    """Scene-graph spatial referring: multi-source
    annotations (referit3d / scanrefer / sgrefer / sgcaption)."""

    def __init__(self, cfg, split, sources=None):
        super().__init__(cfg, split)
        args = cfg.data.spatialrefer.args
        self.pc_type = args.pc_type if split != "train" else "gt"
        self.max_obj_len = args.max_obj_len - 1
        self.num_points = args.num_points
        self.filter_lang = args.filter_lang
        eff_split = "val" if split == "test" else split
        split_scan_ids = set(self._load_split(eff_split))
        split_key = "scannet_train" if eff_split == "train" else "scannet_val"
        split_cfg = args.get(split_key, {})
        sources = sources or split_cfg.get("sources", [])
        self.lang_data = self._load_lang(split_cfg, sources, split_scan_ids)

    def _load_lang(self, split_cfg, sources, split_scan_ids):
        lang = []
        refer_dir = self.base_dir / "annotations" / "refer"
        if "referit3d" in sources:
            for anno_type in split_cfg.get("referit3d", {}).get("anno_type", []):
                for it in _load_jsonl(refer_dir / f"{anno_type}.jsonl"):
                    if it["scan_id"] in split_scan_ids and len(it["tokens"]) <= 24:
                        lang.append(it)
        if "scanrefer" in sources:
            for it in _load_jsonl(refer_dir / "scanrefer.jsonl"):
                if it["scan_id"] in split_scan_ids:
                    lang.append(it)
        for src, stem in (("sgrefer", "ssg_{}_rels.json"), ("sgcaption", "ssg_{}_caption_sumi.json")):
            if src in sources:
                for anno_type in split_cfg.get(src, {}).get("anno_type", []):
                    for it in json.load(open(refer_dir / stem.format(anno_type), encoding="utf-8")):
                        if (
                            it["scan_id"] in split_scan_ids
                            and it["instance_type"] not in BACKGROUND_CATS
                        ):
                            lang.append(it)
        return lang

    def __getitem__(self, index):
        item = self.lang_data[index]
        return self._build_item(
            item,
            is_view_dependent=is_explicitly_view_dependent(item["utterance"].split(" ")),
        )


@DATASET_REGISTRY.register(name="ScanNetScanQA")
class ScanNetScanQA(ScanNetLegacyBase):
    """ScanQA: multi-answer QA with grounded objects;
    answers become a multi-hot over the train answer vocabulary."""

    def __init__(self, cfg, split, sources=None):
        super().__init__(cfg, split)
        args = cfg.data.scanqa.args
        self.pc_type = args.pc_type if split != "train" else "gt"
        self.max_obj_len = args.max_obj_len - 1
        self.num_points = args.num_points
        self.filter_lang = args.filter_lang
        self.use_unanswer = args.use_unanswer
        self.eff_split = "val" if split == "test" else split
        self.is_test = False

        self.num_answers, self.answer_vocab, self.answer_cands = self._build_answer()
        self.lang_data = self._load_lang()

    def _build_answer(self):
        train = json.load(
            open(self.base_dir / "annotations" / "qa" / "ScanQA_v1.0_train.json", encoding="utf-8")
        )
        counter = collections.Counter(sorted(sum([d["answers"] for d in train], [])))
        return len(counter), ScanQAAnswer(list(counter.keys())), list(counter.keys())

    def _load_lang(self):
        anno = json.load(
            open(
                self.base_dir / "annotations" / "qa" / f"ScanQA_v1.0_{self.eff_split}.json",
                encoding="utf-8",
            )
        )
        lang = [
            it
            for it in anno
            if self.use_unanswer or len(set(it["answers"]) & set(self.answer_cands)) > 0
        ]
        debug = self.cfg.get("debug", {})
        if debug.get("flag", False):
            keep = set(sorted({it["scene_id"] for it in lang})[: debug.get("debug_size", 20)])
            lang = [it for it in lang if it["scene_id"] in keep]
        return lang

    def __len__(self):
        return len(self.lang_data)

    def __getitem__(self, index):
        item = self.lang_data[index]
        # question_id digit munging
        digits = "".join(c for c in str(item["question_id"]) if c.isdigit())
        item_id = int(digits[:-1].lstrip("0") + digits[-1])
        scan_id = item["scene_id"]
        question = item["question"]
        tgt_ids = list(item.get("object_ids", []))
        tgt_names = list(item.get("object_names", []))
        answer_list = list(item.get("answers", []))
        answer_id_list = [
            self.answer_vocab.stoi(a) for a in answer_list if self.answer_vocab.stoi(a) >= 0
        ]

        scan = self._scan(scan_id, self.pc_type)
        if self.pc_type == "gt":
            obj_pcds, obj_labels = scan["obj_pcds"], list(scan["inst_labels"])
        else:
            obj_pcds, obj_labels = scan["obj_pcds_pred"], list(scan["inst_labels_pred"])

        sel = self._filter_idxs(obj_labels, self.pc_type, question, self.filter_lang, tgt_ids)
        obj_pcds = [obj_pcds[i] for i in sel]
        obj_labels = [obj_labels[i] for i in sel]

        if self.pc_type == "gt":
            tgt_ids = [sel.index(x) for x in tgt_ids]
            tgt_labels = [obj_labels[x] for x in tgt_ids]
            for lbl, name in zip(tgt_labels, tgt_names):
                assert self.int2cat[lbl] == name
        else:
            gt_boxes = [convert_pc_to_box(scan["obj_pcds"][i]) for i in tgt_ids]
            tgt_ids, tgt_labels = [], []
            for i, p in enumerate(obj_pcds):
                c, s = convert_pc_to_box(p)
                for j, (gc, gs) in enumerate(gt_boxes):
                    if eval_ref_one_sample(
                        construct_bbox_corners(c, s), construct_bbox_corners(gc, gs)
                    ) >= 0.25:
                        tgt_ids.append(i)
                        tgt_labels.append(self.cat2int.get(tgt_names[j], 0))
                        break

        obj_pcds, obj_labels, remap = self._crop_target_first(
            obj_pcds, obj_labels, self.max_obj_len, tgt_ids, tgt_labels
        )
        tgt_ids = [i for i in remap if i >= 0]
        if not tgt_ids:
            tgt_ids, tgt_labels = [len(obj_pcds)], [5]

        obj_fts, obj_locs, obj_boxes, obj_labels_arr = self.obj_processing_post(
            obj_pcds, obj_labels, is_need_bbox=True
        )
        answer_label = np.zeros(self.num_answers, np.int64)
        answer_label[answer_id_list] = 1
        tgt_object_id = np.zeros(len(obj_fts) + 1, np.int64)
        tgt_object_id[tgt_ids] = 1
        tgt_object_label = np.zeros(607, np.int64)
        tgt_object_label[[l for l in tgt_labels if 0 <= l < 607]] = 1

        return {
            "sentence": question,
            "scan_dir": str(self.base_dir / "scans"),
            "scan_id": scan_id,
            "answer_list": "[answer_seq]".join(answer_list),
            "answer_label": answer_label,
            "tgt_object_id": tgt_object_id,
            "tgt_object_label": tgt_object_label,
            "obj_fts": obj_fts,
            "obj_locs": obj_locs,
            "obj_labels": obj_labels_arr,
            "obj_boxes": obj_boxes,
            "data_idx": item_id,
        }


@DATASET_REGISTRY.register(name="ScanNetScanQAInstruction")
class ScanNetScanQAInstruction(ScanNetScanQA):
    """ScanQA in LLM-instruction form: holistic prompt +
    object-token slot + random gold answer as text_output."""

    holistic_prompt = (
        "Assume you are an AI visual assistant situated in a 3D scene. You "
        "receive a sequence of object tokens in the scene, each representing "
        "the feature of a corresponding object. Next you will receive a "
        "question to answer based on the visual information embedded in the "
        "object tokens."
    )

    def __getitem__(self, index):
        data_dict = super().__getitem__(index)
        data_dict["prompt_before_obj"] = (
            f"{self.holistic_prompt} Here are the object tokens in the scene: "
        )
        data_dict["prompt_after_obj"] = f". Question: {data_dict['sentence']} Answer: "
        answers = data_dict["answer_list"].split("[answer_seq]")
        data_dict["text_output"] = random.choice(answers)
        return data_dict


@DATASET_REGISTRY.register(name="ScanNetSGQA")
class ScanNetSGQA(ScanNetLegacyBase):
    """Scene-graph situated QA: MSQA-style items with
    situation pos/orientation from face vectors; relevant objects kept first."""

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        args = cfg.data.scannet_sgqa.args
        self.pc_type = args.get("pc_type", "gt") if split != "train" else "gt"
        self.num_points = args.get("num_points", 1024)
        self.max_obj_len = args.get("max_obj_len", 60)
        self.data, self.scan_ids = self._load_lang(args.anno_dir, split)
        debug = cfg.get("debug", {})
        if debug.get("flag", False):
            self.data = self.data[: debug.get("debug_size", 20)]

    def _load_lang(self, anno_dir, split):
        out, scan_ids = [], set()
        payload = json.load(open(Path(anno_dir) / f"sgqa_{split}.json", encoding="utf-8"))
        for scan_id, v in payload.items():
            if "response" not in v:
                continue
            for meta in v["response"]:
                try:
                    insts = [int(s.split("-")[-1]) for s in meta["T"].split(", ")]
                except Exception:
                    insts = []
                meta["A"] = [a.strip() for a in meta["A"]]
                out.append({"scan_id": scan_id, "qa_pair": meta, "insts": insts})
            scan_ids.add(scan_id)
        return out, sorted(scan_ids)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        sample = self.data[index]
        qa = sample["qa_pair"]
        question = qa["Q"]
        scan_id = sample["scan_id"]

        scan = self._scan(scan_id, self.pc_type)
        obj_pcds = {i: p for i, p in enumerate(scan["obj_pcds"])}

        # relevant-objects-first crop
        if len(obj_pcds) <= self.max_obj_len:
            selected = list(obj_pcds.values())
        else:
            selected = [obj_pcds[i] for i in sample["insts"] if i in obj_pcds]
            if len(selected) >= self.max_obj_len:
                random.shuffle(selected)
                selected = selected[: self.max_obj_len]
            else:
                rest = [i for i in obj_pcds if i not in sample["insts"]]
                random.shuffle(rest)
                selected += [obj_pcds[i] for i in rest[: self.max_obj_len - len(selected)]]

        obj_fts, obj_locs, _, _ = self.obj_processing_post(
            selected, [0] * len(selected), is_need_bbox=False
        )
        return {
            "situation": qa["situation"],
            "situation_pos": np.asarray(qa["location"], np.float32),
            "situation_rot": face_vector_in_xy_to_quaternion(qa["orientation"]),
            "question": question,
            "answer_list": "[answer_seq]".join(qa["A"]),
            "obj_fts": obj_fts,
            "obj_locs": obj_locs,
            "sqa_type": get_sqa_question_type(question),
        }
