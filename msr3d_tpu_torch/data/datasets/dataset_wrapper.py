"""Dataset wrappers + collate.

Counterparts of ``msr3d_tpu/data/datasets/dataset_wrapper.py``:

  * ``LeoScanFamilyDatasetWrapper`` (the MSQA path) pads per-item ragged
    fields to fixed shapes (obj_fts → max_obj_len with pad=1.0, msr3d_imgs
    → msr3d_max_img_num) and its collate stacks into batch-first numpy
    arrays, keeping strings as lists;
  * ``ScanFamilyDatasetWrapper`` and ``MaskDatasetWrapper`` (the legacy
    grounding, QA and pretraining tasks) tokenize the sentence with
    ``WordHashTokenizer`` and pad the objects; ``MaskDatasetWrapper`` adds
    the masked-word and masked-object corruptions, drawn from its own
    ``numpy.random.default_rng(cfg.rng_seed)``.

``WordHashTokenizer`` hashes words with Python's ``hash``, which is salted
per process (``PYTHONHASHSEED``): its ids are stable within a process only,
as the JAX package's are. A ``BertTokenizer`` vocabulary
(``model.prompter.model.language.args.weights``) is not read: the port
raises where the JAX package would load it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from msr3d_tpu_torch.data.data_utils import pad_tensors, random_point_cloud, random_word
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


# ---------------------------------------------------------------------------
# the legacy tasks' wrappers: tokenize the sentence and pad the objects for
# the grounding, QA and pretraining heads


class WordHashTokenizer:
    """Word-level tokenizer standing in for ``BertTokenizer`` without a
    vocabulary: ids 0 = pad, 1 = cls, 2 = sep, 3 = mask, the rest hashes of
    the lower-cased words (Python's ``hash``, salted per process)."""

    pad_token_id, cls_token_id, sep_token_id, mask_token_id = 0, 1, 2, 3
    vocab_size = 30522

    def __call__(self, sentence: str, max_length: int = 80, **_):
        import re

        words = re.findall(r"\w+|[^\w\s]", sentence.lower())
        ids = [self.cls_token_id]
        for w in words[: max_length - 2]:
            ids.append(4 + (hash(w) & 0x7FFFFFFF) % (self.vocab_size - 4))
        ids.append(self.sep_token_id)
        mask = [1] * len(ids)
        ids += [self.pad_token_id] * (max_length - len(ids))
        mask += [0] * (max_length - len(mask))
        return {"input_ids": np.asarray(ids, np.int64), "attention_mask": np.asarray(mask, np.int64)}


def _build_wrapper_tokenizer(cfg):
    """``WordHashTokenizer``; a configured ``BertTokenizer`` vocabulary
    raises (the HF tokenizer is not ported)."""
    weights = ""
    try:
        weights = cfg.model.prompter.model.language.args.weights
    except Exception:
        pass
    if weights:
        raise NotImplementedError(
            f"the legacy wrappers' BertTokenizer ({weights!r}) is not ported; unset "
            "model.prompter.model.language.args.weights to use WordHashTokenizer")
    return WordHashTokenizer()


def _task_args(cfg):
    task = cfg.get("task", "")
    if isinstance(task, str) and task:
        return getattr(cfg.data, task.lower()).args
    return cfg.data.get("wrapper", {}).get("args", {"max_seq_len": 80, "max_obj_len": 60})


@DATASETWRAPPER_REGISTRY.register(name="ScanFamilyDatasetWrapper")
class ScanFamilyDatasetWrapper:
    """Sentence → token ids, fixed-shape object padding, grounding targets."""

    def __init__(self, cfg, dataset, dataset_wrapper_args=None):
        self.dataset = dataset
        args = dataset_wrapper_args or _task_args(cfg)
        self.max_seq_length = args.get("max_seq_len", 80)
        self.max_obj_len = args.get("max_obj_len", 60)
        self.tokenizer = _build_wrapper_tokenizer(cfg)

    def __len__(self):
        return len(self.dataset)

    collate_fn = staticmethod(LeoScanFamilyDatasetWrapper.collate_fn)

    def _pad_objects(self, data_dict):
        n_real = len(data_dict["obj_locs"])
        data_dict["obj_masks"] = np.arange(self.max_obj_len) < n_real
        data_dict["obj_fts"] = pad_tensors(
            np.asarray(data_dict["obj_fts"], np.float32), self.max_obj_len, pad=1.0
        )
        data_dict["obj_locs"] = pad_tensors(
            np.asarray(data_dict["obj_locs"], np.float32), self.max_obj_len, pad=0.0
        )
        if "obj_boxes" in data_dict:
            data_dict["obj_boxes"] = pad_tensors(
                np.asarray(data_dict["obj_boxes"], np.float32), self.max_obj_len, pad=0.0
            )
        data_dict["obj_labels"] = pad_tensors(
            np.asarray(data_dict["obj_labels"], np.int64), self.max_obj_len, pad=-100
        )
        return n_real

    def __getitem__(self, idx):
        data_dict = self.dataset[idx]
        enc = self.tokenizer(data_dict["sentence"], max_length=self.max_seq_length)
        data_dict["txt_ids"] = enc["input_ids"]
        data_dict["txt_masks"] = enc["attention_mask"]

        n_real = self._pad_objects(data_dict)
        data_dict["obj_sem_masks"] = np.arange(self.max_obj_len) < n_real

        data_dict["tgt_object_label"] = np.asarray(data_dict["tgt_object_label"], np.int64)
        tgt_id = np.asarray(data_dict["tgt_object_id"], np.int64)
        if tgt_id.shape[0] > 1:  # multi-hot over objects → pad to max_obj_len
            tgt_id = pad_tensors(tgt_id, self.max_obj_len, pad=0)
        data_dict["tgt_object_id"] = tgt_id
        for key in ("tgt_object_id_iou25", "tgt_object_id_iou50"):
            if data_dict.get(key) is not None:
                data_dict[key] = pad_tensors(
                    np.asarray(data_dict[key], np.int64), self.max_obj_len, pad=0
                )
        if "answer_label" in data_dict:
            data_dict["answer_label"] = np.asarray(data_dict["answer_label"], np.int64)
        return data_dict


@DATASETWRAPPER_REGISTRY.register(name="MaskDatasetWrapper")
class MaskDatasetWrapper(ScanFamilyDatasetWrapper):
    """Masked words and masked object semantics for pretraining."""

    def __init__(self, cfg, dataset, dataset_wrapper_args=None):
        super().__init__(cfg, dataset, dataset_wrapper_args)
        args = dataset_wrapper_args or _task_args(cfg)
        self.txt_mask_ratio = args.get("txt_mask_ratio", 0.15)
        self.pc_mask_ratio = args.get("pc_mask_ratio", 0.1)
        self._rng = np.random.default_rng(int(cfg.get("rng_seed", 42)) if cfg else 42)

    def __getitem__(self, idx):
        data_dict = self.dataset[idx]
        enc = self.tokenizer(data_dict["sentence"], max_length=self.max_seq_length)
        masked_ids, lm_labels = random_word(
            enc["input_ids"], enc["attention_mask"],
            self.tokenizer.mask_token_id, self.tokenizer.vocab_size,
            self._rng, self.txt_mask_ratio,
        )
        data_dict["txt_ids"] = masked_ids
        data_dict["txt_masks"] = enc["attention_mask"]
        data_dict["masked_lm_labels"] = lm_labels

        n_real = self._pad_objects(data_dict)
        data_dict["obj_sem_masks"] = random_point_cloud(
            self.max_obj_len, np.arange(self.max_obj_len) < n_real,
            self._rng, self.pc_mask_ratio,
        )
        return data_dict
