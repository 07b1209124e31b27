"""Scan data access for ScanNet / 3RScan / ARKitScenes ``gt`` clouds.

Counterpart of ``msr3d_tpu/data/scan_loader.py``. File layouts per domain:

  ScanNet:  {scan_family_base}/scan_data/pcd_with_global_alignment/{scan}.pth
            → torch pickle (points, colors, ..., instance_labels); objects
            keyed by consecutive instance ids 0..max
  3RScan:   {rscan_base}/3RScan-ours-align/{scan}/pcds.pth + inst_to_label.pth
  ARKit:    {ARkit_base}/scan_data/pcd-align/{scan}.pth +
            instance_id_to_label/{scan}_inst_to_label.pth (objects < 10 pts
            dropped)
  predicted instances (``pc_type: pred``, ScanNet):
            {scan_family_base}/mask/{scan}.mask.npz (a sparse (instances,
            points) 0/1 matrix as ``scipy.sparse.save_npz`` writes it: CSR,
            CSC or COO, read here with numpy alone) + {scan}.label.npy
  object images: {obj_img_base}/{dataset}/{scan}_inst{id}_{label}_0.jpg

Colors normalize to [-1, 1] (colors/127.5 - 1). All outputs are numpy. The
multi-view frame crops of the legacy tasks (``get_one_img``, which nothing
calls) are not ported.
Object crops are decoded by the port's own JPEG decoder (``data/jpeg.py``)
and resized by its copy of Pillow's bilinear resample (``preprocess_2d``),
bit-equal to the JAX package's Pillow path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from msr3d_tpu_torch.data.data_utils import preprocess_2d
from msr3d_tpu_torch.data.jpeg import decode_jpeg
from msr3d_tpu_torch.utils.io import load_torch_pickle


class ScanDataLoader:
    def __init__(self, cfg, dataset: str = ""):
        self.cfg = cfg
        self.dataset = dataset
        img_args = cfg.data.get("process_args", {}).get("img_process_args", {})
        self.bbox_keep_ratio = img_args.get("bbox_keep_ratio", 0.5)
        self.min_keep_num = img_args.get("min_keep_num", 1)
        self.bbox_expand = img_args.get("bbox_expand", 0.1)
        self.tgt_img_size = tuple(img_args.get("tgt_img_size", [224, 224]))

    # -- point clouds ---------------------------------------------------

    def get_data(
        self, dataset: str, scan_id: str, data_type: List[str] = ("obj_pcds",),
        pc_type: str = "gt",
    ) -> Dict[str, Any]:
        if dataset == "ScanNet":
            return self._get_scannet_data(scan_id, data_type, pc_type=pc_type)
        if dataset == "3RScan":
            return self._get_rscan_data(scan_id, data_type)
        if dataset in ("ARkit", "ARkitScenes"):
            return self._get_arkit_data(scan_id, data_type)
        raise NotImplementedError(f"{dataset} not supported")

    def _split_objects(
        self, points, colors, instance_labels, inst_ids, min_points: int = 0
    ) -> Dict[int, np.ndarray]:
        colors = colors / 127.5 - 1
        pcds = np.concatenate([points, colors], axis=1).astype(np.float32)
        obj_pcds: Dict[int, np.ndarray] = {}
        for inst_id in inst_ids:
            mask = instance_labels == inst_id
            if min_points and mask.sum() < min_points:
                continue
            obj_pcds[int(inst_id)] = pcds[mask]
        return obj_pcds

    def _get_scannet_data(
        self, scan_id: str, data_type, pc_type: str = "gt"
    ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if "obj_pcds" in data_type:
            base = Path(self.cfg.data.scan_family_base)
            pcd_data = load_torch_pickle(
                base / "scan_data" / "pcd_with_global_alignment" / f"{scan_id}.pth",
                weights_only=False,
            )
            points, colors, instance_labels = pcd_data[0], pcd_data[1], pcd_data[-1]
            inst_ids = range(int(instance_labels.max()) + 1)
            out["obj_pcds"] = self._split_objects(
                points, colors, instance_labels, inst_ids
            )
            if pc_type == "pred":
                out.update(self._load_pred_masks(base, scan_id, points, colors))
        return out

    @staticmethod
    def _load_pred_masks(base: Path, scan_id: str, points, colors) -> Dict[str, Any]:
        """Predicted instances: the first 50 masks and labels, each non-empty
        mask's points (colours mapped to [-1, 1]) and label; ``{}`` when the
        mask or the label file is missing."""
        mask_path = base / "mask" / f"{scan_id}.mask.npz"
        label_path = base / "mask" / f"{scan_id}.label.npy"
        if not (mask_path.exists() and label_path.exists()):
            return {}
        colors_n = colors / 127.5 - 1
        pcds = np.concatenate([points, colors_n], axis=1).astype(np.float32)
        obj_mask = load_sparse_npz(mask_path)[:50, :]
        obj_labels = np.load(label_path)[:50]
        obj_pcds_pred, labels_pred = [], []
        for i in range(obj_mask.shape[0]):
            sel = pcds[obj_mask[i] == 1, :]
            if sel.shape[0] > 0:
                obj_pcds_pred.append(sel)
                labels_pred.append(int(obj_labels[i]))
        return {"obj_pcds_pred": obj_pcds_pred, "inst_labels_pred": labels_pred}

    def _get_rscan_data(self, scan_id: str, data_type) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if "obj_pcds" in data_type:
            base = Path(self.cfg.data.rscan_base) / "3RScan-ours-align" / scan_id
            pcd_data = load_torch_pickle(base / "pcds.pth", weights_only=False)
            inst_to_label = load_torch_pickle(
                base / "inst_to_label.pth", weights_only=False
            )
            points, colors, instance_labels = pcd_data[0], pcd_data[1], pcd_data[2]
            out["obj_pcds"] = self._split_objects(
                points, colors, instance_labels, inst_to_label.keys()
            )
        return out

    def _get_arkit_data(self, scan_id: str, data_type) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if "obj_pcds" in data_type:
            base = Path(self.cfg.data.ARkit_base) / "scan_data"
            pcd_data = load_torch_pickle(
                base / "pcd-align" / f"{scan_id}.pth", weights_only=False
            )
            inst_to_label = load_torch_pickle(
                base / "instance_id_to_label" / f"{scan_id}_inst_to_label.pth",
                weights_only=False,
            )
            points, colors, instance_labels = pcd_data[0], pcd_data[1], pcd_data[2]
            inst_ids = [k for k in inst_to_label.keys() if isinstance(k, int)]
            out["obj_pcds"] = self._split_objects(
                points, colors, instance_labels, inst_ids, min_points=10
            )
        return out

    # -- object crop images ---------------------------------------------

    def get_one_certain_img(
        self, scan_id: str, inst_id: int, label: str
    ) -> Optional[np.ndarray]:
        """Pre-cropped object image → normalized (H, W, 3) float32, or None
        when the crop doesn't exist (the caller falls back to text)."""
        img_base = self.cfg.data.get("obj_img_base", "")
        if not img_base:
            return None
        path = Path(img_base) / self.dataset / f"{scan_id}_inst{inst_id}_{label}_0.jpg"
        if not path.exists():
            return None
        return preprocess_2d(decode_jpeg(path), size=self.tgt_img_size)


def load_sparse_npz(path) -> np.ndarray:
    """The dense 2-D array of a ``scipy.sparse.save_npz`` file, read with
    numpy: ``format`` ``csr`` or ``csc`` (``indices``/``indptr``) or ``coo``
    (``row``/``col``, or the newer ``coords``), ``shape`` and ``data``.
    Duplicate entries add up, as ``todense`` sums them. Any other format
    raises ``ValueError``."""
    with np.load(path, allow_pickle=False) as f:
        fmt = f["format"].item()
        fmt = fmt.decode("ascii") if isinstance(fmt, bytes) else str(fmt)
        shape = tuple(int(n) for n in f["shape"])
        data = f["data"]
        if fmt in ("csr", "csc"):
            indptr = f["indptr"]
            major = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
            rows, cols = (major, f["indices"]) if fmt == "csr" else (f["indices"], major)
        elif fmt == "coo":
            rows, cols = (f["row"], f["col"]) if "row" in f.files else tuple(f["coords"])
        else:
            raise ValueError(f"{path}: sparse format {fmt!r} (expected csr, csc or coo)")
    if len(shape) != 2:
        raise ValueError(f"{path}: a sparse matrix of shape {shape} (expected 2-D)")
    out = np.zeros(shape, dtype=data.dtype)
    np.add.at(out, (np.asarray(rows, np.int64), np.asarray(cols, np.int64)), data)
    return out


class ScanCache:
    """Global per-process scan cache, keyed by dataset and scan."""

    _store: Dict[str, Dict[str, Dict[str, Any]]] = {}

    @classmethod
    def get(
        cls, loader: ScanDataLoader, dataset_name: str, scan_id: str,
        data_type_list: List[str], pc_type: str = "gt",
    ) -> Dict[str, Any]:
        # pred loads add extra keys (obj_pcds_pred, ...) — cache separately
        key = scan_id if pc_type == "gt" else f"{scan_id}:{pc_type}"
        ds_cache = cls._store.setdefault(dataset_name, {})
        scan_cache = ds_cache.setdefault(key, {})
        missing = [t for t in data_type_list if t not in scan_cache]
        if missing:
            scan_cache.update(
                loader.get_data(dataset_name, scan_id, missing, pc_type=pc_type)
            )
        return scan_cache

    @classmethod
    def clear(cls) -> None:
        cls._store.clear()
