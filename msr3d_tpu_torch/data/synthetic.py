"""Synthetic on-disk data in the reference file formats.

Counterpart of ``msr3d_tpu/data/synthetic.py`` (the ScanNet, 3RScan and
ARKit trees, the MSQA and MSNN annotations, ``full_config_dict`` and
``build_full_tree``, and the legacy tasks' annotations, multi-view tree and
config slices): for the same ``rng`` it writes the same files, so the real
loaders of both packages parse the same miniature data sets. ``build_msqa_crops`` is the port's own: it
gives the MSQA annotations object-image placeholders and copies the
committed fixture crops (``data/fixtures/crops``) to the names they ask for.
So are ``build_nmr_tree`` (NMR's layout, with PNGs written by the port's
own encoder) and ``build_room_scene`` (a scanned room for the sparse-voxel
encoder).

Write the tree of ``configs/debug_synthetic.yaml`` (the seed of
``scripts/gen_synthetic_data.py``):

    python -m msr3d_tpu_torch.data.synthetic ./synthetic_data
"""

import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch


def _dump_json(obj, path) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)


def make_scene_pcd(rng, n_objects=5, pts_per_obj=200):
    """(points, colors, instance_labels) in the .pth layout."""
    points, colors, inst = [], [], []
    for i in range(n_objects):
        center = rng.uniform(-3, 3, size=3)
        pts = center + rng.normal(scale=0.3, size=(pts_per_obj, 3))
        points.append(pts)
        colors.append(rng.integers(0, 255, size=(pts_per_obj, 3)))
        inst.append(np.full(pts_per_obj, i))
    return (
        np.concatenate(points).astype(np.float32),
        np.concatenate(colors).astype(np.float32),
        np.concatenate(inst).astype(np.int64),
    )


def build_scannet_tree(root: Path, rng, scan_ids=("scene0000_00", "scene0001_00"), n_objects=5):
    base = root / "scan_family"
    (base / "scan_data" / "pcd_with_global_alignment").mkdir(parents=True, exist_ok=True)
    (base / "scan_data" / "instance_id_to_name").mkdir(parents=True, exist_ok=True)
    (base / "annotations" / "sqa_task" / "balanced").mkdir(parents=True, exist_ok=True)
    (base / "annotations" / "meta_data").mkdir(parents=True, exist_ok=True)
    (base / "annotations" / "splits").mkdir(parents=True, exist_ok=True)

    categories = ["wall", "floor", "ceiling", "chair", "table", "lamp", "sofa"]
    _dump_json(categories, base / "annotations" / "meta_data" / "scannetv2_raw_categories.json")

    for scan_id in scan_ids:
        points, colors, inst = make_scene_pcd(rng, n_objects)
        # reference layout: pcd_data[0]=points, [1]=colors, [-1]=instance_labels
        torch.save(
            (torch.from_numpy(points), torch.from_numpy(colors), None,
             torch.from_numpy(inst)),
            base / "scan_data" / "pcd_with_global_alignment" / f"{scan_id}.pth",
        )
        names = ["chair", "table", "lamp", "wall", "sofa"][:n_objects]
        _dump_json(names, base / "scan_data" / "instance_id_to_name" / f"{scan_id}.json")
        (base / "scans" / scan_id).mkdir(parents=True, exist_ok=True)
        align = np.eye(4).reshape(-1)
        with open(base / "scans" / scan_id / f"{scan_id}.txt", "w") as f:
            f.write("axisAlignment = " + " ".join(str(v) for v in align) + "\n")

    for split in ("train", "val", "test"):
        with open(base / "annotations" / "splits" / f"scannetv2_{split}.txt", "w") as f:
            f.write("\n".join(scan_ids))

    # SQA3D annotations
    _dump_json(
        [{"zero": 0, "one": 1, "red": 2, "chair": 3, "two": 4}],
        base / "annotations" / "sqa_task" / "answer_dict.json",
    )
    for split in ("train", "val", "test"):
        questions = {
            "questions": [
                {
                    "scene_id": scan_ids[0],
                    "situation": "I am standing by the chair facing the table.",
                    "alternative_situation": ["I sit near the table."],
                    "question": "What is in front of me?",
                    "question_id": 1000 + i,
                }
                for i in range(3)
            ]
        }
        annos = {
            "annotations": [
                {
                    "scene_id": scan_ids[0],
                    "question_id": 1000 + i,
                    "answers": [{"answer": "chair", "answer_confidence": "yes", "answer_id": 1}],
                    "rotation": {"_x": 0, "_y": 0, "_z": 0.0, "_w": 1.0},
                    "position": {"x": 0.5, "y": -0.2, "z": 0},
                }
                for i in range(3)
            ]
        }
        _dump_json(questions, base / "annotations" / "sqa_task" / "balanced" / f"v1_balanced_questions_{split}_scannetv2.json")
        _dump_json(annos, base / "annotations" / "sqa_task" / "balanced" / f"v1_balanced_sqa_annotations_{split}_scannetv2.json")
    return base


def build_msqa_annotations(root: Path, scan_ids, n=6, domain="scannet"):
    anno_dir = root / "msr3d" / domain
    anno_dir.mkdir(parents=True, exist_ok=True)
    for split in ("train", "val", "test"):
        records = []
        for i in range(n):
            records.append(
                {
                    "scan_id": scan_ids[i % len(scan_ids)],
                    "question": f"What is the color of the chair number {i}?",
                    "answers": ["red", "the red one"],
                    "situation": "To my left there is a <chair-1-IMG> near a table.",
                    "location": [0.1 * i, -0.2, 0.0],
                    "orientation": [0.6, 0.77, 0],
                    "type": "attribute-color",
                    "index": i,
                    "raw_thought": "chair-1, table-2",
                }
            )
        stem = {"scannet": "msqa_scannet", "rscan": "msqa_rscan", "arkitscenes": "msqa_arkitscenes"}[domain]
        _dump_json(records, anno_dir / f"{stem}_{split}.json")
    return root / "msr3d"


CROP_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "crops"

# situations with object-image placeholders: two crops; three (the lamp's
# crop is left out in the second scan, so it falls back to text); and a
# literal "IMG" that makes the image count differ from the placeholders',
# so every placeholder falls back to text
IMAGE_SITUATIONS = (
    "To my left there is a <chair-0-IMG> near a <table-1-IMG>.",
    "A <lamp-2-IMG> is behind me, and a <chair-0-IMG> and a <sofa-4-IMG> are in front.",
    "The IMG tag marks a <table-1-IMG> next to the <wall-3-IMG>.",
)


def build_msqa_crops(root: Path, scan_ids) -> Path:
    """Give the ScanNet MSQA annotations under ``root/msr3d`` (written by
    ``build_msqa_annotations``) situations that cycle through
    ``IMAGE_SITUATIONS``, and copy the fixture crops, in turn, to
    ``root/crops/ScanNet/{scan}_inst{id}_{label}_0.jpg`` for each scan and
    placeholder, except the lamp's in the second scan. Returns the
    ``data.obj_img_base`` of the tree."""
    for path in sorted((root / "msr3d" / "scannet").glob("*.json")):
        with open(path) as fh:
            records = json.load(fh)
        for i, record in enumerate(records):
            record["situation"] = IMAGE_SITUATIONS[i % len(IMAGE_SITUATIONS)]
        _dump_json(records, path)
    placeholders = []
    for situation in IMAGE_SITUATIONS:
        for label, inst in re.findall(r"<([^<>-]+)-(\d+)-IMG>", situation):
            if (label, inst) not in placeholders:
                placeholders.append((label, inst))
    fixtures = sorted(CROP_FIXTURES.glob("*.jpg"))
    out = root / "crops" / "ScanNet"
    out.mkdir(parents=True, exist_ok=True)
    k = 0
    for n, scan_id in enumerate(scan_ids):
        for label, inst in placeholders:
            if n == 1 and label == "lamp":
                continue
            shutil.copyfile(fixtures[k % len(fixtures)],
                            out / f"{scan_id}_inst{inst}_{label}_0.jpg")
            k += 1
    return root / "crops"


def build_rscan_tree(root: Path, rng, scan_ids=("rscan0001",), n_objects=4):
    base = root / "rscan"
    for scan_id in scan_ids:
        d = base / "3RScan-ours-align" / scan_id
        d.mkdir(parents=True, exist_ok=True)
        points, colors, inst = make_scene_pcd(rng, n_objects)
        torch.save((torch.from_numpy(points), torch.from_numpy(colors), torch.from_numpy(inst)), d / "pcds.pth")
        torch.save({i: f"obj{i}" for i in range(n_objects)}, d / "inst_to_label.pth")
    return base


def build_arkit_tree(root: Path, rng, scan_ids=("arkit0001",), n_objects=4):
    base = root / "arkit"
    (base / "scan_data" / "pcd-align").mkdir(parents=True, exist_ok=True)
    (base / "scan_data" / "instance_id_to_label").mkdir(parents=True, exist_ok=True)
    for scan_id in scan_ids:
        points, colors, inst = make_scene_pcd(rng, n_objects, pts_per_obj=50)
        torch.save(
            (torch.from_numpy(points), torch.from_numpy(colors), torch.from_numpy(inst)),
            base / "scan_data" / "pcd-align" / f"{scan_id}.pth",
        )
        torch.save(
            {i: f"obj{i}" for i in range(n_objects)},
            base / "scan_data" / "instance_id_to_label" / f"{scan_id}_inst_to_label.pth",
        )
    return base


def build_msnn_annotations(root: Path, scan_ids, n=4):
    base = root / "msnn"
    base.mkdir(parents=True, exist_ok=True)
    anno = {}
    for scan_id in scan_ids:
        anno[scan_id] = {
            str(i): {
                "location": [0.1 * i, 0.2, 0.0],
                "orientation": [0, 0, 0, 1],
                "situation_multimodal": "You face a chair.",
                "situation_text": "You face a chair (text).",
                "interaction": "Go to the table.",
                "insts": [0, 1],
                "action": {
                    "four_direction": [i % 4, ["move forward", "turn left", "move backward", "turn right"][i % 4]],
                    "eight_direction": [i % 8, "turn"],
                },
            }
            for i in range(n)
        }
    _dump_json(anno, base / "msnn_scannet.json")
    return base


def full_config_dict(root: Path, debug_size=4):
    """Config matching the reference YAML layout, pointed at the fixture tree."""
    return {
        "rng_seed": 42,
        "debug": {"flag": True, "debug_size": debug_size},
        "data": {
            "scan_family_base": str(root / "scan_family"),
            "rscan_base": str(root / "rscan"),
            "ARkit_base": str(root / "arkit"),
            "msr3d_base": str(root / "msr3d"),
            "msnn_base": str(root / "msnn"),
            "obj_img_base": "",
            "process_args": {
                "img_process_args": {
                    "bbox_keep_ratio": 0.5,
                    "bbox_expand": 0.1,
                    "img_processer": "navigation_img_processer",
                    "tgt_img_size": [32, 32],
                }
            },
            "msr3dmix": {"args": {"mix": ["msqa_scannet"], "ratio": 1.0, "few_shot_num": 0, "num_points": 64}},
            "msqa_scannet": {"args": {"anno_dir": str(root / "msr3d" / "scannet"), "max_obj_len": 6, "num_points": 64, "few_shot_num": 0, "msr3d_max_img_num": 4, "val_num": 2}},
            "msqa_3rscan": {"args": {"anno_dir": str(root / "msr3d" / "rscan"), "max_obj_len": 6, "num_points": 64, "few_shot_num": 0, "msr3d_max_img_num": 4, "val_num": 2}},
            "msqa_arkitscenes": {"args": {"anno_dir": str(root / "msr3d" / "arkitscenes"), "max_obj_len": 6, "num_points": 64, "few_shot_num": 0, "msr3d_max_img_num": 4, "val_num": 2}},
            "sqa3d": {"args": {"max_obj_len": 6, "max_seq_len": 80, "num_points": 64, "pc_type": "gt", "sem_type": "607", "filter_lang": False, "use_unanswer": True}},
            "next_step_navigation": {"args": {"max_obj_len": 6, "num_points": 64, "pc_type": "gt", "action_type": "four_direction", "modality_type": "multimodal"}},
        },
        "task": {
            "msr3d_train": {
                "mode": ["train"],
                "dataset": "MSR3DMix",
                "dataset_wrapper": "LeoScanFamilyDatasetWrapper",
                "dataset_wrapper_args": {"max_obj_len": 6, "msr3d_max_img_num": 4},
                "train_dataloader_args": {"batchsize": 2},
                "eval_dataloader_args": {"batchsize": 2},
            },
            "msqa_scannet": {
                "mode": ["val", "test"],
                "dataset": "MSQAScanNet",
                "dataset_wrapper": "LeoScanFamilyDatasetWrapper",
                "dataset_wrapper_args": {"max_obj_len": 6, "msr3d_max_img_num": 4},
                "eval_dataloader_args": {"batchsize": 2},
                "evaluator": "MSQAEval",
            },
        },
    }


def build_full_tree(tmp_path: Path, rng):
    root = tmp_path
    build_scannet_tree(root, rng)
    build_msqa_annotations(root, ["scene0000_00", "scene0001_00"], domain="scannet")
    build_msqa_annotations(root, ["rscan0001"], domain="rscan")
    build_msqa_annotations(root, ["arkit0001"], domain="arkitscenes")
    build_rscan_tree(root, rng)
    build_arkit_tree(root, rng)
    build_msnn_annotations(root, ["scene0000_00"])
    return root


def build_legacy_annotations(base: Path, scan_ids):
    """Legacy-task annotation fixtures in the reference formats:
    ScanRefer/Referit3D jsonl, ScanQA json, SGQA json, ssg captions, labels
    TSV. ``base`` is the scan_family tree root."""
    refer_dir = base / "annotations" / "refer"
    qa_dir = base / "annotations" / "qa"
    refer_dir.mkdir(parents=True, exist_ok=True)
    qa_dir.mkdir(parents=True, exist_ok=True)

    # labels TSV aligned with scannetv2_raw_categories.json row order
    categories = json.load(
        open(base / "annotations" / "meta_data" / "scannetv2_raw_categories.json")
    )
    nyu40 = {"wall": ("wall", 1), "floor": ("floor", 2), "ceiling": ("ceiling", 22),
             "chair": ("chair", 5), "table": ("table", 7), "lamp": ("lamp", 35),
             "sofa": ("sofa", 6)}
    with open(base / "annotations" / "meta_data" / "scannetv2-labels.combined.tsv", "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\tnyuClass\tnyu40class\n")
        for cat in categories:
            name, nid = nyu40.get(cat, ("otherprop", 40))
            f.write(f"1\t{cat}\t{cat}\t1\t{nid}\t1\t{cat}\t{name}\n")

    # ScanRefer: target instance 0 is 'chair' in every synthetic scan
    with open(refer_dir / "scanrefer.jsonl", "w") as f:
        for i, scan_id in enumerate(scan_ids):
            for j in range(2):
                f.write(json.dumps({
                    "item_id": f"scanrefer_{i}_{j}",
                    "scan_id": scan_id,
                    "target_id": 0,
                    "instance_type": "chair",
                    "utterance": "the chair next to the table on the left",
                }) + "\n")

    # Referit3D (nr3d + sr3d+): tokens field, ≤24 tokens
    for fname in ("nr3d.jsonl", "sr3d+.jsonl"):
        with open(refer_dir / fname, "w") as f:
            for i, scan_id in enumerate(scan_ids):
                utt = "find the table behind the chair"
                f.write(json.dumps({
                    "item_id": f"{fname[:-6]}_{i}",
                    "scan_id": scan_id,
                    "target_id": 1,
                    "instance_type": "table",
                    "utterance": utt,
                    "tokens": utt.split(),
                }) + "\n")

    # ScanQA
    for split in ("train", "val", "test"):
        json.dump(
            [
                {
                    "question_id": f"{split}-{scan_id}-{k}",
                    "scene_id": scan_id,
                    "question": "What is next to the chair?",
                    "object_ids": [1],
                    "object_names": ["table"],
                    "answers": ["table", "a table"],
                }
                for scan_id in scan_ids
                for k in range(2)
            ],
            open(qa_dir / f"ScanQA_v1.0_{split}.json", "w"),
        )

    # SGQA (scene-graph situated QA)
    sgqa_dir = base / "annotations" / "sgqa"
    sgqa_dir.mkdir(parents=True, exist_ok=True)
    for split in ("train", "val", "test"):
        payload = {
            scan_id: {
                "response": [
                    {
                        "Q": "What is the color of the chair in front of me?",
                        "A": [" gray "],
                        "T": f"{scan_id}-0, {scan_id}-1",
                        "type": "attribute-color",
                        "situation": "A chair is to my left.",
                        "location": [0.1, -0.2, 0.0],
                        "orientation": [0.6, 0.77, 0],
                        "query_type": "qa_4_directions",
                        "mode": "txt",
                    }
                ]
            }
            for scan_id in scan_ids
        }
        json.dump(payload, open(sgqa_dir / f"sgqa_{split}.json", "w"))

    # pretrain scene captions
    json.dump(
        [{"scan_id": s, "utterance": "a room with a chair and a table"} for s in scan_ids],
        open(refer_dir / "ssg_caption_gpt.json", "w"),
    )
    return base


def legacy_config_dict(base: Path):
    """Config slice for the legacy datasets (the keys their inits read)."""
    common = {
        "pc_type": "gt", "sem_type": "607", "max_obj_len": 10,
        "num_points": 64, "filter_lang": False, "max_seq_len": 32,
    }
    return {
        "rng_seed": 42,
        "debug": {"flag": False, "debug_size": -1},
        "data": {
            "scan_family_base": str(base),
            "process_args": {"img_process_args": {"tgt_img_size": [32, 32]}},
            "pretrain": {"args": {
                "pc_type": "gt", "max_obj_len": 10, "num_points": 64,
                "max_seq_len": 32, "txt_mask_ratio": 0.15, "pc_mask_ratio": 0.1,
                "scannet_train": {"anno_type": ["gpt"]},
                "scannet_val": {"anno_type": ["gpt"]},
            }},
            "scanrefer": {"args": dict(common)},
            "referit3d": {"args": dict(common, anno_type="nr3d", sr3d_plus_aug=True)},
            "spatialrefer": {"args": dict(
                common,
                scannet_train={"sources": ["referit3d", "scanrefer"],
                               "referit3d": {"anno_type": ["nr3d"]}},
                scannet_val={"sources": ["scanrefer"]},
            )},
            "scanqa": {"args": dict(common, use_unanswer=True)},
            "scannet_sgqa": {"args": {
                "pc_type": "gt", "max_obj_len": 10, "num_points": 64,
                "anno_dir": str(base / "annotations" / "sgqa"),
            }},
        },
    }


def build_multiview_tree(base: Path, scan_ids, n_frames=3, feat_len=16):
    """MultiViewInfo_numpy fixture: per scan a multiview_info_refined.json
    whose instance entries index rows of clip.npy, plus identity camera
    poses."""
    rng = np.random.default_rng(0)
    for scan_id in scan_ids:
        d = base / "ScanNetV2-RGBD" / "MultiViewInfo_numpy" / scan_id
        d.mkdir(parents=True, exist_ok=True)
        feats, mv = [], {}
        for f in range(n_frames):
            insts = []
            # frame f sees instances f..f+2 (org ids are 1-based)
            for org in range(f + 1, f + 4):
                insts.append({
                    "org_inst_id": org,
                    "is_need_process": True,
                    "clip": len(feats),
                })
                feats.append(rng.normal(size=feat_len).astype(np.float32))
            mv[f"frame_{f:04d}"] = {
                "instance_info": insts,
                "camera_pose": list(np.eye(4).reshape(-1)),
            }
        json.dump({"multiview_info": mv}, open(d / "multiview_info_refined.json", "w"))
        np.save(d / "clip.npy", np.stack(feats, 0))
    return base


def mv_config_dict(base: Path):
    """Config slice for the MV datasets (cfg.data.mvdatasettings +
    mvpretrain/mvreferit3d args)."""
    cfg = legacy_config_dict(base)
    cfg["data"]["mvdatasettings"] = {
        "pc_type": "gt",
        "max_inst_per_frame": 4,
        "max_frame_num": 2,
        "inst_feat_type": "clip",
        "inst_feat_len": 16,
        "frame_sample_mode": "even",
        "inst_sample_mode": "even",
        "inst_position_type": "pc_gt",
        "is_pool_obj_feature": True,
        "pooling_strategy": "average_all",
        "use_cache": False,
        "use_multi_process": False,
        "process_num": 0,
    }
    cfg["data"]["mvpretrain"] = {"scan_caption": {"anno_type": ["gpt"]}}
    cfg["data"]["mvreferit3d"] = {"args": {
        "max_obj_len": 3, "sem_type": "607", "anno_type": "nr3d",
        "filter_lang": False, "num_points": 64, "max_seq_len": 32,
    }}
    return cfg


# the 13 ShapeNet classes of NMR's renders (their ids in its metadata.yaml)
NMR_CLASSES = (
    ("02691156", "airplane"), ("02828884", "bench"), ("02933112", "cabinet"),
    ("02958343", "car"), ("03001627", "chair"), ("03211117", "display"),
    ("03636649", "lamp"), ("03691459", "loudspeaker"), ("04090263", "rifle"),
    ("04256520", "sofa"), ("04379243", "table"), ("04401088", "telephone"),
    ("04530566", "vessel"),
)


def _look_at(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world (4, 4) of a camera at ``eye`` looking at the origin,
    z up."""
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    cam2world = np.eye(4)
    cam2world[:3, :3] = np.stack([right, -up, forward], 1)
    cam2world[:3, 3] = eye
    return cam2world


def build_nmr_tree(root: Path, rng, n_classes: int = 2, scenes_per_class: int = 2,
                   n_views: int = 24, size: int = 64, rgba: bool = True,
                   splits=("train", "val")) -> Path:
    """An NMR tree: ``metadata.yaml`` (class ids quoted, since YAML 1.1 reads
    an unquoted ``04256520`` as an octal integer),
    ``<class>/softras_<split>.lst`` (each split lists every scene of the
    class), and per scene ``cameras.npz`` (``world_mat_*``,
    ``world_mat_inv_*``, ``camera_mat_inv_*``, (4, 4) float32; the 24 views
    of NMR on a ring at 30° elevation, 2.732 from the object) and
    ``image/<view:04d>.png``: ``size``² renders of a shaded blob on a
    transparent background, RGBA (RGB without ``rgba``), written by
    ``data/png.py::encode_png`` with the five row filters in turn."""
    from msr3d_tpu_torch.data.png import encode_png

    root.mkdir(parents=True, exist_ok=True)
    meta = []
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1) * 2 - 1
    fov = np.deg2rad(30.0)
    camera_mat_inv = np.diag([np.tan(fov / 2), np.tan(fov / 2), 1.0, 1.0])
    for class_id, name in NMR_CLASSES[:n_classes]:
        meta.append(f"{class_id}:\n  id: '{class_id}'\n  name: {name}\n")
        scenes = [f"{class_id[-4:]}{s:04d}" for s in range(scenes_per_class)]
        for split in splits:
            (root / class_id).mkdir(parents=True, exist_ok=True)
            (root / class_id / f"softras_{split}.lst").write_text("\n".join(scenes) + "\n")
        for scene in scenes:
            sdir = root / class_id / scene
            (sdir / "image").mkdir(parents=True, exist_ok=True)
            colour = rng.uniform(0.2, 1.0, size=3)
            radius = rng.uniform(0.4, 0.8)
            cams = {}
            for v in range(n_views):
                az, el = 2 * np.pi * v / n_views, np.deg2rad(30.0)
                eye = 2.732 * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                                        np.sin(el)])
                cam2world = _look_at(eye)
                cams[f"world_mat_{v}"] = np.linalg.inv(cam2world).astype(np.float32)
                cams[f"world_mat_inv_{v}"] = cam2world.astype(np.float32)
                cams[f"camera_mat_inv_{v}"] = camera_mat_inv.astype(np.float32)
                cx, cy = 0.2 * np.cos(az), 0.2 * np.sin(az)
                d2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / radius ** 2
                inside = d2 < 1.0
                shade = np.sqrt(np.clip(1.0 - d2, 0.0, 1.0))[..., None]
                rgb = np.where(inside[..., None], colour * (0.3 + 0.7 * shade), 1.0)
                rgb = rgb + rng.normal(scale=0.02, size=rgb.shape)
                img = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
                if rgba:
                    alpha = np.where(inside, 255, 0).astype(np.uint8)[..., None]
                    img = np.concatenate([img, alpha], -1)
                (sdir / "image" / f"{v:04d}.png").write_bytes(encode_png(img))
            np.savez(sdir / "cameras.npz", **cams)
    (root / "metadata.yaml").write_text("".join(meta))
    return root


def nmr_config_dict(root: Path, points_per_item: int = 8192, n_views: int = 24,
                    canonical: bool = True, full_scale: bool = False):
    """The config slice ``NMRMVRecon`` reads."""
    return {"data": {"nmr_base": str(root), "mvrecon": {"args": {
        "canonical": canonical, "full_scale": full_scale, "points_per_item": points_per_item,
        "num_views": n_views, "num_input_views": 1}}}, "debug": {"flag": False}}


def _surface(rng, origin, u, v, spacing, coverage, tile, noise):
    """Points on the rectangle ``origin + a·u + b·v`` on a grid of ``spacing``,
    kept on a ``coverage`` share of its ``tile``-sized squares, jittered by
    ``noise``."""
    lu, lv = np.linalg.norm(u), np.linalg.norm(v)
    a, b = np.meshgrid(np.arange(0.0, lu, spacing), np.arange(0.0, lv, spacing), indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    if coverage < 1.0:
        nu, nv = int(np.ceil(lu / tile)), int(np.ceil(lv / tile))
        keep = rng.uniform(size=(nu, nv)) < coverage
        sel = keep[(a / tile).astype(int), (b / tile).astype(int)]
        a, b = a[sel], b[sel]
    pts = (origin + a[:, None] * (u / lu) + b[:, None] * (v / lv)
           + rng.normal(scale=noise, size=(len(a), 3)))
    return pts


def build_room_scene(rng, room=(8.0, 8.0, 3.0), spacing: float = 0.01, voxel: float = 0.02,
                     coverage: float = 0.1, n_boxes: int = 3, tile: float = 0.5,
                     noise: float = 0.002):
    """A scanned room as ``PCDSwin3DEncoder`` takes it: (xyz (N, 3) float32
    in voxel units of ``voxel`` metres, colours (N, 3) float32 in [-1, 1],
    instance (N,) int64: 0 the floor, 1-4 the walls, 5 on the boxes). The
    floor and four walls are sampled every ``spacing`` metres on a
    ``coverage`` share of their ``tile`` squares (a scan sees part of
    them); ``n_boxes`` boxes on the floor are sampled whole (top and four
    sides); every surface has a colour of its own with noise."""
    x, y, z = room
    e = np.eye(3)
    surfaces = [(0, (0, 0, 0), x * e[0], y * e[1], coverage),
                (1, (0, 0, 0), x * e[0], z * e[2], coverage),
                (2, (0, y, 0), x * e[0], z * e[2], coverage),
                (3, (0, 0, 0), y * e[1], z * e[2], coverage),
                (4, (x, 0, 0), y * e[1], z * e[2], coverage)]
    for b in range(n_boxes):
        sx, sy, sz = np.minimum(rng.uniform(0.3, 1.2, size=3), (x / 2, y / 2, z))
        ox, oy = rng.uniform(0.2, x - sx - 0.2), rng.uniform(0.2, y - sy - 0.2)
        surfaces += [(5 + b, (ox, oy, sz), sx * e[0], sy * e[1], 1.0),
                     (5 + b, (ox, oy, 0), sx * e[0], sz * e[2], 1.0),
                     (5 + b, (ox, oy + sy, 0), sx * e[0], sz * e[2], 1.0),
                     (5 + b, (ox, oy, 0), sy * e[1], sz * e[2], 1.0),
                     (5 + b, (ox + sx, oy, 0), sy * e[1], sz * e[2], 1.0)]
    xyz, rgb, inst = [], [], []
    for instance, origin, u, v, cover in surfaces:
        pts = _surface(rng, np.asarray(origin, np.float64), u, v, spacing, cover, tile, noise)
        base = rng.uniform(-0.8, 0.8, size=3)
        xyz.append(pts)
        rgb.append(np.clip(base + rng.normal(scale=0.05, size=pts.shape), -1.0, 1.0))
        inst.append(np.full(len(pts), instance, np.int64))
    xyz = np.concatenate(xyz) / voxel
    return xyz.astype(np.float32), np.concatenate(rgb).astype(np.float32), np.concatenate(inst)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0] if argv else "./synthetic_data")
    out.mkdir(parents=True, exist_ok=True)
    build_full_tree(out, np.random.default_rng(7))
    print(f"synthetic data tree written to {out.resolve()}")


if __name__ == "__main__":
    main()
