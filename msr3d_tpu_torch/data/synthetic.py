"""Synthetic on-disk data in the reference file formats.

Counterpart of ``msr3d_tpu/data/synthetic.py`` (the ScanNet, 3RScan and
ARKit trees, the MSQA and MSNN annotations, ``full_config_dict`` and
``build_full_tree``): for the same ``rng`` it writes the same files, so the
real loaders of both packages parse the same miniature data sets. The legacy
tasks' fixtures are not ported. ``build_msqa_crops`` is the port's own: it
gives the MSQA annotations object-image placeholders and copies the
committed fixture crops (``data/fixtures/crops``) to the names they ask for.

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


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0] if argv else "./synthetic_data")
    out.mkdir(parents=True, exist_ok=True)
    build_full_tree(out, np.random.default_rng(7))
    print(f"synthetic data tree written to {out.resolve()}")


if __name__ == "__main__":
    main()
