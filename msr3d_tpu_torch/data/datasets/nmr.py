"""NMR multi-view reconstruction dataset.

Counterpart of ``msr3d_tpu/data/datasets/nmr.py``, the input half of SRT:
per scene, one input view's image, camera position and per-pixel rays, and
a sample of target (ray, pixel, camera position) triples from the other
views, channels-last as ``SRTEncoder`` and ``SRTDecoder``
(``nn/srt.py``) take them.

The draws are the JAX package's: ``random.sample(range(n), 1)`` for the
train input view (view 0 on the eval splits), numpy's global generator for
the train rays and ``np.random.default_rng(index)`` for the eval rays.
``metadata.yaml`` is read with the port's YAML parser, which resolves
scalars as PyYAML does; a class id written unquoted that YAML 1.1 reads as
an octal integer (``04256520``) is an ``int``, and joining it into a path
raises ``TypeError``, as in the JAX package. The PNGs are read by
``data/png.py``.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict

import numpy as np

from msr3d_tpu_torch.config import yaml_load
from msr3d_tpu_torch.data.data_utils import transform_points
from msr3d_tpu_torch.data.png import read_png
from msr3d_tpu_torch.registry import DATASET_REGISTRY

# z-up re-orientation so NMR scenes lay out like the scan datasets
_ROT_MAT = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64
)


@DATASET_REGISTRY.register(name="NMRMVRecon")
class NMRMVRecon:
    def __init__(self, cfg, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.base_dir = cfg.data.nmr_base
        args = cfg.data.mvrecon.args
        self.canonical = args.canonical
        self.full_scale = args.full_scale
        self.points_per_item = args.points_per_item
        self.num_views = args.num_views
        self.num_input_views = args.num_input_views
        assert self.num_input_views == 1, "NMR supports 1 input view"
        self._load_index()
        debug = cfg.get("debug", {})
        if debug.get("flag", False):
            self.scene_paths = self.scene_paths[: debug.get("debug_size", 20)]

    def _load_index(self) -> None:
        """The softras split list of each class id in ``metadata.yaml``."""
        with open(os.path.join(self.base_dir, "metadata.yaml")) as f:
            metadata = yaml_load(f.read())
        class_ids = [entry["id"] for entry in metadata.values()]
        self.scene_paths = []
        for class_id in class_ids:
            lst = os.path.join(self.base_dir, class_id, f"softras_{self.split}.lst")
            with open(lst) as f:
                ids = [line.strip() for line in f if len(line) > 1]
            self.scene_paths.extend(os.path.join(class_id, s) for s in ids)
        self.num_scenes = len(self.scene_paths)

    def __len__(self) -> int:
        return len(self.scene_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        scene_path = os.path.join(self.base_dir, self.scene_paths[index])
        if self.split == "train":
            view_idx = random.sample(range(self.num_views), 1)[0]
        else:
            view_idx = 0
        target_views = np.array(sorted(set(range(self.num_views)) - {view_idx}))

        images = np.stack(
            [read_png(os.path.join(scene_path, "image", f"{i:04d}.png"))
             for i in range(self.num_views)],
            0,
        ).astype(np.float32) / 255.0  # (Nv, H, W, 3 or 4)

        cameras = dict(np.load(os.path.join(scene_path, "cameras.npz")))
        for i in range(self.num_views):
            cameras[f"world_mat_inv_{i}"] = _ROT_MAT @ cameras[f"world_mat_inv_{i}"]
            cameras[f"world_mat_{i}"] = cameras[f"world_mat_{i}"] @ _ROT_MAT.T

        height, width = images.shape[1:3]
        xmap, ymap = np.meshgrid(np.linspace(-1, 1, width), np.linspace(-1, 1, height))
        rays = []
        for i in range(self.num_views):
            cur = np.stack((xmap, ymap, np.ones_like(xmap)), -1)
            cur = transform_points(
                cur,
                cameras[f"world_mat_inv_{i}"] @ cameras[f"camera_mat_inv_{i}"],
                translate=False,
            )[..., :3]
            rays.append(cur / np.linalg.norm(cur, axis=-1, keepdims=True))
        rays = np.stack(rays, 0).astype(np.float32)  # (Nv, H, W, 3)
        camera_pos = np.stack(
            [cameras[f"world_mat_inv_{i}"][:3, -1] for i in range(self.num_views)], 0,
        ).astype(np.float32)

        canonical_extrinsic = None
        if self.canonical:
            canonical_extrinsic = cameras[f"world_mat_{view_idx}"].astype(np.float32)
            camera_pos = transform_points(camera_pos, canonical_extrinsic)
            rays = transform_points(rays, canonical_extrinsic, translate=False)

        rays_flat = rays[target_views].reshape(-1, 3)
        pixels_flat = images[target_views][..., :3].reshape(-1, 3)
        cpos_flat = np.broadcast_to(
            camera_pos[target_views][:, None, :], (len(target_views), width * height, 3),
        ).reshape(-1, 3)

        if not self.full_scale:
            n = rays_flat.shape[0]
            # the eval splits draw from a generator of the item's own, so a
            # val metric scores the same pixels from run to run
            chooser = np.random if self.split == "train" else np.random.default_rng(index)
            sel = chooser.choice(n, size=self.points_per_item, replace=n < self.points_per_item)
            rays_flat = rays_flat[sel]
            pixels_flat = pixels_flat[sel]
            cpos_flat = cpos_flat[sel]

        result = {
            "input_images": images[view_idx][None, ..., :3],  # (1, H, W, 3)
            "input_camera_pos": camera_pos[view_idx][None],  # (1, 3)
            "input_rays": rays[view_idx][None],  # (1, H, W, 3)
            "target_images": np.ascontiguousarray(pixels_flat),
            "target_camera_pos": np.ascontiguousarray(cpos_flat),
            "target_rays": np.ascontiguousarray(rays_flat),
            "scene_id": index,
        }
        if self.canonical:
            result["transform"] = canonical_extrinsic
        return result
