"""The port's MSQA data path against the JAX package's.

* ``data/synthetic.py``: the same ``rng`` writes the same JSON files and
  ``.pth`` contents.
* ``build_task_loaders`` of both packages on the same tree give bit-equal
  train batches (every array, its dtype, and every string of the collated
  dicts) over two epochs, on the native (C++) preprocessing path and on the
  numpy path, with the global generators (Python's ``random``, numpy's
  ``np.random``) seeded alike before each package iterates. The native
  library is the same source built by each package into its own place.
  The ``crop`` case has more objects than ``max_obj_len`` in all three
  domains, so the relevant-objects-first crop runs. The ``images`` case
  sets ``data.obj_img_base``: two or three object-image placeholders a
  situation, one crop missing (its placeholder falls back to text) and one
  situation whose image count differs from its placeholders' (all fall
  back), read by Pillow in JAX and by the port's own JPEG decoder and
  resample; the val and test batches of ``msqa_scannet`` on that tree too.
* What the port does not run raises: the predicted-mask scan branch and
  the grain backend; the SQA3D / navigation members of ``MSR3DMix`` build.
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import msr3d_tpu.data.native as jax_native
from msr3d_tpu.config import load_config as jax_load_config
from msr3d_tpu.data import synthetic as jax_synthetic
from msr3d_tpu.data.build import build_task_loaders as jax_build_task_loaders
from msr3d_tpu.data.scan_loader import ScanCache as JaxScanCache
from msr3d_tpu_torch.config import load_config
from msr3d_tpu_torch.data import native, synthetic
from msr3d_tpu_torch.data.build import DataLoader, build_task_loaders
from msr3d_tpu_torch.data.scan_loader import ScanCache, ScanDataLoader

REPO = Path(__file__).resolve().parent.parent


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _same_tree_contents(a, b) -> None:
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree_contents(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree_contents(a[k], b[k])
    else:
        assert a == b


def test_synthetic_tree_matches_jax(tmp_path):
    jax_synthetic.build_full_tree(tmp_path / "jax", np.random.default_rng(7))
    synthetic.build_full_tree(tmp_path / "port", np.random.default_rng(7))
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and len(files) > 20
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix == ".pth":
            _same_tree_contents(torch.load(a, weights_only=False), torch.load(b, weights_only=False))
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    assert synthetic.full_config_dict(tmp_path) == jax_synthetic.full_config_dict(tmp_path)


def _crop_tree(root: Path, rng) -> None:
    """All three domains with scans of 9 objects (> max_obj_len 6)."""
    synthetic.build_scannet_tree(root, rng, n_objects=9)
    synthetic.build_rscan_tree(root, rng, n_objects=8)
    synthetic.build_arkit_tree(root, rng, n_objects=9)
    synthetic.build_msqa_annotations(root, ["scene0000_00", "scene0001_00"], n=5,
                                     domain="scannet")
    synthetic.build_msqa_annotations(root, ["rscan0001"], n=3, domain="rscan")
    synthetic.build_msqa_annotations(root, ["arkit0001"], n=4, domain="arkitscenes")


def _image_tree(root: Path, rng) -> None:
    """The debug tree with object-image placeholders in the ScanNet MSQA
    annotations and the fixture crops under ``crops/``, one left out."""
    synthetic.build_full_tree(root, rng)
    synthetic.build_msqa_crops(root, ["scene0000_00", "scene0001_00"])


CASES = {
    # (config, tree builder, overrides; {root} is the tree)
    "debug": ("debug_synthetic.yaml", synthetic.build_full_tree, []),
    "crop": ("debug_synthetic_mix3.yaml", _crop_tree, ["debug.flag=False"]),
    "images": ("debug_synthetic.yaml", _image_tree,
               ["debug.flag=False", "data.obj_img_base={root}/crops"]),
}


def _overrides(root: Path):
    return [f"data.scan_family_base={root}/scan_family", f"data.rscan_base={root}/rscan",
            f"data.ARkit_base={root}/arkit", f"data.msr3d_base={root}/msr3d",
            "task.msqa_scannet.mode=[]"]


def _batches(loader, seed: int, epochs: int = 2):
    random.seed(seed)
    np.random.seed(seed)
    return [batch for _ in range(epochs) for batch in loader]


def _assert_batches_equal(got, want) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                assert g[key].shape == w[key].shape, key
                assert np.array_equal(g[key], w[key]), key
            else:
                assert type(g[key]) is type(w[key]) and g[key] == w[key], key


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_batches_bit_equal_to_jax(case, path, tmp_path, monkeypatch):
    config, build_tree, extra = CASES[case]
    build_tree(tmp_path, np.random.default_rng(11))
    if path == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert jax_native.available() and native.available()
        assert native.library_path().parent == REPO / "build" / "native"
    JaxScanCache.clear()
    ScanCache.clear()
    overrides = _overrides(tmp_path) + [e.format(root=tmp_path) for e in extra]
    want_loader = jax_build_task_loaders(
        jax_load_config(REPO / "configs" / config, overrides))["msr3d_train"]["train"]
    loaders = build_task_loaders(load_config(REPO / "configs" / config, overrides))
    assert list(loaders) == ["msr3d_train", "msqa_scannet"] and loaders["msqa_scannet"] == {}
    loader = loaders["msr3d_train"]["train"]
    assert len(loader) == len(want_loader)
    want = _batches(want_loader, seed=5)
    got = _batches(loader, seed=5)
    _assert_batches_equal(got, want)
    members = loader.dataset.dataset.datasets
    assert {m.preprocess_path for m in members} == {path}
    if case == "crop":
        assert len(members) == 3
        assert all(len(m.prepare_data_loading_with_cache(m.scan_dataset_name, m.data[0]["scan_id"],
                                                         ["obj_pcds"])["obj_pcds"])
                   > m.max_obj_len for m in members)
        assert got[0]["obj_fts"].shape[1:] == (6, 64, 6) and got[0]["obj_masks"].all()
    if case == "images":
        _assert_image_placeholders(got, want_shown={0, 2, 3})
    JaxScanCache.clear()
    ScanCache.clear()


def _assert_image_placeholders(batches, want_shown) -> None:
    """Each sample shows as many images as its prompt has 图 placeholders,
    the shown ones first; the missing crop and the count mismatch fell back
    to text."""
    prompts = [p for b in batches for p in b["msr3d_prompt"]]
    masks = np.concatenate([b["msr3d_img_masks"] for b in batches])
    imgs = np.concatenate([b["msr3d_imgs"] for b in batches])
    shown = masks.sum(axis=1)
    assert [p.count("图") for p in prompts] == shown.tolist()
    assert set(shown.tolist()) == want_shown
    assert all(m[:n].all() and not m[n:].any() for m, n in zip(masks, shown))
    assert not imgs[~masks].any() and all(np.abs(i).sum() > 0 for i in imgs[masks])
    assert any("A lamp is behind me" in p for p in prompts)
    assert any("marks a table next to the wall" in p for p in prompts)


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_batches_with_crops_bit_equal_to_jax(split, tmp_path):
    """``msqa_scannet``'s val and test batches with ``data.obj_img_base``
    set, on the ``images`` case's tree."""
    _image_tree(tmp_path, np.random.default_rng(11))
    JaxScanCache.clear()
    ScanCache.clear()
    overrides = _overrides(tmp_path)[:-1] + ["debug.flag=False",
                                             f"data.obj_img_base={tmp_path}/crops"]
    config = REPO / "configs" / "debug_synthetic.yaml"
    want_loader = jax_build_task_loaders(jax_load_config(config, overrides))["msqa_scannet"][split]
    loader = build_task_loaders(load_config(config, overrides))["msqa_scannet"][split]
    assert len(loader) == len(want_loader)
    want = _batches(want_loader, seed=9, epochs=1)
    got = _batches(loader, seed=9, epochs=1)
    _assert_batches_equal(got, want)
    _assert_image_placeholders(got, want_shown={0, 2, 3})
    JaxScanCache.clear()
    ScanCache.clear()


def test_loader_left_early_stops_its_prefetch_thread():
    loader = DataLoader(list(range(100)), batch_size=2, prefetch=2,
                        collate_fn=lambda items: items)
    it = iter(loader)
    assert next(it) == [0, 1]
    it.close()
    assert [b for b in loader][-1] == [98, 99]
    shuffled = DataLoader(list(range(10)), batch_size=3, shuffle=True, drop_last=True,
                          seed=4, collate_fn=lambda items: items)
    order = np.arange(10)
    np.random.default_rng(4).shuffle(order)
    assert [b for b in shuffled] == [order[i:i + 3].tolist() for i in (0, 3, 6)]


def test_unported_branches_raise(tmp_path):
    synthetic.build_full_tree(tmp_path, np.random.default_rng(7))
    cfg = load_config(REPO / "configs" / "debug_synthetic.yaml", _overrides(tmp_path))
    with pytest.raises(NotImplementedError, match="pred"):
        ScanDataLoader(cfg, "ScanNet").get_data("ScanNet", "scene0000_00", ["obj_pcds"],
                                                pc_type="pred")
    for member, config in (("sqa3d", "debug_synthetic_sqa3d.yaml"),
                           ("scannet_one_step_navi", "debug_synthetic_msnn.yaml")):
        # ported since (tests/test_torch_eval.py)
        mix = load_config(REPO / "configs" / config,
                          _overrides(tmp_path)[:4] + [f"data.msnn_base={tmp_path}/msnn"])
        loader = build_task_loaders(mix)["msr3d_train"]["train"]
        assert loader.dataset.dataset.dataset_list == [member] and len(loader) > 0
    with pytest.raises(NotImplementedError, match="grain"):
        build_task_loaders(load_config(REPO / "configs" / "debug_synthetic.yaml",
                                       _overrides(tmp_path) + ["dataloader.train.backend=grain"]))
    ScanCache.clear()


def test_annotations_drive_the_relevant_objects(tmp_path):
    """The MSQA ``raw_thought`` instance ids come first in the crop."""
    _crop_tree(tmp_path, np.random.default_rng(3))
    loaders = build_task_loaders(load_config(
        REPO / "configs" / "debug_synthetic_mix3.yaml",
        _overrides(tmp_path) + ["debug.flag=False"]))
    member = loaders["msr3d_train"]["train"].dataset.dataset.datasets[0]
    with open(tmp_path / "msr3d" / "scannet" / "msqa_scannet_train.json") as fh:
        assert member.data[0]["insts"] == [int(s.split("-")[-1]) for s in
                                           json.load(fh)[0]["raw_thought"].split(", ")]
    ScanCache.clear()
