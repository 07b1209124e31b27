"""Parity of the port's legacy ScanNet data stack with the JAX package: the
fixture builders, the predicted-mask scan branch (``pc_type: pred``), the
nine legacy datasets and ``DefaultDataset`` item by item, both legacy
wrappers' collated batches, ``box_utils`` and the legacy ``data_utils``
helpers.

Both packages read the same trees. The datasets draw from Python's
``random`` and numpy's global generator, so both are re-seeded before each
package iterates. ``WordHashTokenizer`` hashes with Python's salted
``hash``: the ids agree because both packages run in this one process.
Arrays must be equal exactly (the same numpy arithmetic on both sides).
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import torch

import msr3d_tpu.data.box_utils as jbox
import msr3d_tpu.data.data_utils as jdu
import msr3d_tpu.data.synthetic as jsyn
from msr3d_tpu.config import config_from_dict as jax_config_from_dict
from msr3d_tpu.data.datasets import dataset_wrapper as jwrap
from msr3d_tpu.data.datasets import default as jdefault
from msr3d_tpu.data.datasets import scannet_legacy as jlegacy
from msr3d_tpu.data.datasets import scannet_mv as jmv
from msr3d_tpu.data.scan_loader import ScanCache as JaxScanCache
from msr3d_tpu.data.scan_loader import ScanDataLoader as JaxScanDataLoader
from msr3d_tpu_torch.config import config_from_dict
from msr3d_tpu_torch.data import box_utils as pbox
from msr3d_tpu_torch.data import data_utils as pdu
from msr3d_tpu_torch.data import synthetic as psyn
from msr3d_tpu_torch.data.build import build_dataloader_leo
from msr3d_tpu_torch.data.datasets import dataset_wrapper as pwrap
from msr3d_tpu_torch.data.datasets import default as pdefault
from msr3d_tpu_torch.data.datasets import scannet_legacy as plegacy
from msr3d_tpu_torch.data.datasets import scannet_mv as pmv
from msr3d_tpu_torch.data.scan_loader import ScanCache, ScanDataLoader, load_sparse_npz

SCAN_IDS = ("scene0000_00", "scene0001_00")
# names of the scans of the crop tree: 14 objects, 3 of them background,
# two chairs and three tables, so the crop keeps targets, then same-class
# objects, then a random fill
CROP_NAMES = ["chair", "table", "lamp", "wall", "sofa", "chair", "table", "floor", "lamp",
              "sofa", "table", "ceiling", "lamp", "sofa"]


def assert_same(got, want, where=""):
    """Equal values, recursively: arrays exactly (dtype and shape too)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got, want)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def seeded(fn, seed=0):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def clear_caches():
    JaxScanCache.clear()
    ScanCache.clear()


def write_pred_masks(base: Path, scan_id: str, n_points: int, fmt: str, seed: int):
    """A predicted-mask npz of ``fmt`` written by ``scipy.sparse.save_npz``
    and its label npy: each gt instance of 200 points (``make_scene_pcd``'s
    layout) dropped to a random 80%, one empty mask, a mask over two
    instances, and more than 50 masks so the cut bites."""
    r = np.random.default_rng(seed)
    n_inst = n_points // 200
    rows = []
    for i in range(n_inst):
        row = np.zeros(n_points, np.int8)
        keep = r.random(200) < 0.8
        row[i * 200:(i + 1) * 200] = keep
        rows.append(row)
    rows.append(np.zeros(n_points, np.int8))  # an empty mask is skipped
    rows.append(np.zeros(n_points, np.int8))
    rows[-1][:400] = 1  # one mask over two instances
    while len(rows) < 53:
        rows.append((r.random(n_points) < 0.01).astype(np.int8))
    dense = np.stack(rows)
    (base / "mask").mkdir(exist_ok=True)
    mat = {"csr": scipy.sparse.csr_matrix, "csc": scipy.sparse.csc_matrix,
           "coo": scipy.sparse.coo_matrix}[fmt](dense)
    scipy.sparse.save_npz(base / "mask" / f"{scan_id}.mask.npz", mat)
    np.save(base / "mask" / f"{scan_id}.label.npy", r.integers(0, 7, len(rows)))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The legacy tree (5 objects a scan, its multi-view tree) written by
    the JAX package's builders, the same by the port's, and a crop tree of
    14 named objects a scan with predicted masks (CSR for one scan, COO for
    the other)."""
    out = {}
    for name, syn in (("jax", jsyn), ("port", psyn)):
        root = tmp_path_factory.mktemp(f"legacy_{name}")
        base = syn.build_scannet_tree(root, np.random.default_rng(0), scan_ids=SCAN_IDS)
        syn.build_legacy_annotations(base, SCAN_IDS)
        syn.build_multiview_tree(base, SCAN_IDS)
        out[name] = base
    crop_root = tmp_path_factory.mktemp("legacy_crop")
    base = psyn.build_scannet_tree(crop_root, np.random.default_rng(1), scan_ids=SCAN_IDS,
                                   n_objects=len(CROP_NAMES))
    psyn.build_legacy_annotations(base, SCAN_IDS)
    for i, scan_id in enumerate(SCAN_IDS):
        with open(base / "scan_data" / "instance_id_to_name" / f"{scan_id}.json", "w") as fh:
            json.dump(CROP_NAMES, fh)
        write_pred_masks(base, scan_id, 200 * len(CROP_NAMES), ("csr", "coo")[i], seed=i)
    out["crop"] = base
    clear_caches()
    return out


def configs(base, mv=False, **data):
    d = (jsyn.mv_config_dict if mv else jsyn.legacy_config_dict)(base)
    for key, args in data.items():
        d["data"][key]["args"].update(args)
    return jax_config_from_dict(d), config_from_dict(d)


# ---------------------------------------------------------------------------
# the builders and the helpers


def test_fixture_builders_write_the_same_files(trees):
    """Every file of the port's legacy and multi-view trees equals the JAX
    builders' (the .pth scans by their tensors), and the config slices are
    equal."""
    a, b = trees["jax"], trees["port"]
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert any(f.suffix == ".jsonl" for f in files) and any(f.suffix == ".npy" for f in files)
    for f in files:
        if f.suffix == ".pth":
            for x, y in zip(torch.load(a / f, weights_only=False),
                            torch.load(b / f, weights_only=False)):
                assert (x is None and y is None) or torch.equal(x, y)
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert psyn.legacy_config_dict(a) == jsyn.legacy_config_dict(a)
    assert psyn.mv_config_dict(a) == jsyn.mv_config_dict(a)


def test_box_utils_match_jax():
    r = np.random.default_rng(0)
    for _ in range(20):
        pcd = r.normal(size=(50, 6)).astype(np.float32)
        assert_same(pbox.convert_pc_to_box(pcd), jbox.convert_pc_to_box(pcd))
        c1, s1 = r.normal(size=3), r.uniform(0.1, 2, size=3)
        c2, s2 = c1 + r.normal(size=3) * 0.3, r.uniform(0.1, 2, size=3)
        k1, k2 = pbox.construct_bbox_corners(c1, s1), pbox.construct_bbox_corners(c2, s2)
        assert_same(k1, jbox.construct_bbox_corners(c1, s1))
        assert pbox.box3d_iou_aligned(k1, k2) == jbox.box3d_iou_aligned(k1, k2)
        assert pbox.eval_ref_one_sample(k1, k2) == jbox.eval_ref_one_sample(k1, k2)
        deg = float(r.uniform(-180, 180))
        assert_same(pbox.rotate_z_axis_by_degrees(pcd, deg),
                    jbox.rotate_z_axis_by_degrees(pcd, deg))
    flat = pbox.construct_bbox_corners(np.zeros(3), np.zeros(3))
    assert pbox.box3d_iou_aligned(flat, flat) == jbox.box3d_iou_aligned(flat, flat) == 0.0


def test_data_utils_legacy_helpers_match_jax(trees):
    tsv = trees["jax"] / "annotations" / "meta_data" / "scannetv2-labels.combined.tsv"
    got, want = pdu.LabelConverter(tsv), jdu.LabelConverter(tsv)
    assert vars(got) == vars(want)
    ident = pdu.IdentityLabelConverter()
    assert ident.id_to_scannetid[17] == jdu.IdentityLabelConverter().id_to_scannetid[17] == 17
    for toks in (["the", "chair", "behind", "me"], ["a", "red", "chair"], []):
        assert pdu.is_explicitly_view_dependent(toks) == jdu.is_explicitly_view_dependent(toks)
    answers = ["table", "a table", "chair"]
    pa, ja = pdu.ScanQAAnswer(answers), jdu.ScanQAAnswer(answers)
    assert len(pa) == len(ja) and pa.vocab == ja.vocab
    assert [pa.stoi(a) for a in answers + ["sofa"]] == [ja.stoi(a) for a in answers + ["sofa"]]
    assert [pa.itos(i) for i in (0, 2, -100)] == [ja.itos(i) for i in (0, 2, -100)]
    ids = np.arange(5, 45)
    mask = (np.arange(40) < 31).astype(np.int64)
    for ratio in (0.15, 0.6):
        assert_same(pdu.random_word(ids, mask, 3, 1000, np.random.default_rng(4), ratio),
                    jdu.random_word(ids, mask, 3, 1000, np.random.default_rng(4), ratio))
        assert_same(pdu.random_point_cloud(30, mask[:30], np.random.default_rng(5), ratio),
                    jdu.random_point_cloud(30, mask[:30], np.random.default_rng(5), ratio))


# ---------------------------------------------------------------------------
# the predicted-mask branch


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_pred_masks_match_jax(trees, tmp_path, fmt):
    """``_load_pred_masks`` on a ``scipy.sparse.save_npz`` file of each
    format (read by numpy alone), the first 50 masks, an empty one skipped:
    equal to JAX's; ``{}`` without the files; through ``get_data``."""
    base = tmp_path
    n = 200 * 6
    write_pred_masks(base, "scan", n, fmt, seed=3)
    r = np.random.default_rng(2)
    points = r.normal(size=(n, 3)).astype(np.float32)
    colors = r.integers(0, 255, size=(n, 3)).astype(np.float32)
    want = JaxScanDataLoader._load_pred_masks(base, "scan", points, colors)
    got = ScanDataLoader._load_pred_masks(base, "scan", points, colors)
    assert_same(got, want)
    assert len(got["obj_pcds_pred"]) == 49  # 50 masks, one empty
    np.testing.assert_array_equal(
        load_sparse_npz(base / "mask" / "scan.mask.npz"),
        scipy.sparse.load_npz(base / "mask" / "scan.mask.npz").toarray())
    (base / "mask" / "scan.label.npy").unlink()
    assert ScanDataLoader._load_pred_masks(base, "scan", points, colors) == {} == \
        JaxScanDataLoader._load_pred_masks(base, "scan", points, colors)

    crop = trees["crop"]
    jcfg, cfg = configs(crop)
    for scan_id in SCAN_IDS:
        want = JaxScanDataLoader(jcfg, "ScanNet").get_data("ScanNet", scan_id, ["obj_pcds"],
                                                           pc_type="pred")
        got = ScanDataLoader(cfg, "ScanNet").get_data("ScanNet", scan_id, ["obj_pcds"],
                                                      pc_type="pred")
        assert_same(got, want)
        assert len(got["obj_pcds_pred"]) == 49  # the first 50, one empty


def test_sparse_npz_duplicates_and_other_formats(tmp_path):
    """COO duplicates add up as ``todense`` sums them; a DIA or BSR file
    raises ``ValueError``."""
    coo = scipy.sparse.coo_matrix((np.array([1, 1, 1], np.int8), ([0, 0, 1], [2, 2, 0])),
                                  shape=(2, 4))
    scipy.sparse.save_npz(tmp_path / "dup.npz", coo)
    np.testing.assert_array_equal(load_sparse_npz(tmp_path / "dup.npz"), coo.toarray())
    dense = np.eye(4, dtype=np.int8)
    for make in (scipy.sparse.dia_matrix, scipy.sparse.bsr_matrix):
        scipy.sparse.save_npz(tmp_path / "other.npz", make(dense))
        with pytest.raises(ValueError, match="sparse format"):
            load_sparse_npz(tmp_path / "other.npz")


# ---------------------------------------------------------------------------
# the datasets, item by item

DATASETS = [
    # (class name, split, tree, config args); val/test splits read pc_type
    ("ScanNetScanRefer", "train", "jax", {}),
    ("ScanNetScanRefer", "val", "crop", {"scanrefer": {"pc_type": "pred"}}),
    ("ScanNetScanRefer", "train", "crop", {}),
    ("ScanNetReferit3D", "train", "jax", {}),
    ("ScanNetReferit3D", "test", "crop", {"referit3d": {"pc_type": "pred"}}),
    ("ScanNetReferit3D", "val", "crop", {"referit3d": {"filter_lang": True}}),
    ("ScanNetSpatialRefer", "train", "crop", {}),
    ("ScanNetSpatialRefer", "val", "crop", {"spatialrefer": {"pc_type": "pred"}}),
    ("ScanNetScanQA", "train", "crop", {}),
    ("ScanNetScanQA", "val", "crop", {"scanqa": {"pc_type": "pred"}}),
    ("ScanNetScanQA", "val", "jax", {"scanqa": {"filter_lang": True}}),
    ("ScanNetScanQAInstruction", "train", "crop", {}),
    ("ScanNetSGQA", "train", "crop", {}),
    ("ScanNetSGQA", "val", "jax", {}),
    ("ScanNetPretrain", "train", "crop", {}),
    ("ScanNetPretrain", "val", "crop", {"pretrain": {"pc_type": "pred"}}),
]


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def both(name, split, cfgs, jmod=jlegacy, pmod=plegacy):
    jcfg, cfg = cfgs
    clear_caches()
    want = seeded(lambda: _items(getattr(jmod, name)(jcfg, split)))
    got = seeded(lambda: _items(getattr(pmod, name)(cfg, split)))
    return got, want


@pytest.mark.parametrize("name,split,tree,args", DATASETS,
                         ids=[f"{d[0]}-{d[1]}-{d[2]}-{'-'.join(d[3]) or 'gt'}" for d in DATASETS])
def test_dataset_items_match_jax(trees, name, split, tree, args):
    """Every item of the dataset, re-seeded alike: equal to the JAX
    package's, key by key."""
    with_args = {k: dict(v) for k, v in args.items()}
    if tree == "crop" and name.startswith("ScanNetSGQA"):
        # SGQA crops to its own max_obj_len around the annotated objects
        with_args["scannet_sgqa"] = {"max_obj_len": 6}
    got, want = both(name, split, configs(trees[tree], **with_args))
    assert len(want) > 0
    assert_same(got, want, name)


def test_crop_tree_exercises_the_crop_and_the_pred_match(trees):
    """The crop tree's items are cut to max_obj_len - 1 with the target
    first, and the ``pred`` items carry IoU-matched targets."""
    _, cfg = configs(trees["crop"], scanrefer={"pc_type": "pred"})
    clear_caches()
    train = seeded(lambda: plegacy.ScanNetScanRefer(cfg, "train")[0])
    assert train["obj_fts"].shape[0] == 9 and train["tgt_object_id"][0] == 0
    val = seeded(lambda: plegacy.ScanNetScanRefer(cfg, "val")[0])
    assert val["tgt_object_id_iou25"].sum() >= 1 and val["obj_boxes"].shape[1] == 6


@pytest.mark.parametrize("pool", [True, False], ids=["pooled", "per-frame"])
def test_multiview_datasets_match_jax(trees, pool):
    jcfg, cfg = configs(trees["jax"], mv=True)
    for c in (jcfg, cfg):
        c.data.mvdatasettings.is_pool_obj_feature = pool
    for name in ("ScanNetMVPretrain", "ScanNetMVReferit3D") if pool else ("ScanNetMVPretrain",):
        got, want = both(name, "train", (jcfg, cfg), jmv, pmv)
        assert len(want) > 0
        assert_same(got, want, name)


@pytest.mark.parametrize("task,names", [("SpatialRefer", ["ScanNet-referit3d-scanrefer"]),
                                        ("Pretrain", ["ScanNet", "ScanNet"])])
def test_default_dataset_matches_jax(trees, task, names):
    """``DefaultDataset`` over ``{name}{task}`` registry entries, with and
    without a source list: every item of the concatenation."""
    jcfg, cfg = configs(trees["jax"])
    for c in (jcfg, cfg):
        c.task = task
        c.data.pretrain.dataset = names
        c.dataloader = {"filter_empty_annotations": True}
    clear_caches()
    want = seeded(lambda: _items(jdefault.DefaultDataset(jcfg, "train")))
    got = seeded(lambda: _items(pdefault.DefaultDataset(cfg, "train")))
    assert len(got) == len(want) > 2
    assert_same(got, want)
    concat = pdefault.ConcatDataset([[1, 2], [3]])
    assert len(concat) == 3 and concat[-1] == 3 and concat[1] == 2


# ---------------------------------------------------------------------------
# the wrappers


@pytest.mark.parametrize("name,wrapper", [
    ("ScanNetScanRefer", "ScanFamilyDatasetWrapper"),
    ("ScanNetScanQA", "ScanFamilyDatasetWrapper"),
    ("ScanNetReferit3D", "ScanFamilyDatasetWrapper"),
    ("ScanNetPretrain", "MaskDatasetWrapper"),
])
def test_wrapper_batches_match_jax(trees, name, wrapper):
    """The wrapper's items collated into one batch (word-hash ids, padded
    objects, masked words and objects from the wrapper's own generator):
    equal to JAX's."""
    jcfg, cfg = configs(trees["crop"])
    args = {"max_seq_len": 32, "max_obj_len": 10, "txt_mask_ratio": 0.4, "pc_mask_ratio": 0.3}
    clear_caches()

    def batch(mod, ds_mod, c):
        w = getattr(mod, wrapper)(c, getattr(ds_mod, name)(c, "train"), args)
        return w.collate_fn(_items(w))

    want = seeded(lambda: batch(jwrap, jlegacy, jcfg))
    got = seeded(lambda: batch(pwrap, plegacy, cfg))
    assert_same(got, want)
    assert got["obj_fts"].shape[1:] == (10, 64, 6) and got["txt_ids"].shape[1] == 32
    if wrapper == "MaskDatasetWrapper":
        assert (got["masked_lm_labels"] != -1).any() and not got["obj_sem_masks"].all()


def test_wrappers_build_by_name_and_refuse_a_bert_vocabulary(trees):
    """``build_dataloader_leo`` resolves the legacy datasets and wrappers by
    name (the wrapper's args from ``cfg.data.<task>``); a configured
    ``BertTokenizer`` vocabulary raises instead of falling back."""
    _, cfg = configs(trees["crop"])
    cfg.task = "ScanRefer"
    clear_caches()
    loader = build_dataloader_leo(cfg, "ScanNetScanRefer", "ScanFamilyDatasetWrapper", {},
                                  {"batchsize": 2}, "val")
    batch = next(iter(loader))
    assert batch["txt_ids"].shape == (2, 32) and batch["obj_masks"].shape == (2, 10)
    cfg.model = {"prompter": {"model": {"language": {"args": {"weights": "bert-base"}}}}}
    with pytest.raises(NotImplementedError, match="BertTokenizer"):
        pwrap.ScanFamilyDatasetWrapper(cfg, [], None)
    tok = pwrap.WordHashTokenizer()
    assert_same(tok("Find the chair.", max_length=8),
                jwrap.WordHashTokenizer()("Find the chair.", max_length=8))
    clear_caches()
