"""Parity of the port's legacy grounding stack with the JAX package: the
BERT encoder, the three spatial cross encoders, the three heads,
PointTokenizeEncoder (no mixup, ``all_mixup``, ``linear_decay``), PointBERT
(kNN ties included), every registered loss, ULIP and ``no_decay_mask``, the
vision adapters, the HF-BERT loader, and the whole stack from a wrapper
batch: loss, gradients and one AdamW step against ``jax.value_and_grad``
and optax.

Small widths: hidden 64, 2 layers, 8 objects x 64 points. Weights are the
JAX modules' own, perturbed with numpy noise and converted with
``msr3d_tpu_torch.convert``. The JAX side is jitted. Tolerances, stated in
each test: fp32 outputs within atol 1e-5 (relative to the output's scale
above 1), the stack's gradients within rtol 2e-4 / atol 1e-5 element by element and
2e-5 in norm, its parameters after one AdamW step within rtol 2e-5 / atol
1e-6, as the earlier slices' training tests hold them.
"""

import functools
import random
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import msr3d_tpu.nn.build as jax_build
import msr3d_tpu.nn.grounding as jg
import msr3d_tpu.nn.pcd_tokenize as jpt
import msr3d_tpu.nn.pointbert as jpb
import msr3d_tpu.optim.losses as jl
from msr3d_tpu.config import config_from_dict as jax_config_from_dict
from msr3d_tpu.registry import VISION_REGISTRY as JAX_VISION_REGISTRY
from msr3d_tpu_torch import registry
from msr3d_tpu_torch.config import config_from_dict
from msr3d_tpu_torch.convert import jax_to_torch_state_dict, torch_name
from msr3d_tpu_torch.models.llm import prng
from msr3d_tpu_torch.nn import build as port_build
from msr3d_tpu_torch.nn import grounding as pg
from msr3d_tpu_torch.nn import pcd_tokenize as ppt
from msr3d_tpu_torch.nn import pointbert as ppb
from msr3d_tpu_torch.optim import losses as pl
from msr3d_tpu_torch.optim.build import AdamW

from torch_parity_utils import perturbed

B, T, O, P, H = 2, 12, 8, 64, 64
ATOL = 1e-5
# the whole stack's gradients element by element, as tests/test_torch_sp.py
# holds a network's (a few of the thousands of entries pass through a dozen
# fp32 reductions ordered differently), and each tensor's in norm; the
# parameters after one AdamW step as tests/test_torch_pp.py holds them
GRAD_RTOL, GRAD_ATOL, GRAD_NORM_RTOL = 2e-4, 1e-5, 2e-5
STEP_RTOL, STEP_ATOL = 2e-5, 1e-6


def load(module, variables):
    """Convert and load strictly: no JAX key is skipped."""
    state, skipped = jax_to_torch_state_dict(variables)
    assert skipped == []
    module.load_state_dict(state, strict=True)
    return module.eval()


def init(jmod, *args, **kw):
    """The JAX module's variables (init jitted: eager flax compiles op by op)."""
    return jax.jit(jmod.init)(*args, **kw)


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0.0)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol * scale)


def T_(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def streams(seed=0):
    """Text and object streams as numpy: the last two tokens and the last
    object of each row are padding."""
    r = np.random.default_rng(seed)
    return {
        "txt_embeds": r.normal(size=(B, T, H)).astype(np.float32),
        "txt_masks": np.concatenate([np.ones((B, T - 2)), np.zeros((B, 2))], 1).astype(np.int64),
        "obj_embeds": r.normal(size=(B, O, H)).astype(np.float32),
        "obj_locs": r.normal(size=(B, O, 6)).astype(np.float32),
        "obj_masks": np.concatenate([np.ones((B, O - 1)), np.zeros((B, 1))], 1).astype(np.int64),
    }


def object_clouds(seed, b=B, o=O, p=P):
    """Unit-sphere object clouds with colours in [-1, 1], as the legacy
    datasets emit them."""
    r = np.random.default_rng(seed)
    xyz = r.normal(size=(b, o, p, 3)) * 0.4
    rgb = r.uniform(-1, 1, size=(b, o, p, 3))
    return np.concatenate([xyz, rgb], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# registries and adapters


def test_registries_resolve_the_ports_modules():
    for reg, name, cls in [
        (registry.LANGUAGE_REGISTRY, "BERTLanguageEncoder", pg.BERTLanguageEncoder),
        (registry.GROUNDING_REGISTRY, "EntitySpatialCrossEncoder", pg.EntitySpatialCrossEncoder),
        (registry.GROUNDING_REGISTRY, "UnifiedSpatialCrossEncoderV1",
         pg.UnifiedSpatialCrossEncoderV1),
        (registry.GROUNDING_REGISTRY, "UnifiedSpatialCrossEncoderV2",
         pg.UnifiedSpatialCrossEncoderV2),
        (registry.HEADS_REGISTRY, "GroundHeadV1", pg.GroundHeadV1),
        (registry.HEADS_REGISTRY, "QAHeadV1", pg.QAHeadV1),
        (registry.HEADS_REGISTRY, "PretrainHeadV1", pg.PretrainHeadV1),
        (registry.VISION_REGISTRY, "PointTokenizeEncoder", ppt.PointTokenizeEncoder),
        (registry.VISION_REGISTRY, "PcdObjEncoder", port_build.build_pcd_obj_encoder),
        (registry.VISION_REGISTRY, "PointBERTPcdObjEncoder", port_build.build_pointbert_encoder),
        (registry.VISION_REGISTRY, "Backbone2D", port_build.build_backbone2d),
        (registry.LOSS_REGISTRY, "ULIPWithImageLoss", pl.ULIPWithImageLoss),
    ]:
        assert reg.get(name) is cls
    assert set(pl.BUILTIN_LOSSES) == set(jl._BUILTIN)


def test_vision_adapters_map_the_yaml_args_as_jax():
    """Each adapter builds from the same YAML args as JAX's: PointBERT's
    outputs equal on converted weights, PcdObjEncoder's and Backbone2D's
    fields equal, PCDSwin3DEncoder raises until swin3d is ported."""
    pb = {"name": "PointBERTPcdObjEncoder", "args": {
        "trans_dim": 32, "depth": 1, "num_heads": 4, "group_size": 8, "num_group": 16,
        "encoder_dims": 32, "add_RGB": True, "freeze": True}}
    jmod = JAX_VISION_REGISTRY.get("PointBERTPcdObjEncoder")(jax_config_from_dict(pb))
    tmod = registry.build_module("vision", config_from_dict(pb), device="cpu")
    pts = object_clouds(1, b=1, o=3)
    v = perturbed(init(jmod, jax.random.key(0), jnp.asarray(pts)))
    want = jax.jit(jmod.apply)(v, jnp.asarray(pts))[0]
    close(load(tmod, v)(T_(pts))[0], want)
    assert tmod.freeze and jmod.freeze

    pcd = {"name": "PcdObjEncoder", "args": {
        "sa_n_points": [8, 4, None], "sa_n_samples": [8, 8, None], "sa_radii": [0.4, 0.8, None],
        "sa_mlps": [[3, 8, 8, 16], [16, 16, 16, 32], [32, 32, 32, 64]], "dropout": 0.1,
        "freeze": False}}
    jenc = JAX_VISION_REGISTRY.get("PcdObjEncoder")(jax_config_from_dict(pcd))
    tenc = registry.build_module("vision", config_from_dict(pcd), device="cpu")
    assert tenc.freeze == jenc.freeze is False
    assert [s.npoint for s in tenc.pcd_net.sa] == list(jenc.sa_n_points)
    assert [s.radius for s in tenc.pcd_net.sa] == list(jenc.sa_radii)
    v = init(jenc, jax.random.key(0), jnp.asarray(pts))
    assert sorted(jax_to_torch_state_dict(v)[0]) == sorted(tenc.state_dict())

    b2d = {"name": "Backbone2D", "freeze": False,
           "args": {"backbone_name": "convnext_base", "pooling": "attention"}}
    jb, tb = (JAX_VISION_REGISTRY.get("Backbone2D")(jax_config_from_dict(b2d)),
              registry.build_module("vision", config_from_dict(b2d), device="meta"))
    assert (tb.backbone_name, tb.freeze) == (jb.backbone_name, jb.freeze)
    assert tb.pooling == "attn" and jb.pooling == "attention"
    swin = {"name": "PCDSwin3DEncoder",
            "args": {"depths": [1, 1], "channels": [12, 16], "num_heads": [2, 2],
                     "window_sizes": [3, 3], "num_layers": 2, "quant_size": 2,
                     "upsample": "linear"}}
    js = JAX_VISION_REGISTRY.get("PCDSwin3DEncoder")(jax_config_from_dict(swin))
    ts = registry.build_module("vision", config_from_dict(swin), device="cpu")
    assert ts._cfg == js._cfg and (ts.signal, ts.use_offset) == (js.signal, js.use_offset)
    assert ts.unet.stem_transformer is js.unet.stem_transformer is False
    assert ts.unet.up_attn is js.unet.up_attn is False
    assert [len(layer.blocks) for layer in ts.unet.layers] == list(js.unet.depths[1:])
    assert jax_build.build_swin3d_encoder is JAX_VISION_REGISTRY.get("PCDSwin3DEncoder")


# ---------------------------------------------------------------------------
# BERT


def test_bert_matches_jax():
    """Post-LN layers over padded text: fp32 within 1e-5."""
    s = streams()
    ids = np.random.default_rng(3).integers(0, 100, (B, T))
    jmod = jg.BERTLanguageEncoder(hidden_size=H, num_hidden_layers=2, num_attention_heads=4,
                                  vocab_size=100, max_position_embeddings=32)
    v = perturbed(init(jmod, jax.random.key(0), jnp.asarray(ids), jnp.asarray(s["txt_masks"])))
    want = jax.jit(jmod.apply)(v, jnp.asarray(ids), jnp.asarray(s["txt_masks"]))
    tmod = load(pg.BERTLanguageEncoder(hidden_size=H, num_hidden_layers=2,
                                       num_attention_heads=4, vocab_size=100,
                                       max_position_embeddings=32), v)
    close(tmod(T_(ids), T_(s["txt_masks"])), want)


def hf_bert_state_dict(seed, hidden=32, layers=3, vocab=128, positions=64):
    """A Hugging Face ``BertModel`` state dict, written here: every key that
    ``convert_bert_state_dict`` reads, random values, torch (out, in)
    layouts."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g) * 0.2  # noqa: E731
    sd = {"embeddings.word_embeddings.weight": r(vocab, hidden),
          "embeddings.position_embeddings.weight": r(positions, hidden),
          "embeddings.token_type_embeddings.weight": r(2, hidden),
          "embeddings.LayerNorm.weight": 1 + r(hidden), "embeddings.LayerNorm.bias": r(hidden),
          "embeddings.position_ids": torch.arange(positions)[None]}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (hidden, hidden),
                             "attention.self.key": (hidden, hidden),
                             "attention.self.value": (hidden, hidden),
                             "attention.output.dense": (hidden, hidden),
                             "intermediate.dense": (4 * hidden, hidden),
                             "output.dense": (hidden, 4 * hidden)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = r(o, n), r(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = 1 + r(hidden), r(hidden)
    return sd


def test_hf_bert_state_dict_loads_like_jaxs_conversion():
    """A Hugging Face BERT state dict (3 layers, written by the test; keys
    with and without ``bert.``) loads into the port's 2-layer encoder, which
    then equals the JAX encoder on ``convert_bert_state_dict`` of the same
    dict within 1e-5. (JAX's own test holds that conversion to
    ``transformers``' BertModel.)"""
    sd = hf_bert_state_dict(0)
    ids = np.random.default_rng(0).integers(0, 128, (B, T))
    mask = streams()["txt_masks"]
    kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, vocab_size=128,
              max_position_embeddings=64, dropout=0.0)
    want = jax.jit(jg.BERTLanguageEncoder(**kw).apply)(
        jg.convert_bert_state_dict(sd, num_layers=2), jnp.asarray(ids), jnp.asarray(mask))
    for prefix in ("", "bert."):
        tmod = pg.BERTLanguageEncoder(**kw)
        pg.load_hf_bert_state_dict(tmod, {prefix + k: v for k, v in sd.items()})
        with torch.no_grad():
            close(tmod.eval()(T_(ids), T_(mask)), want)
    with pytest.raises(KeyError):  # a 4-layer encoder finds no layer 3
        pg.load_hf_bert_state_dict(pg.BERTLanguageEncoder(**dict(kw, num_hidden_layers=4)), sd)


# ---------------------------------------------------------------------------
# cross encoders and heads


@pytest.mark.parametrize("name", ["EntitySpatialCrossEncoder", "UnifiedSpatialCrossEncoderV1",
                                  "UnifiedSpatialCrossEncoderV2"])
def test_cross_encoder_matches_jax(name):
    """Both streams out of 2 layers: fp32 within 1e-5."""
    s = {k: jnp.asarray(v) for k, v in streams().items()}
    kw = dict(hidden_size=H, num_attention_heads=4, num_layers=2)
    jmod = getattr(jg, name)(**kw)
    v = perturbed(init(jmod, jax.random.key(0), **s))
    want_txt, want_obj = jax.jit(jmod.apply)(v, **s)
    tmod = load(getattr(pg, name)(**kw), v)
    got_txt, got_obj = tmod(**{k: T_(x) for k, x in streams().items()})
    close(got_txt, want_txt)
    close(got_obj, want_obj)


@pytest.mark.parametrize("detach", [False, True])
def test_ground_head_matches_jax(detach):
    """All four outputs, og3d -inf at the padded object: fp32 within 1e-5."""
    s = streams()
    pre = np.random.default_rng(4).normal(size=(B, O, H)).astype(np.float32)
    args = (s["txt_embeds"], s["obj_embeds"], pre, s["obj_masks"])
    jmod = jg.GroundHeadV1(input_size=H, hidden_size=H, sem_cls_size=20,
                           detach_all_aux_loss=detach)
    v = perturbed(init(jmod, jax.random.key(0), *map(jnp.asarray, args)))
    want = jax.jit(jmod.apply)(v, *map(jnp.asarray, args))
    got = load(pg.GroundHeadV1(input_size=H, hidden_size=H, sem_cls_size=20,
                               detach_all_aux_loss=detach), v)(*map(T_, args))
    for g, w in zip(got, want):
        close(g, w)
    assert torch.isneginf(got[3][:, -1]).all()


def test_qa_and_pretrain_heads_match_jax():
    s = streams()
    args = (s["obj_embeds"], s["obj_masks"], s["txt_embeds"], s["txt_masks"])
    jmod = jg.QAHeadV1(hidden_size=H, num_answers=33, flat_out_size=48, mlp_size=24)
    v = perturbed(init(jmod, jax.random.key(0), *map(jnp.asarray, args)))
    tmod = load(pg.QAHeadV1(hidden_size=H, num_answers=33, flat_out_size=48, mlp_size=24), v)
    close(tmod(*map(T_, args)), jax.jit(jmod.apply)(v, *map(jnp.asarray, args)))

    jhead = jg.PretrainHeadV1(hidden_size=H, vocab_size=100)
    v = perturbed(init(jhead, jax.random.key(0), jnp.asarray(s["txt_embeds"])))
    thead = load(pg.PretrainHeadV1(hidden_size=H, vocab_size=100), v)
    close(thead(T_(s["txt_embeds"])), jax.jit(jhead.apply)(v, jnp.asarray(s["txt_embeds"])))


# ---------------------------------------------------------------------------
# the point encoders

TOKENIZE_KW = dict(hidden_size=H, num_attention_heads=4, num_layers=2, num_semantic_classes=20,
                   glove_dim=16, sa_mlps=((3, 8, 8, 16), (16, 16, 16, 32), (32, 32, 32, H)))


def tokenize_inputs(seed):
    r = np.random.default_rng(seed)
    s = streams()
    labels = r.integers(0, 20, (B, O))
    labels[:, -1] = -100
    return dict(obj_pcds=object_clouds(seed), obj_locs=s["obj_locs"], obj_masks=s["obj_masks"],
                obj_sem_masks=(r.random((B, O)) > 0.3).astype(np.int64), obj_labels=labels)


def spy_mixup_key(seen):
    """``linear_decay_mixup`` wrapped to record the key the JAX module's
    ``make_rng('mixup')`` gives it (a host callback, so it works under jit)."""
    real = jpt.linear_decay_mixup

    def spy(*args):
        jax.debug.callback(lambda k: seen.append(np.asarray(k).astype(np.int64)),
                           jax.random.key_data(args[-1]))
        return real(*args)

    return spy


@pytest.mark.parametrize("mixup,matmul", [(None, False), ("all_mixup", True),
                                          ("linear_decay", False)])
def test_point_tokenize_encoder_matches_jax(mixup, matmul):
    """PointNet++ (FPS at npoint 32 and 16), the tokenizer with each mixup,
    the category table (learned, or given) by index and by product, the
    semantic mask and the
    spatial layers: the three outputs in fp32 within 1e-5. ``linear_decay``
    at step 30 of 100 between 0.2 and 0.6 replaces about half the objects,
    drawn from the key flax derives."""
    inputs = tokenize_inputs(5)
    kw = dict(TOKENIZE_KW, mixup_strategy=mixup, use_matmul_label=matmul, mixup_stage1=0.2,
              mixup_stage2=0.6)
    if matmul:  # a given GloVe-like table: a constant on both sides
        kw["cat2vec"] = np.random.default_rng(9).normal(size=(20, 16)).astype(np.float32)
    jmod = jpt.PointTokenizeEncoder(**kw)
    step = dict(cur_step=30, max_steps=100) if mixup == "linear_decay" else {}
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    rngs = {"mixup": jax.random.key(11)}
    v = perturbed(init(jmod, {"params": jax.random.key(0), "mixup": jax.random.key(1)},
                            **jin, **step))
    seen = []
    with mock.patch.object(jpt, "linear_decay_mixup", spy_mixup_key(seen)):
        want = jax.jit(lambda v, x: jmod.apply(v, **x, **step, rngs=rngs))(v, jin)
        jax.effects_barrier()
    tmod = load(ppt.PointTokenizeEncoder(**kw), v)
    extra = {}
    if mixup == "linear_decay":
        extra["mixup_key"] = torch.from_numpy(seen[0])
        ratio_draws = prng.uniform(extra["mixup_key"], (B, O)) < 0.75
        assert 0 < int(ratio_draws.sum()) < B * O  # some objects replaced, some not
    got = tmod(**{k: T_(x) for k, x in inputs.items()}, **step, **extra)
    for g, w in zip(got, want):
        close(g, w)


def test_mixup_functions_match_jax():
    """``all_mixup`` and ``linear_decay_mixup`` alone, before, inside and
    after the annealing window: bit-equal."""
    r = np.random.default_rng(2)
    pred = r.random((3, 9, 7)).astype(np.float32)
    labels = r.integers(-1, 7, (3, 9))
    np.testing.assert_array_equal(ppt.all_mixup(T_(pred), T_(labels)).numpy(),
                                  np.asarray(jpt.all_mixup(jnp.asarray(pred), jnp.asarray(labels))))
    key = jax.random.key(4)
    tkey = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))
    for step in (5, 40, 55, 90):
        want = jpt.linear_decay_mixup(jnp.asarray(pred), jnp.asarray(labels), step, 100, 0.2,
                                      0.6, key)
        got = ppt.linear_decay_mixup(T_(pred), T_(labels), step, 100, 0.2, 0.6, tkey)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def tie_clouds():
    """Clouds whose kNN has ties: every point duplicated (equal distances
    between distinct indices), and a coarse lattice."""
    r = np.random.default_rng(8)
    half = r.normal(size=(2, 32, 3)) * 0.4
    dup = np.concatenate([half, half], 1)
    lattice = r.integers(-2, 3, size=(2, 64, 3)) * 0.25
    xyz = np.concatenate([dup, lattice], 0)
    rgb = r.uniform(-1, 1, size=xyz.shape)
    return np.concatenate([xyz, rgb], -1).astype(np.float32)


def test_knn_point_matches_jax_on_ties():
    """``knn_point`` against ``jax.lax.top_k`` of the negated distances:
    the same indices, ties (duplicated points, a lattice) included."""
    pts = tie_clouds()
    xyz = pts[..., :3]
    centers = xyz[:, ::5]
    want = np.asarray(jax.jit(jpb.knn_point, static_argnums=0)(8, jnp.asarray(xyz),
                                                               jnp.asarray(centers)))
    got = ppb.knn_point(8, T_(xyz), T_(centers)).numpy()
    np.testing.assert_array_equal(got, want)
    d2 = ((centers[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    kth = np.sort(d2, -1)[..., 7:9]
    assert (kth[..., 0] == kth[..., 1]).any()  # a tie straddles the k-th neighbour


def test_pointbert_matches_jax():
    """FPS (16 groups) and kNN (8) over random and tied clouds, the
    mini-PointNet's BatchNorm from ``batch_stats``, 2 blocks: the object
    embeddings in fp32 within 1e-5."""
    pts = np.concatenate([object_clouds(6, b=1, o=4).reshape(4, P, 6), tie_clouds()], 0)
    pts = pts.reshape(2, 4, P, 6)
    kw = dict(trans_dim=32, depth=2, num_heads=4, group_size=8, num_group=16, encoder_dims=32)
    jmod = jpb.PointBERTPcdObjEncoder(**kw)
    v = perturbed(init(jmod, jax.random.key(0), jnp.asarray(pts)))
    assert "batch_stats" in v
    want = jax.jit(jmod.apply)(v, jnp.asarray(pts))[0]
    close(load(ppb.PointBERTPcdObjEncoder(**kw), v)(T_(pts))[0], want)


# ---------------------------------------------------------------------------
# losses and the decay mask


def loss_inputs(seed):
    r = np.random.default_rng(seed)
    n, c, v = 7, 11, 13
    sem = r.random((B, n)) > 0.5
    sem[:, 0], sem[:, 1] = True, False
    lm = r.integers(0, v, (B, T))
    lm[:, ::3] = -1
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "og3d_logits": f(B, n), "txt_cls_logits": f(B, c), "obj_cls_raw_logits": f(B, n, c),
        "obj_cls_pre_logits": f(B, n, c), "obj_cls_post_logits": f(B, n, c),
        "answer_scores": f(B, 17), "txt_lm_cls_logits": f(B, T, v),
        "pred_images": f(B, 4, 4, 3), "target_images": f(B, 4, 4, 3),
        "tgt_object_id": r.integers(0, n, (B, 1)),
        "tgt_object_label": r.integers(0, c, (B, 1)),
        "obj_labels": r.integers(0, c, (B, n)),
        "obj_masks": np.concatenate([np.ones((B, n - 2)), np.zeros((B, 2))], 1).astype(bool),
        "obj_sem_masks": sem, "answer_label": (r.random((B, 17)) > 0.7).astype(np.int64),
        "masked_lm_labels": lm,
    }


MULTI = {"og3d_multi_loss": ("tgt_object_id", 7), "txt_cls_multi_loss": ("tgt_object_label", 11)}


@pytest.mark.parametrize("name", sorted(jl._BUILTIN))
def test_loss_matches_jax(name):
    """Each registered loss and its gradient over every float input: fp32
    within 1e-6 relative."""
    data = loss_inputs(1)
    if name in MULTI:  # the multi-label losses read multi-hot targets
        key, width = MULTI[name]
        data[key] = (np.random.default_rng(2).random((B, width)) > 0.6).astype(np.int64)
    floats = [k for k, x in data.items() if x.dtype == np.float32]

    def jloss(fl):
        return jl._BUILTIN[name]({**{k: jnp.asarray(x) for k, x in data.items()}, **fl})

    want, want_g = jax.jit(jax.value_and_grad(jloss))({k: jnp.asarray(data[k]) for k in floats})
    leaves = {k: T_(data[k]).requires_grad_(True) for k in floats}
    got = pl.BUILTIN_LOSSES[name]({**{k: T_(x) for k, x in data.items()}, **leaves})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for k in floats:
        g = leaves[k].grad
        g = np.zeros(data[k].shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want_g[k]), rtol=1e-5, atol=1e-7)


def test_get_losses_loss_and_ulip_match_jax():
    """``get_losses`` and ``Loss`` (a registry fallback included), a
    model-written ``loss``, and ULIP's tri-modal loss."""
    data = loss_inputs(3)
    keys = ["og3d_loss", "txt_cls_loss", "obj_cls_pre_loss_mask", "lm_cls_loss", "mse_loss"]
    jtot, jall = jl.get_losses({k: jnp.asarray(v) for k, v in data.items()}, keys, keys[:3])
    ttot, tall = pl.get_losses({k: T_(v) for k, v in data.items()}, keys, keys[:3])
    assert set(tall) == set(jall)
    for k in jall:
        np.testing.assert_allclose(tall[k].item(), float(jall[k]), rtol=1e-6)
    cfg = config_from_dict({"model": {"vis_loss_list": keys, "loss_list": keys[3:]}})
    np.testing.assert_allclose(pl.Loss(cfg)({k: T_(v) for k, v in data.items()})[0].item(),
                               float(jall["lm_cls_loss"] + jall["mse_loss"]), rtol=1e-6)
    given = pl.get_losses({**{k: T_(v) for k, v in data.items()}, "loss": torch.tensor(7.0)},
                          keys, keys)[0]
    assert given.item() == 7.0

    r = np.random.default_rng(5)
    ulip = {"pc_embed": r.normal(size=(6, 16)), "text_embed": r.normal(size=(6, 16)),
            "image_embed": r.normal(size=(6, 16)), "logit_scale": np.float32(3.0),
            "labels": np.arange(6)}
    ulip = {k: np.asarray(v, np.float32 if k != "labels" else np.int64) for k, v in ulip.items()}
    want = jl.ULIPWithImageLoss()({k: jnp.asarray(v) for k, v in ulip.items()})
    got = pl.get_losses({k: T_(v) for k, v in ulip.items()}, ["ULIPWithImageLoss"],
                        ["ULIPWithImageLoss"])[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_no_decay_mask_matches_jax():
    """Biases, LayerNorm and BatchNorm scales exempt, embeddings and the
    tables decayed, leaf by leaf through ``torch_name``, over PointBERT,
    PointTokenizeEncoder and the LM head's own bias (the stack test's AdamW
    step holds BERT's, the fusion's and the heads' masks)."""
    pts = object_clouds(0, b=1, o=2)
    s = {k: jnp.asarray(v) for k, v in streams().items()}
    ins = {k: jnp.asarray(v) for k, v in tokenize_inputs(0).items()}
    cases = [
        (jpb.PointBERTPcdObjEncoder(trans_dim=32, depth=1, num_heads=4, group_size=8,
                                    num_group=16, encoder_dims=32), (jnp.asarray(pts),), {},
         ppb.PointBERTPcdObjEncoder(trans_dim=32, depth=1, num_heads=4, group_size=8,
                                    num_group=16, encoder_dims=32)),
        (jpt.PointTokenizeEncoder(**dict(TOKENIZE_KW, num_layers=1)), (), ins,
         ppt.PointTokenizeEncoder(**dict(TOKENIZE_KW, num_layers=1))),
        (jg.PretrainHeadV1(hidden_size=H, vocab_size=50), (s["txt_embeds"],), {},
         pg.PretrainHeadV1(hidden_size=H, vocab_size=50)),
    ]
    for jmod, args, kw, tmod in cases:
        v = init(jmod, jax.random.key(0), *args, **kw)
        flat = jax.tree_util.tree_flatten_with_path(jl.no_decay_mask(v["params"]))[0]
        want = {}
        for path, decays in flat:
            keys = "/".join(str(getattr(p, "key", p)) for p in path)
            want[torch_name("params/" + keys)[0]] = bool(decays)
        assert pl.no_decay_mask(tmod) == want
        assert not all(want.values()) and any(want.values())


# ---------------------------------------------------------------------------
# the whole stack from a wrapper batch: loss, gradients, one AdamW step

STACK_LOSSES = ["og3d_loss", "txt_cls_loss", "obj_cls_pre_loss", "obj_cls_post_loss",
                "answer_loss"]
N_ANSWERS = 33


@pytest.fixture(scope="module")
def stack_batch(tmp_path_factory):
    """A ScanRefer train batch of 2 through the port's
    ``ScanFamilyDatasetWrapper`` (4 objects of 64 points a scan, text 32),
    with the answer multi-hot of a ScanQA batch of the same tree padded to
    N_ANSWERS answers."""
    from msr3d_tpu_torch.data import synthetic
    from msr3d_tpu_torch.data.datasets.dataset_wrapper import ScanFamilyDatasetWrapper
    from msr3d_tpu_torch.data.datasets.scannet_legacy import ScanNetScanQA, ScanNetScanRefer
    from msr3d_tpu_torch.data.scan_loader import ScanCache

    root = tmp_path_factory.mktemp("stack")
    scans = ("scene0000_00", "scene0001_00")
    base = synthetic.build_scannet_tree(root, np.random.default_rng(0), scan_ids=scans)
    synthetic.build_legacy_annotations(base, scans)
    cfg = config_from_dict(synthetic.legacy_config_dict(base))
    random.seed(0)
    np.random.seed(0)
    args = {"max_seq_len": 32, "max_obj_len": 10}
    refer = ScanFamilyDatasetWrapper(cfg, ScanNetScanRefer(cfg, "train"), args)
    batch = refer.collate_fn([refer[0], refer[3]])
    qa = ScanFamilyDatasetWrapper(cfg, ScanNetScanQA(cfg, "train"), args)
    answers = qa.collate_fn([qa[0], qa[3]])["answer_label"]
    batch["answer_label"] = np.pad(answers, ((0, 0), (0, N_ANSWERS - answers.shape[1])))
    ScanCache.clear()
    return batch


STACK_KW = dict(
    enc=dict(TOKENIZE_KW, num_layers=1),
    bert=dict(hidden_size=H, num_hidden_layers=1, num_attention_heads=4),
    fusion=dict(hidden_size=H, num_attention_heads=4, num_layers=2),
    ground=dict(input_size=H, hidden_size=H, sem_cls_size=20),
    qa=dict(hidden_size=H, num_answers=N_ANSWERS, flat_out_size=48, mlp_size=24),
)


def jax_stack():
    return dict(enc=jpt.PointTokenizeEncoder(**STACK_KW["enc"]),
                bert=jg.BERTLanguageEncoder(**STACK_KW["bert"]),
                fusion=jg.UnifiedSpatialCrossEncoderV2(**STACK_KW["fusion"]),
                ground=jg.GroundHeadV1(**STACK_KW["ground"]),
                qa=jg.QAHeadV1(**STACK_KW["qa"]))


def port_stack():
    return torch.nn.ModuleDict(dict(
        enc=ppt.PointTokenizeEncoder(**STACK_KW["enc"]),
        bert=pg.BERTLanguageEncoder(**STACK_KW["bert"]),
        fusion=pg.UnifiedSpatialCrossEncoderV2(**STACK_KW["fusion"]),
        ground=pg.GroundHeadV1(**STACK_KW["ground"]),
        qa=pg.QAHeadV1(**STACK_KW["qa"])))


def stack_outputs(apply, b):
    """encoder → BERT → fusion → heads → the loss dict; ``apply(name, *args)``
    runs one module of either package. The CE losses read the object labels
    with padding at 0, as the JAX package's own wiring test feeds them."""
    obj, obj_pre, _ = apply("enc", b["obj_fts"], b["obj_locs"], b["obj_masks"],
                            b["obj_sem_masks"], b["obj_labels"])
    txt = apply("bert", b["txt_ids"], b["txt_masks"])
    txt, obj = apply("fusion", txt, b["txt_masks"], obj, b["obj_locs"], b["obj_masks"])
    txt_cls, obj_cls, obj_cls_pre, og3d = apply("ground", txt, obj, obj_pre, b["obj_masks"])
    scores = apply("qa", obj, b["obj_masks"], txt, b["txt_masks"])
    return {"og3d_logits": og3d, "txt_cls_logits": txt_cls, "obj_cls_post_logits": obj_cls,
            "obj_cls_pre_logits": obj_cls_pre, "answer_scores": scores,
            "tgt_object_id": b["tgt_object_id"], "tgt_object_label": b["tgt_object_label"],
            "obj_labels": b["obj_labels_ce"], "obj_masks": b["obj_masks"],
            "answer_label": b["answer_label"]}


def test_stack_step_matches_jax(stack_batch):
    """PointTokenizeEncoder (PointNet++ at npoint 32 and 16), BERT, the V2
    fusion, GroundHeadV1 and QAHeadV1 on the wrapper's batch: the five
    losses (rtol 2e-5), every gradient (rtol 2e-4 / atol 1e-5, and 2e-5 in
    norm) and the parameters after one AdamW step with the JAX package's
    no-decay mask: optax's adamw against the port's two AdamW groups over
    the same gradients, rtol 2e-5, atol 1e-6."""
    keys = ["obj_fts", "obj_locs", "obj_masks", "obj_sem_masks", "obj_labels", "txt_ids",
            "txt_masks", "tgt_object_id", "tgt_object_label", "answer_label"]
    b = {k: np.asarray(stack_batch[k]) for k in keys}
    b["obj_labels_ce"] = np.maximum(b["obj_labels"], 0)
    assert b["obj_fts"].shape == (2, 10, 64, 6) and b["txt_ids"].shape == (2, 32)
    assert b["answer_label"].sum() > 0 and (b["obj_labels"] == -100).any()

    jmods = jax_stack()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    variables = {}
    variables["enc"] = init(jmods["enc"], jax.random.key(0), jb["obj_fts"], jb["obj_locs"],
                            jb["obj_masks"], jb["obj_sem_masks"], jb["obj_labels"])
    obj = jax.jit(jmods["enc"].apply)(variables["enc"], jb["obj_fts"], jb["obj_locs"],
                                      jb["obj_masks"], jb["obj_sem_masks"], jb["obj_labels"])
    variables["bert"] = init(jmods["bert"], jax.random.key(1), jb["txt_ids"], jb["txt_masks"])
    txt = jax.jit(jmods["bert"].apply)(variables["bert"], jb["txt_ids"], jb["txt_masks"])
    variables["fusion"] = init(jmods["fusion"], jax.random.key(2), txt, jb["txt_masks"],
                               obj[0], jb["obj_locs"], jb["obj_masks"])
    variables["ground"] = init(jmods["ground"], jax.random.key(3), txt, obj[0], obj[1],
                               jb["obj_masks"])
    variables["qa"] = init(jmods["qa"], jax.random.key(4), obj[0], jb["obj_masks"], txt,
                           jb["txt_masks"])
    variables = {k: perturbed(v, seed=i) for i, (k, v) in enumerate(variables.items())}
    params = {k: v["params"] for k, v in variables.items()}
    stats = {k: {c: x for c, x in v.items() if c != "params"} for k, v in variables.items()}

    def jloss(params):
        def apply(name, *args):
            return jmods[name].apply({"params": params[name], **stats[name]}, *args)

        return jl.get_losses(stack_outputs(apply, jb), STACK_LOSSES, STACK_LOSSES)

    (want, want_all), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = port_stack()
    for name, mod in model.items():
        load(mod, variables[name])
    tb = {k: T_(v) for k, v in b.items()}
    got, got_all = pl.get_losses(stack_outputs(lambda n, *a: model[n](*a), tb),
                                 STACK_LOSSES, STACK_LOSSES)
    got.backward()
    for k in STACK_LOSSES:
        np.testing.assert_allclose(got_all[k].item(), float(want_all[k]), rtol=GRAD_NORM_RTOL)

    want_grads = {f"{n}.{k}": v.numpy() for n in model
                  for k, v in jax_to_torch_state_dict({"params": want_g[n]})[0].items()}
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in named.items()}
    for k, g in grads.items():
        g = g.numpy()
        np.testing.assert_allclose(g, want_grads[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
        assert np.linalg.norm(g - want_grads[k]) <= GRAD_NORM_RTOL * np.linalg.norm(
            want_grads[k]) + GRAD_ATOL, k
    assert named["enc.point_cls_head.fc1.weight"].grad is None  # behind the detached softmax

    # optax's adamw with the JAX mask, over the port's gradients in the JAX
    # tree (Adam's near-sign update would magnify the two frameworks'
    # difference on gradient entries near 0)
    def port_grad(n, path, _):
        name, transpose = torch_name("params/" + "/".join(str(getattr(q, "key", q)) for q in path))
        g = grads[f"{n}.{name}"].numpy()
        return jnp.asarray(g.T if transpose else g)

    port_g = {n: jax.tree_util.tree_map_with_path(functools.partial(port_grad, n), params[n])
              for n in params}
    tx = optax.adamw(1e-3, weight_decay=0.05, mask=jl.no_decay_mask(params))
    new_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        port_g, params)
    want_params = {f"{n}.{k}": v.numpy() for n in model
                   for k, v in jax_to_torch_state_dict({"params": new_params[n]})[0].items()}

    mask = pl.no_decay_mask(model)
    for decays in (True, False):
        group = {k: p for k, p in named.items() if mask[k] == decays}
        AdamW(group, lambda step: 1e-3, weight_decay=0.05 if decays else 0.0).step(
            {k: grads[k] for k in group})
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[k], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=k)
