"""Parity of the port's scene prompter with the JAX package in every option.

The same numpy inputs and the same JAX variables (converted and loaded by
``load_jax_params``, strictly, nothing skipped) go through
``msr3d_tpu.models.ose3d_situation.OSE3DSituation`` and the port's, at a
tiny width: hidden 32, 2 layers, 4 heads, 5 objects of 32 points, fp32.
Cases:

* one for each row of the parameter table of the situation modes (each
  option creates its own parameter set, which the port must match key for
  key), for each spatial fusion with ``spatial_multihead`` on and off, and
  for each pairwise-geometry mode and ``spatial_dim``;
* the options JAX cannot run raise in both packages;
* the reference-checkpoint loader fills the ``as_object`` prompter's anchor
  parameters as JAX's does;
* each layer the modes use (``MultiHeadAttention``,
  ``TransformerEncoderLayer``, ``CrossAttentionLayer``, ``DiTBlock``,
  ``AttFlat``, ``MLPHead``, ``ObjColorEncoder``) and the ops
  (``three_nn`` with a tie, ``three_interpolate``, the Fourier features,
  ``z_rotation_matrix``) against their JAX counterparts.

``obj_tokens`` agree within 1e-5: fp32 on both sides, summed in other
orders, a few ulps on values of order 1 through two layers. The JAX
side is jitted, each option's variables and outputs are computed once, and
JAX runs each option on one shared point encoder's embeddings (the port
runs its whole module, point encoder included, on the same weights).
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.models import load_weights as jax_load_weights
from msr3d_tpu.models.msr3d import MSR3DNetwork as JaxMSR3DNetwork
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.ose3d_situation import OSE3DConfig as JaxOSE3DConfig
from msr3d_tpu.models.ose3d_situation import OSE3DSituation as JaxOSE3DSituation
from msr3d_tpu.models.ose3d_situation import SpatialEncoderConfig as JaxSpatialEncoderConfig
from msr3d_tpu.nn.pointnet import PcdObjEncoder as JaxPcdObjEncoder
from msr3d_tpu.nn import layers as jax_layers
from msr3d_tpu.nn import transformers as jax_transformers
from msr3d_tpu.ops import geometry as jax_geometry
from msr3d_tpu.ops import pointnet2 as jax_pointnet2
from msr3d_tpu_torch.convert import jax_to_torch_state_dict, load_jax_params
from msr3d_tpu_torch.models import load_weights
from msr3d_tpu_torch.models.msr3d import MSR3DNetwork
from msr3d_tpu_torch.models.ose3d_situation import OSE3DSituation
from msr3d_tpu_torch.nn import layers
from msr3d_tpu_torch.nn import transformers
from msr3d_tpu_torch.ops import geometry, pointnet2

from torch_parity_utils import (
    perturbed,
    scene_inputs,
    torch_llama_config,
    torch_prompter_config,
)

ATOL = 1e-5

TINY = JaxOSE3DConfig(
    hidden_size=32,
    spatial_encoder=JaxSpatialEncoderConfig(
        num_attention_heads=4, dim_feedforward=64, dropout=0.1, num_layers=2
    ),
    sa_n_points=(8, 4, None),
    sa_n_samples=(8, 8, None),
    sa_radii=(0.4, 0.8, None),
    sa_mlps=((3, 8, 8, 16), (16, 16, 16, 32), (32, 32, 32, 64)),
    obj_encoder_dtype="float32",
    attn_flat_mlp_size=16,
    attn_flat_out_size=24,
)


def _cfg(situation_type="as_transform_for_objects", **kw):
    se = {k: kw.pop(k) for k in list(kw) if k in JaxSpatialEncoderConfig.__dataclass_fields__}
    return dataclasses.replace(
        TINY, situation_type=situation_type,
        spatial_encoder=dataclasses.replace(TINY.spatial_encoder, **se), **kw)


# the parameter table of the situation modes: each row's submodules besides
# obj_encoder, obj_linear_projection, object_type_embedding and the
# spatial_layer_i (read from OSE3DSituation.init with two layers)
_ORI = ("object_orientation_feat", "orientation_encoder")
_ANCHOR = ("anchor_feat", "anchor_size")
_FOURIER = ("loc_embedding_encoder", "size_embedding_encoder")
_COND = ("loc_embedding_encoder", "loc_layer_0", "object_orientation_feat",
         "orientation_encoder", "situation_condition_0", "situation_condition_1")
MODE_ROWS = {
    "as_object": (_cfg("as_object"), _ANCHOR + ("loc_layer_0",) + _ORI),
    "as_object-no_orientation": (_cfg("as_object", use_orientation=False),
                                 _ANCHOR + ("loc_layer_0",)),
    "as_object-no_anchor": (_cfg("as_object", use_anchor=False),
                            ("loc_layer_0", "object_orientation_feat")),
    "as_object-diff_all": (_cfg("as_object", obj_loc_encoding="diff_all"),
                           _ANCHOR + ("loc_layer_0", "loc_layer_1") + _ORI),
    "as_object-same_0": (_cfg("as_object", obj_loc_encoding="same_0"),
                         _ANCHOR + ("loc_layer_0",) + _ORI),
    "as_object_add_loc": (_cfg("as_object_add_loc"), _ANCHOR + _FOURIER + _ORI),
    "as_object_add_loc-diff_all": (_cfg("as_object_add_loc", obj_loc_encoding="diff_all"),
                                   _ANCHOR + ("loc_layer_0", "loc_layer_1") + _ORI),
    "as_embedding": (_cfg("as_embedding"), _FOURIER + _ORI),
    "as_embedding-diff_all": (_cfg("as_embedding", obj_loc_encoding="diff_all"),
                              ("loc_layer_0", "loc_layer_1", "object_orientation_feat")),
    "as_transform_for_objects": (_cfg(), _FOURIER + ("object_orientation_feat",)),
    "as_transform_for_objects-diff_all": (
        _cfg(obj_loc_encoding="diff_all"),
        ("loc_layer_0", "loc_layer_1", "object_orientation_feat")),
    "as_cross_attention": (_cfg("as_cross_attention"), _COND),
    "as_dit_attention": (_cfg("as_dit_attention"), _COND),
    "as_cross_attention-diff_all": (_cfg("as_cross_attention", obj_loc_encoding="diff_all"),
                                    _COND + ("loc_layer_1",)),
    "as_dit_attention-diff_all": (_cfg("as_dit_attention", obj_loc_encoding="diff_all"),
                                  _COND + ("loc_layer_1",)),
    "as_object-attn_flat": (_cfg("as_object", use_attn_flat=True),
                            _ANCHOR + ("loc_layer_0",) + _ORI + ("attflat_visual",)),
    "as_transform_for_objects-attn_flat": (
        _cfg(use_attn_flat=True), _FOURIER + ("object_orientation_feat", "attflat_visual")),
    "as_object-no_spatial_attn": (_cfg("as_object", use_spatial_attn=False),
                                  _ANCHOR + ("loc_layer_0",) + _ORI),
    "as_transform_for_objects-no_spatial_attn": (
        _cfg(use_spatial_attn=False), _FOURIER + ("object_orientation_feat",)),
}
FUSION_ROWS = {
    f"{fusion}-{'multihead' if multi else 'single'}": _cfg(
        spatial_attn_fusion=fusion, spatial_multihead=multi)
    for fusion in ("mul", "bias", "add", "ctx", "cond") for multi in (True, False)
}
PAIRWISE_ROWS = {
    f"{rel}-dim{dim}": _cfg("as_object", pairwise_rel_type=rel, spatial_dim=dim)
    for rel in ("center", "vertical_bottom") for dim in (1, 4, 5)
}
PAIRWISE_ROWS.update({
    "center-no_dist_norm": _cfg("as_object", spatial_dist_norm=False),
    "vertical_bottom-no_dist_norm": _cfg("as_object", pairwise_rel_type="vertical_bottom",
                                         spatial_dist_norm=False),
    # the 12-d [loc_i ‖ loc_j] goes through pairwise_loc_fc (cond cannot take it)
    "mlp-bias": _cfg("as_object", pairwise_rel_type="mlp", spatial_attn_fusion="bias"),
    "mlp-ctx": _cfg("as_object", pairwise_rel_type="mlp", spatial_attn_fusion="ctx"),
})
ALL_ROWS = {**{k: v[0] for k, v in MODE_ROWS.items()}, **FUSION_ROWS, **PAIRWISE_ROWS}
_ALWAYS = {"obj_encoder", "obj_linear_projection", "object_type_embedding", "spatial_layer_0",
           "spatial_layer_1"}


def _inputs():
    return scene_inputs(3, b=2, n_obj=5, n_pts=32)


@functools.lru_cache(maxsize=None)
def _jax_encoder():
    """The point encoder's perturbed variables and embeddings, shared by
    every option (its compile is most of a JAX init)."""
    pcds = jnp.asarray(_inputs()["obj_fts"])
    jmod = JaxPcdObjEncoder(sa_n_points=TINY.sa_n_points, sa_n_samples=TINY.sa_n_samples,
                            sa_radii=TINY.sa_radii, sa_mlps=TINY.sa_mlps)
    variables = perturbed(jax.jit(jmod.init)(jax.random.key(4), pcds), seed=4)
    return variables, jax.jit(jmod.apply)(variables, pcds)[0]


def _draw(path, leaf, rng):
    """A leaf at the scale of its JAX initialiser, plus N(0, 0.1) noise:
    kernels N(0, 1/fan_in), LayerNorm scales and ``anchor_size`` 1, the
    rest (biases, embeddings, ``anchor_feat``, the orientation feature) 0."""
    name = jax.tree_util.keystr(path)
    noise = rng.normal(size=leaf.shape) * 0.1
    if name.endswith("['kernel']"):
        base = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[0])
    elif name.endswith(("['scale']", "['anchor_size']")):
        base = 1.0
    else:
        base = 0.0
    return (base + noise).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """(variables, JAX outputs) of one option, once per module. The tree is
    the full module's ``init`` tree (by ``jax.eval_shape``: the parameters
    flax creates for this option), the point encoder's leaves the shared
    encoder's and the others drawn by ``_draw``; JAX runs the option on the
    shared encoder's embeddings (``precomputed_obj_embeds``), jitted."""
    cfg = ALL_ROWS[name]
    jin = {k: jnp.asarray(v) for k, v in _inputs().items()}
    enc, embeds = _jax_encoder()
    jmod = JaxOSE3DSituation(cfg)
    tree = jax.eval_shape(lambda: jmod.init(jax.random.key(5), **jin))
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map_with_path(lambda p, x: _draw(p, x, rng), tree)
    variables["params"]["obj_encoder"] = enc["params"]
    variables["batch_stats"] = {"obj_encoder": enc["batch_stats"]}
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(tree)
    out = jax.jit(lambda v: jmod.apply(v, **jin, precomputed_obj_embeds=embeds))(variables)
    return variables, {k: np.asarray(v) for k, v in out.items()}


def _port(cfg, variables):
    module = OSE3DSituation(torch_prompter_config(cfg))
    assert load_jax_params(module, variables) == []
    return module.eval()


def _port_outputs(module):
    with torch.no_grad():
        return module(**{k: torch.from_numpy(v) for k, v in _inputs().items()})


def _assert_matches(name: str):
    variables, want = _jax_run(name)
    module = _port(ALL_ROWS[name], variables)
    state, _ = jax_to_torch_state_dict(variables)
    assert sorted(module.state_dict()) == sorted(state)
    got = _port_outputs(module)
    assert sorted(got) == sorted(want)
    assert got["obj_tokens"].shape == want["obj_tokens"].shape
    np.testing.assert_allclose(got["obj_tokens"].numpy(), want["obj_tokens"], atol=ATOL)
    np.testing.assert_array_equal(got["obj_masks"].numpy(), want["obj_masks"])
    if "oatt" in want:
        np.testing.assert_allclose(got["oatt"].numpy(), want["oatt"], atol=ATOL)
    return variables, got


@pytest.mark.parametrize("name", list(MODE_ROWS))
def test_situation_mode_matches_jax(name):
    variables, got = _assert_matches(name)
    cfg, extra = MODE_ROWS[name]
    assert set(variables["params"]) == _ALWAYS | set(extra)
    prepend = cfg.use_anchor and cfg.situation_type in ("as_object", "as_object_add_loc")
    n = 5 + prepend
    if cfg.use_attn_flat:
        assert got["obj_tokens"].shape == (2, cfg.attn_flat_out_size)
        assert got["oatt"].shape == (2, n, cfg.attn_flat_glimpses)
    else:
        assert got["obj_tokens"].shape == (2, n, cfg.hidden_size)
    # the first token (the anchor where there is one) is valid; padding stays padding
    assert got["obj_masks"][:, 0].all() and not got["obj_masks"][1, -2:].any()


@pytest.mark.parametrize("name", list(FUSION_ROWS))
def test_spatial_fusion_matches_jax(name):
    _assert_matches(name)


@pytest.mark.parametrize("name", list(PAIRWISE_ROWS))
def test_pairwise_mode_matches_jax(name):
    _assert_matches(name)


def test_anchor_size_takes_no_gradient():
    """JAX feeds the anchor's size through ``stop_gradient``; the port reads
    it detached, so autograd leaves its ``.grad`` at None (the trainer turns
    that into a zero gradient) while ``anchor_feat`` gets one."""
    variables, _ = _jax_run("as_object")
    module = _port(ALL_ROWS["as_object"], variables)
    out = module(**{k: torch.from_numpy(v) for k, v in _inputs().items()})
    out["obj_tokens"].square().sum().backward()
    assert module.anchor_size.grad is None
    assert module.anchor_feat.grad is not None and bool(module.anchor_feat.grad.any())


@pytest.mark.parametrize("situation_type", ["as_embedding", "as_cross_attention",
                                            "as_dit_attention"])
def test_modes_that_need_the_orientation_raise_without_it(situation_type):
    """JAX builds ``orientation_encoder`` only with ``use_orientation`` and
    its situation feature calls it: a NameError there, a ValueError at
    construction here. ``as_embedding`` with ``diff_all`` never builds the
    situation feature, so it runs in both."""
    cfg = _cfg(situation_type, use_orientation=False)
    jin = {k: jnp.asarray(v) for k, v in _inputs().items()}
    with pytest.raises(NameError):
        jax.eval_shape(lambda: JaxOSE3DSituation(cfg).init(jax.random.key(0), **jin))
    with pytest.raises(ValueError, match="use_orientation"):
        OSE3DSituation(torch_prompter_config(cfg))
    if situation_type == "as_embedding":
        ok = dataclasses.replace(cfg, spatial_encoder=dataclasses.replace(
            cfg.spatial_encoder, obj_loc_encoding="diff_all"))
        jax.eval_shape(lambda: JaxOSE3DSituation(ok).init(jax.random.key(0), **jin))
        OSE3DSituation(torch_prompter_config(ok))


def test_cond_fusion_over_the_mlp_geometry_raises():
    cfg = _cfg(pairwise_rel_type="mlp")
    jin = {k: jnp.asarray(v) for k, v in _inputs().items()}
    with pytest.raises(Exception):
        jax.eval_shape(lambda: JaxOSE3DSituation(cfg).init(jax.random.key(0), **jin))
    with pytest.raises(ValueError, match="12"):
        OSE3DSituation(torch_prompter_config(cfg))


def test_network_with_attn_flat_raises_as_jax_fails():
    """``use_attn_flat`` pools the scene into one (B, out) vector: JAX's
    ``MSR3DNetwork`` fails at the scene splice, the port's raises a
    ValueError at construction. The prompter alone runs it (above)."""
    cfg = _cfg("as_object", use_attn_flat=True)
    llm = JaxLlamaConfig.tiny(vocab_size=300, dtype=jnp.float32, lora_rank=4)
    net = JaxMSR3DNetwork(JaxMSR3DNetworkConfig(prompter=cfg, llm=llm,
                                                backbone_name="convnext_test"))
    scene = {k: jnp.asarray(v) for k, v in _inputs().items()}
    ids = jnp.full((2, 12), 7, jnp.int32).at[:, 2:8].set(6)  # six scene placeholders
    ones = jnp.ones((2, 12), jnp.int32)
    with pytest.raises(Exception) as err:
        jax.eval_shape(lambda: net.init(jax.random.key(0), ids, ones, ids, ones, **scene))
    assert not isinstance(err.value, (NameError, AttributeError))
    with pytest.raises(ValueError, match="AttFlat"):
        MSR3DNetwork(torch_network_cfg(cfg, llm))


def torch_network_cfg(prompter, llm):
    from msr3d_tpu_torch.models.msr3d import MSR3DNetworkConfig

    return MSR3DNetworkConfig(prompter=torch_prompter_config(prompter),
                              llm=torch_llama_config(llm), backbone_name="convnext_test")


# ---------------------------------------------------------------------------
# the layers and ops, one by one
# ---------------------------------------------------------------------------


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _pad_mask():
    mask = np.zeros((2, 6), bool)
    mask[1, -2:] = True  # True = pad
    return mask


def _layer_parity(jmod, tmod, jargs, targs, seed=0, outputs=2):
    """Init the flax module on ``jargs``, perturb, load into ``tmod`` and
    compare the first ``outputs`` outputs."""
    variables = perturbed(jax.jit(jmod.init)(jax.random.key(seed), *jargs), seed=seed)
    want = jax.jit(jmod.apply)(variables, *jargs)
    assert load_jax_params(tmod, variables) == []
    tmod.eval()
    with torch.no_grad():
        got = tmod(*targs)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in list(zip(got, want))[:outputs]:
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_multi_head_attention_matches_jax():
    q, kv = _rand(0, 2, 6, 32), _rand(1, 2, 4, 32)
    mask = np.zeros((2, 4), bool)
    mask[0, -1] = True
    _layer_parity(jax_transformers.MultiHeadAttention(32, 4),
                  transformers.MultiHeadAttention(32, 4),
                  (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(mask)),
                  (torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
                   torch.from_numpy(mask)))


@pytest.mark.parametrize("prenorm", [False, True], ids=["postnorm", "prenorm"])
def test_transformer_encoder_layer_matches_jax(prenorm):
    x = _rand(2, 2, 6, 32)
    _layer_parity(
        jax_transformers.TransformerEncoderLayer(32, 4, 64, 0.1, "gelu", prenorm=prenorm),
        transformers.TransformerEncoderLayer(32, 4, 64, 0.1, "gelu", prenorm=prenorm),
        (jnp.asarray(x), jnp.asarray(_pad_mask())),
        (torch.from_numpy(x), torch.from_numpy(_pad_mask())))


@pytest.mark.parametrize("prenorm", [False, True], ids=["postnorm", "prenorm"])
def test_cross_attention_layer_matches_jax(prenorm):
    x, mem = _rand(3, 2, 6, 32), _rand(4, 2, 3, 32)
    mem_mask = np.zeros((2, 3), bool)
    mem_mask[1, 0] = True
    _layer_parity(
        jax_transformers.CrossAttentionLayer(32, 4, 64, 0.1, "relu", prenorm=prenorm),
        transformers.CrossAttentionLayer(32, 4, 64, 0.1, "relu", prenorm=prenorm),
        (jnp.asarray(x), jnp.asarray(mem), jnp.asarray(mem_mask)),
        (torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(mem_mask)))


def test_dit_block_matches_jax():
    x, c = _rand(5, 2, 6, 32), _rand(6, 2, 6, 32)
    _layer_parity(jax_transformers.DiTBlock(32, 4), transformers.DiTBlock(32, 4),
                  (jnp.asarray(x), jnp.asarray(c)), (torch.from_numpy(x), torch.from_numpy(c)),
                  outputs=1)


def test_glu_feed_forward_matches_jax():
    x = _rand(7, 2, 6, 32)
    _layer_parity(jax_transformers.FeedForward(32, 64, 0.1, "glu"),
                  transformers.FeedForward(32, 64, "glu", 0.1),
                  (jnp.asarray(x),), (torch.from_numpy(x),), outputs=1)


@pytest.mark.parametrize("glimpses", [1, 2])
def test_attflat_matches_jax(glimpses):
    x = _rand(8, 2, 6, 32)
    _layer_parity(jax_layers.AttFlat(16, glimpses, 24), layers.AttFlat(32, 16, glimpses, 24),
                  (jnp.asarray(x), jnp.asarray(_pad_mask())),
                  (torch.from_numpy(x), torch.from_numpy(_pad_mask())))


def test_mlp_head_matches_jax():
    x = _rand(9, 2, 6, 32)
    _layer_parity(jax_layers.MLPHead(24, 11, dropout=0.3), layers.MLPHead(32, 24, 11, 0.3),
                  (jnp.asarray(x),), (torch.from_numpy(x),), outputs=1)


def test_obj_color_encoder_matches_jax():
    colors = np.abs(_rand(10, 2, 6, 3, 4))
    _layer_parity(jax_layers.ObjColorEncoder(32), layers.ObjColorEncoder(32),
                  (jnp.asarray(colors),), (torch.from_numpy(colors),), outputs=1)


@pytest.mark.parametrize("name", ["relu", "gelu", "gelu_new", "glu", "silu"])
def test_activations_match_jax(name):
    x = _rand(11, 3, 8)
    np.testing.assert_allclose(layers.get_activation(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_layers.get_activation(name)(jnp.asarray(x))),
                               atol=1e-6)


def test_three_nn_and_interpolate_match_jax():
    """A known point repeated at three indices ties for every query's nearest
    neighbours: the lowest index comes first, as ``lax.top_k`` orders them."""
    known = _rand(12, 2, 9, 3)
    known[:, 6] = known[:, 2]
    known[:, 7] = known[:, 2]
    unknown = _rand(13, 2, 5, 3)
    unknown[:, 0] = known[:, 2] + 1e-3  # its three nearest: 2, 6, 7, all equal
    want_d, want_i = map(np.asarray, jax_pointnet2.three_nn(jnp.asarray(unknown),
                                                             jnp.asarray(known)))
    got_d, got_i = pointnet2.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(want_i[:, 0], [[2, 6, 7], [2, 6, 7]])
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-6)

    feats = _rand(14, 2, 9, 7)
    weight = np.abs(_rand(15, 2, 5, 3))
    want = jax_pointnet2.three_interpolate(jnp.asarray(feats), jnp.asarray(want_i),
                                           jnp.asarray(weight))
    got = pointnet2.three_interpolate(torch.from_numpy(feats), got_i, torch.from_numpy(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("concat_pos, sine_only", [(True, False), (False, False),
                                                   (True, True), (False, True)])
def test_fourier_features_match_jax(concat_pos, sine_only):
    pos = _rand(16, 2, 5, 4)
    want = jax_geometry.generate_fourier_features(jnp.asarray(pos), concat_pos=concat_pos,
                                                  sine_only=sine_only)
    got = geometry.generate_fourier_features(torch.from_numpy(pos), concat_pos=concat_pos,
                                             sine_only=sine_only)
    assert got.shape[-1] == geometry.fourier_feature_dim(4, concat_pos=concat_pos,
                                                         sine_only=sine_only) == want.shape[-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_z_rotation_matrix_matches_jax():
    theta = _rand(17, 3, 2)
    np.testing.assert_allclose(geometry.z_rotation_matrix(torch.from_numpy(theta)).numpy(),
                               np.asarray(jax_geometry.z_rotation_matrix(jnp.asarray(theta))),
                               atol=1e-6)


@pytest.mark.parametrize("rel", ["center", "vertical_bottom", "mlp"])
def test_pairwise_locs_normalise_over_all_pairs_padding_included(rel):
    """The distance normaliser is the max over all N×N pairs, padded objects
    included, in both packages."""
    centers, sizes = _rand(18, 2, 6, 3), np.abs(_rand(19, 2, 6, 3))
    centers[1, -1] = 50.0  # a far padded object sets row 1's maximum
    want = jax_geometry.calc_pairwise_locs(jnp.asarray(centers), jnp.asarray(sizes),
                                           pairwise_rel_type=rel)
    got = geometry.calc_pairwise_locs(torch.from_numpy(centers), torch.from_numpy(sizes),
                                      pairwise_rel_type=rel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if rel != "mlp":
        assert float(got[1, :-1, :-1, 0].max()) < 0.2


def _reference_prompter_name(name: str) -> str:
    """A port prompter parameter → its name in the reference's torch
    modules (``loc_layers.i.{0,1}``, ``spatial_encoder.i``, the FFN's
    ``linear1/2`` on the layer)."""
    name = re.sub(r"^loc_layer\.(\d+)\.dense\.", r"loc_layers.\1.0.", name)
    name = re.sub(r"^loc_layer\.(\d+)\.norm\.", r"loc_layers.\1.1.", name)
    return name.replace("spatial_layer.", "spatial_encoder.").replace(".ffn.linear", ".linear")


def test_scene_encoder_loader_fills_the_as_object_prompter(tmp_path):
    """A reference learnable-only save of a LEO prompter (``anchor_feat``,
    ``anchor_size``, ``orientation_encoder``, ``loc_layers.0``) lands in the
    port's ``as_object`` prompter as JAX's loader puts it into JAX's."""
    variables, _ = _jax_run("as_object")
    prompter = _port(ALL_ROWS["as_object"], variables)
    rng = np.random.default_rng(9)
    sd = {f"module.visual_prompter.{_reference_prompter_name(n)}":
          torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
          for n, t in prompter.state_dict().items() if not n.startswith("obj_encoder.")}
    torch.save(sd, tmp_path / "best.pth")

    jvars = jax_load_weights._tree_to_mutable(jax.tree_util.tree_map(
        np.array, {"params": {"visual_prompter": variables["params"]}}))
    jax_load_weights.load_scene_encoder_weights(jvars, tmp_path / "best.pth")
    network = torch.nn.ModuleDict({"visual_prompter": prompter})
    before = {n: t.clone() for n, t in network.state_dict().items()}
    load_weights.load_scene_encoder_weights(network, tmp_path / "best.pth")
    want, _ = jax_to_torch_state_dict(jvars)
    got = network.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    changed = {n for n in got if not torch.equal(got[n], before[n])}
    for name in ("anchor_feat", "anchor_size", "orientation_encoder.weight",
                 "loc_layer.0.dense.weight", "loc_layer.0.norm.bias",
                 "spatial_layer.1.self_attn.lang_cond_fc.weight"):
        assert f"visual_prompter.{name}" in changed, name
    assert not any(".obj_encoder." in n for n in changed)
