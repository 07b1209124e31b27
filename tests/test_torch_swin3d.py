"""Parity of the port's sparse-voxel Swin3D (``msr3d_tpu_torch/nn/swin3d.py``)
with the JAX package: the host plans bit-equal array by array (through the
native library in both packages, and once more with both on numpy), the
cRSE table indices equal, window attention against JAX and against the
numpy oracle of ``tests/test_swin3d.py``, each block, the UNet at both
stems (the transformer stem with ``up_attn``), the registry's encoder with
``keep`` equal, and one training-mode step: outputs, every gradient and the
BatchNorm running statistics.

Small widths (channels 16/24/32, 2 heads, 3 layers of depth 1) over 120
random voxels in two batches. The JAX trees come from ``jax.eval_shape`` of
the modules' init filled with numpy noise (``perturbed``), and the JAX side
runs jitted: at these sizes its compile costs less than eager dispatch.
Tolerances: fp32 outputs within atol 1e-5 relative to the output's scale
above 1 (the port reorders the cRSE sums, see the module's docstring);
gradients within 1e-4 of each tensor's norm; running statistics within
1e-6.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msr3d_tpu.nn.build as jax_build  # noqa: F401 (registers the JAX adapter)
import msr3d_tpu.nn.swin3d as J
import msr3d_tpu.ops.host_geometry as jax_hg
from msr3d_tpu.config import config_from_dict as jax_config_from_dict
from msr3d_tpu.registry import VISION_REGISTRY as JAX_VISION_REGISTRY
from msr3d_tpu_torch import registry
from msr3d_tpu_torch.config import config_from_dict
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.nn import build as port_build  # noqa: F401 (registers the adapter)
from msr3d_tpu_torch.nn import swin3d as P
from msr3d_tpu_torch.ops import host_geometry as port_hg

from test_swin3d import _oracle_window_attention, _scene
from torch_parity_utils import perturbed

N, GRID = 120, 12
CH, HEADS, WS, QUANT = (16, 24, 32), (2, 2, 2), (3, 3, 3), 2
ATOL, GRAD_NORM_RTOL, STAT_ATOL = 1e-5, 1e-4, 1e-6


def scene(seed=0, lattice=False):
    coords, coords_f = _scene(np.random.default_rng(seed), n=N, grid=GRID)
    if lattice:  # offsets on the quant grid: relative coordinates fall on integers
        frac = np.random.default_rng(seed + 1).integers(0, 2, (N, 3)) / 2
        coords_f[:, 1:4] = coords[:, 1:] + frac.astype(np.float32)
        coords_f[:, 4:7] = np.round(coords_f[:, 4:7] * 4) / 4
    return coords, coords_f


def plan_kw(stem):
    return dict(window_sizes=list(WS), quant_size=QUANT, num_layers=3, stem_transformer=stem)


def unet_kw(stem):
    return dict(depths=(1, 1, 1), channels=CH, num_heads=HEADS, window_sizes=WS,
                quant_size=QUANT, num_layers=3, num_classes=13, stem_transformer=stem,
                up_attn=stem)


def tree_like(shapes, seed):
    """A variables tree of ``shapes`` (from ``jax.eval_shape``): ones for
    scales and variances, zeros else, plus numpy noise."""
    def base(path, s):
        last = jax.tree_util.keystr(path)
        one = last.endswith("['scale']") or last.endswith("['var']")
        return (np.ones if one else np.zeros)(s.shape, np.float32)
    return perturbed(jax.tree_util.tree_map_with_path(base, shapes), seed)


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


def load(module, variables):
    state, skipped = jax_to_torch_state_dict(variables)
    assert skipped == []
    module.load_state_dict(state, strict=True)
    return module.eval()


@functools.lru_cache(maxsize=None)
def unet_case(stem):
    """(JAX module, variables, numpy plans, torch plans, feats) of one stem."""
    coords, coords_f = scene()
    plans = J.build_swin3d_plans(coords, coords_f, **plan_kw(stem))
    feats = np.random.default_rng(5).normal(size=(N, 6)).astype(np.float32)
    jmod = J.Swin3DUNet(**unet_kw(stem))
    jplans = jax.tree_util.tree_map(jnp.asarray, plans)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(feats), jplans)
    return jmod, tree_like(shapes, 3 if stem else 4), plans, P.plans_to_torch(plans, "cpu"), feats


# ---------------------------------------------------------------------------
# host plans


def leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_plans_bit_equal_to_jax(path):
    """Windows, shifted windows, conv neighbours, pool groups and their
    representatives, kNN and up weights of both stems, array by array;
    the native path in both packages, then numpy in both."""
    coords, coords_f = scene(1)
    with contextlib.ExitStack() as stack:
        if path == "native":
            assert jax_hg.get_lib() is not None and port_hg.native_loaded()
        else:
            stack.enter_context(mock.patch.object(jax_hg, "get_lib", lambda: None))
            stack.enter_context(mock.patch.object(port_hg, "get_lib", lambda: None))
        for stem in (False, True):
            leaves_equal(P.build_swin3d_plans(coords, coords_f, **plan_kw(stem)),
                         J.build_swin3d_plans(coords, coords_f, **plan_kw(stem)))
        for args in ((coords, 1, 3, 0), (coords, 1, 3, 1), (coords, 2, 4, 2)):
            leaves_equal(P._window_partition(*args), J._window_partition(*args))
        for stride in (1, 2):
            np.testing.assert_array_equal(P._conv_neighbor_plan(coords, stride),
                                          J._conv_neighbor_plan(coords, stride))
        for factor in (2, 3):
            leaves_equal(P._pool_groups(coords, 1, factor), J._pool_groups(coords, 1, factor))


@pytest.mark.parametrize("lattice", [False, True])
def test_crse_indices_equal_to_jax(lattice):
    """The (query, key) table rows, formed as JAX forms them: on a lattice
    scene every relative coordinate lies on an integer, where another order
    or precision would flip the floor."""
    coords, coords_f = scene(2, lattice)
    plan = J._stage_window_plans(coords, coords_f, 1, 3, QUANT)["win"]

    @jax.jit
    def jax_indices(n_coords, windows):
        nc = J._masked_gather(n_coords, windows)
        rel = nc[:, :, None, :] - nc[:, None, :, :]
        return [jnp.clip(jnp.floor(rel[..., sl] + length), 0, 2 * length - 1).astype(jnp.int32)
                for length, sl in ((3 * QUANT, slice(0, 3)), (4 * QUANT, slice(3, 6)))]

    want = jax_indices(jnp.asarray(plan["n_coords"]), jnp.asarray(plan["windows"]))
    got = P.crse_indices(P.plans_to_torch(plan, "cpu"), 3, QUANT)
    if lattice:
        nc = plan["n_coords"][plan["windows"][plan["mask"]]]
        assert np.array_equal(nc[:, :3], np.round(nc[:, :3]))
    for name, w in zip(("xyz", "rgb"), want):
        np.testing.assert_array_equal(got[name].permute(1, 2, 3, 0).numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# window attention and the blocks


def test_window_attention_matches_jax_and_the_oracle():
    """Outputs against JAX and the numpy oracle (rtol 2e-4 / atol 2e-5, as
    tests/test_swin3d.py holds JAX's), and the gradients of sum(out²) with
    respect to every parameter (the tables included) and the input."""
    dim, heads, ws, quant = 16, 2, 4, 2
    rng = np.random.default_rng(42)
    coords, coords_f = _scene(rng, n=40, grid=8)
    plan = J._stage_window_plans(coords, coords_f, 1, ws, quant)["win"]
    feats = rng.normal(size=(40, dim)).astype(np.float32)
    jmod = J.WindowAttentionCRSE(dim, ws, quant, heads)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    v = perturbed(jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(feats), jplan), 6, 0.05)
    want = jax.jit(jmod.apply)(v, jnp.asarray(feats), jplan)
    tmod = load(P.WindowAttentionCRSE(dim, ws, quant, heads), v)
    x = torch.from_numpy(feats).requires_grad_()
    got = tmod(x, P.plans_to_torch(plan, "cpu"))
    close(got, want)
    np.testing.assert_allclose(got.detach().numpy(),
                               _oracle_window_attention(feats, v, plan, dim, heads, ws, quant),
                               rtol=2e-4, atol=2e-5)
    (got ** 2).sum().backward()
    gp, gx = jax.jit(jax.grad(lambda p, f: jnp.sum(jmod.apply(p, f, jplan) ** 2),
                              argnums=(0, 1)))(v, jnp.asarray(feats))
    grads_close(dict(tmod.named_parameters()), gp)
    close(x.grad, gx, atol=GRAD_NORM_RTOL)


def grads_close(named, jax_grads, shift_invariant=()):
    """Each port gradient within GRAD_NORM_RTOL of the JAX gradient's norm.
    The ``shift_invariant`` tensors move every row of the classifier's input
    alike, which the training BatchNorm's batch mean takes out again: their
    gradient is 0 in exact arithmetic and fp32 leaves what the cancellation
    rounds, so they are held within GRAD_NORM_RTOL of the largest gradient's
    norm instead."""
    want, _ = jax_to_torch_state_dict(jax_grads)
    assert sorted(want) == sorted(named)
    largest = max(np.linalg.norm(w.numpy()) for w in want.values())
    for name, p in named.items():
        w = want[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - w)
        ref = largest if name in shift_invariant else max(np.linalg.norm(w), 1e-6)
        assert err <= GRAD_NORM_RTOL * ref, (name, err)


BLOCKS = ["swin_block", "downsample", "upsample_attn", "conv_bn_relu", "res_block"]


@pytest.mark.parametrize("which", BLOCKS)
def test_block_matches_jax(which):
    """Each block of the UNet on the transformer stem's plans at stage 0
    (the sparse convolutions on the stem's neighbour plan, the
    BatchNorms in eval and in train mode)."""
    _, _, plans, tplans, _ = unet_case(True)
    rng = np.random.default_rng(BLOCKS.index(which))
    st, tst = plans["stages"][0], tplans["stages"][0]
    c0, c1 = CH[0], CH[1]
    x0 = rng.normal(size=(N, c0)).astype(np.float32)
    if which == "swin_block":
        jmod = J.SwinTransformerBlock3D(c0, 2, WS[0], QUANT)
        tmod = P.SwinTransformerBlock3D(c0, 2, WS[0], QUANT)
        feats, args, targs = [x0], [st["win_shift"]], [tst["win_shift"]]
    elif which == "downsample":
        jmod, tmod = J.GridKNNDownsample(c1), P.GridKNNDownsample(c0, c1)
        feats, args, targs = [x0], [st["down"]["knn"]], [tst["down"]["knn"]]
    elif which == "upsample_attn":
        jmod = J.Upsample3D(c0, num_heads=2, window_size=WS[0], quant_size=QUANT, attn=True)
        tmod = P.Upsample3D(c1, c0, c0, num_heads=2, window_size=WS[0], quant_size=QUANT,
                            attn=True)
        m = plans["stages"][1]["win"]["n_coords"].shape[0]
        feats = [rng.normal(size=(m, c1)).astype(np.float32), x0]
        args, targs = [plans["ups"][-1], st["win"]], [tplans["ups"][-1], tst["win"]]
    elif which == "conv_bn_relu":
        jmod, tmod = J.SparseConvBNRelu(c0), P.SparseConvBNRelu(6, c0)
        feats = [rng.normal(size=(N, 6)).astype(np.float32)]
        args, targs = [plans["stem_conv"]], [tplans["stem_conv"]]
    else:
        jmod, tmod = J.SparseResBlock(c0), P.SparseResBlock(c0)
        feats, args, targs = [x0], [plans["stem_conv"]], [tplans["stem_conv"]]
    args = feats + args
    feats = [torch.from_numpy(f) for f in feats]
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    v = tree_like(jax.eval_shape(jmod.init, jax.random.key(0), *jargs), 10)
    tmod = load(tmod, v)
    close(tmod(*feats, *targs), jax.jit(jmod.apply)(v, *jargs))
    if which in ("conv_bn_relu", "res_block"):  # training BatchNorm: output and running stats
        want, upd = jax.jit(functools.partial(jmod.apply, train=True, mutable=["batch_stats"]))(
            v, *jargs)
        close(tmod(*feats, *targs, train=True), want)
        stats, _ = jax_to_torch_state_dict({"batch_stats": upd["batch_stats"]})
        for name, val in stats.items():
            close(tmod.state_dict()[name], val, atol=STAT_ATOL)


# ---------------------------------------------------------------------------
# the UNet and the encoder


@pytest.mark.parametrize("stem", [False, True], ids=["conv_stem", "transformer_stem_up_attn"])
def test_unet_matches_jax(stem):
    jmod, v, plans, tplans, feats = unet_case(stem)
    want_f, want_l = jax.jit(jmod.apply)(v, jnp.asarray(feats),
                                         jax.tree_util.tree_map(jnp.asarray, plans))
    tmod = load(P.Swin3DUNet(**unet_kw(stem)), v)
    got_f, got_l = tmod(torch.from_numpy(feats), tplans)
    assert got_f.shape == (N, CH[0]) and got_l.shape == (N, 13)
    close(got_f, want_f)
    close(got_l, want_l)


@pytest.mark.parametrize("stem", [False, True], ids=["conv_stem", "transformer_stem_up_attn"])
def test_unet_train_step_matches_jax(stem):
    """One training-mode forward and backward of sum(logits²): outputs,
    every gradient, and the running statistics the step leaves (the conv
    stem has all three BatchNorm kinds: stem, residual block, classifier).
    JAX's side is a ``jax.vjp`` of the jitted forward."""
    jmod, v, plans, tplans, feats = unet_case(stem)
    jplans = jax.tree_util.tree_map(jnp.asarray, plans)
    fwd = jax.jit(lambda p: jmod.apply({**v, "params": p}, jnp.asarray(feats), jplans,
                                       train=True, mutable=["batch_stats"]))
    (want_f, want_l), vjp, upd = jax.vjp(fwd, v["params"], has_aux=True)
    (gp,) = vjp((jnp.zeros_like(want_f), 2 * want_l))
    tmod = load(P.Swin3DUNet(**unet_kw(stem)), v).train()
    got_f, got_l = tmod(torch.from_numpy(feats), tplans, train=True)
    close(got_f, want_f)
    close(got_l, want_l)
    (got_l ** 2).sum().backward()
    # the biases that shift every row before the classifier's BatchNorm:
    # cls_fc1's, and those added last into the last upsample's output (its
    # two branches' with the conv stem, its Swin block's residual branches'
    # with up_attn)
    last = (("block.attn.proj", "block.mlp.fc2") if stem
            else ("ln1", "ln2", "linear1", "linear2"))
    shift = ["cls_fc1.bias"] + [f"upsamples.1.{m}.bias" for m in last]
    grads_close(dict(tmod.named_parameters()), {"params": gp}, shift)
    stats, _ = jax_to_torch_state_dict({"batch_stats": upd["batch_stats"]})
    assert stats
    for name, val in stats.items():
        close(tmod.state_dict()[name], val, atol=STAT_ATOL)


def test_encoder_through_the_registry():
    """The YAML adapter of both packages on one config (conv stem, the
    adapter's default): the same voxels kept, the same signal and plans,
    and the same features and logits."""
    cfg = dict(name="PCDSwin3DEncoder",
               args=dict(depths=[1, 1, 1], channels=list(CH), num_heads=list(HEADS),
                         window_sizes=list(WS), up_k=2, quant_size=QUANT, num_layers=3,
                         num_classes=5))
    jenc = JAX_VISION_REGISTRY.get("PCDSwin3DEncoder")(jax_config_from_dict(cfg))
    tenc = registry.build_module("vision", config_from_dict(cfg), device="cpu")
    assert isinstance(tenc, P.PCDSwin3DEncoder) and not tenc.unet.stem_transformer
    rng = np.random.default_rng(9)
    n = 200  # a voxel holds several points: prepare keeps the first of each
    xyz = np.concatenate([rng.uniform(0, 8, (n, 3)),
                          np.repeat([[0.0], [1.0]], n // 2, axis=0)], axis=1).astype(np.float32)
    colors = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    sig_j, plans_j, keep_j = jenc.prepare(colors, xyz)
    sig_t, plans_t, keep_t = tenc.prepare(colors, xyz)
    assert len(keep_t) < n
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(sig_t, sig_j)
    leaves_equal(plans_t, plans_j)
    shapes = jax.eval_shape(jenc.unet.init, jax.random.key(0), jnp.asarray(sig_j),
                            jax.tree_util.tree_map(jnp.asarray, plans_j))
    v = tree_like(shapes, 11)
    want_f, want_l, keep = jenc(v, colors, xyz)
    load(tenc.unet, v)
    got_f, got_l, keep2 = tenc(colors, xyz)
    np.testing.assert_array_equal(keep2, keep)
    close(got_f, want_f)
    close(got_l, want_l)
