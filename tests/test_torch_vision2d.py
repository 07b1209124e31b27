"""The image encoder of the port (``msr3d_tpu_torch/models/vision2d.py``)
against the JAX package's: ConvNeXt and ``Backbone2D`` in its four poolings,
flax's SAME padding at sizes that are not multiples of the strides, the
timm checkpoint conversion and both packages' loaders.

Inputs and weights come from numpy seeds: the JAX module's own weights,
perturbed with numpy noise (so the layer scale ``gamma`` is far from its
1e-6 start and every block takes part), converted with
``msr3d_tpu_torch.convert``. Both sides compute in fp32; values of order 1
agree to a few ulps, and 1e-5 leaves room for the depth of the network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.models.load_weights import load_convnext_weights as jax_load_convnext_weights
from msr3d_tpu.models.vision2d import CONVNEXT_SPECS as JAX_SPECS
from msr3d_tpu.models.vision2d import Backbone2D as JaxBackbone2D
from msr3d_tpu.models.vision2d import ConvNeXt as JaxConvNeXt
from msr3d_tpu.models.vision2d import convert_convnext_state_dict as jax_convert
from msr3d_tpu_torch.convert import jax_to_torch_state_dict, load_jax_params
from msr3d_tpu_torch.models.load_weights import load_convnext_weights
from msr3d_tpu_torch.models.vision2d import (
    CONVNEXT_SPECS,
    Backbone2D,
    ConvNeXt,
    _same_pads,
    convert_convnext_state_dict,
)

from torch_parity_utils import perturbed

ATOL = 1e-5
DEPTHS, DIMS = CONVNEXT_SPECS["convnext_test"]
# (H, W): 32 is a multiple of every stride; 30 needs SAME padding in the stem
# (1 before, 1 after); 29 and 27 x 45 pad asymmetrically (0/1 or 1/2 in the
# stem, 0/1 in the 2x2 downsampling of odd maps)
SIZES = [(32, 32), (30, 30), (29, 29), (27, 45)]
POOLINGS = ["avg", "conv", "attn", "none"]


def _images(seed, b, h, w):
    return np.random.default_rng(seed).normal(size=(b, h, w, 3)).astype(np.float32)


def _load(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(jax_to_torch_state_dict(variables)[0], strict=True)
    return module.eval()


def test_specs_and_same_pads_match_flax():
    assert CONVNEXT_SPECS == JAX_SPECS
    # flax pads ceil(n/s)·s - n + (k - s) in all, half of it (rounded down) before
    for n, k, s, want in ((224, 4, 4, (0, 0)), (30, 4, 4, (1, 1)), (29, 4, 4, (1, 2)),
                          (27, 4, 4, (0, 1)), (7, 2, 2, (0, 1)), (8, 2, 2, (0, 0))):
        assert _same_pads(n, k, s) == want, (n, k, s)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_convnext_matches_jax(hw):
    images = _images(1, 2, *hw)
    jmod = JaxConvNeXt(DEPTHS, DIMS)
    variables = perturbed(jmod.init(jax.random.key(0), jnp.asarray(images)), seed=2)
    want = np.asarray(jmod.apply(variables, jnp.asarray(images)))
    port = _load(ConvNeXt(DEPTHS, DIMS), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, -(-hw[0] // 32), -(-hw[1] // 32), DIMS[-1])
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_backbone2d_matches_jax(pooling):
    images = _images(3, 3, 32, 32)
    jmod = JaxBackbone2D(backbone_name="convnext_test", pooling=pooling)
    variables = perturbed(jmod.init(jax.random.key(1), jnp.asarray(images)), seed=4)
    want = np.asarray(jmod.apply(variables, jnp.asarray(images)))
    port = _load(Backbone2D("convnext_test", pooling), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    for name in ("convnext_test", "convnext_base"):
        assert (Backbone2D(name, pooling, device="meta").out_channels
                == JaxBackbone2D(backbone_name=name, pooling=pooling).out_channels)


def test_frozen_backbone_keeps_no_graph():
    """``freeze``: the backbone runs without autograd (JAX's stop_gradient),
    the pooling layers after it still do."""
    port = Backbone2D("convnext_test", "attn")
    feats = port(torch.from_numpy(_images(5, 2, 32, 32)))
    feats.sum().backward()
    assert all(p.grad is None for p in port.backbone.parameters())
    assert all(p.grad is not None for n, p in port.named_parameters()
               if n.startswith("attn_conv"))
    thawed = Backbone2D("convnext_test", "avg", freeze=False)
    thawed(torch.from_numpy(_images(5, 2, 32, 32))).sum().backward()
    assert all(p.grad is not None for p in thawed.backbone.parameters())


def _timm_state_dict(seed: int, names: str):
    """A random timm-named ConvNeXt state dict of ``convnext_test``, with the
    ``module.`` prefix of a wrapped model. ``names`` "timm": conv_dw,
    mlp.fc1, mlp.fc2; "alt": dwconv, pwconv1, pwconv2. The convolution
    kernels are asymmetric, so a kh/kw swap shows."""
    r = np.random.default_rng(seed)

    def t(*shape, scale=0.2):
        return torch.from_numpy((r.normal(size=shape) * scale).astype(np.float32))

    dw, fc1, fc2 = {"timm": ("conv_dw", "mlp.fc1", "mlp.fc2"),
                    "alt": ("dwconv", "pwconv1", "pwconv2")}[names]
    sd = {"stem.0.weight": t(DIMS[0], 3, 4, 4), "stem.0.bias": t(DIMS[0]),
          "stem.1.weight": 1 + t(DIMS[0]), "stem.1.bias": t(DIMS[0])}
    for s in range(4):
        if s:
            sd.update({f"stages.{s}.downsample.0.weight": 1 + t(DIMS[s - 1]),
                       f"stages.{s}.downsample.0.bias": t(DIMS[s - 1]),
                       f"stages.{s}.downsample.1.weight": t(DIMS[s], DIMS[s - 1], 2, 2),
                       f"stages.{s}.downsample.1.bias": t(DIMS[s])})
        for blk in range(DEPTHS[s]):
            base, d = f"stages.{s}.blocks.{blk}", DIMS[s]
            sd.update({f"{base}.{dw}.weight": t(d, 1, 7, 7), f"{base}.{dw}.bias": t(d),
                       f"{base}.norm.weight": 1 + t(d), f"{base}.norm.bias": t(d),
                       f"{base}.{fc1}.weight": t(4 * d, d), f"{base}.{fc1}.bias": t(4 * d),
                       f"{base}.{fc2}.weight": t(d, 4 * d), f"{base}.{fc2}.bias": t(d),
                       f"{base}.gamma": t(d, scale=0.5)})
    sd["head.fc.weight"] = t(10, DIMS[-1])  # a classifier head: not the backbone's
    return {f"module.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("names", ["timm", "alt"])
def test_convnext_checkpoint_conversion_and_loaders_match_jax(names, tmp_path):
    sd = _timm_state_dict(7, names)
    stripped = {k.replace("module.", ""): v for k, v in sd.items()}
    tree, want_tree = (convert(stripped, DEPTHS) for convert in (convert_convnext_state_dict,
                                                                  jax_convert))
    flat, want_flat = (jax.tree_util.tree_flatten_with_path(t) for t in (tree, want_tree))
    assert flat[1] == want_flat[1]
    for (path, got), (_, want) in zip(flat[0], want_flat[0]):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))

    path = tmp_path / "convnext.pth"
    torch.save(sd, path)
    images = _images(9, 2, 30, 30)
    jmod = JaxBackbone2D(backbone_name="convnext_test", pooling="avg")
    variables = jax.tree_util.tree_map(np.asarray,
                                       jmod.init(jax.random.key(2), jnp.asarray(images)))
    variables = {"params": {"image_encoder": variables["params"]}}
    jax_load_convnext_weights(variables, path, DEPTHS)
    jvars = {"params": variables["params"]["image_encoder"]}
    want = np.asarray(jmod.apply(jvars, jnp.asarray(images)))

    holder = torch.nn.Module()
    holder.image_encoder = Backbone2D("convnext_test", "avg")
    load_convnext_weights(holder, path, DEPTHS)
    # every loaded tensor equals JAX's loaded tree, converted
    state = jax_to_torch_state_dict(jvars)[0]
    for name, val in holder.image_encoder.state_dict().items():
        torch.testing.assert_close(val, state[name], rtol=0, atol=0, msg=name)
    with torch.no_grad():
        got = holder.image_encoder(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)

    # the same weights through load_jax_params: one network, two routes
    twin = torch.nn.Module()
    twin.image_encoder = Backbone2D("convnext_test", "avg")
    load_jax_params(twin, {"params": variables["params"]})
    for name, val in twin.state_dict().items():
        assert torch.equal(val, holder.state_dict()[name]), name
