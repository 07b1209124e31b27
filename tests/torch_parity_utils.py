"""Shared helpers of the ``test_torch_*`` parity tests: the JAX package and
its PyTorch port (``msr3d_tpu_torch``) fed the same numpy inputs and the
same weights."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from msr3d_tpu.models.ose3d_situation import OSE3DConfig as JaxOSE3DConfig
from msr3d_tpu.models.ose3d_situation import SpatialEncoderConfig as JaxSpatialEncoderConfig
from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig, SpatialEncoderConfig

BEAM_MARGIN = 1e-4
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the tiny prompter of tests/test_msr3d.py, fp32 so the point encoder is
# compared without bf16 rounding
TINY_PROMPTER = JaxOSE3DConfig(
    hidden_size=32,
    spatial_encoder=JaxSpatialEncoderConfig(
        num_attention_heads=4, dim_feedforward=64, dropout=0.0, num_layers=1
    ),
    sa_n_points=(8, 4, None),
    sa_n_samples=(8, 8, None),
    sa_radii=(0.4, 0.8, None),
    sa_mlps=((3, 8, 8, 16), (16, 16, 16, 32), (32, 32, 32, 64)),
    obj_encoder_dtype="float32",
)


def scene_inputs(seed: int, b: int = 2, n_obj: int = 6, n_pts: int = 32):
    """Object clouds, masks (row 1 has two padding objects), locations and
    a unit-quaternion anchor, as numpy."""
    r = np.random.default_rng(seed)
    masks = np.ones((b, n_obj), bool)
    masks[1, -2:] = False
    quat = r.normal(size=(b, 4))
    return {
        "obj_fts": (r.normal(size=(b, n_obj, n_pts, 6)) * 0.3).astype(np.float32),
        "obj_masks": masks,
        "obj_locs": r.normal(size=(b, n_obj, 6)).astype(np.float32),
        "anchor_locs": r.normal(size=(b, 3)).astype(np.float32),
        "anchor_orientation": (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(
            np.float32
        ),
    }


# prompts with image placeholders (图): two in the first, one in the second
IMAGE_PROMPTS = [
    "Look at 图 and 图 in the scene: 景. What is on the table?",
    "Scene 景 here, view 图. Can I go north?",
]


def image_inputs(seed: int, masks, size: int = 32):
    """``msr3d_imgs`` (B, M, size, size, 3) normalized-pixel-like noise and
    ``msr3d_img_masks`` (B, M) from ``masks``, as the dataset wrapper pads
    them (valid images first)."""
    masks = np.asarray(masks, bool)
    r = np.random.default_rng(seed)
    return {
        "msr3d_imgs": r.normal(size=masks.shape + (size, size, 3)).astype(np.float32),
        "msr3d_img_masks": masks,
    }


def torch_prompter_config(cfg: JaxOSE3DConfig) -> OSE3DConfig:
    """The port's prompter config with the JAX config's values (every field
    the port has: ``spatial_encoder.dropout``, ``vision_freeze`` and
    ``vision_dropout`` included)."""
    se = SpatialEncoderConfig(**{
        f.name: getattr(cfg.spatial_encoder, f.name)
        for f in dataclasses.fields(SpatialEncoderConfig)
    })
    return OSE3DConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(OSE3DConfig)
        if f.name != "spatial_encoder"
    }, spatial_encoder=se)


def torch_llama_config(cfg, **overrides):
    """The port's LlamaConfig with a JAX LlamaConfig's values (every field
    the port has, ``lora_dropout`` included)."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(LlamaConfig)
          if f.name not in ("dtype", "param_dtype")}
    kw["dtype"] = _TORCH_DTYPES[np.dtype(cfg.dtype).name]
    kw["param_dtype"] = _TORCH_DTYPES[np.dtype(cfg.param_dtype).name]
    kw.update(overrides)
    return LlamaConfig(**kw)


def torch_network_config(cfg, **llm_overrides):
    """The port's MSR3DNetworkConfig with a JAX MSR3DNetworkConfig's values
    (``answer_window_loss`` and the image encoder's fields included)."""
    from msr3d_tpu_torch.models.msr3d import MSR3DNetworkConfig

    return MSR3DNetworkConfig(
        prompter=torch_prompter_config(cfg.prompter),
        llm=torch_llama_config(cfg.llm, **llm_overrides),
        backbone_name=cfg.backbone_name,
        image_pooling=cfg.image_pooling,
        freeze_image_encoder=cfg.freeze_image_encoder,
        scene_token_id=cfg.scene_token_id,
        img_token_id=cfg.img_token_id,
        answer_window_loss=cfg.answer_window_loss,
    )


def to_numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def perturbed(variables, seed=0, std=0.1):
    """Add N(0, std) noise to every leaf; variances stay positive."""
    r = np.random.default_rng(seed)

    def bump(path, x):
        x = np.asarray(x, np.float32)
        noise = (r.normal(size=x.shape) * std).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return np.abs(x + noise) + 0.5
        return x + noise

    return jax.tree_util.tree_map_with_path(bump, to_numpy_tree(variables))


def assert_beam_generate_matches(jmodel, model, data, new_tokens: int):
    """Beam generate of both packages, ancestry on and off: equal tokens and
    texts, and every top-k boundary the port's beam search decided (k-th
    against (k+1)-th value, live values only) held by BEAM_MARGIN, well
    above the frameworks' fp32 disagreement (1e-5 on the logits), so equal
    tokens are not luck."""
    from msr3d_tpu_torch.models.llm import sampling

    boundaries = []
    top_k = sampling._top_k

    def recording_top_k(x, k):
        values, indices = top_k(x, k)
        if x.shape[-1] > k:
            nxt = torch.sort(x, dim=-1, descending=True, stable=True)[0][..., k]
            live = values[..., -1] > -1e8
            boundaries.append((values[..., -1] - nxt)[live])
        return values, indices

    for ancestry in (True, False):
        jmodel.beam_ancestry = model.beam_ancestry = ancestry
        want = jmodel.generate(dict(data))
        sampling._top_k = recording_top_k
        try:
            got = model.generate(dict(data))  # use_beam=None: num_beams
        finally:
            sampling._top_k = top_k
        assert got["output_tokens"].shape == (2, new_tokens)
        np.testing.assert_array_equal(got["output_tokens"], want["output_tokens"])
        assert got["output_text"] == want["output_text"]
    gaps = torch.cat(boundaries)
    assert len(boundaries) > 3 * new_tokens and float(gaps.min()) > BEAM_MARGIN, float(gaps.min())
