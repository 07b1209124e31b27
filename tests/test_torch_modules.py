"""Parity of the port's modules with the JAX package: the point encoder,
the scene prompter and a Llama prefill plus decode step.

Weights are the JAX modules' own, perturbed with numpy noise (so BatchNorm
statistics, norm scales and LoRA B are not at their trivial initial
values) and converted with ``msr3d_tpu_torch.convert``. fp32 outputs agree
within 1e-5 (relative to the output's scale where it exceeds 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.models.llm.llama import _make_cache as jax_make_cache
from msr3d_tpu.models.ose3d_situation import OSE3DSituation as JaxOSE3DSituation
from msr3d_tpu.nn.pointnet import PcdObjEncoder as JaxPcdObjEncoder
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaModel, _make_cache
from msr3d_tpu_torch.models.ose3d_situation import OSE3DSituation
from msr3d_tpu_torch.nn.pointnet import PcdObjEncoder

from torch_parity_utils import (
    TINY_PROMPTER,
    perturbed,
    scene_inputs,
    torch_llama_config,
    torch_prompter_config,
)

ATOL = 1e-5


def load(module, variables):
    """Convert and load strictly: no JAX key is skipped."""
    state, skipped = jax_to_torch_state_dict(variables)
    assert skipped == []
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 3e-2)])
def test_pcd_obj_encoder_matches_jax(dtype, atol):
    """bf16: both frameworks round each Dense/BN output to bf16 (8-bit
    mantissa) but accumulate in other orders, so a few elements land one
    bf16 ulp apart and the fp32 fc carries that: atol 3e-2 on outputs of
    magnitude ~1."""
    cfg = TINY_PROMPTER
    pcds = scene_inputs(0)["obj_fts"]
    jmod = JaxPcdObjEncoder(
        sa_n_points=cfg.sa_n_points, sa_n_samples=cfg.sa_n_samples, sa_radii=cfg.sa_radii,
        sa_mlps=cfg.sa_mlps, compute_dtype=jnp.dtype(dtype),
    )
    variables = perturbed(jmod.init(jax.random.key(0), jnp.asarray(pcds)))
    want, want_sem = map(np.asarray, jmod.apply(variables, jnp.asarray(pcds)))
    tmod = load(
        PcdObjEncoder(cfg.sa_n_points, cfg.sa_n_samples, cfg.sa_radii, cfg.sa_mlps,
                      compute_dtype=getattr(torch, dtype)),
        variables,
    )
    with torch.no_grad():
        got = tmod(torch.from_numpy(pcds)).numpy()
        got_embeds, got_sem = tmod(torch.from_numpy(pcds), return_sem=True)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_array_equal(got_embeds.numpy(), got)
    # the semantic head (607 classes) on the embeddings: the fp32 head adds
    # a few ulps of its own to what the embeddings carry
    assert got_sem.shape == want_sem.shape == want.shape[:2] + (607,)
    np.testing.assert_allclose(got_sem.numpy(), want_sem, atol=atol, rtol=atol)


def test_ose3d_situation_matches_jax():
    cfg = TINY_PROMPTER
    inputs = scene_inputs(1)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jmod = JaxOSE3DSituation(cfg)
    variables = perturbed(jmod.init(jax.random.key(1), **jin), seed=1)
    want = jmod.apply(variables, **jin)
    tmod = load(OSE3DSituation(torch_prompter_config(cfg)), variables)
    with torch.no_grad():
        got = tmod(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got["obj_tokens"].numpy(), np.asarray(want["obj_tokens"]),
                               atol=ATOL)
    np.testing.assert_array_equal(got["obj_masks"].numpy(), np.asarray(want["obj_masks"]))


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_llama_prefill_and_decode_step_match_jax(flash):
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4, num_key_value_heads=2,
                               flash_attention=flash)
    b, t, new = 2, 11, 3
    r = np.random.default_rng(2)
    embeds = (r.normal(size=(b, t, jcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, :4] = 0  # left padding
    jmod = JaxLlamaModel(jcfg)
    variables = jmod.init(  # through embed_tokens too, so the table exists
        jax.random.key(2), jnp.asarray(embeds), jnp.asarray(mask),
        method=lambda m, e, a: (m.embed_tokens(jnp.zeros((1, 1), jnp.int32)), m(e, a)),
    )
    variables = perturbed(variables, seed=2, std=0.02)
    logits, _, caches, cache_mask, next_pos = jmod.apply(
        variables, jnp.asarray(embeds), jnp.asarray(mask), t,
        method=JaxLlamaModel.prefill_with_cache,
    )
    tmod = load(LlamaModel(torch_llama_config(jcfg)), variables)
    with torch.no_grad():
        t_logits, _, t_caches, t_cache_mask, t_next = tmod.prefill_with_cache(
            torch.from_numpy(embeds), torch.from_numpy(mask), t
        )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(t_caches[key].numpy(), np.asarray(caches[key]), atol=ATOL)
    np.testing.assert_array_equal(t_cache_mask.numpy(), np.asarray(cache_mask))
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(next_pos))

    # one decode token over the split cache, written at slot 0 of the
    # generated segment
    tok = (r.normal(size=(b, 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
    gen_mask = np.zeros((b, new), bool)
    gen_mask[:, 0] = True
    pos = np.array(next_pos)[:, None]
    j_logits, j_gen = jmod.apply(
        variables, jnp.asarray(tok), jnp.asarray(pos), caches, cache_mask,
        jax_make_cache(jcfg, b, new), 0, jnp.asarray(gen_mask),
        method=JaxLlamaModel.decode_step_shared,
    )
    t_gen = _make_cache(tmod.cfg, b, new, "cpu")
    with torch.no_grad():
        got = tmod.decode_step_shared(
            torch.from_numpy(tok), torch.from_numpy(pos), t_caches, t_cache_mask, t_gen, 0,
            torch.from_numpy(gen_mask),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(j_logits), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(t_gen[key].numpy(), np.asarray(j_gen[key]), atol=ATOL)


def test_converter_lists_skipped_keys_and_rejects_unknown():
    """Nothing is skipped: the semantic head and the anchor parameters
    convert like every other key."""
    variables = {
        "params": {
            "visual_prompter": {"obj_encoder": {"sem_head": {"fc1": {"kernel": np.ones((2, 3))}}},
                                "anchor_feat": np.ones((1, 1, 3), np.float32),
                                "anchor_size": np.ones((1, 1, 3), np.float32)},
            "llm_proj": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                         "bias": np.zeros(3, np.float32)},
        },
        "batch_stats": {"sa_0": {"mlp": {"bn_1": {"mean": np.zeros(4, np.float32)}}}},
    }
    state, skipped = jax_to_torch_state_dict(variables)
    assert skipped == []
    assert sorted(state) == ["llm_proj.bias", "llm_proj.weight", "sa.0.mlp.bn.1.running_mean",
                             "visual_prompter.anchor_feat", "visual_prompter.anchor_size",
                             "visual_prompter.obj_encoder.sem_head.fc1.weight"]
    assert state["visual_prompter.obj_encoder.sem_head.fc1.weight"].shape == (3, 2)
    assert state["visual_prompter.anchor_size"].shape == (1, 1, 3)
    assert state["llm_proj.weight"].shape == (3, 2)  # (in, out) → (out, in)
    assert torch.equal(state["llm_proj.weight"], torch.arange(6.0).reshape(2, 3).T)
    with pytest.raises(KeyError):
        jax_to_torch_state_dict({"params": {"x": {"mystery": np.zeros(2)}}})
    with pytest.raises(KeyError):
        jax_to_torch_state_dict({"cache": {"x": {"kernel": np.zeros((2, 2))}}})


def test_unported_llama_options_raise():
    # sp is ported (tests/test_torch_sp.py): where JAX's config names the
    # mesh axis (sp_axis), the port's holds the ring's size and this rank's
    # block, which the build sets from the mesh; pp x sp raises as JAX's
    # pipeline asserts
    cfg = torch_llama_config(JaxLlamaConfig.tiny(sp_axis="sp"), sp_size=4, sp_rank=3)
    assert (cfg.sp_size, cfg.sp_rank) == (4, 3)
    with pytest.raises(ValueError, match="sp_rank"):
        torch_llama_config(JaxLlamaConfig.tiny(), sp_size=2, sp_rank=2)
    with pytest.raises(NotImplementedError, match="pp × sp"):
        torch_llama_config(JaxLlamaConfig.tiny(), sp_size=2, pp_size=2)
    # remat is ported (tests/test_torch_remat.py): its policy is carried over,
    # and what JAX cannot run raises
    cfg = torch_llama_config(JaxLlamaConfig.tiny(remat=True, remat_policy="dots"))
    assert (cfg.remat, cfg.remat_policy) == (True, "dots")
    with pytest.raises(ValueError, match="remat_policy"):
        torch_llama_config(JaxLlamaConfig.tiny(), remat_policy="bogus")
    with pytest.raises(ValueError, match="lora_dropout"):
        torch_llama_config(JaxLlamaConfig.tiny(lora_rank=4, lora_dropout=0.1), remat=True)
    # the quantization options are ported, and carried over field by field
    cfg = torch_llama_config(JaxLlamaConfig.tiny(quantize=True, quantize_bits=4,
                                                 kv_quantize=True))
    assert (cfg.quantize, cfg.quantize_bits, cfg.quantize_group, cfg.kv_quantize) == (
        True, 4, None, True)
    # every situation mode is ported: as_object builds (its parity with JAX:
    # tests/test_torch_situation.py); what JAX cannot run raises
    prompter = torch_prompter_config(TINY_PROMPTER)
    leo = OSE3DSituation(dataclasses.replace(prompter, situation_type="as_object"))
    assert leo.prepend_anchor and leo.anchor_size.shape == (1, 1, 3)
    with pytest.raises(ValueError, match="use_orientation"):
        OSE3DSituation(dataclasses.replace(prompter, situation_type="as_cross_attention",
                                           use_orientation=False))
