"""Beam search of the port against the JAX package's: ``lax.top_k``'s order
of equal values, ``beam_search_decode_shared`` on a synthetic decode step
(exact ties, EOS, penalty 3.0, a length penalty and an EOS bias), the beam
decode steps of ``LlamaModel`` over the compute-dtype and the int8 KV cache
(the prompt shared by the beams, the generated segment read directly or
through a random ancestry map), and beam-5 ``MSR3D.generate`` with images,
ancestry on and off, over both caches: the whole slice.

Inputs and weights come from numpy seeds; weights are the JAX modules' own,
perturbed with numpy noise and converted with ``msr3d_tpu_torch.convert``.
Everything is fp32. Logits agree at 1e-5 (fp32 sums in other orders);
tokens are equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.models.llm.llama import _quantize_kv as jax_quantize_kv
from msr3d_tpu.models.llm.sampling import _expand_cache as jax_expand_cache
from msr3d_tpu.models.llm.sampling import beam_search_decode_shared as jax_beam_search
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaModel
from msr3d_tpu_torch.models.llm.sampling import _expand_cache, _top_k, beam_search_decode_shared
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.msr3d import MSR3D

from torch_parity_utils import (
    IMAGE_PROMPTS,
    TINY_PROMPTER,
    assert_beam_generate_matches,
    image_inputs,
    perturbed,
    scene_inputs,
    to_numpy_tree,
    torch_llama_config,
    torch_network_config,
)

ATOL = 1e-5


def test_top_k_orders_equal_values_as_lax_top_k():
    r = np.random.default_rng(0)
    x = r.integers(-3, 3, size=(4, 40)).astype(np.float32)
    x[1] = -1e9  # a row of dead scores: every entry ties
    x[2, ::3] = -1e9 + r.normal(size=14).astype(np.float32)  # rounds to -1e9 in fp32
    for k in (1, 5, 10, 40):
        values, indices = _top_k(torch.from_numpy(x), k)
        want_values, want_indices = lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))
        np.testing.assert_array_equal(indices.numpy(), np.asarray(want_indices))


def test_expand_cache_matches_jax():
    x = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    np.testing.assert_array_equal(_expand_cache(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jax_expand_cache(jnp.asarray(x), 3)))


# ---------------------------------------------------------------------------
# beam_search_decode_shared on a synthetic decode step
# ---------------------------------------------------------------------------

B, K, V, NEW, EOS, HASH = 3, 4, 16, 9, 2, 97


def _synthetic_tables(seed):
    """Logits T[h] for a hash h of the history each query sees: multiples of
    1/2 in [-4, 4] with two pairs of equal columns (exact ties in every row)
    and a raised EOS column; first-token logits with ties, EOS included."""
    r = np.random.default_rng(seed)
    table = r.integers(-8, 9, size=(HASH, V)).astype(np.float32) / 2
    table[:, 7] = table[:, 5]
    table[:, 11] = table[:, EOS]
    table[:, EOS] += 1.0
    first = r.integers(-4, 5, size=(B, V)).astype(np.float32) / 2
    first[:, 3] = first[:, 9]
    first[0, EOS] = first[0].max()  # EOS ties for the first place in row 0
    mult = r.integers(1, HASH, size=NEW)
    return table, first, mult


def _jax_steps(table, mult):
    table, mult = jnp.asarray(table), jnp.asarray(mult)

    def logits(hist, mask):
        h = jnp.sum(jnp.where(mask, (hist + 1) * mult[None, :], 0), axis=1) % HASH
        return table[h][:, None, :]

    def write(cache, tok, gidx):
        return cache["k"].at[0, :, gidx, 0, 0].set(tok[:, 0].astype(jnp.float32))

    def step(tok, pos, cache, gidx, gmask):
        c = write(cache, tok, gidx)
        return logits(c[0, :, :, 0, 0].astype(jnp.int32), gmask), {"k": c}

    def step_anc(tok, pos, cache, gidx, gmask, anc):
        c = write(cache, tok, gidx)
        rows = (jnp.arange(B * K) // K * K)[:, None] + anc
        hist = c[0, rows, jnp.arange(NEW)[None, :], 0, 0].astype(jnp.int32)
        return logits(hist, gmask), {"k": c}

    return step, step_anc


def _torch_steps(table, mult):
    table, mult = torch.from_numpy(table), torch.from_numpy(mult)

    def logits(hist, mask):
        h = torch.where(mask, (hist + 1) * mult[None, :], 0).sum(dim=1) % HASH
        return table[h][:, None, :]

    def step(tok, pos, cache, gidx, gmask):
        cache["k"][0, :, gidx, 0, 0] = tok[:, 0].float()
        return logits(cache["k"][0, :, :, 0, 0].long(), gmask)

    def step_anc(tok, pos, cache, gidx, gmask, anc):
        cache["k"][0, :, gidx, 0, 0] = tok[:, 0].float()
        rows = (torch.arange(B * K) // K * K)[:, None] + anc
        hist = cache["k"][0, rows, torch.arange(NEW)[None, :], 0, 0].long()
        return logits(hist, gmask)

    return step, step_anc


@pytest.mark.parametrize("length_penalty,eos_bias", [(1.3, 0.75), (0.7, -0.5)],
                         ids=["lp1.3-bias0.75", "lp0.7-bias-0.5"])
@pytest.mark.parametrize("ancestry", [True, False], ids=["ancestry", "reorder"])
def test_beam_search_on_a_synthetic_step_matches_jax(ancestry, length_penalty, eos_bias):
    table, first, mult = _synthetic_tables(5)
    kw = dict(num_beams=K, max_new_tokens=NEW, eos_id=EOS, pad_id=EOS, min_length=1,
              repetition_penalty=3.0, length_penalty=length_penalty, eos_logit_bias=eos_bias)
    positions = np.array([5, 7, 6])
    j_step, j_anc = _jax_steps(table, mult)
    want = np.asarray(jax_beam_search(
        j_step, jnp.asarray(positions), jnp.asarray(first),
        {"k": jnp.zeros((1, B * K, NEW, 1, 1), jnp.float32)},
        decode_step_anc=j_anc if ancestry else None, **kw))
    t_step, t_anc = _torch_steps(table, mult)
    got = beam_search_decode_shared(
        t_step, torch.from_numpy(positions), torch.from_numpy(first),
        {"k": torch.zeros((1, B * K, NEW, 1, 1))},
        decode_step_anc=t_anc if ancestry else None, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    # the case reaches what it is for: a finished hypothesis (EOS before the
    # end) wins in some row
    assert any(EOS in row[:-1] for row in got), got


# ---------------------------------------------------------------------------
# The beam decode steps of LlamaModel
# ---------------------------------------------------------------------------


def _gen_cache(jcfg, bk, s_g, seed):
    """A generated segment (L, B·K, S_g, hkv, D) of random k/v, int8 with
    scales when ``kv_quantize``; the JAX arrays and the port's tensors."""
    r = np.random.default_rng(seed)
    shape = (jcfg.num_hidden_layers, bk, s_g, jcfg.kv_heads, jcfg.head_dim)
    cache = {key: jnp.asarray(r.normal(size=shape).astype(np.float32) * 0.5)
             for key in ("k", "v")}
    if jcfg.kv_quantize:
        kq, ks = jax_quantize_kv(cache["k"])
        vq, vs = jax_quantize_kv(cache["v"])
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    ported = {key: torch.from_numpy(np.array(val.astype(jnp.float32) if "scale" in key
                                             else val)) for key, val in cache.items()}
    for key in ported:
        if "scale" in key:
            ported[key] = ported[key].to(torch.bfloat16)
    return cache, ported


@pytest.mark.parametrize("kv_quantize", [False, True], ids=["fp32-cache", "int8-cache"])
def test_beam_decode_steps_match_jax(kv_quantize):
    """Prompt at batch B = 2 shared by K = 3 beams, GQA (hkv 2), LoRA, a
    generated segment with 3 filled slots and the 4th written now, a random
    ancestry map; logits within 1e-5, the step's writes exactly equal."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4, num_key_value_heads=2,
                               kv_quantize=kv_quantize, flash_attention=True)
    b, k, t, s_g, gidx = 2, 3, 11, 6, 3
    bk = b * k
    r = np.random.default_rng(21)
    embeds = (r.normal(size=(b, t, jcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, :4] = 0
    jmod = JaxLlamaModel(jcfg)
    # jitted: one compile a method (eager flax applies compile op by op)
    variables = perturbed(jax.jit(lambda e, a: jmod.init(
        jax.random.key(3), e, a,
        method=lambda m, e_, a_: (m.embed_tokens(jnp.zeros((1, 1), jnp.int32)), m(e_, a_)),
    ))(jnp.asarray(embeds), jnp.asarray(mask)), seed=6, std=0.02)
    _, _, prompt, prompt_mask, next_pos = jax.jit(lambda v, e, a: jmod.apply(
        v, e, a, t, method=JaxLlamaModel.prefill_with_cache))(
        variables, jnp.asarray(embeds), jnp.asarray(mask))
    tmod = LlamaModel(torch_llama_config(jcfg)).eval()
    tmod.load_state_dict(jax_to_torch_state_dict(to_numpy_tree(variables))[0], strict=True)
    with torch.no_grad():
        _, _, t_prompt, t_prompt_mask, _ = tmod.prefill_with_cache(
            torch.from_numpy(embeds), torch.from_numpy(mask), t)

    tok = (r.normal(size=(bk, 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
    pos = np.repeat(np.asarray(next_pos), k)[:, None] + gidx
    gen_mask = np.zeros((bk, s_g), bool)
    gen_mask[:, :gidx + 1] = True
    anc = r.integers(0, k, size=(bk, s_g)).astype(np.int32)
    anc[:, gidx] = np.tile(np.arange(k), b)  # the step's write lands in the row itself
    j_gen, t_gen = _gen_cache(jcfg, bk, s_g, seed=8)
    args = (jnp.asarray(tok), jnp.asarray(pos), prompt, prompt_mask)
    targs = (torch.from_numpy(tok), torch.from_numpy(pos), t_prompt, t_prompt_mask)

    for name, extra, textra in (
        ("decode_step_shared", (), ()),
        ("decode_step_beam_anc", (jnp.asarray(anc),), (torch.from_numpy(anc), k)),
    ):
        method = getattr(JaxLlamaModel, name)
        j_logits, j_new = jax.jit(lambda v, a, g, gm, *x: jmod.apply(
            v, *a, g, gidx, gm, *x, *((k,) if x else ()), method=method))(
            variables, args, dict(j_gen), jnp.asarray(gen_mask), *extra)
        gen = {key: val.clone() for key, val in t_gen.items()}
        with torch.no_grad():
            got = getattr(tmod, name)(*targs, gen, gidx, torch.from_numpy(gen_mask), *textra)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_logits), atol=ATOL, err_msg=name)
        for key in gen:
            # int8 values and bf16 scales exactly; fp32 k/v at fp32 rounding
            np.testing.assert_allclose(gen[key].float().numpy(),
                                       np.asarray(j_new[key].astype(jnp.float32)),
                                       atol=0 if kv_quantize else ATOL, rtol=0,
                                       err_msg=f"{name} {key}")

    with torch.no_grad():
        # ancestry reads what the physically reordered segment holds, and
        # computes with it as the reordered segment is computed with
        rows = torch.from_numpy(np.arange(bk)[:, None] // k * k + anc).long()
        slots = torch.arange(s_g)[None, :]
        anc_gen = {key: val.clone() for key, val in t_gen.items()}
        by_anc = tmod.decode_step_beam_anc(*targs, anc_gen, gidx, torch.from_numpy(gen_mask),
                                           torch.from_numpy(anc), k)
        reordered = {key: val[:, rows, slots] for key, val in t_gen.items()}
        by_rows = tmod.decode_step_shared(*targs, reordered, gidx, torch.from_numpy(gen_mask))
        assert torch.equal(by_anc, by_rows)  # the same arithmetic: the same bits
        # a prompt shared by the beams reads as the prompt copied for each beam
        expanded = {key: _expand_cache(val, k) for key, val in t_prompt.items()}
        copied = tmod.decode_step_shared(
            targs[0], targs[1], expanded, t_prompt_mask.repeat_interleave(k, dim=0),
            {key: val.clone() for key, val in t_gen.items()}, gidx,
            torch.from_numpy(gen_mask))
        shared = tmod.decode_step_shared(*targs, {key: val.clone() for key, val in t_gen.items()},
                                         gidx, torch.from_numpy(gen_mask))
        torch.testing.assert_close(shared, copied, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The slice as a whole: beam-5 MSR3D.generate with images
# ---------------------------------------------------------------------------

NEW_TOKENS, SCENE_TOKENS, BEAMS, PENALTY = 8, 6, 5, 3.0


def beam_requests():
    data = scene_inputs(3)
    data["msr3d_prompt"] = list(IMAGE_PROMPTS)
    data.update(image_inputs(11, [[1, 1, 0], [1, 0, 0]]))
    return data


def jax_beam_model(**llm):
    """The tiny JAX MSR3D (fp32, LoRA r4, flash, ``convnext_test`` avg) with
    the weights of ``_beam_params``."""
    model = _jax_msr3d(**llm)
    model.params = _beam_params()
    return model


def _jax_msr3d(**llm):
    tok = JaxByteTokenizer()
    cfg = JaxMSR3DNetworkConfig(
        prompter=TINY_PROMPTER,
        llm=JaxLlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=jnp.float32, lora_rank=4,
                                **llm),
        backbone_name="convnext_test")
    return JaxMSR3D(cfg, tok, scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS,
                    num_beams=BEAMS, repetition_penalty=PENALTY)


@functools.lru_cache(maxsize=None)
def _beam_params():
    """The JAX model's own weights, initialised on a batch with images and
    perturbed (the KV cache's options do not change them)."""
    model = _jax_msr3d()
    data = beam_requests()
    ids, attn = model._encode_prompts(model.build_text_prompt(data))
    answers, answer_mask = model._encode_answers(["a chair", "yes"])
    batch = model._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=answers, output_mask=answer_mask)
    return perturbed(model.init_params(batch), seed=4, std=0.05)


@pytest.mark.parametrize("kv_quantize", [False, True], ids=["fp32-cache", "int8-cache"])
def test_beam_generate_with_images_matches_jax(kv_quantize):
    jmodel = jax_beam_model(kv_quantize=kv_quantize)
    model = MSR3D(torch_network_config(jmodel.cfg), ByteTokenizer(),
                  scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS, num_beams=BEAMS,
                  repetition_penalty=PENALTY, device="cpu")
    skipped = model.load_jax_params(jmodel.params)
    assert skipped == [], skipped
    assert model.network.cfg.llm.kv_quantize == kv_quantize
    assert_beam_generate_matches(jmodel, model, beam_requests(), NEW_TOKENS)
