"""The quantized serving slice of the port against the JAX package: weight
quantization and int4 packing, the plain versions of kernels K3 and K4
against the Pallas kernels in interpret mode, the quantized ``LoraDense`` in
every mode, the int8 KV cache, the HF checkpoint loader, and greedy
``MSR3D.generate`` on the tiny config in five quantized configurations.

Inputs come from numpy seeds; the JAX side runs as its own tests run it.
Every tolerance is stated where it is used."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.models.llm import convert as jconvert
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.models.llm.llama import LoraDense as JaxLoraDense
from msr3d_tpu.models.llm.llama import _make_cache as jax_make_cache
from msr3d_tpu.models.llm.llama import _quantize_kv as jax_quantize_kv
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.load_weights import load_llm_weights as jax_load_llm_weights
from msr3d_tpu.models.load_weights import load_peft_lora as jax_load_peft_lora
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu.ops.pallas import w4_matmul as jw4
from msr3d_tpu.ops.pallas import w8_matmul as jw8
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm import convert
from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel, LoraDense, _make_cache
from msr3d_tpu_torch.models.llm.llama import _quantize_kv
from msr3d_tpu_torch.models.llm.sampling import apply_repetition_penalty
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.load_weights import load_llm_weights, load_peft_lora
from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
from msr3d_tpu_torch.ops import w4_matmul, w8_matmul

from torch_parity_utils import (
    TINY_PROMPTER,
    assert_beam_generate_matches,
    perturbed,
    scene_inputs,
    to_numpy_tree,
    torch_llama_config,
    torch_prompter_config,
)
from torch_w4_model import kernel_model_w4
from torch_w8_model import kernel_model_w8

ATOL = 1e-5  # fp32 outputs of the two frameworks: summation order only
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _kernel(seed, d_in=128, d_out=96):
    """An N(0, 0.02) flax-layout kernel with one all-zero output channel
    (its scale becomes 1) and one all-zero group of 32 input rows."""
    k = (np.random.default_rng(seed).normal(size=(d_in, d_out)) * 0.02).astype(np.float32)
    k[:, 5] = 0.0
    k[32:64, 7] = 0.0
    return k


def _one_layer_tree(kernel):
    return {"layer_0": {"attn": {"q_proj": {"kernel": kernel}}, "mlp": {}}}


QUANT_MODES = [(8, None), (4, None), (4, 32)]


@pytest.mark.parametrize("bits,group", QUANT_MODES, ids=["int8", "int4", "int4-g32"])
def test_quantize_llm_params_bit_equal_to_jax(bits, group):
    k = _kernel(bits + (group or 0))
    jcfg = JaxLlamaConfig.tiny(num_hidden_layers=1, quantize=True, quantize_bits=bits,
                               quantize_group=group)
    want = jconvert.quantize_llm_params(_one_layer_tree(k), jcfg)["layer_0"]["attn"]["q_proj"]
    got = convert.quantize_llm_params(_one_layer_tree(torch.from_numpy(k)),
                                      torch_llama_config(jcfg))["layer_0"]["attn"]["q_proj"]
    assert set(got) == {"kernel_q", "kernel_scale"}
    assert got["kernel_q"].dtype == torch.int8 and got["kernel_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["kernel_q"].numpy(), want["kernel_q"])
    np.testing.assert_array_equal(got["kernel_scale"].numpy(), want["kernel_scale"])


def test_int4_packings_bit_equal_to_jax():
    r = np.random.default_rng(3)
    w4 = r.integers(-8, 8, size=(64, 40)).astype(np.int8)
    packed = jconvert.pack_int4(w4)
    np.testing.assert_array_equal(convert.pack_int4(torch.from_numpy(w4)).numpy(), packed)
    np.testing.assert_array_equal(convert.unpack_int4(torch.from_numpy(packed)).numpy(),
                                  jconvert.unpack_int4(packed))
    np.testing.assert_array_equal(w4_matmul.pack_w4(torch.from_numpy(w4)).numpy(),
                                  jw4.pack_w4(w4))
    np.testing.assert_array_equal(
        w4_matmul.repack_from_splitnibble(torch.from_numpy(packed)).numpy(),
        jw4.repack_from_splitnibble(packed))
    with pytest.raises(ValueError):
        w4_matmul.pack_w4(torch.full((4, 2), 9, dtype=torch.int8))


# ---------------------------------------------------------------------------
# K3 and K4: the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _assert_one_bf16_ulp(got: torch.Tensor, want) -> None:
    """bf16 outputs of the same exact products summed in another order (fp32)
    and rounded once: at most one bf16 ulp apart."""
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("b", [3, 8, 16])
@pytest.mark.parametrize("k,n,bk,bn", [(512, 1024, 256, 512), (256, 640, 128, 128)])
def test_matmul_w8_reference_matches_pallas(b, k, n, bk, bn):
    r = np.random.default_rng(b * k + n)
    x = (r.normal(size=(b, k)) * 0.1).astype(np.float32)
    wq = r.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = (r.uniform(0.5, 1.5, size=(n,)) / 127).astype(np.float32)
    want = jw8.matmul_w8(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq), jnp.asarray(scale),
                         block_k=bk, block_n=bn, interpret=True)
    got = w8_matmul.matmul_w8(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wq),
                              torch.from_numpy(scale))
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    _assert_one_bf16_ulp(got, want.astype(jnp.float32))


@pytest.mark.parametrize("b", [1, 4, 7, 16, 37])
@pytest.mark.parametrize("k,split,tile", [
    (512, 4, 128),  # K a whole number of 64-row tiles
    (384, 2, 32),  # 256-row tiles: the second is half padding
    (640, 8, 64),  # 128-row tiles, 5 of them over 8 splits: three are empty
])
def test_w8_kernel_model_matches_pallas(b, k, split, tile):
    """K3's split-K sum order (``tests/torch_w8_model.py``) against the
    Pallas kernel in interpret mode: within one bf16 ulp."""
    n = 640
    r = np.random.default_rng(b * k + split)
    x = (r.normal(size=(b, k)) * 0.1).astype(np.float32)
    wq = r.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = (r.uniform(0.5, 1.5, size=(n,)) / 127).astype(np.float32)
    want = jw8.matmul_w8(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq), jnp.asarray(scale),
                         block_k=128, block_n=128, interpret=True)
    got = kernel_model_w8(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wq),
                          torch.from_numpy(scale), split, tile)
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    _assert_one_bf16_ulp(got, want.astype(jnp.float32))


@pytest.mark.parametrize("unpack", ["bf16", "f32", "i16"])
@pytest.mark.parametrize("b", [3, 8, 16])
def test_matmul_w4_reference_matches_pallas(unpack, b):
    k, n = 512, 640
    r = np.random.default_rng(b)
    x = (r.normal(size=(b, k)) * 0.1).astype(np.float32)
    packed = jw4.pack_w4(r.integers(-8, 8, size=(k, n)))
    scale = (r.uniform(0.5, 1.5, size=(n,)) / 7).astype(np.float32)
    want = jw4.matmul_w4(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(packed),
                         jnp.asarray(scale), block_kp=128, block_n=128, unpack=unpack,
                         interpret=True)
    got = w4_matmul.matmul_w4(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed),
                              torch.from_numpy(scale))
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    _assert_one_bf16_ulp(got, want.astype(jnp.float32))


@pytest.mark.parametrize("unpack", ["bf16", "f32", "i16"])
@pytest.mark.parametrize("b", [1, 4, 7, 16, 37])
@pytest.mark.parametrize("k,split,tile", [
    (1024, 4, 128),  # K/2 a whole number of 128-row tiles
    (1536, 2, 32),  # 512-row tiles: the second is half padding
    (2560, 8, 64),  # 256-row tiles, 5 of them over 8 splits: three are empty
])
def test_w4_kernel_model_matches_pallas(unpack, b, k, split, tile):
    """K4's split-K sum order over signed nibbles (``tests/torch_w4_model.py``)
    against the Pallas kernel in interpret mode and the plain version, both of
    which sum the +8-biased low nibbles and subtract 8·rowsum(x_lo) after:
    within one bf16 ulp plus the rounding of that biased sum, 2^-12·Σ|x|·|s|
    (as ``chip_smoke.py``'s DEQ_W4_BIAS)."""
    n = 640
    r = np.random.default_rng(b * k + split)
    x = (r.normal(size=(b, k)) * 0.1).astype(np.float32)
    packed = jw4.pack_w4(r.integers(-8, 8, size=(k, n)))
    scale = (r.uniform(0.5, 1.5, size=(n,)) / 7).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = kernel_model_w4(xb, torch.from_numpy(packed), torch.from_numpy(scale), split, tile)
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    pallas = jw4.matmul_w4(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(packed),
                           jnp.asarray(scale), block_kp=256, block_n=128, unpack=unpack,
                           interpret=True)
    plain = w4_matmul.matmul_w4_reference(xb, torch.from_numpy(packed), torch.from_numpy(scale))
    bias = 2.0 ** -12 * xb.float().abs().sum(1, keepdim=True).numpy() * np.abs(scale)
    for want in (np.asarray(pallas.astype(jnp.float32)), plain.float().numpy()):
        err = np.abs(got.float().numpy() - want)
        assert bool((err <= BF16_ULP * np.abs(want) + bias + 1e-6).all())


def test_dequant_matmul_bad_shapes_raise_as_pallas():
    x = np.zeros((4, 512), np.float32)
    cases = [  # (JAX function, port function, wq shape, scale length)
        (jw8.matmul_w8, w8_matmul.matmul_w8, (256, 256), 256),  # K mismatch
        (jw8.matmul_w8, w8_matmul.matmul_w8, (512, 256), 99),  # scale length
        (jw4.matmul_w4, w4_matmul.matmul_w4, (128, 256), 256),  # 2 * 128 != 512
        (jw4.matmul_w4, w4_matmul.matmul_w4, (256, 256), 99),
    ]
    for jfn, fn, wshape, n_scale in cases:
        with pytest.raises(ValueError):
            jfn(jnp.asarray(x).astype(jnp.bfloat16), jnp.zeros(wshape, jnp.int8),
                jnp.ones((n_scale,)), interpret=True)
        with pytest.raises(ValueError):
            fn(torch.from_numpy(x), torch.zeros(wshape, dtype=torch.int8), torch.ones(n_scale))


# ---------------------------------------------------------------------------
# The quantized LoraDense in every mode
# ---------------------------------------------------------------------------

DENSE_MODES = [(8, None, False), (4, None, False), (4, 32, False), (8, None, True),
               (4, None, True)]


@pytest.mark.parametrize("bits,group,act", DENSE_MODES,
                         ids=["int8", "int4", "int4-g32", "s8s8-int8", "s8s8-int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_lora_dense_matches_jax(bits, group, act, dtype):
    d_in, d_out, rank = 128, 96, 4
    r = np.random.default_rng(11)
    jcfg = JaxLlamaConfig.tiny(num_hidden_layers=1, quantize=True, quantize_bits=bits,
                               quantize_group=group, act_quantize=act)
    qt = jconvert.quantize_llm_params(_one_layer_tree(_kernel(7, d_in, d_out)),
                                      jcfg)["layer_0"]["attn"]["q_proj"]
    lora_a = (r.normal(size=(d_in, rank)) * 0.1).astype(np.float32)
    lora_b = (r.normal(size=(rank, d_out)) * 0.1).astype(np.float32)
    x = r.normal(size=(2, 3, d_in)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x).astype(jdt)
    jmod = JaxLoraDense(d_out, use_lora=True, lora_rank=rank, quantized=True, bits=bits,
                        quant_group=group, act_quant=act, dtype=jdt)
    want = jmod.apply({"params": {**qt, "lora_a": lora_a, "lora_b": lora_b}}, jx)

    cfg = torch_llama_config(jcfg, dtype=getattr(torch, dtype), lora_rank=rank)
    mod = LoraDense(d_in, d_out, cfg, use_lora=True)
    state = {"weight_q": torch.from_numpy(qt["kernel_q"]),
             "weight_scale": torch.from_numpy(qt["kernel_scale"]),
             "lora_a": torch.from_numpy(lora_a.T.copy()), "lora_b": torch.from_numpy(lora_b.T.copy())}
    mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(cfg.dtype))
    assert got.dtype == cfg.dtype and got.shape == (2, 3, d_out)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    else:  # the same bf16 roundings in the same order; sums in another order
        _assert_one_bf16_ulp(got, want.astype(jnp.float32))


def test_quantize_config_checks_match_jax():
    for kw in (dict(quantize=True, quantize_bits=3), dict(quantize=True, quantize_group=32),
               dict(quantize=True, quantize_bits=4, quantize_group=32, act_quantize=True),
               dict(act_quantize=True)):
        with pytest.raises(ValueError):
            JaxLlamaConfig.tiny(**kw)
        with pytest.raises(ValueError):
            LlamaConfig.tiny(**kw)


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------


def test_quantize_kv_bit_equal_to_jax():
    arr = (np.random.default_rng(5).normal(size=(2, 5, 4, 16)) * 3).astype(np.float32)
    arr[0, 1, 2] = 0.0  # an all-zero head: scale bf16(1e-6 / 127)
    for dtype in (jnp.float32, jnp.bfloat16):
        ja = jnp.asarray(arr).astype(dtype)
        jq, js = jax_quantize_kv(ja)
        q, s = _quantize_kv(torch.from_numpy(np.array(ja.astype(jnp.float32))).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(s), np.asarray(js.astype(jnp.float32)))
    # the empty cache equals the quantized zeros, as JAX builds it
    jcfg = JaxLlamaConfig.tiny(kv_quantize=True)
    want = jax_make_cache(jcfg, 2, 3)
    got = _make_cache(torch_llama_config(jcfg), 2, 3, "cpu")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key].astype(
            jnp.float32 if "scale" in key else jnp.int8)))


@pytest.mark.parametrize("quant,rank", [
    (dict(), 4),
    (dict(quantize=True, quantize_bits=4, quantize_group=32), 4),
    (dict(quantize=True), 0),  # a quantized tree without LoRA: the merged-LoRA deployment
], ids=["bf16-base", "int4-g32-base", "int8-base-no-lora"])
def test_int8_cache_prefill_and_decode_step_match_jax(quant, rank):
    """The kv_quantize prefill cache and one decode step over it against
    JAX's ``decode_step_shared``, fp32 compute, with weights converted by
    ``msr3d_tpu_torch.convert`` (strictly: every port tensor covered). The
    int8 values are compared exactly, the logits within ATOL."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=rank, num_key_value_heads=2,
                               kv_quantize=True, flash_attention=True)
    b, t, new = 2, 11, 3
    r = np.random.default_rng(12)
    embeds = (r.normal(size=(b, t, jcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, :4] = 0
    variables = JaxLlamaModel(jcfg).init(
        jax.random.key(3), jnp.asarray(embeds), jnp.asarray(mask),
        method=lambda m, e, a: (m.embed_tokens(jnp.zeros((1, 1), jnp.int32)), m(e, a)),
    )
    variables = perturbed(variables, seed=3, std=0.02)
    if quant:
        jcfg = dataclasses.replace(jcfg, **quant)
        variables = {"params": jconvert.quantize_llm_params(variables["params"], jcfg)}
    jmod = JaxLlamaModel(jcfg)
    logits, _, caches, cache_mask, next_pos = jmod.apply(
        variables, jnp.asarray(embeds), jnp.asarray(mask), t,
        method=JaxLlamaModel.prefill_with_cache)
    tmod = LlamaModel(torch_llama_config(jcfg)).eval()
    tmod.load_state_dict(jax_to_torch_state_dict(to_numpy_tree(variables))[0], strict=True)
    with torch.no_grad():
        t_logits, _, t_caches, t_cache_mask, t_next = tmod.prefill_with_cache(
            torch.from_numpy(embeds), torch.from_numpy(mask), t)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), atol=ATOL)
    assert set(t_caches) == {"k", "v", "k_scale", "v_scale"}
    for key in ("k", "v"):
        np.testing.assert_array_equal(t_caches[key].numpy(), np.asarray(caches[key]))
        np.testing.assert_array_equal(_np(t_caches[f"{key}_scale"]),
                                      np.asarray(caches[f"{key}_scale"].astype(jnp.float32)))

    tok = (r.normal(size=(b, 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
    gen_mask = np.zeros((b, new), bool)
    gen_mask[:, 0] = True
    pos = np.array(next_pos)[:, None]
    j_logits, j_gen = jmod.apply(
        variables, jnp.asarray(tok), jnp.asarray(pos), caches, cache_mask,
        jax_make_cache(jcfg, b, new), 0, jnp.asarray(gen_mask),
        method=JaxLlamaModel.decode_step_shared)
    t_gen = _make_cache(tmod.cfg, b, new, "cpu")
    with torch.no_grad():
        got = tmod.decode_step_shared(torch.from_numpy(tok), torch.from_numpy(pos), t_caches,
                                      t_cache_mask, t_gen, 0, torch.from_numpy(gen_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_logits), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_array_equal(t_gen[key].numpy(), np.asarray(j_gen[key]))
        np.testing.assert_array_equal(_np(t_gen[f"{key}_scale"]),
                                      np.asarray(j_gen[f"{key}_scale"].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# The slice as a whole: greedy generate in five quantized configurations
# ---------------------------------------------------------------------------

NEW_TOKENS, SCENE_TOKENS, PENALTY = 12, 6, 1.5
MARGIN = 1e-4  # least top-1 over top-2 logit gap of each pick

GENERATE_CONFIGS = {
    "int8": dict(quantize=True),
    "int8-kv8": dict(quantize=True, kv_quantize=True),
    "int4": dict(quantize=True, quantize_bits=4),
    "int4-g32-kv8": dict(quantize=True, quantize_bits=4, quantize_group=32, kv_quantize=True),
    "s8s8-int8": dict(quantize=True, act_quantize=True),
}


def _requests():
    data = scene_inputs(3)
    data["msr3d_prompt"] = [
        "You are in a scene: 景. What is on the table?",
        "Scene 景 here. Can I go north?",
    ]
    return data


def _jax_quantized_model(quant):
    """The tiny JAX MSR3D (fp32, LoRA r4, flash) with perturbed weights whose
    LLM tree is quantized by JAX's ``quantize_llm_params``."""
    tok = JaxByteTokenizer()
    llm = JaxLlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=jnp.float32, lora_rank=4,
                              flash_attention=True)
    kw = dict(scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS, repetition_penalty=PENALTY)
    fp = JaxMSR3D(JaxMSR3DNetworkConfig(prompter=TINY_PROMPTER, llm=llm,
                                        backbone_name="convnext_test"), tok, **kw)
    data = _requests()
    ids, attn = fp._encode_prompts(fp.build_text_prompt(data))
    answers, answer_mask = fp._encode_answers(["a chair", "yes"])
    batch = fp._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=answers, output_mask=answer_mask)
    variables = perturbed(fp.init_params(batch), seed=4, std=0.05)
    llm_q = dataclasses.replace(llm, **quant)
    variables["params"]["llm"] = jconvert.quantize_llm_params(variables["params"]["llm"], llm_q)
    model = JaxMSR3D(JaxMSR3DNetworkConfig(prompter=TINY_PROMPTER, llm=llm_q,
                                           backbone_name="convnext_test"), tok, **kw)
    model.params = variables
    return model


@pytest.mark.parametrize("name", list(GENERATE_CONFIGS))
def test_quantized_greedy_generate_matches_jax(name):
    jmodel = _jax_quantized_model(GENERATE_CONFIGS[name])
    want = jmodel.generate(_requests(), use_beam=False)
    cfg = MSR3DNetworkConfig(prompter=torch_prompter_config(TINY_PROMPTER),
                             llm=torch_llama_config(jmodel.cfg.llm))
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS,
                  repetition_penalty=PENALTY, device="cpu")
    skipped = model.load_jax_params(jmodel.params)
    assert skipped == [], skipped

    steps = []
    net = model.network
    prefill, decode = net.prefill, net.decode_step_shared

    def record_prefill(*args, **kw):
        out = prefill(*args, **kw)
        steps.append(out[0])
        return out

    def record_decode(*args, **kw):
        out = decode(*args, **kw)
        steps.append(out[:, -1].float())
        return out

    net.prefill, net.decode_step_shared = record_prefill, record_decode
    got = model.generate(_requests(), use_beam=False)
    tokens = got["output_tokens"]
    assert tokens.shape == (2, NEW_TOKENS)
    np.testing.assert_array_equal(tokens, want["output_tokens"])
    assert got["output_text"] == want["output_text"]
    assert len(steps) >= 2  # the decode loop ran

    # every pick of a row still generating won by more than MARGIN, so the
    # equality is not luck between near-tied logits
    seen = torch.zeros(steps[0].shape, dtype=torch.bool)
    finished = np.zeros(tokens.shape[0], bool)
    rows = torch.arange(tokens.shape[0])
    for step, logits in enumerate(steps):
        top2 = apply_repetition_penalty(logits, seen, PENALTY).topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        assert (gap[~finished] > MARGIN).all(), (step, gap)
        tok = torch.from_numpy(tokens[:, step]).long()
        seen[rows[~finished], tok[~finished]] = True
        finished |= tokens[:, step] == model.tokenizer.eos_id


@pytest.mark.parametrize("name", ["int8-kv8", "int4-g32-kv8"])
def test_quantized_beam_generate_matches_jax(name):
    """Beam-5 generate with penalty 3.0 (the reference's eval decode) over
    quantized weights and the int8 KV cache: the prompt cache shared by the
    beams, the generated segment read through the ancestry map or
    reordered; tokens equal to JAX's, both ways."""
    jmodel = _jax_quantized_model(GENERATE_CONFIGS[name])
    cfg = MSR3DNetworkConfig(prompter=torch_prompter_config(TINY_PROMPTER),
                             llm=torch_llama_config(jmodel.cfg.llm),
                             backbone_name="convnext_test")
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS,
                  repetition_penalty=3.0, device="cpu")
    model.load_jax_params(jmodel.params)
    jmodel.repetition_penalty = 3.0
    assert jmodel.num_beams == model.num_beams == 5 and model.network.cfg.llm.kv_quantize
    assert_beam_generate_matches(jmodel, model, _requests(), NEW_TOKENS)


def test_quantized_init_equals_quantizing_the_bf16_init():
    """``MSR3D(quantized cfg).init_params(seed)`` draws the bf16 model's
    weights and quantizes them: it equals ``init_params(seed)`` of the bf16
    model followed by ``quantize_llm``."""
    llm = LlamaConfig.tiny(vocab_size=ByteTokenizer().vocab_size, dtype=torch.float32,
                           lora_rank=4)
    cfg = MSR3DNetworkConfig(prompter=torch_prompter_config(TINY_PROMPTER), llm=llm)
    quant = dict(quantize=True, quantize_bits=4, quantize_group=32, kv_quantize=True)
    a = MSR3D(cfg, scene_token_len=SCENE_TOKENS, max_out_len=4, device="cpu")
    a.init_params(seed=1)
    a.quantize_llm(4, 32, kv_quantize=True)
    b = MSR3D(dataclasses.replace(cfg, llm=dataclasses.replace(llm, **quant)),
              scene_token_len=SCENE_TOKENS, max_out_len=4, device="cpu")
    b.init_params(seed=1)
    assert a.cfg == b.cfg and a.network.llm.cfg == b.network.llm.cfg
    sa, sb = a.network.state_dict(), b.network.state_dict()
    assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(n.startswith("llm.") and n.endswith("_proj.weight") for n in sa)  # bases gone
    ta = a.generate(_requests(), use_beam=False)["output_tokens"]
    np.testing.assert_array_equal(ta, b.generate(_requests(), use_beam=False)["output_tokens"])


# ---------------------------------------------------------------------------
# The HF checkpoint loader, on a synthetic checkpoint written here
# ---------------------------------------------------------------------------

HF_CFG = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4, rms_norm_eps=1e-6,
              rope_theta=10000.0, max_position_embeddings=128, tie_word_embeddings=False)
PROJS = {"self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
         "mlp": ("gate_proj", "up_proj", "down_proj")}


def _hf_state(seed):
    r = np.random.default_rng(seed)
    h, m, v = HF_CFG["hidden_size"], HF_CFG["intermediate_size"], HF_CFG["vocab_size"]
    shapes = {"model.embed_tokens.weight": (v, h), "model.norm.weight": (h,),
              "lm_head.weight": (v, h)}
    for i in range(HF_CFG["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for proj in PROJS["self_attn"]:
            shapes[f"{pre}self_attn.{proj}.weight"] = (h, h)
        shapes[f"{pre}mlp.gate_proj.weight"] = shapes[f"{pre}mlp.up_proj.weight"] = (m, h)
        shapes[f"{pre}mlp.down_proj.weight"] = (h, m)
        shapes[f"{pre}input_layernorm.weight"] = shapes[f"{pre}post_attention_layernorm.weight"] = (h,)
    sd = {k: (r.normal(size=s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(8, np.float32)  # skipped
    return sd


def _write_checkpoint(path, seed=0):
    """config.json, a torch .bin shard with layer 0 and an fp16
    .safetensors shard with the rest, and the index json naming both."""
    from safetensors.numpy import save_file

    sd = _hf_state(seed)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(HF_CFG))
    first = {k: v for k, v in sd.items() if k.startswith("model.layers.0.")}
    rest = {k: v.astype(np.float16) for k, v in sd.items() if k not in first}
    torch.save({k: torch.from_numpy(v) for k, v in first.items()},
               path / "pytorch_model-00001-of-00002.bin")
    save_file(rest, str(path / "model-00002-of-00002.safetensors"))
    weight_map = {k: "pytorch_model-00001-of-00002.bin" for k in first}
    weight_map.update({k: "model-00002-of-00002.safetensors" for k in rest})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for key, val in want.items():
        if isinstance(val, dict):
            _assert_trees_equal(got[key], val, f"{path}/{key}")
        else:
            np.testing.assert_array_equal(_np(got[key]), np.asarray(val, np.float32),
                                          err_msg=f"{path}/{key}")


def test_load_hf_checkpoint_matches_jax(tmp_path):
    _write_checkpoint(tmp_path)
    jcfg, jparams = jconvert.load_hf_checkpoint(tmp_path)
    cfg, params = convert.load_hf_checkpoint(tmp_path)
    assert cfg == torch_llama_config(jcfg)
    _assert_trees_equal(params, jparams)
    with pytest.raises(NotImplementedError):  # an lm_head tied to the embeddings is not ported
        convert.config_from_hf(dict(HF_CFG, tie_word_embeddings=True))
    names = [n for n, _ in convert.iter_hf_checkpoint_tensors(tmp_path)]
    assert "model.layers.0.self_attn.rotary_emb.inv_freq" in names and len(names) == len(
        _hf_state(0))
    # init_lora_params draws the same numpy numbers
    lcfg = dataclasses.replace(cfg, lora_rank=4)
    _assert_trees_equal(convert.init_lora_params(params, lcfg, seed=2),
                        jconvert.init_lora_params(jparams, dataclasses.replace(jcfg, lora_rank=4),
                                                  seed=2))


def test_safetensors_reader_reads_bf16_and_ints(tmp_path):
    from safetensors.torch import save_file

    want = {"a": torch.randn(3, 5).to(torch.bfloat16), "b": torch.arange(7, dtype=torch.int64),
            "c": torch.zeros((0, 2)), "d": torch.randn(2, 2, dtype=torch.float16)}
    save_file(want, str(tmp_path / "x.safetensors"))
    got = dict(convert._safetensors_tensors(tmp_path / "x.safetensors"))
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype and torch.equal(got[key], val)


class _Holder(torch.nn.Module):
    """The ``llm`` attribute the loaders overlay, as ``MSR3DNetwork`` has it."""

    def __init__(self, cfg):
        super().__init__()
        self.llm = LlamaModel(cfg)


def _jax_llm_variables(jcfg):
    b, t = 1, 4
    return {"params": {"llm": jax.tree_util.tree_map(np.asarray, JaxLlamaModel(jcfg).init(
        jax.random.key(0), jnp.zeros((b, t, jcfg.hidden_size)), jnp.ones((b, t), jnp.int32),
        method=lambda m, e, a: (m.embed_tokens(jnp.zeros((1, 1), jnp.int32)), m(e, a)),
    )["params"])}}


@pytest.mark.parametrize("quant", [dict(), dict(quantize=True),
                                   dict(quantize=True, quantize_bits=4, quantize_group=32)],
                         ids=["fp32", "int8", "int4-g32"])
def test_load_llm_weights_matches_jax(tmp_path, quant):
    """Quantize-on-load: the loaded model equals JAX's loaded variables."""
    _write_checkpoint(tmp_path, seed=1)
    jcfg = jconvert.config_from_hf(HF_CFG, dtype=jnp.float32, **quant)
    variables = _jax_llm_variables(jcfg)
    jax_load_llm_weights(variables, tmp_path, jcfg)
    holder = _Holder(torch_llama_config(jcfg))
    load_llm_weights(holder, tmp_path, holder.llm.cfg)
    want, _ = jax_to_torch_state_dict(variables)
    got = holder.state_dict()
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(_np(got[key]), val.float().numpy() if val.is_floating_point()
                                      else val.numpy(), err_msg=key)
    if quant:
        assert holder.llm.layer[0].attn.q_proj.weight_q.abs().max() > 0


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_peft_lora_matches_jax(tmp_path, fmt):
    r = np.random.default_rng(8)
    h, m, rank = HF_CFG["hidden_size"], HF_CFG["intermediate_size"], 4
    dims = {"q_proj": (h, h), "k_proj": (h, h), "v_proj": (h, h), "o_proj": (h, h),
            "gate_proj": (h, m), "up_proj": (h, m), "down_proj": (m, h)}
    sd = {}
    for i in range(HF_CFG["num_hidden_layers"]):
        for block, projs in PROJS.items():
            for proj in projs:
                d_in, d_out = dims[proj]
                pre = f"base_model.model.model.layers.{i}.{block}.{proj}"
                sd[f"{pre}.lora_A.weight"] = r.normal(size=(rank, d_in)).astype(np.float32)
                sd[f"{pre}.lora_B.default.weight"] = r.normal(size=(d_out, rank)).astype(np.float32)
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "adapter_model.bin")
    else:
        from safetensors.numpy import save_file

        save_file(sd, str(tmp_path / "adapter_model.safetensors"))
    jcfg = jconvert.config_from_hf(HF_CFG, dtype=jnp.float32, lora_rank=rank)
    variables = _jax_llm_variables(jcfg)
    holder = _Holder(torch_llama_config(jcfg))
    holder.load_state_dict(jax_to_torch_state_dict(variables)[0], strict=True)  # before
    jax_load_peft_lora(variables, tmp_path)
    load_peft_lora(holder, tmp_path)
    want, _ = jax_to_torch_state_dict(variables)
    got = holder.state_dict()
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key].numpy(), val.numpy(), err_msg=key)
    lora_b = holder.llm.layer[1].mlp.down_proj.lora_b
    assert torch.equal(lora_b, torch.from_numpy(sd["base_model.model.model.layers.1.mlp."
                                                   "down_proj.lora_B.default.weight"]))
