"""The whole slice: greedy ``MSR3D.generate`` of the port against the JAX
package's, on a tiny fp32 config (the ``tests/test_msr3d.py`` prompter,
``LlamaConfig.tiny`` with LoRA, the ``convnext_test`` image encoder),
requests without images, with MSR3D images (some masked), with a LEO single
view, and with an EOS logit bias.

Both models hold the same weights: the JAX model's own, perturbed with
numpy noise (LoRA B included, so the adapters take part) and converted
with ``msr3d_tpu_torch.convert``. The greedy tokens must be equal. Since
argmax can agree by luck where two logits nearly tie, the test also
asserts that every pick the port made won by more than ``MARGIN`` over the
runner-up, well above the fp32 disagreement of the two frameworks (the
first-token logits are compared at 1e-5)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu_torch.models.llm.llama import LlamaConfig, _make_cache
from msr3d_tpu_torch.models.llm.sampling import apply_repetition_penalty
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig

from torch_parity_utils import (
    IMAGE_PROMPTS,
    TINY_PROMPTER,
    image_inputs,
    perturbed,
    scene_inputs,
    torch_llama_config,
    torch_network_config,
    torch_prompter_config,
)

NEW_TOKENS, SCENE_TOKENS, PENALTY = 12, 6, 1.5
MARGIN = 1e-4  # least top-1 over top-2 logit gap of each pick
ATOL = 1e-5
EOS_BIAS = 0.5


def _requests():
    data = scene_inputs(3)
    data["msr3d_prompt"] = [
        "You are in a scene: 景. What is on the table?",
        "Scene 景 here. Can I go north?",
    ]
    return data


def _jax_model(flash: bool):
    tok = JaxByteTokenizer()
    llm = JaxLlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=jnp.float32, lora_rank=4,
                              flash_attention=flash)
    model = JaxMSR3D(
        JaxMSR3DNetworkConfig(prompter=TINY_PROMPTER, llm=llm, backbone_name="convnext_test"),
        tok,
        scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS, repetition_penalty=PENALTY,
    )
    data = _requests()
    ids, attn = model._encode_prompts(model.build_text_prompt(data))
    answers, answer_mask = model._encode_answers(["a chair", "yes"])
    batch = model._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=answers,
                 output_mask=answer_mask)
    model.params = perturbed(model.init_params(batch), seed=4, std=0.05)
    return model


def _port_model(jax_model: JaxMSR3D, flash: bool) -> MSR3D:
    cfg = MSR3DNetworkConfig(
        prompter=torch_prompter_config(TINY_PROMPTER),
        llm=torch_llama_config(jax_model.cfg.llm, flash_attention=flash),
    )
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=SCENE_TOKENS,
                  max_out_len=NEW_TOKENS, repetition_penalty=PENALTY, device="cpu")
    skipped = model.load_jax_params(jax_model.params)
    assert skipped == [], skipped
    return model


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_greedy_generate_matches_jax(flash):
    jmodel = _jax_model(flash)
    assert_greedy_generate_matches(jmodel, _port_model(jmodel, flash), _requests())


def assert_greedy_generate_matches(jmodel: JaxMSR3D, model: MSR3D, data, eos_bias: float = 0.0):
    """Greedy generate of both packages: equal tokens and texts, the
    first-token logits within ATOL, and every pick the port made won by
    more than MARGIN."""
    want = jmodel.generate(dict(data), use_beam=False)

    # record the logits of every pick the port makes
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
    got = model.generate(dict(data), use_beam=False)

    tokens = got["output_tokens"]
    assert tokens.shape == (2, NEW_TOKENS)
    np.testing.assert_array_equal(tokens, want["output_tokens"])
    assert got["output_text"] == want["output_text"]

    # the first-token logits against the JAX prefill's
    ids, attn = jmodel._encode_prompts(jmodel.build_text_prompt(data))
    ids, attn = jmodel._pad_to_bucket(ids, attn, side="left")
    jfirst = jmodel.network.apply(
        jmodel.params, jnp.asarray(ids), jnp.asarray(attn),
        **{k: jnp.asarray(v) for k, v in jmodel._scene_batch(data).items()},
        bos_id=jmodel.tokenizer.bos_id, max_cache_len=ids.shape[1] + 1,
        method=jmodel.network.prefill,
    )[0]
    np.testing.assert_allclose(steps[0].numpy(), np.asarray(jfirst), atol=ATOL)

    # every pick of a row still generating won by more than MARGIN
    seen = torch.zeros(steps[0].shape, dtype=torch.bool)
    finished = np.zeros(tokens.shape[0], bool)
    rows = torch.arange(tokens.shape[0])
    eos = model.tokenizer.eos_id
    for step, logits in enumerate(steps):
        logits = apply_repetition_penalty(logits, seen, jmodel.repetition_penalty).clone()
        logits[:, eos] += eos_bias
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        assert (gap[~finished] > MARGIN).all(), (step, gap)
        tok = torch.from_numpy(tokens[:, step]).long()
        seen[rows[~finished], tok[~finished]] = True
        finished |= tokens[:, step] == eos
    assert len(steps) >= 2  # the decode loop ran
    return tokens


@functools.lru_cache(maxsize=None)
def _image_model_params():
    """The weights of the image cases: the dense JAX model's own, initialised
    on a batch with images (so its tree holds the image encoder and
    ``llm_proj_img``), perturbed."""
    model = _jax_image_model()
    data = _image_requests("msr3d_imgs")
    ids, attn = model._encode_prompts(model.build_text_prompt(data))
    answers, answer_mask = model._encode_answers(["a chair", "yes"])
    batch = model._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=answers,
                 output_mask=answer_mask)
    return perturbed(model.init_params(batch), seed=6, std=0.05)


def _jax_image_model(**kw):
    tok = JaxByteTokenizer()
    llm = JaxLlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=jnp.float32, lora_rank=4)
    return JaxMSR3D(
        JaxMSR3DNetworkConfig(prompter=TINY_PROMPTER, llm=llm, backbone_name="convnext_test"),
        tok, scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS, repetition_penalty=PENALTY,
        **kw)


def _image_requests(kind):
    """MSR3D images (three a request, the second of request 1 and the last
    two of request 2 masked) or a LEO single view (request 2's masked)."""
    data = scene_inputs(3)
    data["msr3d_prompt"] = list(IMAGE_PROMPTS)
    images = image_inputs(13, [[1, 1, 0], [1, 0, 0]])
    if kind == "msr3d_imgs":
        data.update(images)
    else:
        data["img_fts"] = images["msr3d_imgs"][:, 0]
        data["img_masks"] = np.array([1, 0], np.int32)
    return data


def _image_models(**kw):
    jmodel = _jax_image_model(**kw)
    jmodel.params = _image_model_params()
    model = MSR3D(torch_network_config(jmodel.cfg), ByteTokenizer(),
                  scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS,
                  repetition_penalty=PENALTY, device="cpu", **kw)
    skipped = model.load_jax_params(jmodel.params)
    assert skipped == [], skipped
    return jmodel, model


@pytest.mark.parametrize("kind", ["msr3d_imgs", "img_fts"])
def test_greedy_generate_with_images_matches_jax(kind):
    jmodel, model = _image_models()
    data = _image_requests(kind)
    tokens = assert_greedy_generate_matches(jmodel, model, data)
    # the images reach the tokens: other pixels in the unmasked images
    # change them, other pixels in the masked ones do not
    other = dict(data)
    key = "msr3d_imgs" if kind == "msr3d_imgs" else "img_fts"
    masks = np.asarray(data["msr3d_img_masks" if kind == "msr3d_imgs" else "img_masks"], bool)
    pixels = np.array(data[key])
    pixels[~masks] += 1.0
    other[key] = pixels
    np.testing.assert_array_equal(model.generate(other, use_beam=False)["output_tokens"],
                                  tokens)
    pixels[masks] += 1.0
    assert not np.array_equal(model.generate(other, use_beam=False)["output_tokens"], tokens)


def test_greedy_eos_logit_bias_matches_jax():
    """``eos_logit_bias`` on the greedy path: the bias ends some rows early,
    the same way in both packages."""
    jmodel, model = _image_models(eos_logit_bias=EOS_BIAS)
    tokens = assert_greedy_generate_matches(jmodel, model, _image_requests("msr3d_imgs"),
                                            eos_bias=EOS_BIAS)
    assert (tokens[:, :-1] == model.tokenizer.eos_id).any()


def test_generate_refuses_what_is_not_ported():
    """Greedy and beam generate run on seeded weights (as chip_smoke.py's do),
    with images. The prefix-pool engines' forms run: a per-query prompt mask
    gives the logits of the same mask repeated for each row's queries, and a
    tuple of prompt segments (the prompt split in two) those of the whole
    segment; a tuple needs a per-query mask, as JAX asserts. Decode windows
    of T > 1 run (speculative and grouped-scene decoding); the ancestry beam
    step refuses them, as JAX's asserts. The pool engines are held to JAX's
    in tests/test_torch_serving_pool.py."""
    cfg = MSR3DNetworkConfig(
        prompter=torch_prompter_config(TINY_PROMPTER),
        llm=LlamaConfig.tiny(vocab_size=ByteTokenizer().vocab_size, dtype=torch.float32),
        backbone_name="convnext_test",
    )
    model = MSR3D(cfg, scene_token_len=SCENE_TOKENS, max_out_len=4, device="cpu")
    model.init_params(seed=0)  # the seeded weights chip_smoke.py runs on
    for use_beam in (False, True):
        tokens = model.generate(_image_requests("msr3d_imgs"),
                                use_beam=use_beam)["output_tokens"]
        assert tokens.shape == (2, 4) and ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all()

    llm = model.network.llm
    data = _requests()
    ids, attn = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                     side="left")
    with torch.no_grad():
        _, prompt_kv, prompt_mask, next_pos = model.network.prefill(
            torch.from_numpy(ids).long(), torch.from_numpy(attn), **model._scene_batch(data),
            bos_id=model.tokenizer.bos_id, max_cache_len=ids.shape[1] + 1)
    gen_kv = _make_cache(llm.cfg, 4, 3, "cpu")
    embeds = torch.randn((4, 1, cfg.llm.hidden_size), generator=torch.Generator().manual_seed(0))
    pos = next_pos.repeat_interleave(2)[:, None]
    gen_mask = torch.ones((4, 3), dtype=torch.bool)
    anc = torch.tensor([[0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1]], dtype=torch.int32)
    per_query = prompt_mask.repeat_interleave(2, dim=0)
    half = ids.shape[1] // 2
    halves = tuple({key: val[:, :, part] for key, val in prompt_kv.items()}
                   for part in (slice(0, half), slice(half, None)))

    def step(fn, prompt, mask, *extra):
        with torch.no_grad():  # a fresh generated segment a call: the step writes it
            return fn(embeds, pos, prompt, mask, {k: v.clone() for k, v in gen_kv.items()}, 0,
                      gen_mask, *extra)

    want = step(llm.decode_step_shared, prompt_kv, prompt_mask)
    assert torch.equal(step(llm.decode_step_shared, prompt_kv, per_query), want)
    want = step(llm.decode_step_beam_anc, prompt_kv, prompt_mask, anc, 2)
    torch.testing.assert_close(step(llm.decode_step_beam_anc, halves, per_query, anc, 2), want,
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="per-query prompt mask"):
        step(llm.decode_step_beam_anc, halves, prompt_mask, anc, 2)
    # windows of T > 1 are ported (tests/test_torch_speculative.py holds them
    # to JAX's); the ancestry beam step stays at one token a row, as JAX's
    with torch.no_grad():
        window = llm.decode_step_shared(torch.zeros((2, 2, cfg.llm.hidden_size)),
                                        next_pos[:, None] + torch.arange(2), prompt_kv,
                                        prompt_mask, _make_cache(llm.cfg, 2, 3, "cpu"), 0,
                                        torch.zeros((2, 3), dtype=torch.bool))
    assert window.shape == (2, 2, cfg.llm.vocab_size) and torch.isfinite(window).all()
    with pytest.raises(ValueError, match="T = 1"):
        llm.decode_step_beam_anc(torch.zeros((4, 2, cfg.llm.hidden_size)), pos, prompt_kv,
                                 prompt_mask, gen_kv, 0, gen_mask,
                                 torch.zeros((4, 3), dtype=torch.int32), 2)
