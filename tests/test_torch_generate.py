"""The whole slice: greedy ``MSR3D.generate`` of the port against the JAX
package's, on a tiny fp32 config (the ``tests/test_msr3d.py`` prompter,
``LlamaConfig.tiny`` with LoRA), requests without images.

Both models hold the same weights: the JAX model's own, perturbed with
numpy noise (LoRA B included, so the adapters take part) and converted
with ``msr3d_tpu_torch.convert``. The greedy tokens must be equal. Since
argmax can agree by luck where two logits nearly tie, the test also
asserts that every pick the port made won by more than ``MARGIN`` over the
runner-up, well above the fp32 disagreement of the two frameworks (the
first-token logits are compared at 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu_torch.models.llm.llama import LlamaConfig
from msr3d_tpu_torch.models.llm.sampling import apply_repetition_penalty
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig

from torch_parity_utils import (
    TINY_PROMPTER,
    perturbed,
    scene_inputs,
    torch_llama_config,
    torch_prompter_config,
)

NEW_TOKENS, SCENE_TOKENS, PENALTY = 12, 6, 1.5
MARGIN = 1e-4  # least top-1 over top-2 logit gap of each pick
ATOL = 1e-5


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
    assert all("sem_head" in k for k in skipped), skipped
    return model


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_greedy_generate_matches_jax(flash):
    jmodel = _jax_model(flash)
    model = _port_model(jmodel, flash)
    want = jmodel.generate(_requests(), use_beam=False)

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
    got = model.generate(_requests(), use_beam=False)

    tokens = got["output_tokens"]
    assert tokens.shape == (2, NEW_TOKENS)
    np.testing.assert_array_equal(tokens, want["output_tokens"])
    assert got["output_text"] == want["output_text"]

    # the first-token logits against the JAX prefill's
    data = _requests()
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
        top2 = apply_repetition_penalty(logits, seen, PENALTY).topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        assert (gap[~finished] > MARGIN).all(), (step, gap)
        tok = torch.from_numpy(tokens[:, step]).long()
        seen[rows[~finished], tok[~finished]] = True
        finished |= tokens[:, step] == eos
    assert len(steps) >= 2  # the decode loop ran


def test_generate_refuses_what_is_not_ported():
    cfg = MSR3DNetworkConfig(
        prompter=torch_prompter_config(TINY_PROMPTER),
        llm=LlamaConfig.tiny(vocab_size=ByteTokenizer().vocab_size, dtype=torch.float32),
    )
    model = MSR3D(cfg, scene_token_len=SCENE_TOKENS, max_out_len=4, device="cpu")
    model.init_params(seed=0)  # the seeded weights chip_smoke.py runs on
    tokens = model.generate(_requests(), use_beam=False)["output_tokens"]
    assert tokens.shape == (2, 4) and ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all()
    with pytest.raises(NotImplementedError, match="beam"):
        model.generate(_requests(), use_beam=True)
    data = _requests()
    data["msr3d_imgs"] = np.zeros((2, 1, 32, 32, 3), np.float32)
    with pytest.raises(NotImplementedError, match="images"):
        model.generate(data, use_beam=False)
