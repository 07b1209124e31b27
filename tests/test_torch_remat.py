"""Activation checkpointing (``remat``, ``remat_policy``) of the port's LLM
against the JAX package's ``nn.remat`` blocks.

A policy changes what the backward keeps and what it recomputes, never the
arithmetic: the port with remat is bit-equal to the port without it, and
both are held to JAX's remat at the tolerances of
``tests/test_remat_policy.py`` (fp32, sums in other orders). The
recompute itself is counted: the backward's ``aten.mm`` calls show which
projections each policy reruns, and the tensors each keeps are counted on
both sides. Generation under remat and the trainer's steps under ``dots``
are held in ``tests/test_torch_train_options.py``. One JAX init serves the
file; the JAX side runs jitted.
"""

import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch.utils._python_dispatch import TorchDispatchMode

import msr3d_tpu_torch.models.llm.llama as port_llama
import msr3d_tpu_torch.ops.flash_attention as fa
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.models.llm.llama import resolve_remat_policy
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel

from torch_parity_utils import (
    one_torch_thread,
    perturbed,
    to_numpy_tree,
    torch_llama_config,
)

POLICIES = ("full", "dots", "residuals")
B, T = 2, 16
ANSWER_START = 10  # logits for positions 9 .. T-2, the answer window
# tests/test_remat_policy.py's tolerances: fp32 on both sides, other
# summation orders; the loss is a mean of squares of order 1
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


# ---------------------------------------------------------------------------
# the LLM: loss and LoRA gradients under each policy
# ---------------------------------------------------------------------------


def _jax_llama_cfg(**kw):
    return JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4, **kw)


def _inputs():
    r = np.random.default_rng(11)
    embeds = (r.normal(size=(B, T, 64)) * 0.5).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :5] = 0  # a left-padded row
    return embeds, mask


@functools.lru_cache(maxsize=None)
def _llama_variables():
    """The file's one JAX init: the tiny LLM's weights, perturbed so that
    LoRA B is nonzero (remat, its policy and flash create the same tree)."""
    embeds, mask = _inputs()
    variables = JaxLlamaModel(_jax_llama_cfg()).init(
        jax.random.key(2), jnp.asarray(embeds), jnp.asarray(mask),
        method=lambda m, e, a: (m.embed_tokens(jnp.zeros((1, 1), jnp.int32)), m(e, a)))
    return to_numpy_tree(perturbed(variables, seed=5, std=0.05))


def _split_lora(params):
    flat = flatten_dict(params)
    lora = {k: v for k, v in flat.items() if k[-1].startswith("lora")}
    return lora, {k: v for k, v in flat.items() if k not in lora}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_lora_grads(jcfg):
    """Jitted ``mean(logits²)`` and its gradient in the LoRA leaves, over the
    whole sequence and over the answer window, in one program."""
    model = JaxLlamaModel(jcfg)
    embeds, mask = map(jnp.asarray, _inputs())
    lora, rest = _split_lora(_llama_variables()["params"])

    @jax.jit
    def values_and_grads(lora_leaves):
        def loss(leaves, answer_start):
            params = unflatten_dict({**rest, **leaves})
            logits = model.apply({"params": params}, embeds, mask,
                                 answer_start=answer_start)[0]
            return jnp.mean(logits.astype(jnp.float32) ** 2)
        return [jax.value_and_grad(loss)(lora_leaves, start) for start in (None, ANSWER_START)]

    out = {}
    for window, (loss, grads) in zip((False, True), values_and_grads(lora)):
        state = jax_to_torch_state_dict({"params": unflatten_dict(to_numpy_tree(grads))})[0]
        out[window] = (float(loss), state)
    return out


def _port_llama(cfg: LlamaConfig, variables) -> LlamaModel:
    model = LlamaModel(cfg)
    state, skipped = jax_to_torch_state_dict(to_numpy_tree(variables))
    assert skipped == []
    model.load_state_dict(state, strict=True)
    return model


def _port_loss_and_lora_grads(model: LlamaModel, window: bool):
    embeds, mask = map(torch.from_numpy, _inputs())
    logits = model(embeds, mask, answer_start=ANSWER_START if window else None)
    loss = logits.float().square().mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if "lora_" in n}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@functools.lru_cache(maxsize=None)
def _port_without_remat(flash: bool, window: bool):
    jcfg = _jax_llama_cfg(flash_attention=flash)
    return _port_loss_and_lora_grads(_port_llama(torch_llama_config(jcfg),
                                                 _llama_variables()), window)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_and_the_port_without_it(policy, flash):
    """Each policy, flash or dense, over the whole sequence and over the
    answer window: the loss and the LoRA gradients equal the port's without
    remat bit for bit, and JAX's remat at the stated tolerance: dense, under
    the same policy; flash, under ``full`` (one Pallas interpret-mode
    program for the three: JAX's policies change no value,
    ``tests/test_remat_policy.py``). The flash route's forward wrapper
    (kernel K2f on the card) runs twice a layer, the second time in the
    recompute; the backward wrappers (K2dq, K2dkv) once."""
    jcfg = _jax_llama_cfg(flash_attention=flash, remat=True, remat_policy=policy)
    want = _jax_loss_and_lora_grads(dataclasses.replace(jcfg, remat_policy="full")
                                    if flash else jcfg)
    layers = jcfg.num_hidden_layers
    for window in (False, True):
        model = _port_llama(torch_llama_config(jcfg), _llama_variables())
        assert (model.cfg.remat, model.cfg.remat_policy) == (True, policy)
        calls = {"fwd": 0, "dq": 0}
        forward, bwd_dq = fa.flash_attention, fa.flash_attention_bwd_dq

        def counted_forward(*args, **kw):
            calls["fwd"] += 1
            return forward(*args, **kw)

        def counted_dq(*args, **kw):
            calls["dq"] += 1
            return bwd_dq(*args, **kw)

        with _patched(fa, flash_attention=counted_forward, flash_attention_bwd_dq=counted_dq):
            loss, grads = _port_loss_and_lora_grads(model, window)
        assert calls == ({"fwd": 2 * layers, "dq": layers} if flash else {"fwd": 0, "dq": 0})

        base_loss, base_grads = _port_without_remat(flash, window)
        want_loss, want_grads = want[window]
        assert torch.equal(loss, base_loss), window
        assert set(grads) == set(base_grads) == set(want_grads)
        assert len(grads) == 2 * 7 * layers
        for name, grad in grads.items():
            assert torch.equal(grad, base_grads[name]), (window, name)
            np.testing.assert_allclose(grad.numpy(), want_grads[name].numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{window} {name}")
        np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL, err_msg=str(window))


@contextlib.contextmanager
def _patched(module, **attrs):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


# ---------------------------------------------------------------------------
# what each policy recomputes and keeps
# ---------------------------------------------------------------------------


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _jax_bth_residuals(policy):
    """The (B, T, H) tensors JAX's backward keeps under ``policy`` (None: no
    remat), read from ``jax.ad_checkpoint.print_saved_residuals``."""
    jcfg = _jax_llama_cfg(remat=policy is not None, remat_policy=policy or "full")
    model = JaxLlamaModel(jcfg)
    embeds, mask = map(jnp.asarray, _inputs())
    lora, rest = _split_lora(_llama_variables()["params"])

    def loss(leaves, x):
        logits = model.apply({"params": unflatten_dict({**rest, **leaves})}, x, mask)[0]
        return jnp.mean(logits ** 2)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax.ad_checkpoint.print_saved_residuals(loss, lora, embeds)
    return len(re.findall(rf"f32\[{B},{T},64\]", out.getvalue()))


def test_policies_recompute_and_keep_what_jax_keeps():
    """Counted on the backward's ``aten.mm`` calls: ``dots`` reruns no
    product (the backward's mm count equals the run without remat), ``full``
    and ``residuals`` rerun every base projection of every layer (plus LoRA
    products; the recompute stops at the last tensor the backward reads).
    Kept tensors: ``full`` keeps the block input, ``residuals`` the block
    input and ``attn_out`` (one (B, T, H) tensor a layer more than
    ``full``), as JAX's backward keeps them: JAX's policy names ``mlp_out``
    too, but no backward op reads it."""
    cfg = torch_llama_config(_jax_llama_cfg())
    layers = cfg.num_hidden_layers
    embeds, mask = map(torch.from_numpy, _inputs())
    counts, kept = {}, {}
    for policy in (None, *POLICIES):
        model = _port_llama(dataclasses.replace(cfg, remat=policy is not None,
                                                remat_policy=policy or "full"),
                            _llama_variables())
        inputs = []
        real_checkpoint = port_llama.checkpoint

        def recording_checkpoint(fn, *args, **kw):
            inputs.extend(a for a in args if isinstance(a, torch.Tensor)
                          and a.shape == (B, T, cfg.hidden_size))
            return real_checkpoint(fn, *args, **kw)

        forward = _CountMM()
        with forward, _patched(port_llama, checkpoint=recording_checkpoint):
            loss = model(embeds, mask).float().square().mean()
        backward = _CountMM()
        with backward:
            loss.backward()
        counts[policy] = (forward.mm, backward.mm)
        kept[policy] = len({a.data_ptr() for a in inputs})
    fwd_mm, bwd_mm = counts[None]
    per_layer = (fwd_mm - 1) // layers  # the lm_head's product is outside the blocks
    assert per_layer == 7 + 2 * 7  # seven base projections, two LoRA products each
    assert counts["dots"][1] == bwd_mm
    for policy in ("full", "residuals"):
        assert bwd_mm + layers * 7 <= counts[policy][1] < bwd_mm + layers * per_layer + 1, policy
    assert (kept["full"], kept["dots"], kept["residuals"]) == (layers, layers, 2 * layers)

    jax_kept = {policy: _jax_bth_residuals(policy) for policy in POLICIES}
    assert jax_kept["residuals"] - jax_kept["full"] == layers
    assert jax_kept["dots"] > jax_kept["residuals"]  # dots also keeps the projections


def test_remat_refusals_match_jax():
    """An unknown policy raises ``ValueError`` naming ``remat_policy``, as
    ``resolve_remat_policy`` does. remat with LoRA dropout cannot be traced
    by JAX (``deterministic`` becomes a tracer under ``nn.remat``), so the
    port's config refuses it."""
    with pytest.raises(ValueError, match="remat_policy"):
        resolve_remat_policy("bogus")
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaConfig.tiny(remat=True, remat_policy="bogus")
    embeds, mask = map(jnp.asarray, _inputs())
    jcfg = _jax_llama_cfg(remat=True, lora_dropout=0.1)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        JaxLlamaModel(jcfg).init(jax.random.key(0), embeds, mask)
    with pytest.raises(ValueError, match="TracerBoolConversionError"):
        torch_llama_config(jcfg)
    # without LoRA there is no LoRA dropout to trace
    assert LlamaConfig.tiny(remat=True, lora_dropout=0.1).remat
