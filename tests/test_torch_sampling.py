"""Sampled decoding of the port against the JAX package's: HF's warper chain
(``sample_filter_logits``), the per-row sampled pick, the sampling greedy
loop, ``MSR3D.generate`` with ``do_sample`` and the continuous engine's
per-request keys.

The port draws JAX's threefry stream (``prng.py``, held bit for bit in
``tests/test_torch_prng.py``), so tokens must be equal. The warpers return
either a logit unchanged or -inf, so their outputs must be equal too (the
temperature multiplies by the fp32 reciprocal that XLA folds JAX's divide
into); the top-p threshold is a decision on an fp32 cumsum, and the inputs
here keep every row's mass before a token at least 1e-4 from ``top_p``,
well past fp32 rounding of the sum, so the decisions must agree. The
models are those of ``tests/test_torch_serving.py`` (the tiny fp32 model,
the port holding the JAX weights, repetition penalty 1.5), built and fed
without images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu import serving as jax_serving
from msr3d_tpu.models.llm import sampling as jax_sampling
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu_torch import serving
from msr3d_tpu_torch.models.llm import prng, sampling
from msr3d_tpu_torch.models.msr3d import MSR3D

from test_torch_serving import build_models, prompt_bucket, text_requests

MAX_NEW = 8
SAMPLE_KW = dict(temperature=1.3, top_k=20, top_p=0.9)
_filter = jax.jit(jax_sampling.sample_filter_logits, static_argnames=("temperature", "top_k",
                                                                      "top_p"))


@pytest.fixture(scope="module")
def models():
    return build_models(images=False)


def _batch(n: int, seed: int):
    return serving._collate(text_requests(n, seed))


def _set_sampling(models, **kw):
    for m in models:
        m.do_sample = True
        m._sample_calls = 0
        for key, val in {**SAMPLE_KW, "sample_seed": 0, **kw}.items():
            setattr(m, key, val)


@pytest.fixture
def sampling_models(models):
    saved = [{k: getattr(m, k) for k in ("do_sample", "temperature", "top_k", "top_p",
                                         "sample_seed", "_sample_calls")} for m in models]
    yield models
    for m, s in zip(models, saved):
        for key, val in s.items():
            setattr(m, key, val)


def _tie_logits():
    """Rows whose top-k and top-p thresholds fall on tied values."""
    r = np.random.default_rng(3)
    logits = r.normal(size=(4, 29)).astype(np.float32)
    logits[0, :6] = 2.0  # six-way tie at the top
    logits[1, [3, 9, 17]] = logits[1].max() + 1.0  # a three-way tie at the 3rd place
    logits[2, :] = 0.0  # all equal
    logits[3, [0, 1]] = [5.0, 5.0]
    return logits


FILTER_CASES = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.9),
    "combined": dict(temperature=1.3, top_k=8, top_p=0.85),
    "top_k_1": dict(top_k=1),
    "top_k_over_vocab": dict(top_k=100),
    "top_p_keeps_argmax": dict(top_p=0.01),
    "ties_top_k": dict(top_k=3, ties=True),
    "ties_top_p": dict(top_p=0.5, ties=True),
}


def _top_p_margin(logits, top_p):
    """The smallest |mass before a token - top_p| over the sorted rows."""
    srt = -np.sort(-logits.astype(np.float64), axis=-1)
    e = np.exp(srt - srt[:, :1])
    probs = e / e.sum(axis=-1, keepdims=True)
    return np.abs(np.cumsum(probs, axis=-1) - probs - top_p).min()


@pytest.mark.parametrize("name", list(FILTER_CASES))
def test_filter_logits_equals_jax(name):
    kw = dict(FILTER_CASES[name])
    if kw.pop("ties", False):
        logits = _tie_logits()
    else:
        logits = (np.random.default_rng(0).normal(size=(6, 37)) * 3).astype(np.float32)
        logits[0, 4] = -np.inf  # a min-length EOS mask
    if kw.get("top_p", 1.0) < 1.0 and name != "ties_top_p":
        assert _top_p_margin(logits / kw.get("temperature", 1.0), kw["top_p"]) > 1e-4
    want = np.asarray(_filter(jnp.asarray(logits), **kw))
    got = sampling.sample_filter_logits(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if kw.get("top_k") == 1 or kw.get("top_p") == 0.01:
        assert (np.isfinite(got).sum(axis=-1) == 1).all()
        np.testing.assert_array_equal(got.argmax(-1), logits.argmax(-1))


@pytest.mark.parametrize("bias, min_length", [(0.0, 1), (2.0, 3)])
def test_pick_next_rows_sampled_equals_jax(bias, min_length):
    r = np.random.default_rng(1)
    b, vocab, eos = 6, 50, 2
    logits = r.normal(size=(b, vocab)).astype(np.float32) * 2
    seen = r.random((b, vocab)) < 0.3
    steps = np.array([0, 1, 2, 3, 5, 9], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(4), b)
    kw = dict(eos_id=eos, repetition_penalty=1.5, eos_logit_bias=bias, min_length=min_length,
              **SAMPLE_KW)
    want = jax.jit(lambda *a: jax_sampling.pick_next_rows_sampled(*a, **kw))(
        jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(steps), keys)
    got = sampling.pick_next_rows_sampled(
        torch.from_numpy(logits), torch.from_numpy(seen), torch.from_numpy(steps),
        torch.from_numpy(np.asarray(keys).astype(np.int64)), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _table_step(table, jax_side: bool):
    """A cache-free decode step: the next logits are row ``tok`` of a fixed
    (V, V) table."""
    if jax_side:
        tab = jnp.asarray(table)
        return lambda tok, pos, gkv, gidx, gmask: (tab[tok], gkv)
    tab = torch.from_numpy(table)
    return lambda tok, pos, gkv, gidx, gmask: tab[tok]


@pytest.mark.parametrize("seed", [0, 3, 12])
def test_sampling_loop_equals_jax(seed):
    """``greedy_decode_shared`` with ``sample_key`` on a synthetic step: one
    key split a step, one (B, V) draw a step, EOS padding, the penalty."""
    r = np.random.default_rng(seed)
    b, vocab, new, eos = 5, 40, 12, 3
    table = (r.normal(size=(vocab, vocab)) * 2).astype(np.float32)
    table[:, eos] -= 2.0
    first = (r.normal(size=(b, vocab)) * 2).astype(np.float32)
    kw = dict(max_new_tokens=new, eos_id=eos, pad_id=eos, repetition_penalty=1.3,
              eos_logit_bias=0.5, **SAMPLE_KW)
    gkv = {"k": np.zeros((1, b, new, 1, 1), np.float32)}
    want = jax.jit(lambda f, key: jax_sampling.greedy_decode_shared(
        _table_step(table, True), jnp.zeros(b, jnp.int32), f,
        {"k": jnp.asarray(gkv["k"])}, sample_key=key, **kw))(
        jnp.asarray(first), jax.random.PRNGKey(seed))
    got = sampling.greedy_decode_shared(
        _table_step(table, False), torch.zeros(b, dtype=torch.long), torch.from_numpy(first),
        {"k": torch.from_numpy(gkv["k"])}, sample_key=prng.prng_key(seed), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(map(tuple, got.numpy()))) > 1


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sampled_generate_equals_jax(sampling_models, seed):
    """Two successive calls at one seed: each call's key is
    ``fold_in(PRNGKey(sample_seed), call count)``, so the calls differ and
    each equals JAX's; resetting the count repeats the first."""
    jmodel, model = sampling_models
    _set_sampling(sampling_models, sample_seed=seed)
    data = _batch(3, seed)
    runs = []
    for m in (jmodel, model):
        calls = [np.asarray(m.generate(dict(data), use_beam=False,
                                       max_new_tokens=MAX_NEW)["output_tokens"])
                 for _ in range(2)]
        runs.append(calls)
    for want, got in zip(*runs):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(runs[1][0], runs[1][1])
    model._sample_calls = 0
    again = model.generate(dict(data), use_beam=False, max_new_tokens=MAX_NEW)["output_tokens"]
    np.testing.assert_array_equal(again, runs[1][0])


def test_top_k1_equals_greedy(sampling_models):
    _, model = sampling_models
    data = _batch(2, 5)
    greedy = model.generate(dict(data), use_beam=False, max_new_tokens=6)["output_tokens"]
    _set_sampling(sampling_models, top_k=1, top_p=1.0)
    sampled = model.generate(dict(data), use_beam=False, max_new_tokens=6)["output_tokens"]
    np.testing.assert_array_equal(sampled, greedy)


def test_sampling_rejects_beam_and_spec(sampling_models):
    """As JAX's: sampling needs the greedy path, and excludes spec_k, at
    construction, in ``generate`` and in the engines."""
    jmodel, model = sampling_models
    _set_sampling(sampling_models)
    data = _batch(2, 0)
    for m in (jmodel, model):
        with pytest.raises(ValueError, match="greedy path"):
            m.generate(dict(data), max_new_tokens=4)  # num_beams 2
    for cls, m in ((JaxMSR3D, jmodel), (MSR3D, model)):
        kw = dict(device="cpu") if cls is MSR3D else {}
        with pytest.raises(ValueError, match="mutually exclusive"):
            cls(m.cfg, m.tokenizer, do_sample=True, spec_k=2, repetition_penalty=1.0, **kw)
    with pytest.raises(ValueError, match="greedy engine"):
        serving.ContinuousBeamBatchingServer(model, num_slots=2, refill_group=1)
    model.repetition_penalty = 1.0
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            serving.ContinuousBatchingServer(model, num_slots=2, refill_group=1, spec_k=2)
    finally:
        model.repetition_penalty = jmodel.repetition_penalty


def test_engine_sampled_equals_jax_and_slot_invariant(sampling_models):
    """The continuous engine samples each request from ``fold_in(fold_in(
    PRNGKey(sample_seed), request id), row step)``: tokens equal JAX's
    engine request by request, at mixed budgets and under lookahead, and do
    not change with the slot count or the refill group."""
    jmodel, model = sampling_models
    _set_sampling(sampling_models, sample_seed=9)
    reqs = text_requests(7, seed=8)
    budgets = [3, 8, 1, 5, 8, 2, 6]
    kw = dict(num_slots=3, refill_group=1, chunk_steps=3, max_new_tokens=MAX_NEW,
              prompt_len=prompt_bucket(model, reqs))
    je = jax_serving.ContinuousBatchingServer(jmodel, **kw)
    want = je.run(reqs, budgets=budgets)
    pe = serving.ContinuousBatchingServer(model, **kw)
    got = pe.run(reqs, budgets=budgets)
    assert pe.steps_run == je.steps_run > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output_tokens, np.asarray(w.output_tokens))
    other = serving.ContinuousBatchingServer(model, **dict(kw, num_slots=4, refill_group=2,
                                                           lookahead=0))
    for g, o in zip(got, other.run(reqs, budgets=budgets)):
        np.testing.assert_array_equal(o.output_tokens, g.output_tokens)
