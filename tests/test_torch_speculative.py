"""Speculative (n-gram prompt-lookup) greedy decoding and decode windows of
T > 1 in the port, against the JAX package.

* ``ngram_propose`` equal to JAX's; ``ngram_speculative_decode`` on JAX's
  deterministic Markov "model" (``tests/test_speculative.py``: high
  acceptance, EOS inside a window, budgets) with tokens and stats equal to
  JAX's, and tokens equal to the plain greedy loop.
* The window KV write (``llama._cache_write``) equal to JAX's, fp32 and
  int8: a negative start drops the whole window, the part past the
  segment's end is dropped, a finished row writes nothing, a scalar start
  is clamped as ``dynamic_update_slice`` clamps it.
* A T > 1 ``decode_step_shared`` over the tiny model's prompt cache: the
  logits at every window position against JAX's, within 2e-5 (fp32 sums in
  other orders), with and without ``window_valid``, windows that start at
  -1 and that run past S_g; the written segment equal within the same.
* ``MSR3D.generate`` with ``spec_k``: tokens and ``spec_stats`` equal to
  JAX's, tokens equal to plain greedy. The continuous engine with
  ``spec_k``: tokens per request equal to JAX's engine and to ``spec_k=0``,
  ``steps_run`` (model calls) equal to JAX's. ``serve --spec-k`` over HTTP.

The models are those of ``tests/test_torch_serving.py`` with the repetition
penalty at 1.0, which speculative decoding needs, built and fed without
images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu import serving as jax_serving
from msr3d_tpu.models.llm import sampling as jax_sampling
from msr3d_tpu.models.llm.llama import _cache_write as jax_cache_write
from msr3d_tpu.models.llm.llama import quantize_kv_cache as jax_quantize_kv_cache
from msr3d_tpu_torch import serving
from msr3d_tpu_torch.models.llm import sampling
from msr3d_tpu_torch.models.llm.llama import _cache_write, _make_cache
from msr3d_tpu_torch.serve import create_frontend, parse_args
from msr3d_tpu_torch.serving_http import encode_scene_b64

from test_torch_serving import _to_torch, build_models, prompt_bucket, text_requests
from test_torch_serving_http import _post

LOGIT_ATOL = 2e-5
MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
    jmodel, model = build_models(images=False)
    jmodel.repetition_penalty = model.repetition_penalty = 1.0
    return jmodel, model


def test_ngram_propose_equals_jax():
    r = np.random.default_rng(0)
    b, length = 6, 30
    ctx = r.integers(0, 5, size=(b, length)).astype(np.int32)  # small vocab: many matches
    ctx[0] = np.tile([1, 2, 3], 10)
    ctx[1] = np.arange(length)  # no repeats: no match
    cur = np.array([30, 25, 12, 3, 1, 17], np.int32)
    for n, k in ((2, 3), (3, 4), (1, 2)):
        want = jax.jit(jax_sampling.ngram_propose, static_argnames=("ngram_n", "k", "pad_id"))(
            jnp.asarray(ctx), jnp.asarray(cur), ngram_n=n, k=k, pad_id=99)
        got = sampling.ngram_propose(torch.from_numpy(ctx).long(), torch.from_numpy(cur),
                                     ngram_n=n, k=k, pad_id=99)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"n={n} k={k}")


def _markov(v, jax_side):
    """JAX's fake model: next(tok) = (7 tok + 3) mod v, one-hot logits x 10."""
    if jax_side:
        return lambda t, po, c, ci, cm: (jax.nn.one_hot((t * 7 + 3) % v, v) * 10.0, c)
    return lambda t, po, c, ci, cm: torch.nn.functional.one_hot((t * 7 + 3) % v, v).float() * 10


@pytest.mark.parametrize("spec_k, ngram_n, eos", [(4, 2, 99), (3, 3, 99), (1, 2, 99),
                                                  (4, 2, 4)])
def test_markov_oracle_equals_jax(spec_k, ngram_n, eos):
    v, b, p, max_new = 13, 3, 6, 24
    r = np.random.default_rng(0)
    prompt = r.integers(0, v, size=(b, p)).astype(np.int32)
    first = np.eye(v, dtype=np.float32)[(prompt[:, -1] * 7 + 3) % v] * 10.0
    kw = dict(max_new_tokens=max_new, eos_id=eos, pad_id=0, prompt_len=p, spec_k=spec_k,
              ngram_n=ngram_n, return_stats=True)
    cmask = np.zeros((b, 64), bool)
    cmask[:, :p] = True
    caches = {"k": np.zeros((1, b, 64, 1, 1), np.float32)}
    want, wstats = jax_sampling.ngram_speculative_decode(
        _markov(v, True), {"k": jnp.asarray(caches["k"])}, jnp.asarray(cmask),
        jnp.full((b,), p, jnp.int32), jnp.asarray(first), jnp.asarray(prompt), **kw)
    got, stats = sampling.ngram_speculative_decode(
        _markov(v, False), {"k": torch.from_numpy(caches["k"])}, torch.from_numpy(cmask),
        torch.full((b,), p), torch.from_numpy(first), torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {k: int(x) for k, x in stats.items()} == {k: int(x) for k, x in wstats.items()}
    if eos < v:  # EOS in the cycle: rows end, inside a window, before drafts repeat
        assert (got.numpy()[:, :-1] == eos).any()
    else:
        assert int(stats["accepted_drafts"]) > 0
    greedy = sampling.greedy_decode_shared(
        _markov(v, False), torch.full((b,), p), torch.from_numpy(first),
        {"k": torch.zeros((1, b, max_new, 1, 1))}, max_new_tokens=max_new, eos_id=eos,
        pad_id=0)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_window_cache_write_equals_jax(int8):
    """Rows: a window inside, one at slot 0, one whose tail runs past S (the
    rest written), a negative start (dropped whole, as a finished
    speculative row or an idle slot), one ending exactly at S; then a
    window wider than S, and scalar starts (clamped to [0, S - T])."""
    r = np.random.default_rng(0)
    b, s, h, d, t = 5, 10, 2, 4, 3
    k = r.normal(size=(b, t, h, d)).astype(np.float32)
    v = r.normal(size=(b, t, h, d)).astype(np.float32)
    jcache = {"k": jnp.asarray(r.normal(size=(b, s, h, d)).astype(np.float32)),
              "v": jnp.asarray(r.normal(size=(b, s, h, d)).astype(np.float32))}
    if int8:
        jcache = jax_quantize_kv_cache(jcache)

    def check(kk, vv, index):
        want = jax_cache_write(jcache, jnp.asarray(kk), jnp.asarray(vv),
                               jnp.asarray(np.asarray(index, np.int32)) if isinstance(index, list)
                               else index)
        got = {key: _to_torch(val) for key, val in jcache.items()}
        idx = torch.tensor(index) if isinstance(index, list) else index
        _cache_write(got, torch.from_numpy(kk), torch.from_numpy(vv), idx)
        for key in want:
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          np.asarray(want[key], np.float32),
                                          err_msg=f"{key} at {index}")

    check(k, v, [4, 0, 8, -1, 7])
    check(k, v, [-1] * b)
    wide = r.normal(size=(b, s + 2, h, d)).astype(np.float32)
    check(wide, wide, [0, 3, -1, 9, 11])
    for start in (0, 5, 8, 20):
        check(k, v, start)


@pytest.fixture(scope="module")
def prompt_caches(models):
    """The prompt caches of both packages over 3 requests."""
    jmodel, model = models
    data = serving._collate(text_requests(3, seed=2))
    ids, attn = jmodel._pad_to_bucket(*jmodel._encode_prompts(jmodel.build_text_prompt(data)),
                                      side="left")
    net = jmodel.gen_network
    batch = {k: jnp.asarray(v) for k, v in jmodel._scene_batch(data).items()}
    jout = jax.jit(lambda p, i, a, bt: net.apply(
        p, i, a, **bt, bos_id=jmodel.tokenizer.bos_id, max_cache_len=ids.shape[1] + 1,
        method=net.prefill))(jmodel.params, jnp.asarray(ids), jnp.asarray(attn), batch)
    with torch.no_grad():
        pout = model.network.prefill(torch.from_numpy(ids).long(), torch.from_numpy(attn),
                                     **model._scene_batch(data), bos_id=model.tokenizer.bos_id,
                                     max_cache_len=ids.shape[1] + 1)
    return jout, pout


@pytest.mark.parametrize("window_valid", [False, True], ids=["spec", "window_valid"])
def test_window_decode_step_equals_jax(models, prompt_caches, window_valid):
    """T = 4 windows over a prompt cache at batch 3 and a generated segment
    of 6 slots holding earlier k/v: per-row starts 1, -1 (no write) and 4
    (the window runs 2 slots past S_g), accepted-context masks; with
    ``window_valid`` left-pad tokens hidden (row 0 pads 2, row 2 pads 1)."""
    jmodel, model = models
    (_, jkv, jmask, jpos), (_, pkv, pmask, ppos) = prompt_caches
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    r = np.random.default_rng(1)
    cfg = model.network.llm.cfg
    b, t, s_g = 3, 4, 6
    gen = {key: (r.normal(size=val.shape) * 0.5).astype(np.float32)
           for key, val in _make_cache(cfg, b, s_g, "cpu").items()}
    tokens = r.integers(5, 200, size=(b, t)).astype(np.int32)
    start = np.array([1, -1, 4], np.int32)
    gen_mask = np.arange(s_g)[None, :] < np.array([1, 3, 4])[:, None]
    positions = (np.asarray(jpos)[:, None] + np.arange(t)).astype(np.int32)
    wv = np.ones((b, t), bool)
    if window_valid:
        wv[0, :2] = False
        wv[2, :1] = False
    net = jmodel.gen_network
    jlogits, jgen = jax.jit(lambda *a: net.apply(jmodel.params, *a,
                                                 method=net.decode_step_shared))(
        jnp.asarray(tokens), jnp.asarray(positions), jkv, jmask,
        {key: jnp.asarray(val) for key, val in gen.items()}, jnp.asarray(start),
        jnp.asarray(gen_mask), jnp.asarray(wv) if window_valid else None)
    pgen = {key: torch.from_numpy(val) for key, val in gen.items()}
    with torch.no_grad():
        plogits = model.network.decode_step_shared(
            torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(), pkv, pmask, pgen,
            torch.from_numpy(start).long(), torch.from_numpy(gen_mask),
            torch.from_numpy(wv) if window_valid else None)
    assert plogits.shape == (b, t, cfg.vocab_size)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    for key in jgen:
        np.testing.assert_allclose(pgen[key].numpy(), np.asarray(jgen[key]), atol=LOGIT_ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(pgen["k"][:, 1].numpy(), gen["k"][:, 1])  # row 1: no write


def test_spec_generate_equals_jax_and_greedy(models):
    """Prompts that repeat a phrase, so that drafts are found; the
    generated slots start at 0, as JAX's spec path puts them."""
    jmodel, model = models
    spec_k, ngram = 3, 2
    reqs = text_requests(3, seed=4)
    for i, q in enumerate(reqs):
        q["msr3d_prompt"] = q["msr3d_prompt"] + " red chair red chair red" * (i + 1)
    data = serving._collate(reqs)
    plain = model.generate(dict(data), use_beam=False, max_new_tokens=MAX_NEW)["output_tokens"]
    outs = []
    for m in (jmodel, model):
        m.spec_k, m.spec_ngram = spec_k, ngram
        try:
            outs.append(m.generate(dict(data), use_beam=False, max_new_tokens=MAX_NEW))
        finally:
            m.spec_k = 0
    want, got = outs
    np.testing.assert_array_equal(got["output_tokens"], np.asarray(want["output_tokens"]))
    assert got["output_text"] == want["output_text"]
    assert got["spec_stats"] == want["spec_stats"]
    assert got["spec_stats"]["emitted"] == 3 * MAX_NEW or (plain == model.tokenizer.eos_id).any()
    np.testing.assert_array_equal(got["output_tokens"], plain)


def test_engine_spec_equals_jax_and_plain(models):
    """Mixed budgets, lookahead 1 and 2: tokens equal JAX's speculative
    engine and the port's ``spec_k=0`` engine, ``steps_run`` (verify calls)
    equal JAX's."""
    jmodel, model = models
    reqs = text_requests(7, seed=6)
    budgets = [1, 3, 8, 5, 2, 8, 4]
    kw = dict(num_slots=3, refill_group=1, chunk_steps=3, max_new_tokens=MAX_NEW,
              prompt_len=prompt_bucket(model, reqs))
    je = jax_serving.ContinuousBatchingServer(jmodel, spec_k=3, spec_ngram=2, **kw)
    want = je.run(reqs, budgets=budgets)
    plain = serving.ContinuousBatchingServer(model, **kw).run(reqs, budgets=budgets)
    for lookahead in (1, 2):
        pe = serving.ContinuousBatchingServer(model, spec_k=3, spec_ngram=2,
                                              lookahead=lookahead, **kw)
        got = pe.run(reqs, budgets=budgets)
        if lookahead == 1:
            assert pe.steps_run == je.steps_run > 0
        for g, w, p in zip(got, want, plain):
            np.testing.assert_array_equal(g.output_tokens, np.asarray(w.output_tokens))
            np.testing.assert_array_equal(g.output_tokens, p.output_tokens)
    with pytest.raises(ValueError, match="repetition_penalty"):
        model.repetition_penalty = 1.5
        try:
            serving.ContinuousBatchingServer(model, spec_k=2, **kw)
        finally:
            model.repetition_penalty = 1.0


def test_serve_spec_k_over_http():
    """``serve --spec-k 2`` on the debug config (random weights, penalty
    1.0): two answers over HTTP equal a ``spec_k=0`` engine's on the same
    model; at the config's penalty 3.0 it refuses, as JAX's engine does."""
    argv = ["--config", "configs/debug_synthetic.yaml", "--device", "cpu", "--random-init",
            "--port", "0", "--slots", "2", "--refill-group", "1", "--chunk-steps", "2",
            "--max-new-tokens", "6"]
    with pytest.raises(ValueError, match="repetition_penalty"):
        create_frontend(parse_args(argv + ["--spec-k", "2"]))
    fe = create_frontend(parse_args(argv + ["--spec-k", "2", "eval_repetition_penalty=1.0"]))
    assert fe.engine.spec_k == 2
    reqs = text_requests(2, seed=9)
    for q in reqs:
        q["msr3d_prompt"] = "scene: 景 USER: what is here? is it a chair? ASSISTANT:"
    with fe:
        answers = [_post(fe.port, {"prompt": q["msr3d_prompt"], "scene_b64": encode_scene_b64(q)},
                         timeout=300) for q in reqs]
    model = fe.engine.model
    plain = serving.ContinuousBatchingServer(model, num_slots=2, refill_group=1, chunk_steps=2,
                                             max_new_tokens=6).run(reqs)
    for (status, payload), p in zip(answers, plain):
        assert status == 200
        assert payload["tokens"] == p.output_tokens.tolist()
