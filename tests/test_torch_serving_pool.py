"""The prefix-pool serving engines of the port against the JAX package's:
the decode steps over a batch-1 block pool with a visibility row per query
and over a tuple of segments (``llama.py``), the greedy, speculative and
beam pool engines (``serving.py``), the HTTP front end's per-segment
validation and the quantized configurations.

* Decode steps: ``decode_step_shared`` over the pool as a (1, G·S_pre)
  segment with a per-slot mask and a question window at the head of each
  slot's generated segment, and ``decode_step_beam_anc`` over the tuple
  (pool, per-slot suffixes) with a per-query mask, against JAX's within
  1e-5 on fp32 and int8 caches.
* Greedy engine: every scenario of ``tests/test_serving_pool.py``
  (interleaved scenes, sharing within a refill group, LRU eviction and a
  scene's return, resident reuse, head-of-line blocking, prompts without a
  placeholder, budgets, a ``group_key`` shared by other prompts or other
  scenes, a pool too small for the mix, the refusals); tokens,
  ``steps_run`` and ``prefix_prefills`` equal JAX's engine, and tokens the
  port's own ``generate``.
* Speculative: the spec pool's tokens equal the T = 1 pool's.
* Beam: tokens equal JAX's beam pool and a batch-1 beam ``generate``, with
  eviction and budgets.
* The HTTP front end with ``_pool_split`` and a 400 for a long suffix; int8
  weights and the int8 KV cache against the port's ``generate`` on the same
  quantized model (as JAX's ``test_pool_engine_quantized_config``).

On the tiny fp32 model of ``tests/test_torch_serving.py`` (the port holding
the JAX weights); one JAX greedy engine serves every greedy scenario and one
beam engine both beam ones. ``eval_engine_opts.prefix_pool`` is in ``tests/test_torch_eval.py``, on
that file's trainers; ``serve --engine pool|pool-beam`` in
``tests/test_torch_serving_http.py::test_serve_cli_end_to_end``."""

import dataclasses
import functools
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu import serving as jax_serving
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu_torch import serving
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaModel
from msr3d_tpu_torch.models.llm.tokenizer import IMAGE_PLACEHOLDER, SCENE_PLACEHOLDER
from msr3d_tpu_torch.models.msr3d import MSR3D
from msr3d_tpu_torch.serving_http import ServingFrontend, encode_scene_b64

from test_torch_beam import _gen_cache
from test_torch_serving import _KEYS, build_models, collate, make_requests
from torch_parity_utils import (
    one_torch_thread,
    perturbed,
    to_numpy_tree,
    torch_llama_config,
    torch_network_config,
)

ATOL = 1e-5
MAX_NEW = 8
QUESTIONS = ["What do you see?", "Is the chair red?",
             "How many lamps are there, roughly speaking?", "Go north?"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def models():
    return build_models()


# ---------------------------------------------------------------------------
# The decode steps over the pool
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _llama_variables():
    """The tiny JAX Llama's variables (fp32, LoRA, GQA), perturbed; a KV
    cache's dtype does not change them."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4, num_key_value_heads=2)
    jmod = JaxLlamaModel(jcfg)
    embeds, mask = jnp.zeros((1, 3, jcfg.hidden_size)), jnp.ones((1, 3), jnp.int32)
    return perturbed(jax.jit(lambda e, a: jmod.init(
        jax.random.key(5), e, a,
        method=lambda m, e_, a_: (m.embed_tokens(jnp.zeros((1, 1), jnp.int32)), m(e_, a_)),
    ))(embeds, mask), seed=9, std=0.02)


def _llama_pair(kv_quantize: bool):
    """The tiny JAX Llama on an fp32 or int8 KV cache, and the port's holding
    the same weights."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4, num_key_value_heads=2,
                               kv_quantize=kv_quantize)
    jmod, variables = JaxLlamaModel(jcfg), _llama_variables()
    tmod = LlamaModel(torch_llama_config(jcfg)).eval()
    tmod.load_state_dict(jax_to_torch_state_dict(to_numpy_tree(variables))[0], strict=True)
    return jcfg, jmod, variables, tmod


def _flat(cache):
    """(L, N, S, ...) → the batch-1 (L, 1, N·S, ...) segment."""
    return {key: val.reshape((val.shape[0], 1, -1) + tuple(val.shape[3:]))
            for key, val in cache.items()}


@pytest.mark.parametrize("kv_quantize", [False, True], ids=["fp32-cache", "int8-cache"])
def test_pool_decode_steps_match_jax(kv_quantize):
    """G = 3 blocks of S_pre = 7 (left-padded masks), B = 4 slots on blocks
    [2, 0, 2, 1] at their own depths. Greedy: one token a slot over the pool
    as a batch-1 segment with a per-slot mask, the question window (W = 5)
    at the head of the generated segment. Beam (K = 2): the tuple (pool,
    per-slot suffixes), a mask a query over both, a random ancestry map.
    Logits within 1e-5, the step's writes equal (int8 exactly)."""
    jcfg, jmod, variables, tmod = _llama_pair(kv_quantize)
    g, s_pre, b, w, s_g, k = 3, 7, 4, 5, 6, 2
    r = np.random.default_rng(17)
    j_pool, t_pool = _gen_cache(jcfg, g, s_pre, seed=1)
    pool_mask = np.arange(s_pre)[None, :] >= np.array([[2], [0], [4]])
    assign = np.array([2, 0, 2, 1])
    vis = ((assign[:, None] == np.arange(g))[:, :, None] & pool_mask[None]).reshape(b, -1)
    sufmask = np.arange(w)[None, :] >= np.array([[1], [3], [0], [2]])
    cnt = np.array([1, 3, 2, 6])
    pos = (pool_mask.sum(1)[assign] + sufmask.sum(1) + cnt - 1)[:, None]

    # greedy: the question window heads each slot's generated segment
    tok = (r.normal(size=(b, 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
    gen_index = w + cnt - 1
    gen_mask = np.concatenate([sufmask, np.arange(s_g)[None, :] < cnt[:, None]], axis=1)
    j_gen, t_gen = _gen_cache(jcfg, b, w + s_g, seed=2)
    j_logits, j_new = jax.jit(lambda v, *a: jmod.apply(
        v, *a, method=JaxLlamaModel.decode_step_shared))(
        variables, jnp.asarray(tok), jnp.asarray(pos), _flat(j_pool), jnp.asarray(vis),
        dict(j_gen), jnp.asarray(gen_index), jnp.asarray(gen_mask))
    flat = _flat(t_pool)
    assert all(val.data_ptr() == t_pool[key].data_ptr() for key, val in flat.items())  # a view
    gen = {key: val.clone() for key, val in t_gen.items()}
    with torch.no_grad():
        got = tmod.decode_step_shared(torch.from_numpy(tok), torch.from_numpy(pos), flat,
                                      torch.from_numpy(vis), gen, torch.from_numpy(gen_index),
                                      torch.from_numpy(gen_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_logits), atol=ATOL)
    for key in gen:
        np.testing.assert_allclose(gen[key].float().numpy(),
                                   np.asarray(j_new[key].astype(jnp.float32)),
                                   atol=0 if kv_quantize else ATOL, rtol=0, err_msg=key)

    # beam: (pool, per-slot suffixes), each a batch-1 segment
    bk = b * k
    j_suf, t_suf = _gen_cache(jcfg, b, w, seed=3)
    vis_suf = (np.eye(b, dtype=bool)[:, :, None] & sufmask[None]).reshape(b, b * w)
    pm = np.repeat(np.concatenate([vis, vis_suf], axis=1), k, axis=0)
    tok = (r.normal(size=(bk, 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
    cnt_k = np.repeat(cnt, k)
    pos_k = np.repeat(pos, k, axis=0)
    gen_index = cnt_k - 1
    gen_mask = np.arange(s_g)[None, :] < cnt_k[:, None]
    anc = r.integers(0, k, size=(bk, s_g)).astype(np.int32)
    anc[np.arange(bk), gen_index] = np.arange(bk) % k  # the step's write lands in its row
    j_gen, t_gen = _gen_cache(jcfg, bk, s_g, seed=4)
    j_logits, j_new = jax.jit(lambda v, *a: jmod.apply(
        v, *a, k, method=JaxLlamaModel.decode_step_beam_anc))(
        variables, jnp.asarray(tok), jnp.asarray(pos_k), (_flat(j_pool), _flat(j_suf)),
        jnp.asarray(pm), dict(j_gen), jnp.asarray(gen_index), jnp.asarray(gen_mask),
        jnp.asarray(anc))
    gen = {key: val.clone() for key, val in t_gen.items()}
    with torch.no_grad():
        got = tmod.decode_step_beam_anc(
            torch.from_numpy(tok), torch.from_numpy(pos_k), (flat, _flat(t_suf)),
            torch.from_numpy(pm), gen, torch.from_numpy(gen_index), torch.from_numpy(gen_mask),
            torch.from_numpy(anc), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_logits), atol=ATOL)
    for key in gen:
        np.testing.assert_allclose(gen[key].float().numpy(),
                                   np.asarray(j_new[key].astype(jnp.float32)),
                                   atol=0 if kv_quantize else ATOL, rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# The engines: requests, shapes and scenarios
# ---------------------------------------------------------------------------


def scene_requests(n_scenes, n_q, seed=0, questions=QUESTIONS):
    """``n_scenes`` scenes x ``n_q`` questions, scene-major; the requests of
    a scene share its arrays and the text before the question, so each
    scene takes one block."""
    scenes = make_requests(n_scenes, seed)
    return [dict({k: scenes[s][k] for k in _KEYS},
                 msr3d_prompt=f"Scene number {s}: {SCENE_PLACEHOLDER}. Ego view: "
                              f"{IMAGE_PLACEHOLDER}. USER: {questions[q % len(questions)]}")
            for s in range(n_scenes) for q in range(n_q)]


def _interleaved():
    reqs = scene_requests(3, 3)
    return [reqs[s * 3 + q] for q in range(3) for s in range(3)]  # round-robin


def _empty_prefix():
    scene = scene_requests(1, 2, seed=1)
    pure = [dict({k: scene[0][k] for k in _KEYS}, msr3d_prompt=f"USER: pure text question {i}?")
            for i in range(2)]
    return [pure[0], scene[0], pure[1], scene[1]]


def _same_group_key():
    reqs = scene_requests(1, 2, seed=2)
    reqs[0]["group_key"] = reqs[1]["group_key"] = "scene0"
    reqs[1]["msr3d_prompt"] = (f"A DIFFERENT preamble {SCENE_PLACEHOLDER}. Ego view: "
                               f"{IMAGE_PLACEHOLDER}. USER: {QUESTIONS[1]}")
    return reqs


def _group_key_ignored():
    reqs = scene_requests(2, 1, seed=3, questions=["What do you see?"])
    reqs[1]["msr3d_prompt"] = reqs[0]["msr3d_prompt"]
    reqs[0]["group_key"] = reqs[1]["group_key"] = "same-key"
    return reqs


def _evict_return():
    reqs = scene_requests(3, 1, seed=4)
    return reqs + reqs[:1]


STREAMS = {
    "interleaved": _interleaved,
    "scene-major-2x4": lambda: scene_requests(2, 4, seed=5),
    "lru-return": lambda: (lambda r: r + r[:2])(scene_requests(3, 2, seed=6)),
    "lru-return-4": lambda: (lambda r: r + r[:2])(scene_requests(4, 2, seed=6)),
    "resident-reuse": lambda: (lambda r: r + r[:1])(scene_requests(2, 2, seed=7)),
    "two-scenes": lambda: scene_requests(2, 2, seed=8),
    "four-scenes": lambda: scene_requests(4, 1, seed=10),
    "empty-prefix": _empty_prefix,
    "same-group-key": _same_group_key,
    "group-key-ignored": _group_key_ignored,
    "beam-interleaved": lambda: (lambda r: [r[s * 3 + q] for q in range(3) for s in range(2)])(
        scene_requests(2, 3, seed=9)),
    "evict-return": _evict_return,
}


@functools.lru_cache(maxsize=None)
def stream(name):
    return STREAMS[name]()


COMMON = dict(prefix_len=64, suffix_len=64, chunk_steps=3, max_new_tokens=MAX_NEW)
# 4 slots over 3 blocks, refill groups of 2: one JAX engine (its compiles
# dominate the file) serves every greedy scenario. name: (stream, budgets,
# prefixes prefilled, whether a refill is head-of-line blocked)
GREEDY_ENGINE = dict(num_slots=4, num_prefixes=3, refill_group=2)
S2G2 = dict(num_slots=2, num_prefixes=2, refill_group=1)
GREEDY = {
    "interleaved": ("interleaved", None, 3, False),  # 3 scenes stay resident
    "group-refill-shares": ("scene-major-2x4", None, 2, False),  # a group's pair shares
    "lru-eviction-and-return": ("lru-return-4", None, 5, False),  # s0 evicted, returns
    "resident-reuse": ("resident-reuse", None, 2, False),  # s0 returns for free
    "head-of-line-blocking": ("four-scenes", None, 4, True),  # s3 waits for a block
    "empty-prefix": ("empty-prefix", None, 1, False),  # only the real scene
    "budgets": ("two-scenes", [1, 3, 8, 5], 2, False),
    "same-group-key-other-prompts": ("same-group-key", None, 2, False),
    "group-key-ignored": ("group-key-ignored", None, 2, False),
}
BEAM = {
    "interleaved": ("beam-interleaved", None, 2),
    "eviction-and-budgets": ("evict-return", [5, 8, 3, 6], 4),
}
BEAM_ENGINE = dict(num_slots=2, num_prefixes=2, refill_group=1)


@dataclasses.dataclass
class Run:
    tokens: dict
    steps: int
    prefills: int


def _run(engine, reqs, budgets=None) -> Run:
    results = engine.run(reqs, budgets=budgets)
    assert [r.id for r in results] == list(range(len(reqs)))
    return Run({r.id: np.asarray(r.output_tokens) for r in results}, engine.steps_run,
               engine.prefix_prefills)


def _count(engine) -> dict:
    """Wrap the port engine's hooks to count the prefixes it prefills and
    the refills it stops short with requests still queued (head-of-line
    blocked on a block)."""
    counts = dict(prefixes=0, blocked=0)
    take, prefill = engine._take_group, engine._prefix_prefill

    def take_counted(queue):
        group = take(queue)
        counts["blocked"] += bool(queue) and len(group) < engine.refill_group
        return group

    def prefill_counted(pool, new):
        counts["prefixes"] += len(new)
        return prefill(pool, new)

    engine._take_group, engine._prefix_prefill = take_counted, prefill_counted
    return counts


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every scenario's JAX run: one greedy engine, one beam engine."""
    jmodel, _ = models
    out = {}
    engine = jax_serving.PrefixPoolContinuousBatchingServer(jmodel, **GREEDY_ENGINE, **COMMON)
    for name, (reqs, budgets, _, _) in GREEDY.items():
        out[name] = _run(engine, stream(reqs), budgets)
    engine = jax_serving.PrefixPoolContinuousBeamBatchingServer(jmodel, **BEAM_ENGINE, **COMMON)
    for name, (reqs, budgets, _) in BEAM.items():
        out[f"beam-{name}"] = _run(engine, stream(reqs), budgets)
    return out


def direct(model, reqs, max_new=MAX_NEW, use_beam=False):
    return model.generate(collate(reqs), use_beam=use_beam,
                          max_new_tokens=max_new)["output_tokens"]


@pytest.mark.parametrize("name", list(GREEDY))
def test_pool_engine_equals_jax_and_generate(models, jax_runs, name):
    _, model = models
    reqs, budgets, prefixes, blocked = GREEDY[name]
    engine = serving.PrefixPoolContinuousBatchingServer(model, **GREEDY_ENGINE, **COMMON)
    counts = _count(engine)
    got, want = _run(engine, stream(reqs), budgets), jax_runs[name]
    for rid, toks in got.tokens.items():
        np.testing.assert_array_equal(toks, want.tokens[rid], err_msg=f"request {rid}")
    assert (got.steps, got.prefills) == (want.steps, want.prefills)
    assert counts["prefixes"] == prefixes and (counts["blocked"] > 0) == blocked, counts
    plain = direct(model, stream(reqs))
    eos = model.tokenizer.eos_id
    for rid, toks in got.tokens.items():
        cap = budgets[rid] if budgets else MAX_NEW
        np.testing.assert_array_equal(toks[:cap], plain[rid][:cap])
        assert (toks[cap:] == eos).all()


def test_pool_too_small_fails_loud(models):
    """One block taken by the prompts without a placeholder leaves a scene
    request unschedulable: both packages raise, not hang."""
    reqs = _empty_prefix()[:2]
    for pkg, model in zip((jax_serving, serving), models):
        engine = pkg.PrefixPoolContinuousBatchingServer(
            model, num_slots=1, num_prefixes=1, refill_group=1, prefix_len=64, suffix_len=64,
            chunk_steps=2, max_new_tokens=4)
        with pytest.raises(RuntimeError, match="prefix pool exhausted"):
            engine.run(reqs)


@pytest.mark.parametrize("knob", ["do_sample", "spec_k"])
def test_pool_refusals_equal_jax(models, knob):
    """Sampling on a pool engine, and speculative drafts under a repetition
    penalty: the same ``ValueError`` in both packages."""
    match = "plain-continuous-engine" if knob == "do_sample" else "repetition_penalty"
    for pkg, model in zip((jax_serving, serving), models):
        saved = model.do_sample
        model.do_sample = knob == "do_sample"
        try:
            with pytest.raises(ValueError, match=match):
                pkg.PrefixPoolContinuousBatchingServer(
                    model, num_slots=2, num_prefixes=2, refill_group=2,
                    spec_k=2 if knob == "spec_k" else 0)
            if knob == "do_sample":
                with pytest.raises(ValueError, match="plain-continuous-engine"):
                    pkg.PrefixPoolContinuousBeamBatchingServer(model, num_slots=2,
                                                               refill_group=2)
        finally:
            model.do_sample = saved


def test_pool_spec_equals_t1_pool(models):
    """``spec_k`` 3 with 2-grams on the pool, at penalty 1.0: tokens equal
    the T = 1 pool's request for request across eviction, a scene's return
    and budgets, with the same prefix prefills; tokens and ``steps_run``
    (verify calls) equal JAX's speculative pool engine."""
    jmodel, model = models
    saved = model.repetition_penalty
    model.repetition_penalty = jmodel.repetition_penalty = 1.0
    try:
        reqs = stream("lru-return")[:7]  # 3 scenes x 2, then the evicted first returns
        budgets = [8, 3, 6, 8, 5, 8, 4]
        spec_kw = dict(S2G2, **COMMON)
        plain = serving.PrefixPoolContinuousBatchingServer(model, **spec_kw)
        spec = serving.PrefixPoolContinuousBatchingServer(model, **spec_kw, spec_k=3,
                                                          spec_ngram=2)
        want, got = _run(plain, reqs, budgets), _run(spec, reqs, budgets)
        jax_spec = _run(jax_serving.PrefixPoolContinuousBatchingServer(
            jmodel, **spec_kw, spec_k=3, spec_ngram=2), reqs, budgets)
        direct_tokens = direct(model, reqs)
    finally:
        model.repetition_penalty = jmodel.repetition_penalty = saved
    for rid, toks in got.tokens.items():
        np.testing.assert_array_equal(toks, want.tokens[rid], err_msg=f"request {rid}")
        np.testing.assert_array_equal(toks, jax_spec.tokens[rid], err_msg=f"request {rid}")
        np.testing.assert_array_equal(toks[:budgets[rid]], direct_tokens[rid][:budgets[rid]])
    assert got.prefills == want.prefills == jax_spec.prefills == 4
    assert got.steps == jax_spec.steps


@pytest.mark.parametrize("name", list(BEAM))
def test_beam_pool_equals_jax_and_generate(models, jax_runs, name):
    """The beam pool engine (the model's 2 beams): tokens, ``steps_run`` and
    prefix prefills equal JAX's beam pool engine; each request's tokens
    equal a batch-1 beam ``generate`` at its budget."""
    _, model = models
    reqs, budgets, prefills = BEAM[name]
    engine = serving.PrefixPoolContinuousBeamBatchingServer(model, **BEAM_ENGINE, **COMMON)
    assert engine.num_beams == model.num_beams == 2 and not engine.supports_progress
    got, want = _run(engine, stream(reqs), budgets), jax_runs[f"beam-{name}"]
    for rid, toks in got.tokens.items():
        np.testing.assert_array_equal(toks, want.tokens[rid], err_msg=f"request {rid}")
    assert (got.steps, got.prefills) == (want.steps, want.prefills) and got.prefills == prefills
    for rid, req in enumerate(stream(reqs)):
        cap = budgets[rid] if budgets else MAX_NEW
        one = direct(model, [req], max_new=cap, use_beam=True)[0]
        np.testing.assert_array_equal(got.tokens[rid][:cap], one[:cap])


# ---------------------------------------------------------------------------
# The HTTP front end and the quantized configurations
# ---------------------------------------------------------------------------


def _post(port, body, timeout=240):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_pool_engine_behind_http(models, monkeypatch):
    """Answers equal ``generate``'s; the front end splits each request once
    (``_pool_split``), the engine not again; a suffix past the bucket is a
    400 on its own connection and the engine serves on; the scenes' blocks
    stay resident across requests."""
    _, model = models
    reqs = stream("two-scenes")
    want = model.batch_detokenize(direct(model, reqs, max_new=5))
    engine = serving.PrefixPoolContinuousBatchingServer(model, **S2G2,
                                                        **dict(COMMON, max_new_tokens=5))
    calls = []
    split = engine._split_sample
    monkeypatch.setattr(engine, "_split_sample", lambda s: calls.append(1) or split(s))
    with ServingFrontend(engine, port=0) as fe:
        for i, req in enumerate(reqs):
            status, payload = _post(fe.port, {"prompt": req["msr3d_prompt"],
                                              "scene_b64": encode_scene_b64(req)})
            assert status == 200 and payload["text"] == want[i], payload
        bad = dict(reqs[0], msr3d_prompt=reqs[0]["msr3d_prompt"] + " pad" * 40)
        status, payload = _post(fe.port, {"prompt": bad["msr3d_prompt"],
                                          "scene_b64": encode_scene_b64(bad)})
        assert status == 400 and "suffix" in payload["error"]
        status, payload = _post(fe.port, {"prompt": reqs[0]["msr3d_prompt"],
                                          "scene_b64": encode_scene_b64(reqs[0])})
        assert status == 200 and payload["text"] == want[0]
    assert len(calls) == len(reqs) + 2  # each request once, in validation
    assert engine.prefix_prefills == 2


@pytest.mark.parametrize("config", ["int8-weights", "int8-kv"])
def test_pool_engine_quantized_config(models, config):
    """The pool engine on a quantized model of the same weights. int8
    weights: tokens equal ``generate``'s on that model. The int8 KV cache
    (scales in the pool, the windows and the slots): the question window
    attends the prefix as the cache holds it, quantized, where ``generate``'s
    prefill attends the prompt's own unquantized k/v, so its tokens may part
    from generate's (on these weights request 3 does, in both packages);
    they equal JAX's pool engine on the int8 KV cache instead, with its
    ``steps_run`` and prefix prefills."""
    jmodel, base = models
    kw = dict(scene_token_len=5, max_out_len=16, num_beams=1, repetition_penalty=1.5)
    llm = {"kv_quantize": True} if config == "int8-kv" else {}
    model = MSR3D(torch_network_config(jmodel.cfg, **llm), base.tokenizer, device="cpu", **kw)
    assert model.load_jax_params(jmodel.params) == []
    if config == "int8-weights":
        model.quantize_llm(bits=8)
    assert model.cfg.llm.kv_quantize == (config == "int8-kv")
    reqs = stream("two-scenes")
    engine = serving.PrefixPoolContinuousBatchingServer(model, **S2G2, **COMMON)
    got = _run(engine, reqs)
    if config == "int8-weights":
        want = Run(dict(enumerate(direct(model, reqs))), got.steps, 2)
    else:
        jcfg = dataclasses.replace(jmodel.cfg, llm=dataclasses.replace(jmodel.cfg.llm,
                                                                       kv_quantize=True))
        jmodel_q = type(jmodel)(jcfg, jmodel.tokenizer, **kw)
        jmodel_q.params = jmodel.params
        want = _run(jax_serving.PrefixPoolContinuousBatchingServer(
            jmodel_q, **S2G2, **COMMON), reqs)
    for rid, toks in got.tokens.items():
        np.testing.assert_array_equal(toks, want.tokens[rid], err_msg=f"request {rid}")
    assert (got.steps, got.prefills) == (want.steps, want.prefills) and got.prefills == 2
