"""The port's serving engines against the JAX package's: the per-row KV
write, ``pick_next_rows``, ``uncollate_batch``, the fixed batcher, and the
greedy and beam slot-refill engines (``msr3d_tpu_torch/serving.py``).

Both packages serve the same requests, made with numpy from a seed, on the
tiny fp32 model (the ``tests/test_msr3d.py`` prompter, ``LlamaConfig.tiny``
with LoRA, the ``convnext_test`` image encoder, 2 beams, repetition penalty
1.5), the port holding the JAX model's weights (perturbed with numpy noise,
so that LoRA takes part) converted with ``load_jax_params``. Each request's
tokens must be equal, and so must ``steps_run`` (the decode steps the chunks
ran, early exits included). The JAX engines compile a program set each, so
each setting's JAX run happens once per module (``jax_runs``) and settings
that share an engine's shapes share its instance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu import serving as jax_serving
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import _cache_write as jax_cache_write
from msr3d_tpu.models.llm.llama import quantize_kv_cache as jax_quantize_kv_cache
from msr3d_tpu.models.llm.sampling import pick_next_rows as jax_pick_next_rows
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu_torch import serving
from msr3d_tpu_torch.models.llm.llama import _cache_write, quantize_kv_cache
from msr3d_tpu_torch.models.llm.sampling import pick_next_rows
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.msr3d import MSR3D

from torch_parity_utils import TINY_PROMPTER, perturbed, torch_network_config

MAX_NEW, N_REQ = 8, 7
PROMPTS = [
    "You are in a scene: 景. Image: 图. What do you see?",
    "Scene 景 here. 图 go north?",
    "Objects 景 around me, view 图. Which chair is closest to the window on my left?",
]
_KEYS = ("obj_fts", "obj_masks", "obj_locs", "anchor_locs", "anchor_orientation",
         "msr3d_imgs", "msr3d_img_masks")


def make_requests(n: int, seed: int = 0):
    """``n`` single-sample requests: 6 objects of 32 points, two 32² images
    (the second shown in every other request), prompts of three lengths."""
    r = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        quat = r.normal(size=4)
        reqs.append({
            "msr3d_prompt": f"{PROMPTS[i % 3]} Question {i}.",
            "obj_fts": (r.normal(size=(6, 32, 6)) * 0.3).astype(np.float32),
            "obj_masks": np.arange(6) < 6 - i % 2,
            "obj_locs": r.normal(size=(6, 6)).astype(np.float32),
            "anchor_locs": r.normal(size=3).astype(np.float32),
            "anchor_orientation": (quat / np.linalg.norm(quat)).astype(np.float32),
            "msr3d_imgs": r.normal(size=(2, 32, 32, 3)).astype(np.float32),
            "msr3d_img_masks": np.array([True, i % 2 == 0]),
        })
    return reqs


def collate(reqs):
    return {"msr3d_prompt": [q["msr3d_prompt"] for q in reqs],
            **{k: np.stack([q[k] for q in reqs]) for k in _KEYS}}


def text_requests(n: int, seed: int = 0):
    """``make_requests`` without the images, for models built without them."""
    return [{k: v for k, v in q.items() if k not in ("msr3d_imgs", "msr3d_img_masks")}
            for q in make_requests(n, seed)]


def prompt_bucket(model, reqs) -> int:
    """generate's prompt bucket over all requests, plus the trailing bos."""
    ids, _ = model._encode_prompts(model.build_text_prompt(serving._collate(reqs)))
    return max(32, -(-ids.shape[1] // 32) * 32) + 1


def build_models(images: bool = True):
    """The JAX tiny model with perturbed weights, and the port's holding them.
    Without ``images`` the JAX init sees no image (a third cheaper), so the
    models serve requests without images only."""
    tok = JaxByteTokenizer()
    llm = JaxLlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=jnp.float32, lora_rank=4)
    net_cfg = JaxMSR3DNetworkConfig(prompter=TINY_PROMPTER, llm=llm, backbone_name="convnext_test")
    kw = dict(scene_token_len=5, max_out_len=16, num_beams=2, repetition_penalty=1.5)
    jmodel = JaxMSR3D(net_cfg, tok, **kw)
    data = collate(make_requests(2))
    if not images:
        data = {k: v for k, v in data.items() if k not in ("msr3d_imgs", "msr3d_img_masks")}
    ids, attn = jmodel._encode_prompts(jmodel.build_text_prompt(data))
    answers, answer_mask = jmodel._encode_answers(["a chair", "yes"])
    batch = jmodel._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=answers, output_mask=answer_mask)
    jmodel.params = perturbed(jmodel.init_params(batch), seed=4, std=0.05)
    model = MSR3D(torch_network_config(jmodel.cfg), ByteTokenizer(), device="cpu", **kw)
    skipped = model.load_jax_params(jmodel.params)
    assert skipped == [], skipped
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    return build_models()


@dataclasses.dataclass
class Run:
    tokens: dict
    steps: int


def _run(engine, reqs, **kw) -> Run:
    results = engine.run(reqs, **kw)
    assert [r.id for r in results] == list(range(len(reqs)))
    return Run({r.id: np.asarray(r.output_tokens) for r in results}, engine.steps_run)


# (engine class, shapes) per JAX engine instance; (instance, host settings,
# run arguments) per setting
GREEDY_ENGINES = {
    "s3r1": dict(num_slots=3, refill_group=1, chunk_steps=3),
    "s4r2": dict(num_slots=4, refill_group=2, chunk_steps=3),
    "s1r1": dict(num_slots=1, refill_group=1, chunk_steps=4),
    "stale": dict(num_slots=2, refill_group=1, chunk_steps=2, max_new_tokens=12),
}
BUDGETS = [1, 3, 8, 5, 2, 8, 4]
STALE_BUDGETS = [1, 12, 2, 1, 3, 12]  # short budgets refill one slot under lookahead 2
GREEDY_SETTINGS = {
    "s3r1-look0": ("s3r1", dict(lookahead=0), {}),
    "s3r1-look1": ("s3r1", dict(lookahead=1), {}),
    "s3r1-look2": ("s3r1", dict(lookahead=2), {}),
    "s3r1-drain-look2": ("s3r1", dict(lookahead=2, drain_between_batches=True), {}),
    "s3r1-budgets": ("s3r1", dict(lookahead=1), dict(budgets=BUDGETS)),
    "s4r2": ("s4r2", dict(lookahead=1), {}),
    "s4r2-drain": ("s4r2", dict(lookahead=1, drain_between_batches=True), {}),
    "s4r2-budgets-look0": ("s4r2", dict(lookahead=0), dict(budgets=BUDGETS)),
    "s1r1": ("s1r1", dict(lookahead=1), {}),
    "stale-flags": ("stale", dict(lookahead=2), dict(budgets=STALE_BUDGETS)),
}
BEAM_ENGINES = {
    "s3r1": dict(num_slots=3, refill_group=1, chunk_steps=4),
    "s4r2": dict(num_slots=4, refill_group=2, chunk_steps=3),
}
BEAM_SETTINGS = {
    "s3r1": ("s3r1", dict(lookahead=1), {}),
    "s3r1-look0": ("s3r1", dict(lookahead=0), {}),
    "s3r1-budgets-look2": ("s3r1", dict(lookahead=2), dict(budgets=[3, 8, 1, 5, 2, 8, 4])),
    "s4r2": ("s4r2", dict(lookahead=1), {}),
    "s4r2-drain": ("s4r2", dict(lookahead=1, drain_between_batches=True), {}),
}


def _to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor of its dtype (bf16 through fp32)."""
    arr = np.asarray(x)
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _engine_kw(model, reqs, shapes):
    return dict(dict(max_new_tokens=MAX_NEW, prompt_len=prompt_bucket(model, reqs)), **shapes)


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every setting's JAX run, each engine instance compiled once."""
    jmodel, _ = models
    out = {}
    for cls, engines, settings, n in (
        (jax_serving.ContinuousBatchingServer, GREEDY_ENGINES, GREEDY_SETTINGS, N_REQ),
        (jax_serving.ContinuousBeamBatchingServer, BEAM_ENGINES, BEAM_SETTINGS, 5),
    ):
        built = {}
        for name, (inst, host, run_kw) in settings.items():
            reqs = make_requests(len(run_kw.get("budgets", ())) or n)
            if inst not in built:
                built[inst] = cls(jmodel, **_engine_kw(jmodel, reqs, engines[inst]))
            engine = built[inst]
            for key, val in dict(dict(lookahead=1, drain_between_batches=False), **host).items():
                setattr(engine, key, val)
            out[(cls.__name__, name)] = _run(engine, reqs, **run_kw)
    return out


def _port_run(model, cls, engines, setting):
    inst, host, run_kw = setting
    reqs = make_requests(len(run_kw.get("budgets", ())) or (N_REQ if cls is
                         serving.ContinuousBatchingServer else 5))
    engine = cls(model, **_engine_kw(model, reqs, engines[inst]), **host)
    return _run(engine, reqs, **run_kw)


@pytest.mark.parametrize("name", list(GREEDY_SETTINGS))
def test_greedy_engine_equals_jax(models, jax_runs, name):
    _, model = models
    want = jax_runs[("ContinuousBatchingServer", name)]
    got = _port_run(model, serving.ContinuousBatchingServer, GREEDY_ENGINES,
                    GREEDY_SETTINGS[name])
    for rid, tokens in want.tokens.items():
        np.testing.assert_array_equal(got.tokens[rid], tokens, err_msg=f"request {rid}")
    assert got.steps == want.steps > 0
    budgets = GREEDY_SETTINGS[name][2].get("budgets")
    if budgets:  # a budget caps its request: nothing past it but eos
        eos = model.tokenizer.eos_id
        assert all((got.tokens[i][b:] == eos).all() for i, b in enumerate(budgets))


@pytest.mark.parametrize("name", list(BEAM_SETTINGS))
def test_beam_engine_equals_jax(models, jax_runs, name):
    _, model = models
    want = jax_runs[("ContinuousBeamBatchingServer", name)]
    got = _port_run(model, serving.ContinuousBeamBatchingServer, BEAM_ENGINES,
                    BEAM_SETTINGS[name])
    for rid, tokens in want.tokens.items():
        np.testing.assert_array_equal(got.tokens[rid], tokens, err_msg=f"request {rid}")
    assert got.steps == want.steps > 0


def test_engines_with_eos_bias_equal_jax(models):
    """An EOS logit bias ends requests early, so slots refill on EOS as well
    as on their budgets: tokens and steps equal JAX's, greedy and beam."""
    jmodel, model = models
    reqs = make_requests(5, seed=1)
    kw = dict(num_slots=2, refill_group=1, chunk_steps=4, max_new_tokens=MAX_NEW,
              prompt_len=prompt_bucket(model, reqs))
    jmodel.eos_logit_bias = model.eos_logit_bias = 4.0
    try:
        for jcls, cls in ((jax_serving.ContinuousBatchingServer,
                           serving.ContinuousBatchingServer),
                          (jax_serving.ContinuousBeamBatchingServer,
                           serving.ContinuousBeamBatchingServer)):
            want, got = _run(jcls(jmodel, **kw), reqs), _run(cls(model, **kw), reqs)
            eos = model.tokenizer.eos_id
            assert any(eos in t[:-1] for t in want.tokens.values()), cls.__name__
            for rid, tokens in want.tokens.items():
                np.testing.assert_array_equal(got.tokens[rid], tokens, err_msg=cls.__name__)
            assert got.steps == want.steps
    finally:
        jmodel.eos_logit_bias = model.eos_logit_bias = 0.0


def test_greedy_engine_equals_generate_at_matched_shapes(models):
    """One refill group the size of the batch, at generate's prompt bucket:
    the engine's tokens equal the port's own ``generate``, as phase 12 of
    chip_smoke.py holds on the card at the flagship width."""
    _, model = models
    reqs = make_requests(4, seed=2)
    engine = serving.ContinuousBatchingServer(
        model, num_slots=4, refill_group=4, chunk_steps=5, max_new_tokens=MAX_NEW,
        prompt_len=prompt_bucket(model, reqs))
    got = _run(engine, reqs)
    want = model.generate(collate(reqs), use_beam=False, max_new_tokens=MAX_NEW)
    for rid, tokens in got.tokens.items():
        np.testing.assert_array_equal(tokens, want["output_tokens"][rid])


def test_lazy_feed_on_result_and_progress(models, jax_runs):
    """``run`` reads the requests lazily (at most the slots plus one refill
    group ahead of the results), ``on_result`` sees every result, and every
    ``on_progress`` snapshot is a prefix of the request's final tokens;
    ``progress_gate`` False suppresses them all. Tokens equal JAX's."""
    _, model = models
    reqs = make_requests(N_REQ)
    want = jax_runs[("ContinuousBatchingServer", "s3r1-look1")]
    engine = serving.ContinuousBatchingServer(
        model, **_engine_kw(model, reqs, dict(num_slots=3, refill_group=2, chunk_steps=2)))
    pulled, completed, snaps = [0], [], {i: [] for i in range(N_REQ)}

    def lazy():
        for req in reqs:
            assert pulled[0] - len(completed) <= 3 + 2
            pulled[0] += 1
            yield req

    results = engine.run(lazy(), on_result=completed.append,
                         on_progress=lambda rid, toks: snaps[rid].append(np.array(toks)))
    assert pulled[0] == N_REQ and sorted(r.id for r in completed) == list(range(N_REQ))
    for r in results:
        np.testing.assert_array_equal(r.output_tokens, want.tokens[r.id])
        prev = 0
        for s in snaps[r.id]:
            assert len(s) >= prev
            prev = len(s)
            np.testing.assert_array_equal(s, r.output_tokens[:len(s)])
    assert any(snaps.values())
    calls = []
    engine.run(reqs[:3], on_progress=lambda rid, toks: calls.append(rid),
               progress_gate=lambda: False)
    assert calls == []
    beam = serving.ContinuousBeamBatchingServer(
        model, **_engine_kw(model, reqs, dict(num_slots=2, refill_group=1)))
    with pytest.raises(ValueError, match="greedy-engine only"):
        beam.run(reqs[:1], on_progress=lambda rid, toks: None)


@pytest.mark.parametrize("use_beam", [False, True], ids=["greedy", "beam"])
def test_batching_server_equals_jax(models, use_beam):
    """The fixed batcher over ``generate_async``: 5 requests at batch 2 (the
    last batch padded with a copy), pipeline depth 1; ids and tokens equal
    JAX's, and ``submit``/``flush`` give the same results."""
    jmodel, model = models
    reqs = make_requests(5, seed=3)
    kw = dict(batch_size=2, pipeline_depth=1, use_beam=use_beam, max_new_tokens=6)
    want = list(jax_serving.BatchingServer(jmodel, **kw).run(iter(reqs)))
    got = list(serving.BatchingServer(model, **kw).run(iter(reqs)))
    assert [r.id for r in got] == [r.id for r in want] == list(range(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output_tokens, np.asarray(w.output_tokens))
        assert g.output_text == w.output_text
    server = serving.BatchingServer(model, **dict(kw, pipeline_depth=2))
    for q in reqs:
        server.submit(q)
    flushed = server.flush()
    assert [r.id for r in flushed] == list(range(5)) and server.flush() == []
    for g, w in zip(flushed, want):
        np.testing.assert_array_equal(g.output_tokens, np.asarray(w.output_tokens))


def test_generate_async_is_generate(models):
    _, model = models
    data = collate(make_requests(2, seed=4))
    finalize = model.generate_async(dict(data), use_beam=False, max_new_tokens=5)
    out = finalize()
    want = model.generate(dict(data), use_beam=False, max_new_tokens=5)
    np.testing.assert_array_equal(out["output_tokens"], want["output_tokens"])
    assert out["output_text"] == want["output_text"]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_cache_write_rows_equals_jax(int8):
    """The per-row KV write: row b's token at slot index[b], rows at -1 or S
    write nothing, an int8 cache quantized per row with its scales; equal to
    the JAX ``_cache_write_rows`` (and to the scalar write where all rows
    share an index)."""
    r = np.random.default_rng(0)
    b, s, h, d = 5, 7, 2, 4
    k = r.normal(size=(b, 1, h, d)).astype(np.float32)
    v = r.normal(size=(b, 1, h, d)).astype(np.float32)
    cache = {"k": r.normal(size=(b, s, h, d)).astype(np.float32),
             "v": r.normal(size=(b, s, h, d)).astype(np.float32)}
    jcache = {key: jnp.asarray(val) for key, val in cache.items()}
    if int8:
        jcache = jax_quantize_kv_cache(jcache)
    for index in ([1, -1, 6, 7, 0], [4] * b, [-1] * b):
        want = jax_cache_write(jcache, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(np.array(index, np.int32)))
        got = {key: _to_torch(val) for key, val in jcache.items()}
        _cache_write(got, torch.from_numpy(k), torch.from_numpy(v),
                     torch.tensor(index, dtype=torch.int32))
        for key in want:
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          np.asarray(want[key], np.float32), err_msg=key)
        if len(set(index)) == 1 and index[0] >= 0:
            scalar = {key: _to_torch(val) for key, val in jcache.items()}
            _cache_write(scalar, torch.from_numpy(k), torch.from_numpy(v), index[0])
            for key in scalar:
                assert torch.equal(scalar[key], got[key])
    # the port's quantizer is the JAX one (tests/test_torch_quant.py)
    assert set(quantize_kv_cache({"k": torch.zeros(1, 1, 1, 4), "v": torch.zeros(1, 1, 1, 4)})) \
        == {"k", "v", "k_scale", "v_scale"}


@pytest.mark.parametrize("bias, min_length", [(0.0, 1), (2.5, 1), (0.0, 4), (1.5, 3)])
def test_pick_next_rows_equals_jax(bias, min_length):
    r = np.random.default_rng(1)
    b, vocab, eos = 6, 40, 2
    logits = r.normal(size=(b, vocab)).astype(np.float32)
    logits[:, eos] = logits.max(axis=1) - 0.5  # EOS near the top
    seen = r.random((b, vocab)) < 0.3
    steps = np.array([0, 1, 2, 3, 5, 9], np.int32)
    kw = dict(eos_id=eos, repetition_penalty=1.5, eos_logit_bias=bias, min_length=min_length)
    want = jax_pick_next_rows(jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(steps), **kw)
    got = pick_next_rows(torch.from_numpy(logits), torch.from_numpy(seen),
                         torch.from_numpy(steps), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uncollate_batch_equals_jax():
    reqs = make_requests(3, seed=5)
    data = collate(reqs)
    samples = serving.uncollate_batch(data)
    want = jax_serving.uncollate_batch(data)
    assert [s["msr3d_prompt"] for s in samples] == [s["msr3d_prompt"] for s in want]
    rebuilt = serving._collate(samples)
    for key in _KEYS:
        np.testing.assert_array_equal(rebuilt[key], data[key])
        for s, w in zip(samples, want):
            np.testing.assert_array_equal(s[key], w[key])
    leo = {"prompt_before_obj": ["role A.", "role B."], "prompt_middle_1": ["ego", "ego"],
           "prompt_middle_2": ["objects", "objects"], "prompt_after_obj": ["q1?", "q2?"],
           **{k: data[k][:2] for k in _KEYS[:5]}}
    assert [s["msr3d_prompt"] for s in serving.uncollate_batch(leo)] \
        == [s["msr3d_prompt"] for s in jax_serving.uncollate_batch(leo)]


def test_unported_options_raise(models):
    """The options of the second serving slice are ported
    (tests/test_torch_speculative.py, test_torch_sampling.py); what JAX's
    engines refuse, the port's refuse the same way: speculation under a
    repetition penalty, sampling with speculation or in the beam engine, and
    ``spec_k`` on the beam engine."""
    jmodel, model = models
    for m, mod in ((jmodel, jax_serving), (model, serving)):
        with pytest.raises(ValueError, match="repetition_penalty"):
            mod.ContinuousBatchingServer(m, num_slots=2, refill_group=1, spec_k=2)
    model.do_sample = True
    try:
        with pytest.raises(ValueError, match="greedy engine"):
            serving.ContinuousBeamBatchingServer(model, num_slots=2, refill_group=1)
        engine = serving.ContinuousBatchingServer(model, num_slots=2, refill_group=1)
        assert engine.sample and engine.spec_k == 0
    finally:
        model.do_sample = False
    with pytest.raises(TypeError):  # as JAX's: the beam engine has no spec_k
        serving.ContinuousBeamBatchingServer(model, num_slots=2, spec_k=2)
