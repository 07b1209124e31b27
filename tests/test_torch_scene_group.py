"""Scene-grouped generation and serving in the port, and ``compact_transfer``,
against the JAX package.

* ``scene_fingerprint``: the same blake2b digests as JAX's.
* ``MSR3D.generate_scene_group``: G scene prefixes prefilled once, all
  G·Q question suffixes in one T = W window, then greedy or beam-5 decoding
  (ancestry map on and off) from slot W. Tokens equal JAX's grouped
  tokens and the port's per-question ``generate``; ragged groups, identical
  prompts; JAX's ``ValueError``s.
* ``SceneGroupBatchingServer``: ids and results equal JAX's, in bulk, with
  a miskeyed group (same arrays, prompts that part before the scene
  placeholder: the singleton fallback) and ``max_open_scenes`` forcing
  unfilled groups out; online behind the HTTP front end, and ``serve
  --engine grouped``.
* ``eval_engine: grouped`` through ``LeoTrainer``: in
  ``tests/test_torch_eval.py::test_eval_grouped_equals_jax``, on that file's
  trainers.
* ``compact_transfer``: the packed int16/int8 points bit-equal to JAX's, the
  unpacked fp32 bit-equal, and greedy tokens (``generate``, and the
  continuous engine at generate's shapes) equal JAX's with it on.

Tokens are compared exactly, in fp32, on the tiny model of
``tests/test_torch_serving.py`` (the port holding the JAX weights)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

from msr3d_tpu import serving as jax_serving
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu_torch import serving
from msr3d_tpu_torch.models.llm.tokenizer import IMAGE_PLACEHOLDER, SCENE_PLACEHOLDER
from msr3d_tpu_torch.models.msr3d import MSR3D
from msr3d_tpu_torch.serve import create_frontend, parse_args
from msr3d_tpu_torch.serving_http import ServingFrontend, encode_scene_b64

from test_torch_serving import _KEYS, build_models, collate, make_requests, prompt_bucket
from test_torch_serving_http import _health, _post

MAX_NEW = 6
PREFIX = f"You are in a scene: {SCENE_PLACEHOLDER}. Image: {IMAGE_PLACEHOLDER}. "
QUESTIONS = ["What do you see?", "Is there a chair next to the window in the corner?",
             "Color?", "Count the tables now please?", "Exit?"]


@pytest.fixture(scope="module")
def models():
    return build_models()


def _group(scenes, questions):
    """Scene rows (leading dim G) and the nested prompts of each scene."""
    data = collate(scenes)
    data["msr3d_prompt"] = [[PREFIX + q for q in qs] for qs in questions]
    return data


def _per_question(group):
    """The same questions as independent rows, each scene repeated."""
    reps = [len(qs) for qs in group["msr3d_prompt"]]
    return {"msr3d_prompt": [p for qs in group["msr3d_prompt"] for p in qs],
            **{k: np.repeat(group[k], reps, axis=0) for k in _KEYS}}


@pytest.fixture
def beam_models(models):
    saved = [(m.num_beams, m.beam_ancestry) for m in models]
    yield models
    for m, (beams, anc) in zip(models, saved):
        m.num_beams, m.beam_ancestry = beams, anc


def test_scene_fingerprint_equals_jax():
    reqs = make_requests(3, seed=1)
    leo = {k: reqs[0][k] for k in _KEYS[:5]}
    leo["img_fts"] = np.ones((8, 8, 3), np.float32)
    for sample in reqs + [leo, dict(reqs[1], group_key="scan7/situation2")]:
        assert serving.scene_fingerprint(sample) == jax_serving.scene_fingerprint(sample)
    assert serving.scene_fingerprint(reqs[0]) != serving.scene_fingerprint(reqs[1])
    assert serving.scene_fingerprint(dict(reqs[0], msr3d_prompt="other")) \
        == serving.scene_fingerprint(reqs[0])


@pytest.mark.parametrize("beams", [1, 5], ids=["greedy", "beam5"])
def test_grouped_equals_jax_and_generate(beam_models, beams):
    """Greedy, and beam 5 with the ancestry map on (JAX's default) and off:
    the port's grouped tokens equal JAX's grouped tokens (ancestry on; JAX's
    own tests hold its two ways token-equal) and the questions' own
    ``generate``."""
    jmodel, model = beam_models
    for m in beam_models:
        m.num_beams, m.beam_ancestry = beams, True
    group = _group(make_requests(1, seed=2), [QUESTIONS[:3]])
    want = jmodel.generate_scene_group(dict(group), max_new_tokens=MAX_NEW)
    for ancestry in ((True, False) if beams > 1 else (True,)):
        model.beam_ancestry = ancestry
        got = model.generate_scene_group(dict(group), max_new_tokens=MAX_NEW)
        assert got["output_tokens"].shape == (3, MAX_NEW)  # the Q-bucket pad row dropped
        np.testing.assert_array_equal(got["output_tokens"], np.asarray(want["output_tokens"]))
        assert got["output_text"] == want["output_text"]
        plain = model.generate(_per_question(group), max_new_tokens=MAX_NEW)
        np.testing.assert_array_equal(got["output_tokens"], plain["output_tokens"])


def test_grouped_ragged_and_identical(models):
    """G = 2 scenes with 3 and 2 questions in one program; the second
    group's prompts are identical, so its suffix is the trailing bos alone."""
    jmodel, model = models
    group = _group(make_requests(2, seed=3), [QUESTIONS[:3], [QUESTIONS[3]] * 2])
    want = jmodel.generate_scene_group(dict(group), use_beam=False, max_new_tokens=MAX_NEW)
    got = model.generate_scene_group(dict(group), use_beam=False, max_new_tokens=MAX_NEW)
    assert got["output_tokens"].shape == (5, MAX_NEW)
    np.testing.assert_array_equal(got["output_tokens"], np.asarray(want["output_tokens"]))
    np.testing.assert_array_equal(got["output_tokens"][3], got["output_tokens"][4])
    plain = model.generate(_per_question(group), use_beam=False, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got["output_tokens"], plain["output_tokens"])


def test_grouped_value_errors(models):
    """As JAX's: prompts that part before a placeholder, a scene count that
    is not the group count, and speculative or sampled decoding."""
    scene = make_requests(1, seed=4)
    diverging = collate(scene)
    diverging["msr3d_prompt"] = [[f"Alpha {SCENE_PLACEHOLDER}. {IMAGE_PLACEHOLDER} one?",
                                  f"Beta {SCENE_PLACEHOLDER}. {IMAGE_PLACEHOLDER} two?"]]
    two_groups = _group(scene, [QUESTIONS[:1], QUESTIONS[1:2]])
    for m in models:
        with pytest.raises(ValueError, match="shared prefix"):
            m.generate_scene_group(dict(diverging), max_new_tokens=4)
        with pytest.raises(ValueError, match="ONE scene row per prompt group"):
            m.generate_scene_group(dict(two_groups), max_new_tokens=4)
        for knob in ("spec_k", "do_sample"):
            saved = getattr(m, knob)
            setattr(m, knob, 2 if knob == "spec_k" else True)
            try:
                with pytest.raises(ValueError, match="grouped mode"):
                    m.generate_scene_group(_group(scene, [QUESTIONS[:1]]), max_new_tokens=4)
            finally:
                setattr(m, knob, saved)


def _server_requests():
    """Scenes A, B, C interleaved, then a miskeyed pair: the same arrays
    with situation texts that part before the scene placeholder."""
    scenes = make_requests(4, seed=5)
    order = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (2, 1)]
    reqs = [dict(scenes[s], msr3d_prompt=PREFIX + QUESTIONS[q]) for s, q in order]
    reqs += [dict(scenes[3], msr3d_prompt=f"Facing north in {SCENE_PLACEHOLDER} with "
                                          f"{IMAGE_PLACEHOLDER}. {QUESTIONS[0]}"),
             dict(scenes[3], msr3d_prompt=f"Sitting in {SCENE_PLACEHOLDER} with "
                                          f"{IMAGE_PLACEHOLDER}. {QUESTIONS[4]}")]
    return reqs


@pytest.fixture(scope="module")
def server_runs(models):
    """The JAX server's bulk results over ``_server_requests``."""
    jmodel, _ = models
    server = jax_serving.SceneGroupBatchingServer(jmodel, 2, 2, pipeline_depth=1,
                                                  use_beam=False, max_new_tokens=MAX_NEW,
                                                  max_open_scenes=2)
    return list(server.run(_server_requests()))


def test_group_server_equals_jax(models, server_runs):
    """Bulk: ids in JAX's order and the same tokens and texts; ``submit``
    and ``flush`` give the same; every answer equals the question's own
    ``generate``."""
    _, model = models
    reqs = _server_requests()
    kw = dict(pipeline_depth=1, use_beam=False, max_new_tokens=MAX_NEW, max_open_scenes=2)
    got = list(serving.SceneGroupBatchingServer(model, 2, 2, **kw).run(reqs))
    assert [r.id for r in got] == [r.id for r in server_runs]
    assert sorted(r.id for r in got) == list(range(len(reqs)))
    for g, w in zip(got, server_runs):
        np.testing.assert_array_equal(g.output_tokens, np.asarray(w.output_tokens))
        assert g.output_text == w.output_text
    server = serving.SceneGroupBatchingServer(model, 2, 2, **kw)
    for q in reqs:
        server.submit(q)
    flushed = server.flush()
    assert [r.id for r in flushed] == list(range(len(reqs))) and server.flush() == []
    want = {r.id: r.output_tokens for r in got}
    for r in flushed:
        np.testing.assert_array_equal(r.output_tokens, want[r.id])
    plain = model.generate(collate(reqs), use_beam=False, max_new_tokens=MAX_NEW)
    for r in got:
        np.testing.assert_array_equal(r.output_tokens, plain["output_tokens"][r.id])


def test_grouped_engine_over_http(models, server_runs):
    """The grouped server behind the HTTP front end (online mode: a quiet
    stream flushes the buffered groups after ``idle_flush_s``): concurrent
    requests get JAX's tokens, a budget truncates; the front end skips the
    prompt-width check (the grouped server has no prompt bucket). Then
    ``serve --engine grouped`` on the debug config answers."""
    _, model = models
    reqs = _server_requests()[:5]
    want = {r.id: np.asarray(r.output_tokens) for r in server_runs}
    engine = serving.SceneGroupBatchingServer(model, 2, 2, use_beam=False,
                                              max_new_tokens=MAX_NEW)
    assert not hasattr(engine, "prompt_len")
    out = {}
    with ServingFrontend(engine, port=0) as fe:
        def client(i):
            body = {"prompt": reqs[i]["msr3d_prompt"], "scene_b64": encode_scene_b64(reqs[i])}
            if i == 2:
                body["max_new_tokens"] = 3
            out[i] = _post(fe.port, body, timeout=300)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert _health(fe.port)["served"] == len(reqs)
    for i, (status, payload) in out.items():
        assert status == 200
        cap = 3 if i == 2 else MAX_NEW
        np.testing.assert_array_equal(payload["tokens"], want[i][:cap])
        assert payload["text"] == model.batch_detokenize(want[i][None, :cap])[0]

    args = parse_args(["--config", "configs/debug_synthetic.yaml", "--device", "cpu",
                       "--random-init", "--port", "0", "--engine", "grouped",
                       "--group-scenes", "2", "--group-questions", "2",
                       "--max-new-tokens", "4"])
    fe = create_frontend(args)
    assert isinstance(fe.engine, serving.SceneGroupBatchingServer)
    assert fe.engine.num_slots == 4
    scene = {k: reqs[0][k] for k in _KEYS[:5]}
    with fe:
        status, payload = _post(fe.port, {"prompt": "scene: 景 USER: what is here? ASSISTANT:",
                                          "scene_b64": encode_scene_b64(scene)}, timeout=300)
    assert status == 200 and len(payload["tokens"]) == 4


def test_compact_transfer_equals_jax(models):
    """The packed points bit-equal to JAX's (values past ±1 clipped), the
    unpacked fp32 bit-equal to JAX's, and greedy tokens equal JAX's with
    ``compact_transfer`` on, through ``generate`` and the continuous engine
    (whose prefill packs as JAX's does)."""
    jmodel, model = models
    r = np.random.default_rng(6)
    fts = r.uniform(-1.2, 1.2, size=(2, 3, 8, 6)).astype(np.float32)
    for m in models:
        m.compact_transfer = True
    try:
        jpacked = jmodel._maybe_pack({"obj_fts": fts.copy()})
        packed = model._maybe_pack({"obj_fts": fts.copy()})
        assert sorted(packed) == sorted(jpacked) == ["obj_fts_rgb_q", "obj_fts_xyz_q"]
        for key in packed:
            assert packed[key].dtype == jpacked[key].dtype
            np.testing.assert_array_equal(packed[key], jpacked[key])
        junpacked = JaxMSR3D._unpack_batch({k: jnp.asarray(v) for k, v in jpacked.items()})
        unpacked = MSR3D._unpack_batch(model._to_device(packed))
        np.testing.assert_array_equal(unpacked["obj_fts"].numpy(),
                                      np.asarray(junpacked["obj_fts"]))
        assert packed["obj_fts_xyz_q"].nbytes + packed["obj_fts_rgb_q"].nbytes \
            == fts.size // 6 * 9

        reqs = make_requests(4, seed=7)
        data = collate(reqs)
        want = jmodel.generate(dict(data), use_beam=False, max_new_tokens=MAX_NEW)
        got = model.generate(dict(data), use_beam=False, max_new_tokens=MAX_NEW)
        np.testing.assert_array_equal(got["output_tokens"], np.asarray(want["output_tokens"]))
        # the engine's prefill packs too; at generate's shapes its tokens are
        # generate's (tests/test_torch_serving.py)
        engine = serving.ContinuousBatchingServer(
            model, num_slots=4, refill_group=4, chunk_steps=3, max_new_tokens=MAX_NEW,
            prompt_len=prompt_bucket(model, reqs))
        for r in engine.run(reqs):
            np.testing.assert_array_equal(r.output_tokens, np.asarray(want["output_tokens"][r.id]))
    finally:
        for m in models:
            m.compact_transfer = False
    plain = model.generate(dict(data), use_beam=False, max_new_tokens=MAX_NEW)["output_tokens"]
    assert plain.shape == got["output_tokens"].shape
