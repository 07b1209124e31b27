"""The port's online serving against the JAX package's: the online request
stream, request parsing, the HTTP front end over a real socket
(``msr3d_tpu_torch/serving_http.py``) and the serve entry
(``python -m msr3d_tpu_torch.serve``).

The models and requests are those of ``tests/test_torch_serving.py`` (the
tiny fp32 model, the port holding the JAX weights). Every answer's tokens
must equal the JAX engine's for the same request, run once per module
(``jax_tokens``). The serve entry runs on ``configs/debug_synthetic.yaml``
with random weights, in this process and as a subprocess stopped by
SIGTERM, and on ``configs/debug_synthetic_leo.yaml`` against JAX's serve
entry."""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from msr3d_tpu import serving as jax_serving
from msr3d_tpu import serving_http as jax_http
from msr3d_tpu_torch.serving import (
    ContinuousBatchingServer,
    ContinuousBeamBatchingServer,
    OnlineRequestStream,
    PrefixPoolContinuousBatchingServer,
    PrefixPoolContinuousBeamBatchingServer,
)
from msr3d_tpu_torch.serving_http import (
    RequestError,
    ServingFrontend,
    encode_scene_b64,
    parse_generate_request,
)
from msr3d_tpu_torch.serve import create_frontend, parse_args

from test_torch_serving import build_models, make_requests, prompt_bucket

REPO = Path(__file__).resolve().parent.parent
MAX_NEW, N_REQ = 8, 6


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def reqs():
    return make_requests(N_REQ, seed=11)


@pytest.fixture(scope="module")
def jax_tokens(models, reqs):
    """Each request's tokens from the JAX greedy and beam engines."""
    jmodel, _ = models
    out = {}
    for name, cls in (("greedy", jax_serving.ContinuousBatchingServer),
                      ("beam", jax_serving.ContinuousBeamBatchingServer)):
        engine = cls(jmodel, num_slots=3, refill_group=1, chunk_steps=3, max_new_tokens=MAX_NEW,
                     prompt_len=prompt_bucket(jmodel, reqs))
        out[name] = {r.id: np.asarray(r.output_tokens) for r in engine.run(reqs)}
    return out


def _engine(model, reqs, cls=ContinuousBatchingServer, **kw):
    kw = dict(dict(num_slots=3, refill_group=1, chunk_steps=3), **kw)
    return cls(model, max_new_tokens=MAX_NEW, prompt_len=prompt_bucket(model, reqs), **kw)


def _body(req, **extra):
    return dict({"prompt": req["msr3d_prompt"], "scene_b64": encode_scene_b64(req)}, **extra)


def _post(port, body, timeout=120):
    request = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _health(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/health", timeout=30) as resp:
        return json.loads(resp.read())


def _http_error(port, body) -> urllib.error.HTTPError:
    with pytest.raises(urllib.error.HTTPError) as info:
        _post(port, body)
    return info.value


def test_online_stream_waves_equal_jax(models, reqs, jax_tokens):
    """Two waves with a full-idle gap: the engine sleeps, wakes on the second
    wave, returns after close(); tokens equal JAX's."""
    _, model = models
    stream, got, done = OnlineRequestStream(), {}, threading.Event()

    def on_result(res):
        got[res.id] = np.asarray(res.output_tokens)
        if len(got) == N_REQ:
            done.set()

    thread = threading.Thread(target=_engine(model, reqs).run, args=(stream,),
                              kwargs={"on_result": on_result})
    thread.start()
    try:
        for q in reqs[:3]:
            stream.submit(q)
        deadline = time.time() + 120
        while len(got) < 3 and time.time() < deadline:
            time.sleep(0.02)
        assert len(got) == 3, "first wave not served"
        time.sleep(0.2)  # the engine sits in stream.wait()
        for q in reqs[3:]:
            stream.submit(q)
        assert done.wait(120), "second wave not served"
    finally:
        stream.close()
        thread.join(60)
    assert not thread.is_alive()
    for rid, tokens in jax_tokens["greedy"].items():
        np.testing.assert_array_equal(got[rid], tokens)


def test_online_stream_close_drains_pending(models, reqs, jax_tokens):
    _, model = models
    stream = OnlineRequestStream()
    for q in reqs[:4]:
        stream.submit(q)
    stream.close()
    with pytest.raises(RuntimeError):
        stream.submit(reqs[0])
    results = _engine(model, reqs).run(stream)  # no on_result: results retained
    assert [r.id for r in results] == [0, 1, 2, 3]
    for r in results:
        np.testing.assert_array_equal(r.output_tokens, jax_tokens["greedy"][r.id])


def test_parse_generate_request_equals_jax(reqs):
    body = _body(reqs[0], max_new_tokens=7)
    small = {"prompt": "hi 景", "obj_fts": np.zeros((2, 8, 6)).tolist(),
             "obj_masks": [True, False], "obj_locs": np.zeros((2, 6)).tolist(),
             "anchor_locs": [0.0, 0.0, 0.0], "anchor_orientation": [0.0, 0.0, 0.0, 1.0]}
    for good in (body, small):
        got, budget = parse_generate_request(good)
        want, want_budget = jax_http.parse_generate_request(good)
        assert budget == want_budget and sorted(got) == sorted(want)
        for key in want:
            if key != "msr3d_prompt":
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    assert parse_generate_request(body)[1] == 7
    assert encode_scene_b64(reqs[1]) == jax_http.encode_scene_b64(reqs[1])
    for bad in ({}, {"prompt": ""}, {"prompt": "x"}, {**small, "max_new_tokens": 0},
                {**small, "scene_b64": "!!!notbase64!!!"}, [1, 2],
                {**small, "obj_masks": [True, False, True]}):
        with pytest.raises(RequestError):
            parse_generate_request(bad)


def test_http_serving_end_to_end(models, reqs, jax_tokens):
    """Concurrent clients get JAX's tokens; health counts them; a malformed
    request is a 400 and an unknown route a 404; after close() the engine
    thread is gone and submits are refused."""
    _, model = models
    with ServingFrontend(_engine(model, reqs), port=0) as fe:
        out = {}

        def client(i):
            out[i] = _post(fe.port, _body(reqs[i]))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_REQ)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        texts = model.batch_detokenize(np.stack([jax_tokens["greedy"][i] for i in range(N_REQ)]))
        for i, (status, payload) in out.items():
            assert status == 200
            np.testing.assert_array_equal(payload["tokens"], jax_tokens["greedy"][i])
            assert payload["text"] == texts[i]
        health = _health(fe.port)
        assert health["status"] == "ok" and health["served"] == N_REQ
        assert health["in_flight"] == 0 and health["decode_steps"] > 0
        assert health["slots"] == 3
        assert _http_error(fe.port, {"prompt": ""}).code == 400
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{fe.port}/nope", data=b"{}"), timeout=30)
        assert info.value.code == 404
    assert not fe._engine_thread.is_alive()
    with pytest.raises(RuntimeError):
        fe.stream.submit(reqs[0])


def test_http_beam_engine_equals_jax(models, reqs, jax_tokens):
    """The beam engine behind the front end: JAX's beam tokens; a streaming
    request is refused with 400 (beam hypotheses finalize at the end)."""
    _, model = models
    with ServingFrontend(_engine(model, reqs, cls=ContinuousBeamBatchingServer), port=0) as fe:
        for i in (0, 3):
            status, payload = _post(fe.port, _body(reqs[i]))
            assert status == 200
            np.testing.assert_array_equal(payload["tokens"], jax_tokens["beam"][i])
        assert _http_error(fe.port, _body(reqs[1], stream=True)).code == 400


def _read_sse(resp):
    events = []
    for raw in resp:
        line = raw.decode().strip()
        if line.startswith("data: "):
            events.append(json.loads(line[len("data: "):]))
            if events[-1].get("done"):
                break
    return events


def test_http_streaming_sse(models, reqs, jax_tokens):
    """SSE: text snapshots after each chunk, each a prefix of the final
    text, then the final tokens (JAX's); a plain request on the same engine
    still works, and the stream's registration is cleaned up."""
    _, model = models
    with ServingFrontend(_engine(model, reqs, chunk_steps=2), port=0) as fe:
        request = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/v1/generate",
            data=json.dumps(_body(reqs[0], stream=True)).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=180) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            events = _read_sse(resp)
        final = events[-1]
        assert final["done"] is True
        np.testing.assert_array_equal(final["tokens"], jax_tokens["greedy"][0])
        partials = [e for e in events if not e.get("done")]
        assert partials and all(final["text"].startswith(e["text"]) for e in partials)
        deadline = time.time() + 10
        while fe._progress and time.time() < deadline:
            time.sleep(0.05)
        assert fe._progress == {}
        status, payload = _post(fe.port, _body(reqs[1]))
        assert status == 200
        np.testing.assert_array_equal(payload["tokens"], jax_tokens["greedy"][1])


def test_http_budget_and_bad_requests(models, reqs, jax_tokens):
    """A per-request budget caps its answer (a prefix of the unbudgeted
    tokens, then eos); an oversize prompt, other scene shapes and arrays
    that disagree are 400s that leave the engine serving."""
    _, model = models
    eos = model.tokenizer.eos_id
    with ServingFrontend(_engine(model, reqs), port=0) as fe:
        status, payload = _post(fe.port, _body(reqs[0], max_new_tokens=3))
        assert status == 200
        toks = np.asarray(payload["tokens"])
        np.testing.assert_array_equal(toks[:3], jax_tokens["greedy"][0][:3])
        assert (toks[3:] == eos).all()
        err = _http_error(fe.port, _body(dict(reqs[1], msr3d_prompt=reqs[1]["msr3d_prompt"]
                                              + "x" * 4096)))
        assert err.code == 400 and "bucket" in json.loads(err.read())["error"]
        small = dict(reqs[1], **{k: np.asarray(reqs[1][k])[:1]
                                 for k in ("obj_fts", "obj_masks", "obj_locs")})
        err = _http_error(fe.port, _body(small))
        assert err.code == 400 and "shapes" in json.loads(err.read())["error"]
        assert _http_error(fe.port, _body(dict(reqs[1], obj_masks=np.ones(7, bool)))).code == 400
        status, payload = _post(fe.port, _body(reqs[2]))
        assert status == 200 and fe._engine_error is None
        np.testing.assert_array_equal(payload["tokens"], jax_tokens["greedy"][2])


def test_http_timed_out_result_not_leaked_and_keepalive(models, reqs):
    _, model = models
    fe = ServingFrontend(_engine(model, reqs), port=0).start()
    try:
        rid = fe.submit(reqs[0])
        assert fe.wait(rid, timeout=0.0) is None  # the waiter gives up at once
        deadline = time.time() + 120
        while fe._served < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert fe._served == 1
        time.sleep(0.1)
        with fe._lock:
            assert rid not in fe._results and rid not in fe._events
        # a POST with a body to a wrong path drains the body before its 404,
        # so the keep-alive connection parses the next request cleanly
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=120)
        body = json.dumps(_body(reqs[0]))
        conn.request("POST", "/wrong", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.request("POST", "/v1/generate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and isinstance(json.loads(resp.read())["text"], str)
        conn.close()
    finally:
        fe.close()


def test_engine_thread_runs_without_grad(models, reqs):
    """Grad mode is local to a thread: the front end's engine thread turns
    it off itself, even when the thread that starts it has it on."""
    _, model = models
    seen = []
    step = model.network.decode_step_shared

    def record(*args, **kw):
        seen.append(torch.is_grad_enabled())
        return step(*args, **kw)

    model.network.decode_step_shared = record
    try:
        with torch.enable_grad(), ServingFrontend(_engine(model, reqs), port=0) as fe:
            assert _post(fe.port, _body(reqs[0]))[0] == 200
    finally:
        del model.network.decode_step_shared
    assert seen and not any(seen)


def _scene(n_obj=4, n_pts=16, seed=3):
    r = np.random.default_rng(seed)
    return {"obj_fts": (r.normal(size=(n_obj, n_pts, 6)) * 0.1).astype(np.float32),
            "obj_masks": np.ones((n_obj,), bool),
            "obj_locs": r.normal(size=(n_obj, 6)).astype(np.float32),
            "anchor_locs": np.zeros((3,), np.float32),
            "anchor_orientation": np.array([0, 0, 0, 1], np.float32)}


def test_serve_cli_end_to_end():
    args = parse_args(["--config", "configs/debug_synthetic.yaml", "--device", "cpu",
                       "--random-init", "--port", "0", "--slots", "2", "--refill-group", "1",
                       "--chunk-steps", "2", "--max-new-tokens", "4"])
    fe = create_frontend(args)
    with fe:
        status, payload = _post(fe.port, {"prompt": "scene: 景 USER: what is here? ASSISTANT:",
                                          "scene_b64": encode_scene_b64(_scene())}, timeout=300)
        assert status == 200 and isinstance(payload["text"], str)
        assert len(payload["tokens"]) == 4
        health = _health(fe.port)
        assert health["status"] == "ok" and health["served"] == 1 and health["slots"] == 2
    assert not fe._engine_thread.is_alive()
    base = ["--config", "configs/debug_synthetic.yaml", "--device", "cpu", "--random-init"]
    # --prompt-len reaches the continuous and beam engines
    for engine in ("continuous", "beam"):
        fe = create_frontend(parse_args(base + ["--engine", engine, "--port", "0",
                                                "--slots", "2", "--prompt-len", "40"]))
        with fe:
            assert fe.engine.prompt_len == 40
    # the prefix-pool engines build and serve (their parity with JAX's:
    # tests/test_torch_serving_pool.py)
    for engine, cls in (("pool", PrefixPoolContinuousBatchingServer),
                        ("pool-beam", PrefixPoolContinuousBeamBatchingServer)):
        fe = create_frontend(parse_args(base + [
            "--engine", engine, "--port", "0", "--slots", "2", "--refill-group", "1",
            "--num-prefixes", "2", "--max-new-tokens", "4"]))
        assert type(fe.engine) is cls and fe.engine.num_prefixes == 2
        with fe:
            status, payload = _post(fe.port, {"prompt": "scene: 景 USER: what is here? "
                                              "ASSISTANT:", "scene_b64": encode_scene_b64(
                                                  _scene())}, timeout=300)
            assert status == 200 and len(payload["tokens"]) == 4, payload
        assert fe.engine.prefix_prefills == 1
    # ported: --engine grouped (tests/test_torch_scene_group.py) and --spec-k
    # (tests/test_torch_speculative.py), which refuses the config's penalty 3.0
    # as JAX's engine does
    with pytest.raises(ValueError, match="repetition_penalty"):
        create_frontend(parse_args(base + ["--spec-k", "2"]))


def test_serve_cli_on_the_leo_config_equals_jax(monkeypatch):
    """The serve entry on ``configs/debug_synthetic_leo.yaml`` (the
    ``as_object`` prompter: six objects give seven scene tokens, of which the
    config's six placeholders take the first six): one request gives the
    tokens the JAX serve entry gives on the same config, with the port's
    random init replaced by JAX's weights (fp32 in both)."""
    sys.path.insert(0, str(REPO))
    import serve as jax_serve
    from msr3d_tpu_torch.models.msr3d import MSR3D

    from test_torch_entry import _switch_to_fp32
    from torch_parity_utils import to_numpy_tree

    argv = ["--config", "configs/debug_synthetic_leo.yaml", "--random-init", "--port", "0",
            "--slots", "2", "--refill-group", "1", "--chunk-steps", "2",
            "--max-new-tokens", "6", "model.llm.param_dtype=fp32"]
    body = {"prompt": "scene: 景 USER: what is on my left? ASSISTANT:",
            "scene_b64": encode_scene_b64(_scene(n_obj=6, n_pts=64, seed=5))}
    _switch_to_fp32(monkeypatch)
    jfe = jax_serve.create_frontend(jax_serve.parse_args(argv))
    with jfe:
        status, want = _post(jfe.port, body, timeout=300)
    assert status == 200
    jparams = to_numpy_tree(jfe.engine.model.params)
    monkeypatch.setattr(MSR3D, "init_params",
                        lambda self, seed=None: self.load_jax_params(jparams))
    fe = create_frontend(parse_args(argv + ["--device", "cpu"]))
    model = fe.engine.model
    assert model.network.visual_prompter.cfg.situation_type == "as_object"
    assert model.cfg.llm.dtype == torch.float32 and model.scene_token_len == 6
    with fe:
        status, got = _post(fe.port, body, timeout=300)
    assert status == 200 and len(got["tokens"]) == 6
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]


def test_serve_module_drains_on_sigterm():
    """``python -m msr3d_tpu_torch.serve``: the listening line, one answer,
    then SIGTERM drains and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "msr3d_tpu_torch.serve", "--device", "cpu", "--config",
         "configs/debug_synthetic.yaml", "--random-init", "--port", "0", "--slots", "2",
         "--max-new-tokens", "4"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "listening on http://" in line:
                break
        port = int(lines[-1].split("http://")[1].split()[0].rsplit(":", 1)[1])
        status, payload = _post(port, {"prompt": "scene: 景 USER: hi? ASSISTANT:",
                                       "scene_b64": encode_scene_b64(_scene())}, timeout=300)
        assert status == 200 and len(payload["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, "".join(lines) + out
    assert "drained, bye" in out
