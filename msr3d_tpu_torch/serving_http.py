"""HTTP front end for the continuous serving engines: a QA endpoint on the
standard library alone.

Counterpart of ``msr3d_tpu/serving_http.py`` (``RequestError``,
``parse_generate_request``, ``encode_scene_b64``, ``ServingFrontend``), with
the same wire protocol:

    frontend = ServingFrontend(engine)          # engine: Continuous*Server
    frontend.start()                            # engine + HTTP threads
    ...                                         # POST /v1/generate
    frontend.close()

Handler threads only parse, ``submit()`` onto an
:class:`~msr3d_tpu_torch.serving.OnlineRequestStream` and wait on a
per-request event. One engine thread owns all device work: it runs
``engine.run(stream, on_result=...)`` under ``torch.no_grad()`` (grad mode
is local to a thread, so the handlers' mode would not reach it), batching
whatever requests are in flight, sleeping when idle, and returning when
the front end closes the stream.

``POST /v1/generate``
    {
      "prompt": "<msr3d_prompt string>",
      "max_new_tokens": 32,                      # optional, per request
      // scene arrays, one of:
      "scene_b64": "<base64 of an .npz>",        # keys below, compact
      // or inline JSON lists per key:
      "obj_fts": [...], "obj_masks": [...], "obj_locs": [...],
      "anchor_locs": [...], "anchor_orientation": [...]
    }
    -> 200 {"id": N, "text": "...", "tokens": [...]}
    -> 400 {"error": "..."} on malformed requests
    -> 503 {"error": "..."} when shutting down

    With ``"stream": true`` (greedy engine only) the answer is server-sent
    events (``text/event-stream``): after each decode chunk one
    ``data: {"text": <text so far>, "done": false}`` snapshot, then a final
    ``data: {"id": N, "text": ..., "tokens": [...], "done": true}``.

``GET /v1/health``
    -> 200 {"status": "ok", "slots": S, "pending": Q, "in_flight": F,
            "decode_steps": N, "served": M}

The npz form is the one for real scenes (60 x 1024 x 6 fp32 object points
are about 1.4 MB); JSON lists are for tests and small probes. Arrays are
cast to the model's contract (fp32 features and locations, bool masks).
"""

from __future__ import annotations

import base64
import io
import json
import queue as queue_mod
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch

from msr3d_tpu_torch.serving import OnlineRequestStream, Result, _collate

_SCENE_KEYS: Dict[str, Any] = {
    "obj_fts": np.float32,
    "obj_masks": bool,
    "obj_locs": np.float32,
    "anchor_locs": np.float32,
    "anchor_orientation": np.float32,
    "msr3d_imgs": np.float32,
    "msr3d_img_masks": bool,
    "img_fts": np.float32,
}
_REQUIRED = ("obj_fts", "obj_masks", "obj_locs", "anchor_locs",
             "anchor_orientation")


class RequestError(ValueError):
    """Malformed client request (maps to HTTP 400)."""


def _check_scene_shapes(sample: Dict[str, Any]) -> None:
    """Internal-consistency shape validation: a malformed request must be
    a 400, never an exception inside the (shared) engine thread — one bad
    request would otherwise kill the server for every client."""
    fts = sample["obj_fts"]
    if fts.ndim != 3 or fts.shape[-1] != 6:
        raise RequestError(f"obj_fts must be (O, P, 6), got {fts.shape}")
    n_obj = fts.shape[0]
    if sample["obj_masks"].shape != (n_obj,):
        raise RequestError(
            f"obj_masks must be ({n_obj},), got {sample['obj_masks'].shape}"
        )
    if sample["obj_locs"].shape != (n_obj, 6):
        raise RequestError(
            f"obj_locs must be ({n_obj}, 6), got {sample['obj_locs'].shape}"
        )
    if sample["anchor_locs"].shape != (3,):
        raise RequestError(
            f"anchor_locs must be (3,), got {sample['anchor_locs'].shape}"
        )
    if sample["anchor_orientation"].shape != (4,):
        raise RequestError(
            "anchor_orientation must be (4,), got "
            f"{sample['anchor_orientation'].shape}"
        )
    if "msr3d_imgs" in sample and sample["msr3d_imgs"].ndim != 4:
        raise RequestError(
            f"msr3d_imgs must be (N, H, W, C), got {sample['msr3d_imgs'].shape}"
        )


def parse_generate_request(body: Dict[str, Any]) -> Tuple[Dict[str, Any], Optional[int]]:
    """JSON body -> (engine sample dict, per-request budget or None)."""
    if not isinstance(body, dict):
        raise RequestError("body must be a JSON object")
    prompt = body.get("prompt")
    if not isinstance(prompt, str) or not prompt:
        raise RequestError("'prompt' (non-empty string) is required")
    sample: Dict[str, Any] = {"msr3d_prompt": prompt}

    if "scene_b64" in body:
        try:
            raw = base64.b64decode(body["scene_b64"], validate=True)
            arrays = np.load(io.BytesIO(raw))
        except Exception as exc:
            raise RequestError(f"scene_b64 is not a base64 .npz: {exc}")
        for key in arrays.files:
            if key in _SCENE_KEYS:
                sample[key] = np.asarray(arrays[key], dtype=_SCENE_KEYS[key])
    for key, dtype in _SCENE_KEYS.items():
        if key in body:
            try:
                sample[key] = np.asarray(body[key], dtype=dtype)
            except Exception as exc:
                raise RequestError(f"bad array for '{key}': {exc}")
    missing = [k for k in _REQUIRED if k not in sample]
    if missing:
        raise RequestError(f"missing scene arrays: {missing}")
    _check_scene_shapes(sample)

    budget = body.get("max_new_tokens")
    if budget is not None:
        try:
            budget = int(budget)
        except (TypeError, ValueError):
            raise RequestError("'max_new_tokens' must be an integer")
        if budget < 1:
            raise RequestError("'max_new_tokens' must be >= 1")
    return sample, budget


def encode_scene_b64(sample: Dict[str, Any]) -> str:
    """Client-side helper: pack a sample's scene arrays into the
    ``scene_b64`` field (the compact transport for real-scale points)."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in sample.items()
                     if k in _SCENE_KEYS and v is not None})
    return base64.b64encode(buf.getvalue()).decode("ascii")


class ServingFrontend:
    """Ties one continuous-batching engine to a threaded HTTP server.

    ``engine`` is a :class:`~msr3d_tpu_torch.serving.ContinuousBatchingServer`
    (or the beam subclass) over a model with its weights. ``port=0``
    binds an ephemeral port (read it back from ``frontend.port``).
    """

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout: float = 600.0,
    ):
        self.engine = engine
        self.stream = OnlineRequestStream()
        self.request_timeout = request_timeout
        self._lock = threading.Lock()
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, Result] = {}
        self._progress: Dict[int, "queue_mod.Queue"] = {}
        self._served = 0
        self._engine_error: Optional[BaseException] = None
        self._scene_shapes = None  # the serving shapes, set by the first request

        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # one engine, many handler threads: handlers only parse,
            # submit and wait; all device work stays on the engine thread
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/v1/health":
                    self._reply(200, frontend.health())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                # read the body FIRST: replying without consuming it
                # desyncs HTTP/1.1 keep-alive (leftover bytes parse as
                # the connection's next request line)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                except Exception:
                    self.close_connection = True
                    self._reply(400, {"error": "unreadable body"})
                    return
                if self.path != "/v1/generate":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    body = json.loads(raw or b"{}")
                    sample, budget = parse_generate_request(body)
                    frontend.validate_for_engine(sample)
                except RequestError as exc:
                    self._reply(400, {"error": str(exc)})
                    return
                except Exception as exc:
                    self._reply(400, {"error": f"bad request: {exc}"})
                    return
                stream_mode = bool(body.get("stream", False))
                if stream_mode and not getattr(
                    frontend.engine, "supports_progress", False
                ):
                    self._reply(400, {
                        "error": "stream=true requires the greedy engine "
                        "(beam hypotheses finalize at search end)"
                    })
                    return
                try:
                    rid = frontend.submit(sample, budget, stream=stream_mode)
                except RuntimeError as exc:  # stream closed
                    self._reply(503, {"error": str(exc)})
                    return
                if stream_mode:
                    self._stream_events(rid)
                    return
                try:
                    res = frontend.wait(rid, frontend.request_timeout)
                except RuntimeError as exc:  # engine died mid-request
                    self._reply(503, {"error": str(exc), "id": rid})
                    return
                if res is None:
                    self._reply(
                        504, {"error": "generation timed out", "id": rid}
                    )
                    return
                self._reply(200, {
                    "id": res.id,
                    "text": res.output_text,
                    "tokens": np.asarray(res.output_tokens).tolist(),
                })

            def _sse(self, payload: Dict[str, Any]) -> None:
                self.wfile.write(
                    f"data: {json.dumps(payload)}\n\n".encode()
                )
                self.wfile.flush()

            def _stream_events(self, rid: int) -> None:
                """Server-sent events: a "text so far" snapshot after each
                decode chunk, then one final event with done=true."""
                import time as _time

                q = frontend.progress_queue(rid)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
                model = frontend.engine.model
                last_len = -1
                deadline = _time.monotonic() + frontend.request_timeout
                try:
                    while True:
                        left = deadline - _time.monotonic()
                        if left <= 0:
                            self._sse({"error": "generation timed out",
                                       "done": True})
                            return
                        try:
                            kind, payload = q.get(timeout=min(left, 5.0))
                        except queue_mod.Empty:
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        if kind == "tokens":
                            if len(payload) == last_len:
                                continue  # lookahead re-delivered a prefix
                            last_len = len(payload)
                            text = (
                                model.batch_detokenize(
                                    np.asarray(payload)[None]
                                )[0]
                                if len(payload) else ""
                            )
                            self._sse({"text": text, "done": False})
                        elif kind == "done":
                            res = payload
                            self._sse({
                                "id": res.id,
                                "text": res.output_text,
                                "tokens":
                                    np.asarray(res.output_tokens).tolist(),
                                "done": True,
                            })
                            return
                        else:  # engine error
                            self._sse({"error": repr(payload), "done": True})
                            return
                except (BrokenPipeError, ConnectionResetError):
                    return  # client went away; engine finishes on its own
                finally:
                    frontend.finish_stream(rid)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._engine_thread = threading.Thread(
            target=self._run_engine, name="msr3d-engine", daemon=True
        )
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="msr3d-http", daemon=True
        )

    # -- engine side ----------------------------------------------------

    def _run_engine(self) -> None:
        try:
            torch.set_grad_enabled(False)  # this thread's grad mode; run() also sets it
            kw = {}
            if getattr(self.engine, "supports_progress", False):
                kw["on_progress"] = self._on_progress
                # per-chunk count-copy + token fetch only while some
                # client actually registered a streaming request
                kw["progress_gate"] = lambda: bool(self._progress)
            self.engine.run(self.stream, on_result=self._on_result, **kw)
        except BaseException as exc:  # surface to waiting handlers
            self._engine_error = exc
            with self._lock:
                events = list(self._events.values())
                queues = list(self._progress.values())
            for ev in events:
                ev.set()
            for q in queues:
                q.put(("error", exc))

    def _on_result(self, res: Result) -> None:
        with self._lock:
            self._served += 1
            ev = self._events.get(res.id)
            q = self._progress.get(res.id)
            if ev is not None:
                # keep the result only while a waiter exists — timed-out
                # or disconnected requests must not leak Results forever
                self._results[res.id] = res
        if q is not None:
            q.put(("done", res))
        if ev is not None:
            ev.set()

    def _on_progress(self, rid: int, tokens: np.ndarray) -> None:
        # engine thread; registered streaming requests only, snapshots
        with self._lock:
            q = self._progress.get(rid)
        if q is not None:
            q.put(("tokens", np.array(tokens, copy=True)))

    # -- producer side --------------------------------------------------

    def validate_for_engine(self, sample: Dict[str, Any]) -> None:
        """Checks against the engine's fixed shapes, so that a bad request is
        a 400 on its own connection and never an exception on the shared
        engine thread (which would answer 503 to every later client):

        - the expanded prompt must fit the engine's prompt width, where the
          engine has one; on a prefix-pool engine its prefix and its suffix
          must fit their buckets, checked by the engine's own split, which
          is attached to the sample (``_pool_split``) so that the engine
          does not tokenize it again;
        - the scene arrays' shapes must match the serving shapes, which the
          first accepted request pins.

        Costs one host tokenize a request."""
        model = self.engine.model
        if hasattr(self.engine, "_split_sample"):
            try:
                sample["_pool_split"] = self.engine._split_sample(sample)
            except (AssertionError, ValueError) as exc:
                raise RequestError(str(exc))
            except Exception as exc:
                raise RequestError(f"prompt build failed: {exc}")
        else:
            try:
                prompts = model.build_text_prompt(_collate([sample]))
                ids, _ = model._encode_prompts(prompts)
            except Exception as exc:
                raise RequestError(f"prompt build failed: {exc}")
            # an engine without a fixed prompt bucket (the scene-grouped
            # server buckets each batch itself) needs no width check
            engine_prompt_len = getattr(self.engine, "prompt_len", None)
            if engine_prompt_len is not None and ids.shape[1] > engine_prompt_len - 1:
                raise RequestError(
                    f"prompt expands to {ids.shape[1]} tokens; the engine's prompt bucket "
                    f"allows {engine_prompt_len - 1}"  # the trailing bos
                )
        shapes = tuple(
            (k, tuple(np.asarray(sample[k]).shape))
            for k in sorted(k for k in sample if k in _SCENE_KEYS)
        )
        with self._lock:
            if self._scene_shapes is None:
                self._scene_shapes = shapes
            elif shapes != self._scene_shapes:
                raise RequestError(
                    f"scene shapes {dict(shapes)} do not match this "
                    f"server's shapes {dict(self._scene_shapes)}"
                )

    def submit(
        self,
        sample: Dict[str, Any],
        budget: Optional[int] = None,
        stream: bool = False,
    ) -> int:
        """Register interest and enqueue; returns the request id."""
        if self._engine_error is not None:
            raise RuntimeError(f"engine died: {self._engine_error!r}")
        with self._lock:
            # the lock orders this against _on_result/_on_progress: the
            # engine cannot deliver rid's events before registration
            rid = self.stream.submit(sample, budget)
            self._events[rid] = threading.Event()
            if stream:
                self._progress[rid] = queue_mod.Queue()
        return rid

    def progress_queue(self, rid: int) -> "queue_mod.Queue":
        with self._lock:
            return self._progress[rid]

    def finish_stream(self, rid: int) -> None:
        with self._lock:
            self._progress.pop(rid, None)
            self._events.pop(rid, None)
            self._results.pop(rid, None)

    def wait(self, rid: int, timeout: Optional[float] = None) -> Optional[Result]:
        """Block until request ``rid`` finishes; None on timeout."""
        with self._lock:
            ev = self._events.get(rid)
        if ev is None:
            raise KeyError(f"unknown request id {rid}")
        ev.wait(timeout)
        with self._lock:
            self._events.pop(rid, None)
            res = self._results.pop(rid, None)
        if res is None and self._engine_error is not None:
            raise RuntimeError(f"engine died: {self._engine_error!r}")
        return res

    def health(self) -> Dict[str, Any]:
        with self._lock:
            in_flight = len(self._events)
            served = self._served
        return {
            "status": "error" if self._engine_error else "ok",
            "slots": self.engine.num_slots,
            "pending": self.stream.pending,
            "in_flight": in_flight,
            "decode_steps": int(getattr(self.engine, "steps_run", 0)),
            "served": served,
        }

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ServingFrontend":
        self._engine_thread.start()
        self._http_thread.start()
        return self

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop taking requests, drain in-flight work, stop HTTP.

        ``timeout=None`` waits until the engine has drained completely: a
        deployment that promises every accepted request an answer (the
        serve entry's SIGTERM path) must use it; a finite timeout can
        abandon a long backlog when the process exits."""
        self.stream.close()
        if self._engine_thread.is_alive():
            self._engine_thread.join(timeout)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread.is_alive():
            self._http_thread.join(timeout)

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
