"""Serving engines for MSR3D generation: the fixed and the scene-grouped
batchers, the slot-refill continuous engines, greedy (also speculative
and sampled) and beam, and the prefix-pool engines over a shared pool of
scene-prefix KV blocks, greedy (also speculative) and beam.

Counterpart of ``msr3d_tpu/serving.py`` (``Result``, ``RequestStreamIdle``,
``OnlineRequestStream``, ``_collate``, ``uncollate_batch``,
``BatchingServer``, ``scene_fingerprint``, ``SceneGroupBatchingServer``,
``ContinuousBatchingServer``, ``_hf_beam_machinery``,
``ContinuousBeamBatchingServer``, ``PrefixPoolContinuousBatchingServer``,
``PrefixPoolContinuousBeamBatchingServer``), with the same host loop, the
same request ids and the same tokens request for request.

Each request is a single-sample dict with the keys a dataset item has
(``msr3d_prompt``, ``obj_fts`` (O, P, 6), ``obj_masks``, ``obj_locs``,
``anchor_locs``, ``anchor_orientation``, optional ``msr3d_imgs`` with
``msr3d_img_masks``, or ``img_fts``).

The JAX engines are jitted programs over a donated device state
(``prefill``, ``insert``, ``decode_chunk`` as a ``lax.while_loop``; the pool
engines' ``prefix_prefill``, ``prefix_insert`` and ``suffix_insert``). Here
the state is a dict of tensors on the model's device, updated in place: a
prefill is ``MSR3DNetwork.prefill`` (kernels K1 and K2f, through the same
wrappers ``MSR3D.generate`` uses), ``insert`` writes a refill group's rows
at its slots, and a decode chunk is a Python loop of up to ``chunk_steps``
decode steps that reads ``run.any()`` on the host before each step, so it
stops where JAX's ``while_loop`` stops and ``steps_run`` counts the same
steps. Slots sit at different depths, so every row writes its generated
KV at its own slot (``llama._cache_write`` with a (B,) index) and picks
its token with ``pick_next_rows``. Under ``lookahead`` the host reads a
chunk's ``finished``, ``generated`` and ``cnt`` after later chunks have
changed the state, so they are cloned on the device when the chunk ends.
With ``spec_k`` > 0 a chunk step is one verify window of spec_k + 1 tokens
a slot (``llama._cache_write`` then writes a window a row); with the
model's ``do_sample`` each slot samples from a key folded from its
request id at insert and from the row's step at each pick. The pool
engines' prefix prefill writes only its valid rows into their blocks (JAX
scatters with ``mode="drop"``), and their decode reads the pool through a
view, not a copy.

Under tensor parallelism (a model whose LLM is split over the tp group,
``MSR3D.shard_for_serving``) every tp rank runs the engine SPMD on the same
requests: the logits are gathered whole on every rank, so each rank makes
the same host decisions, and a continuous engine checks at the end of
``run`` that the ranks emitted the same tokens (one sha256 gathered over
the tp group).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from msr3d_tpu_torch.models.llm import prng
from msr3d_tpu_torch.parallel.tensor_parallel import check_tp_agree
from msr3d_tpu_torch.models.llm.llama import _make_cache, _write_rows
from msr3d_tpu_torch.models.llm.sampling import (
    _NEG,
    _mask_min_length,
    _scatter_drop,
    _top_k,
    apply_repetition_penalty,
    ngram_propose,
    pick_next_rows,
    pick_next_rows_sampled,
    spec_accept,
)
from msr3d_tpu_torch.models.llm.tokenizer import IMAGE_PLACEHOLDER, SCENE_PLACEHOLDER

_BATCH_KEYS = (
    "obj_fts",
    "obj_masks",
    "obj_locs",
    "anchor_locs",
    "anchor_orientation",
    "msr3d_imgs",
    "msr3d_img_masks",
    "img_fts",  # LEO-format single ego view
)
@dataclasses.dataclass
class Result:
    id: int
    output_text: str
    output_tokens: np.ndarray


class RequestStreamIdle(Exception):
    """Raised by :class:`OnlineRequestStream` when no request is pending
    now but more may arrive: the engine keeps decoding what is in flight."""


class OnlineRequestStream:
    """Thread-safe request feed for online serving.

    A plain iterable ends :meth:`ContinuousBatchingServer.run` when it is
    exhausted. This stream instead keeps the engine alive while producers
    (the HTTP handler threads) ``submit()`` requests at any time:

    - ``__next__`` raises :class:`RequestStreamIdle` when the queue is
      empty for now, so chunks in flight keep running;
    - at full idle (no slot busy, nothing queued) the engine sleeps in
      :meth:`wait` until the next ``submit`` or ``close``;
    - after :meth:`close` the queue drains and ``StopIteration`` ends the
      run loop.

    The engine numbers requests in pull order, which is submission order,
    so :meth:`submit`'s return value is the ``id`` of the eventual
    :class:`Result` (when one ``run()`` consumes the stream from its
    start, the only supported use).
    """

    def __init__(self):
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._n = 0

    def submit(self, sample: Dict[str, Any], budget: Optional[int] = None) -> int:
        """Enqueue one request; returns its future result id."""
        with self._cv:
            if self._closed:
                raise RuntimeError("stream is closed")
            self._q.append((sample, budget))
            rid = self._n
            self._n += 1
            self._cv.notify_all()
            return rid

    def close(self) -> None:
        """No further submits; the engine drains and run() returns."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._q)

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            if self._q:
                return self._q.popleft()
            if self._closed:
                raise StopIteration
            raise RequestStreamIdle

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until a request is pending or the stream is closed."""
        with self._cv:
            self._cv.wait_for(lambda: self._q or self._closed, timeout)


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    batch: Dict[str, Any] = {"msr3d_prompt": [s["msr3d_prompt"] for s in samples]}
    for key in _BATCH_KEYS:
        if key in samples[0] and samples[0][key] is not None:
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
    return batch


def uncollate_batch(data_dict: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Split one collated loader batch into per-request samples, the inverse
    of :func:`_collate`, so eval batches can feed the continuous engines.

    Prompts come out in the unexpanded placeholder form the engines'
    prefill expects: ``msr3d_prompt`` passes through; the LEO prompt parts
    (``prompt_before_obj``, the middles, ``prompt_after_obj``) are composed
    into the one-placeholder string that ``build_text_prompt`` expands as
    its LEO branch does."""
    if "msr3d_prompt" in data_dict:
        prompts = list(data_dict["msr3d_prompt"])
    else:
        prompts = [
            f"{before} {mid1}{IMAGE_PLACEHOLDER}. {mid2} {SCENE_PLACEHOLDER}. {after}"
            for before, mid1, mid2, after in zip(
                data_dict["prompt_before_obj"], data_dict["prompt_middle_1"],
                data_dict["prompt_middle_2"], data_dict["prompt_after_obj"],
            )
        ]
    samples: List[Dict[str, Any]] = [{"msr3d_prompt": p} for p in prompts]
    for key in _BATCH_KEYS:
        v = data_dict.get(key)
        if v is None:
            continue
        arr = np.asarray(v)
        assert arr.shape[0] == len(samples), (
            f"{key}: leading dim {arr.shape[0]} != batch {len(samples)}")
        for i, s in enumerate(samples):
            s[key] = arr[i]
    return samples


class BatchingServer:
    """Fixed-size batcher over ``MSR3D.generate_async``: requests are
    stacked into batches of ``batch_size`` (a partial last batch repeats
    its last request, and the copies' outputs are dropped), with at most
    ``pipeline_depth`` batches unfinalized. Results carry submission ids.

        server = BatchingServer(model, batch_size=16, pipeline_depth=3)
        results = list(server.run(requests))         # bulk
        server.submit(request); ...; server.flush()   # incremental
    """

    def __init__(
        self,
        model,
        batch_size: int,
        *,
        pipeline_depth: int = 3,
        use_beam: Optional[bool] = None,
        max_new_tokens: Optional[int] = None,
    ):
        assert batch_size >= 1
        self.model = model
        self.batch_size = batch_size
        self.pipeline_depth = max(0, pipeline_depth)
        self.use_beam = use_beam
        self.max_new_tokens = max_new_tokens
        self._queue: deque = deque()
        self._next_id = 0
        self._inflight: deque = deque()  # (finalize, [ids], n_real)
        self._ready: List[Result] = []

    def submit(self, sample: Dict[str, Any]) -> int:
        """Enqueue one request; returns its id. Dispatches a batch whenever
        a full one is queued."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, sample))
        while len(self._queue) >= self.batch_size:
            self._ready.extend(self._dispatch(self.batch_size))
        return rid

    def flush(self) -> List[Result]:
        """Dispatch the remainder, finalize everything in flight, and return
        every result not returned yet, in id order."""
        out, self._ready = self._ready, []
        if self._queue:
            out.extend(self._dispatch(len(self._queue)))
        while self._inflight:
            out.extend(self._drain_one())
        out.sort(key=lambda r: r.id)
        return out

    def run(self, samples: Iterable[Dict[str, Any]]) -> Iterator[Result]:
        """Serve an iterable of requests, yielding results as batches
        finish (within a batch, in submission order)."""
        for s in samples:
            self.submit(s)
            if self._ready:
                ready, self._ready = self._ready, []
                yield from ready
        yield from self.flush()

    def _dispatch(self, n: int) -> List[Result]:
        taken = [self._queue.popleft() for _ in range(n)]
        ids = [rid for rid, _ in taken]
        samples = [s for _, s in taken]
        while len(samples) < self.batch_size:  # pad the partial batch
            samples.append(samples[-1])
        finalize = self.model.generate_async(
            _collate(samples), use_beam=self.use_beam, max_new_tokens=self.max_new_tokens)
        self._inflight.append((finalize, ids, n))
        done: List[Result] = []
        while len(self._inflight) > self.pipeline_depth:
            done.extend(self._drain_one())
        return done

    def _drain_one(self) -> List[Result]:
        finalize, ids, n = self._inflight.popleft()
        data = finalize()
        return [Result(id=ids[i], output_text=data["output_text"][i],
                       output_tokens=np.asarray(data["output_tokens"][i])) for i in range(n)]


def scene_fingerprint(sample: Dict[str, Any]) -> Any:
    """The grouping key of :class:`SceneGroupBatchingServer`: a sample's
    ``group_key`` where it has one, else a blake2b digest (16 bytes, hex) of
    every scene array it carries, each as its key, its shape and its bytes,
    so that two requests group only if the prefix prefill would see the
    same inputs (the JAX package's digest, byte for byte)."""
    if "group_key" in sample:
        return sample["group_key"]
    h = hashlib.blake2b(digest_size=16)
    for key in _BATCH_KEYS:
        v = sample.get(key)
        if v is not None:
            arr = np.ascontiguousarray(np.asarray(v))
            h.update(key.encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


class SceneGroupBatchingServer:
    """Scene-grouped serving: requests that share a scene are answered by one
    grouped program (``MSR3D.generate_scene_group_async``), so the scene
    encode and the prefix prefill run once a scene, not once a question.

    The contract of :class:`BatchingServer` (submit, flush, run; results
    carry submission ids), plus grouping:

    - requests group by :func:`scene_fingerprint`;
    - a group is full at ``questions_per_scene`` requests, and a batch of
      ``scenes_per_batch`` full groups dispatches as one program;
    - ``flush()`` dispatches the ragged rest;
    - beyond ``max_open_scenes`` open groups (a stream that is not
      scene-contiguous) the oldest dispatch unfilled.

    A batch whose prompts diverge inside a group before the placeholders (a
    miskeyed group) falls back to singleton groups, each question its own
    prefix: still the grouped program, still exact.
    """

    def __init__(
        self,
        model,
        scenes_per_batch: int,
        questions_per_scene: int,
        *,
        pipeline_depth: int = 3,
        use_beam: Optional[bool] = None,
        max_new_tokens: Optional[int] = None,
        max_open_scenes: Optional[int] = None,
    ):
        assert scenes_per_batch >= 1 and questions_per_scene >= 1
        self.model = model
        self.scenes_per_batch = scenes_per_batch
        self.questions_per_scene = questions_per_scene
        self.pipeline_depth = max(0, pipeline_depth)
        self.use_beam = use_beam
        self.max_new_tokens = max_new_tokens
        self.max_open_scenes = max_open_scenes or 4 * scenes_per_batch
        self._next_id = 0
        self._open: Dict[Any, List] = {}  # key -> [(rid, sample), ...]
        self._open_order: List[Any] = []
        self._full: List[List] = []  # full groups waiting for a batch
        self._inflight: deque = deque()  # (finalize, [ids])
        self._ready: List[Result] = []

    @property
    def num_slots(self) -> int:
        return self.scenes_per_batch * self.questions_per_scene

    def submit(self, sample: Dict[str, Any]) -> int:
        """Enqueue one request; returns its id."""
        rid = self._next_id
        self._next_id += 1
        key = scene_fingerprint(sample)
        if key not in self._open:
            self._open[key] = []
            self._open_order.append(key)
        self._open[key].append((rid, sample))
        if len(self._open[key]) >= self.questions_per_scene:
            self._full.append(self._open.pop(key))
            self._open_order.remove(key)
        while len(self._open_order) > self.max_open_scenes:
            self._full.append(self._open.pop(self._open_order.pop(0)))
        while len(self._full) >= self.scenes_per_batch:
            groups = self._full[:self.scenes_per_batch]
            self._full = self._full[self.scenes_per_batch:]
            self._ready.extend(self._dispatch(groups))
        return rid

    def _dispatch_rest(self) -> List[Result]:
        """Dispatch every buffered group, full or not, a batch at a time."""
        rest = self._full + [self._open.pop(k) for k in list(self._open_order)]
        self._full, self._open_order = [], []
        out: List[Result] = []
        for start in range(0, len(rest), self.scenes_per_batch):
            out.extend(self._dispatch(rest[start:start + self.scenes_per_batch]))
        return out

    def flush(self) -> List[Result]:
        """Dispatch the rest, finalize everything in flight, and return every
        result not returned yet, in id order."""
        out, self._ready = self._ready, []
        out.extend(self._dispatch_rest())
        while self._inflight:
            out.extend(self._drain_one())
        out.sort(key=lambda r: r.id)
        return out

    def run(self, samples, on_result=None, idle_flush_s: float = 0.05):
        """Serve requests.

        Bulk (an iterable, no ``on_result``): a generator of results, as
        :meth:`BatchingServer.run`.

        Online (an :class:`OnlineRequestStream` and ``on_result``, the HTTP
        front end's engine thread): pulls until the stream closes and
        delivers each result through the callback. Groups wait for their
        scene-mates only while requests keep coming: after ``idle_flush_s``
        of a quiet stream every buffered group dispatches, ragged or
        singleton. A request's ``max_new_tokens`` truncates its tokens (the
        grouped program decodes one budget for all its rows)."""
        if on_result is None:
            return self._run_bulk(samples)
        assert isinstance(samples, OnlineRequestStream), \
            "online mode expects an OnlineRequestStream"
        budgets: Dict[int, Optional[int]] = {}

        def deliver(results: List[Result]) -> None:
            for res in results:
                cap = budgets.pop(res.id, None)
                if cap is not None and len(res.output_tokens) > cap:
                    toks = np.asarray(res.output_tokens)[:cap]
                    res = Result(id=res.id, output_text=self.model.batch_detokenize(toks[None])[0],
                                 output_tokens=toks)
                on_result(res)

        while True:
            try:
                sample, budget = next(samples)
            except RequestStreamIdle:
                if self._inflight:
                    deliver(self._drain_one())
                elif self._open or self._full:
                    # a quiet stream with groups buffered: a grace, then all go
                    samples.wait(timeout=idle_flush_s)
                    if samples.pending == 0 and not samples.closed:
                        deliver(self._dispatch_rest())
                else:
                    samples.wait(timeout=1.0)
                continue
            except StopIteration:
                break
            rid = self.submit(sample)
            budgets[rid] = budget
            if self._ready:
                ready, self._ready = self._ready, []
                deliver(ready)
        deliver(self.flush())

    def _run_bulk(self, samples: Iterable[Dict[str, Any]]) -> Iterator[Result]:
        for s in samples:
            self.submit(s)
            if self._ready:
                ready, self._ready = self._ready, []
                yield from ready
        yield from self.flush()

    def _dispatch(self, groups: List[List]) -> List[Result]:
        ids = [rid for grp in groups for rid, _ in grp]
        try:
            finalize = self._dispatch_grouped(groups)
        except ValueError:
            # prompts diverge before the placeholders (a miskeyed group):
            # singleton groups are always valid, the whole prompt a prefix
            finalize = self._dispatch_grouped([[(rid, s)] for grp in groups for rid, s in grp])
        self._inflight.append((finalize, ids))
        done: List[Result] = []
        while len(self._inflight) > self.pipeline_depth:
            done.extend(self._drain_one())
        return done

    def _dispatch_grouped(self, groups: List[List]):
        batch = _collate([grp[0][1] for grp in groups])
        batch["msr3d_prompt"] = [[s["msr3d_prompt"] for _, s in grp] for grp in groups]
        return self.model.generate_scene_group_async(batch, use_beam=self.use_beam,
                                                     max_new_tokens=self.max_new_tokens)

    def _drain_one(self) -> List[Result]:
        finalize, ids = self._inflight.popleft()
        data = finalize()
        return [Result(id=ids[i], output_text=data["output_text"][i],
                       output_tokens=np.asarray(data["output_tokens"][i]))
                for i in range(len(ids))]


# ---------------------------------------------------------------------------
# Continuous batching: slot refill
# ---------------------------------------------------------------------------


class ContinuousBatchingServer:
    """Slot-refill continuous batching for greedy serving.

    The fixed batcher decodes every batch until its slowest request ends.
    This engine keeps ``num_slots`` requests decoding together and refills
    a slot as soon as its request finishes, so at mixed answer lengths a
    request costs about the mean number of steps, not the maximum.

    - The prefill runs at the refill group size R (``refill_group``) over
      prompts left-padded to ``prompt_len`` (default the model's
      ``prompt_pad_to``, the trailing bos included).
    - ``insert`` writes the R prefilled rows (prompt KV, mask, first token,
      position, budget) at R free slots; rows past the group's requests
      are padding and insert idle.
    - A decode chunk runs up to ``chunk_steps`` steps; rows write their KV
      at their own slots and pick their tokens row by row.

    A request finishes at EOS or at its own budget (``budgets`` of
    :meth:`run`, a sample's ``max_new_tokens``, or the engine-wide
    ``max_new_tokens``). ``drain_between_batches=True`` refills only once
    every slot is free: gang scheduling with the same programs.
    """

    supports_progress = True  # on_progress streams greedy prefixes

    def __init__(
        self,
        model,
        num_slots: int,
        *,
        refill_group: int = 4,
        chunk_steps: int = 16,
        max_new_tokens: Optional[int] = None,
        prompt_len: Optional[int] = None,
        drain_between_batches: bool = False,
        lookahead: int = 1,
        spec_k: int = 0,
        spec_ngram: int = 3,
    ):
        assert 1 <= refill_group <= num_slots
        if spec_k > 0 and model.repetition_penalty != 1.0:
            raise ValueError("speculative continuous batching requires repetition_penalty == "
                             "1.0 (the penalty serializes the verify window)")
        self.sample = bool(getattr(model, "do_sample", False))
        if self.sample and spec_k > 0:
            raise ValueError("do_sample and spec_k are mutually exclusive — n-gram "
                             "verification accepts drafts against the argmax pick")
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.model = model
        self.num_slots = num_slots
        self.refill_group = refill_group
        self.chunk_steps = chunk_steps
        self.max_new = int(max_new_tokens or model.max_out_len)
        self.prompt_len = int(prompt_len or model.prompt_pad_to)
        self.drain_between_batches = drain_between_batches
        # up to `lookahead` further chunks run before a chunk's flags are
        # read, so scheduling lags by at most that many chunks
        self.lookahead = max(0, lookahead)
        self.steps_run = 0  # decode steps (model calls), for utilization reporting
        self.tokens_digest: Optional[str] = None  # sha256 of the last run's emitted tokens

    # -- device state ----------------------------------------------------

    def _llm_cfg(self):
        return self.model.network.llm.cfg

    def _slot_state(self, gen_len: int, ids_len: int):
        """Every slot idle and finished: a generated KV segment of ``gen_len``
        slots a row and, with ``spec_k``, ``ids_len`` prompt ids a slot (the
        drafts' context)."""
        cfg, dev = self._llm_cfg(), self.model.device
        b, s_g = self.num_slots, self.max_new
        eos = self.model.tokenizer.eos_id
        state = dict(
            gen_kv=_make_cache(cfg, b, gen_len, dev),
            generated=torch.full((b, s_g), eos, dtype=torch.int32, device=dev),
            cnt=torch.zeros(b, dtype=torch.long, device=dev),
            pos=torch.zeros(b, dtype=torch.long, device=dev),
            finished=torch.ones(b, dtype=torch.bool, device=dev),
            active=torch.zeros(b, dtype=torch.bool, device=dev),
            seen=torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev),
            budget=torch.zeros(b, dtype=torch.long, device=dev),
        )
        if self.spec_k:
            state["prompt_ids"] = torch.zeros((b, ids_len), dtype=torch.int32, device=dev)
        if self.sample:  # each slot's key, folded from its request id
            state["rng"] = torch.zeros((b, 2), dtype=torch.int64, device=dev)
        return state

    def _init_state(self):
        """(prompt_kv, prompt_mask), state: every slot idle and finished."""
        cfg, dev = self._llm_cfg(), self.model.device
        b = self.num_slots
        prompt = (_make_cache(cfg, b, self.prompt_len, dev),
                  torch.zeros((b, self.prompt_len), dtype=torch.bool, device=dev))
        return prompt, self._slot_state(self.max_new, self.prompt_len - 1)

    def _pick_rows(self, logits, seen, steps, keys=None):
        model = self.model
        kw = dict(eos_id=model.tokenizer.eos_id, repetition_penalty=model.repetition_penalty,
                  eos_logit_bias=model.eos_logit_bias)
        if self.sample:
            return pick_next_rows_sampled(logits, seen, steps, prng.fold_in(keys, steps),
                                          temperature=model.temperature, top_k=model.top_k,
                                          top_p=model.top_p, **kw)
        return pick_next_rows(logits, seen, steps, **kw)

    @staticmethod
    def _insert_prompt(prompt_ctx, kv, mask, slots):
        prompt_kv, prompt_mask = prompt_ctx
        for key, arr in prompt_kv.items():
            arr[:, slots] = kv[key].to(arr.dtype)
        prompt_mask[slots] = mask

    def _insert(self, prompt_ctx, state, kv, mask, first, next_pos, slots, valid, budgets,
                ids=None, rids=None):
        """Write a prefilled group at ``slots``: its prompt KV and mask, then
        its rows (``_insert_rows``)."""
        self._insert_prompt(prompt_ctx, kv, mask, slots)
        self._insert_rows(state, first, next_pos, slots, valid, budgets, ids, rids)

    def _insert_rows(self, state, first, next_pos, slots, valid, budgets, ids=None, rids=None):
        """Start a group's requests at ``slots``: the first token picked at
        step 0 from ``first`` (R, V), count 1, position and budget, and with
        ``spec_k`` their prompt ``ids``, with ``do_sample`` their keys folded
        from the request ids ``rids``; padding rows (``valid`` False) insert
        finished and idle."""
        r, v = first.shape
        dev = first.device
        eos = self.model.tokenizer.eos_id
        row_keys = None
        if self.sample:
            seed_key = prng.prng_key(self.model.sample_seed, dev)
            row_keys = prng.fold_in(seed_key.expand(r, 2), rids)
            state["rng"][slots] = row_keys
        if self.spec_k:
            state["prompt_ids"][slots] = ids.to(torch.int32)
        tok0 = self._pick_rows(first.float(), torch.zeros((r, v), dtype=torch.bool, device=dev),
                               torch.zeros(r, dtype=torch.long, device=dev), row_keys)
        gen_rows = torch.full((r, self.max_new), eos, dtype=torch.int32, device=dev)
        gen_rows[:, 0] = tok0
        seen_rows = torch.zeros((r, v), dtype=torch.bool, device=dev)
        seen_rows[torch.arange(r, device=dev), tok0.long()] = True
        fin0 = (tok0 == eos) | (budgets <= 1)
        state["generated"][slots] = gen_rows
        state["seen"][slots] = seen_rows
        state["cnt"][slots] = 1
        state["pos"][slots] = next_pos.long()
        state["finished"][slots] = torch.where(valid, fin0, True)
        state["active"][slots] = valid
        state["budget"][slots] = budgets

    def _gen_offset(self, state) -> int:
        """Where a slot's tokens start in its generated KV segment."""
        return 0

    def _gen_mask(self, state, visible: torch.Tensor) -> torch.Tensor:
        """The generated segment's mask from the token slots ``visible``
        (B, S_g)."""
        return visible

    def _running(self, state) -> Optional[torch.Tensor]:
        """The rows still decoding, or None when none is (one host read:
        the exit test of JAX's ``while_loop``)."""
        run = state["active"] & ~state["finished"]
        return run if bool(run.any()) else None

    def _decode_chunk(self, prompt_ctx, state) -> int:
        """Up to ``chunk_steps`` greedy steps over the slots in place;
        returns the steps run."""
        if self.spec_k:
            return self._decode_chunk_spec(prompt_ctx, state)
        prompt_kv, prompt_mask = prompt_ctx
        model = self.model
        eos = model.tokenizer.eos_id
        dev = state["cnt"].device
        s_g = self.max_new
        rows = torch.arange(self.num_slots, device=dev)
        slot_iota = torch.arange(s_g, device=dev)[None, :]
        w = self._gen_offset(state)
        steps = 0
        while steps < self.chunk_steps:
            run = self._running(state)
            if run is None:
                break
            cnt = state["cnt"]
            tok = state["generated"][rows, (cnt - 1).clamp(min=0)]
            gen_index = torch.where(run, w + cnt - 1, -1)  # idle rows write nothing
            logits = model.network.decode_step_shared(
                tok[:, None].long(), state["pos"][:, None], prompt_kv, prompt_mask,
                state["gen_kv"], gen_index, self._gen_mask(state, slot_iota < cnt[:, None]))
            nxt = self._pick_rows(logits[:, -1, :].float(), state["seen"], cnt,
                                  state.get("rng"))
            nxt = torch.where(run, nxt, eos)
            col = cnt.clamp(max=s_g - 1)
            state["generated"][rows, col] = torch.where(run, nxt, state["generated"][rows, col])
            state["seen"][rows, nxt.long()] |= run
            state["finished"] |= run & ((nxt == eos) | (cnt + 1 >= state["budget"]))
            inc = run.long()
            state["cnt"] += inc
            state["pos"] += inc
            steps += 1
        return steps

    def _decode_chunk_spec(self, prompt_ctx, state) -> int:
        """Up to ``chunk_steps`` verify windows over the slots in place:
        each running slot proposes spec_k drafts from its context (its
        prompt ids, then its tokens; the prefill's trailing bos between them
        is not in it, which costs drafts, never tokens; the prefix-pool
        engine's ids end with the suffix's bos), writes the window [last
        token, drafts] from token slot cnt-1 of its generated segment (slots
        before it are its accepted context) and emits the accepted drafts
        and the model's next pick, up to EOS and its budget. Returns the
        model calls run."""
        prompt_kv, prompt_mask = prompt_ctx
        model = self.model
        eos = model.tokenizer.eos_id
        dev = state["cnt"].device
        s_g, k = self.max_new, self.spec_k
        n_ids = state["prompt_ids"].shape[1]
        w = self._gen_offset(state)
        rows = torch.arange(self.num_slots, device=dev)
        slot_iota = torch.arange(s_g, device=dev)[None, :]
        win = torch.arange(k + 1, device=dev)
        steps = 0
        while steps < self.chunk_steps:
            run = self._running(state)
            if run is None:
                break
            cnt = state["cnt"]
            generated = state["generated"]
            last_tok = generated[rows, (cnt - 1).clamp(min=0)]
            ctx = torch.cat([state["prompt_ids"], generated], dim=1)
            props = ngram_propose(ctx, n_ids + cnt, ngram_n=self.spec_ngram, k=k, pad_id=eos)
            verify = torch.cat([last_tok[:, None], props], dim=1).long()
            logits = model.network.decode_step_shared(
                verify, state["pos"][:, None] + win, prompt_kv, prompt_mask, state["gen_kv"],
                torch.where(run, w + cnt - 1, -1),
                self._gen_mask(state, slot_iota < (cnt - 1)[:, None]))
            lg = logits.float()
            if model.eos_logit_bias:
                lg[..., eos] += model.eos_logit_bias
            y = lg.argmax(dim=-1).to(torch.int32)  # (B, K+1)
            steps_idx = cnt[:, None] + win
            emit, _, is_eos_y = spec_accept(props, y, steps_idx, state["budget"][:, None], run,
                                            eos)
            state["generated"] = _scatter_drop(generated, rows[:, None],
                                               torch.where(emit, steps_idx, s_g),
                                               torch.where(emit, y, eos))
            n_new = emit.sum(dim=1)
            state["finished"] |= run & ((emit & is_eos_y).any(dim=1)
                                        | (cnt + n_new >= state["budget"]))
            state["cnt"] += n_new
            state["pos"] += n_new
            steps += 1
        return steps

    # -- host side -------------------------------------------------------

    def _prefill_group(self, samples: List[Dict[str, Any]]):
        """Prefill R samples at the engine's prompt width: (first-token
        logits (R, V) fp32, prompt KV, mask, next positions, the prompt ids
        (R, prompt_len - 1))."""
        model = self.model
        data = _collate(samples)
        ids, attn = model._encode_prompts(model.build_text_prompt(data))
        width = self.prompt_len - 1  # the prefill appends the trailing bos
        assert ids.shape[1] <= width, (
            f"prompt ({ids.shape[1]} tokens) exceeds the engine bucket ({width}); "
            "raise prompt_len")
        pad = width - ids.shape[1]
        if pad:
            b = ids.shape[0]
            ids = np.concatenate([np.full((b, pad), model.tokenizer.pad_id, ids.dtype), ids], 1)
            attn = np.concatenate([np.zeros((b, pad), attn.dtype), attn], 1)
        dev = model.device
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
        return model.network.prefill(
            ids_t, torch.as_tensor(attn, dtype=torch.int32, device=dev),
            **model._gen_scene_batch(data), bos_id=model.tokenizer.bos_id,
            max_cache_len=self.prompt_len) + (ids_t,)

    # -- scheduling-loop hooks (the prefix-pool engines override them) -----

    def _engine_init(self):
        """(prompt_ctx, state): the prompt side threaded through refill and
        decode, and the slot state."""
        return self._init_state()

    def _take_group(self, queue: deque) -> list:
        """Pop the next refill group (at most ``refill_group`` requests). An
        empty group means head-of-line blocked: the loop decodes on."""
        n = min(self.refill_group, len(queue))
        return [queue.popleft() for _ in range(n)]

    def _engine_refill(self, prompt_ctx, state, group, slots):
        """Prefill ``group`` (list of (rid, sample, budget)) and insert it at
        ``slots`` (exactly R slot ids; rows past the group insert idle)."""
        r = self.refill_group
        samples = [s for _, s, _ in group]
        budgets = [b for _, _, b in group]
        while len(samples) < r:  # pad the tail group
            samples.append(samples[-1])
            budgets.append(1)
        first, kv, mask, next_pos, ids = self._prefill_group(samples)
        dev = self.model.device
        valid = torch.arange(r, device=dev) < len(group)
        rids = [rid for rid, _, _ in group] + [0] * (r - len(group))  # padding rows idle
        self._insert(prompt_ctx, state, kv, mask, first, next_pos,
                     torch.as_tensor(slots, dtype=torch.long, device=dev), valid,
                     torch.as_tensor(budgets, dtype=torch.long, device=dev), ids=ids,
                     rids=torch.as_tensor(rids, dtype=torch.long, device=dev))
        return prompt_ctx, state

    def _engine_decode(self, prompt_ctx, state):
        return self._decode_chunk(prompt_ctx, state), state

    def _on_slot_free(self, slot: int) -> None:
        """Called when a finished request releases its slot."""

    @torch.no_grad()
    def run(
        self,
        samples: Iterable[Dict[str, Any]],
        *,
        budgets: Optional[Iterable[int]] = None,
        on_result=None,
        on_progress=None,
        progress_gate=None,
    ) -> List[Result]:
        """Serve all requests; returns the results in request order.

        ``samples`` is read lazily: at most one refill group beyond what the
        free slots take. Budgets come from ``budgets`` (parallel to
        ``samples``), a sample's ``max_new_tokens`` or the engine's.

        ``on_result(result)`` is called as each request finishes, in
        completion order. With an :class:`OnlineRequestStream` the loop
        serves until ``stream.close()``; with ``on_result`` set there, the
        results go to the callback only and the return value is empty.

        ``on_progress(rid, tokens)`` streams the tokens so far of each
        running request after every chunk (a snapshot; under lookahead the
        same prefix may come twice); greedy engine only. ``progress_gate()``,
        read at each chunk, skips the copies while it is False."""
        if on_progress is not None and not self.supports_progress:
            raise ValueError("on_progress streaming is greedy-engine only (beam hypotheses "
                             "finalize at the end of the search)")
        model = self.model
        model.network.eval()

        online = isinstance(samples, OnlineRequestStream)
        if online:
            # the stream yields (sample, budget) itself; a generator around it
            # would end for good at the first RequestStreamIdle
            assert budgets is None, "an online stream carries its own budgets"
            pairs = samples
        elif budgets is not None:
            pairs = iter(zip(samples, budgets))
        else:
            pairs = iter((s, None) for s in samples)
        next_rid = 0
        exhausted = False
        queue: deque = deque()  # (rid, sample, budget)

        def pull(n: int) -> None:
            # top the queue up to n pending requests (or the iterator's end)
            nonlocal next_rid, exhausted
            while not exhausted and len(queue) < n:
                try:
                    s, b = next(pairs)
                except StopIteration:
                    exhausted = True
                    return
                except RequestStreamIdle:
                    return  # for now: the online stream may refill
                if b is None:
                    b = s.get("max_new_tokens", self.max_new)
                queue.append((next_rid, s, max(1, min(int(b), self.max_new))))
                next_rid += 1

        # a long-lived online server delivers through on_result only
        retain_results = not (online and on_result is not None)
        results: Dict[int, Result] = {}
        # every request's tokens in completion order: under tensor
        # parallelism each tp rank serves the same requests, and its host
        # decisions (finished rows, beam reorders, refills) must agree
        emitted = hashlib.sha256()

        prompt_ctx, state = self._engine_init()
        free: deque = deque(range(self.num_slots))
        slot_rid: Dict[int, int] = {}
        self.steps_run = 0
        r = self.refill_group
        # a chunk's copies speak for a slot only if no refill happened after
        # that chunk: under lookahead the flag of a refilled slot may still be
        # its previous occupant's
        slot_epoch = [0] * self.num_slots
        inflight: deque = deque()  # (steps, finished, generated, epochs, cnt)

        def process_one():
            steps, fin_dev, gen_dev, epochs, cnt_dev = inflight.popleft()
            self.steps_run += int(steps)
            finished = fin_dev.cpu().numpy()
            gen = None
            if cnt_dev is not None:
                gen = gen_dev.cpu().numpy()
                cnt = cnt_dev.cpu().numpy()
                for s, rid in list(slot_rid.items()):
                    if epochs[s] == slot_epoch[s] and not finished[s]:
                        on_progress(rid, gen[s, : int(cnt[s])])
            done = [s for s in list(slot_rid) if finished[s] and epochs[s] == slot_epoch[s]]
            if done:
                if gen is None:
                    gen = gen_dev.cpu().numpy()
                texts = model.batch_detokenize(np.stack([gen[s] for s in done]))
                for j, s in enumerate(done):
                    rid = slot_rid.pop(s)
                    emitted.update(np.int64(rid).tobytes() + gen[s].tobytes())
                    res = Result(id=rid, output_text=texts[j], output_tokens=gen[s])
                    if retain_results:
                        results[rid] = res
                    if on_result is not None:
                        on_result(res)
                    free.append(s)
                    self._on_slot_free(s)

        while True:
            # refill whenever a full group of free slots is there; drain mode
            # refills only once every slot is home, still group by group
            burst = not (self.drain_between_batches and slot_rid)
            if burst and len(free) >= r:
                pull(r)
            can_refill = burst and len(free) >= r and bool(queue)
            while can_refill:
                group = self._take_group(queue)
                if not group:
                    break  # head-of-line blocked: decode on
                n_real = len(group)
                slots = [free.popleft() for _ in range(r)]
                prompt_ctx, state = self._engine_refill(prompt_ctx, state, group, slots)
                for j, (rid, _, _) in enumerate(group):
                    slot_rid[slots[j]] = rid
                for s in slots:
                    slot_epoch[s] += 1
                for s_pad in slots[n_real:]:  # padding rows are idle
                    free.append(s_pad)
                if len(free) >= r:
                    pull(r)
                can_refill = burst and len(free) >= r and bool(queue)

            if slot_rid:
                steps, state = self._engine_decode(prompt_ctx, state)
                want_progress = on_progress is not None and (
                    progress_gate is None or progress_gate())
                # copies on the device: the next chunk and refills change the
                # state before the host reads this chunk's flags
                inflight.append((steps, state["finished"].clone(), state["generated"].clone(),
                                 tuple(slot_epoch),
                                 state["cnt"].clone() if want_progress else None))

            # keep at most `lookahead` chunks unread while work remains
            target = self.lookahead if slot_rid else 0
            while len(inflight) > target or (not slot_rid and inflight):
                process_one()

            if not slot_rid and not inflight and not queue:
                pull(r)
                if not queue:
                    if online and not exhausted:
                        samples.wait()  # fully idle: sleep until a submit or close
                        continue
                    break  # everything served

        self.tokens_digest = emitted.hexdigest()
        check_tp_agree(self.tokens_digest, "the tokens this engine emitted")
        return [results[k] for k in sorted(results)]


def _hf_beam_machinery(*, K, V, S_g, eos, pad, lp, rp, eos_bias, device, min_length=1):
    """The per-slot HF beam search of the beam engine: finalize, the
    ``early_stopping=False`` done test, step 0 from the first-token logits,
    and the 2K-candidate re-rank step. It is ``beam_search_decode_shared``
    with every scalar step made per slot; top-k ties resolve as
    ``lax.top_k``'s (``sampling._top_k``)."""
    neg = torch.tensor(_NEG, dtype=torch.float32, device=device)
    # n ** length_penalty in fp32, the table generate divides by
    norm = (torch.arange(S_g + 2, dtype=torch.float32) ** lp).to(device)

    def finalize_best(beam_tokens, beam_scores, hyp_tokens, hyp_scores, budget):
        """Per slot, the live beams compete with the pool at the budget
        length: (B, K, S_g) beams → the best (B, S_g)."""
        live_norm = beam_scores / norm[budget.clamp(min=1)][:, None]
        all_scores = torch.cat([hyp_scores, live_norm], dim=1)
        all_tokens = torch.cat([hyp_tokens, beam_tokens], dim=1)
        best = all_scores.argmax(dim=1)
        return all_tokens[torch.arange(all_tokens.shape[0], device=device), best]

    def running_done(beam_scores, hyp_scores, step):
        # done when the best live score at the current length cannot beat
        # the worst of K finished hypotheses, per slot at its own step
        best_live = beam_scores.amax(dim=1) / norm[step + 1]
        worst_hyp = hyp_scores.amin(dim=1)
        full = (hyp_scores > _NEG / 2).sum(dim=1) >= K
        return full & (worst_hyp >= best_live)

    def step0(first, budgets):
        """Beam step 0: the K best first tokens; EOS candidates finalize at
        once. → (gen_rows (r, K, S_g), scores (r, K), hyp tokens, hyp
        scores, seen (r, K, V), finished, the finalized best)."""
        r = first.shape[0]
        logp0 = torch.log_softmax(
            _mask_min_length(first.float(), 0, min_length, eos, eos_bias), dim=-1)
        top_logp, top_tok = _top_k(logp0, K)
        gen_rows = torch.full((r, K, S_g), pad, dtype=torch.int32, device=device)
        gen_rows[:, :, 0] = top_tok.to(torch.int32)
        seen_rows = torch.zeros((r * K, V), dtype=torch.bool, device=device)
        seen_rows[torch.arange(r * K, device=device), top_tok.reshape(-1)] = True
        is_eos0 = top_tok == eos
        hyp_tok_rows = torch.where(is_eos0[..., None], gen_rows, pad)
        hyp_score_rows = torch.where(is_eos0, top_logp / norm[1], neg)
        score_rows = torch.where(is_eos0, neg, top_logp)
        # the done test of the fixed loop's first pass (step 1)
        done0 = running_done(score_rows, hyp_score_rows,
                             torch.ones(r, dtype=torch.long, device=device))
        fin0 = done0 | (budgets <= 1)
        out0 = finalize_best(gen_rows, score_rows, hyp_tok_rows, hyp_score_rows, budgets)
        return (gen_rows, score_rows, hyp_tok_rows, hyp_score_rows,
                seen_rows.reshape(r, K, V), fin0, out0)

    def rerank(st, logits, run, cnt):
        """One re-rank from the step's last-token logits: log-probs, the
        penalty and EOS bias, 2K candidates, the EOS candidates into the
        slot's pool, the best K others live on, the ancestry map follows the
        beams, and a slot that stops finalizes. Returns the new state."""
        b = cnt.shape[0]
        rows_k = torch.arange(b * K, device=device)
        block = torch.arange(b, device=device)[:, None] * K
        beam_eye = torch.arange(K, device=device)[None, :].expand(b, K)
        run_k = run.repeat_interleave(K)
        cnt_k = cnt.repeat_interleave(K)
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        logp = apply_repetition_penalty(logp, st["seen"], rp)
        logp = _mask_min_length(logp, 1, 1, eos, eos_bias)
        if min_length > 1:
            logp = logp.clone()
            logp[:, eos] = torch.where(cnt_k < min_length - 1, float("-inf"), logp[:, eos])

        total = (st["beam_scores"][:, None] + logp).reshape(b, K * V)
        cand_scores, cand_idx = _top_k(total, 2 * K)
        cand_beam = cand_idx // V
        cand_tok = (cand_idx % V).to(torch.int32)
        cand_is_eos = cand_tok == eos

        # the EOS candidates join the slot's pool of finished hypotheses
        cand_seqs = st["beam_tokens"][(block + cand_beam).reshape(-1)].reshape(b, 2 * K, S_g)
        col_mask = (torch.arange(S_g, device=device)[None, None, :]
                    == cnt.clamp(max=S_g - 1)[:, None, None])
        cand_seqs = torch.where(col_mask,
                                torch.where(cand_is_eos, eos, pad).to(torch.int32)[..., None],
                                cand_seqs)
        cand_norm = torch.where(cand_is_eos, cand_scores / norm[cnt + 1][:, None], neg)
        pool_scores = torch.cat([st["hyp_scores"], cand_norm], dim=1)
        pool_tokens = torch.cat([st["hyp_tokens"], cand_seqs], dim=1)
        top_pool, pool_idx = _top_k(pool_scores, K)
        hyp_scores = torch.where(run[:, None], top_pool, st["hyp_scores"])
        hyp_tokens = torch.where(run[:, None, None],
                                 torch.take_along_dim(pool_tokens, pool_idx[:, :, None], dim=1),
                                 st["hyp_tokens"])

        # the best K other candidates live on (pad at a dead score past them)
        _, live_pick = _top_k(torch.where(cand_is_eos, neg, cand_scores), K)
        valid_live = torch.gather(~cand_is_eos, 1, live_pick)
        new_tok = torch.where(valid_live, torch.gather(cand_tok, 1, live_pick), pad)
        new_scores = torch.where(valid_live, torch.gather(cand_scores, 1, live_pick), neg)
        # idle slots gather their own rows (their state is frozen)
        new_beam = torch.where(run[:, None], torch.gather(cand_beam, 1, live_pick), beam_eye)
        gather = (block + new_beam).reshape(-1)
        beam_tokens = st["beam_tokens"][gather]
        seen = st["seen"][gather]
        anc = st["anc"][gather]  # the generated KV never moves, only the map

        col_k = cnt_k.clamp(max=S_g - 1)
        new_tok = new_tok.reshape(-1)
        beam_tokens[rows_k, col_k] = torch.where(run_k, new_tok, beam_tokens[rows_k, col_k])
        seen[rows_k, new_tok.long()] |= run_k
        beam_scores = torch.where(run_k, new_scores.reshape(-1), st["beam_scores"])

        inc = run.long()
        cnt_new = cnt + inc
        # a slot stops at the fixed loop's test for its next step
        stop = (cnt_new >= st["budget"]) | running_done(beam_scores.reshape(b, K), hyp_scores,
                                                        cnt_new)
        newly_done = run & stop
        out = finalize_best(beam_tokens.reshape(b, K, S_g), beam_scores.reshape(b, K),
                            hyp_tokens, hyp_scores, st["budget"])
        generated = torch.where(newly_done[:, None], out, st["generated"])
        return dict(st, anc=anc, beam_tokens=beam_tokens, seen=seen, beam_scores=beam_scores,
                    hyp_tokens=hyp_tokens, hyp_scores=hyp_scores, generated=generated,
                    finished=st["finished"] | newly_done, cnt=cnt_new, pos=st["pos"] + inc)

    return finalize_best, running_done, step0, rerank


class _BeamSlots:
    """Per-slot beam search for a slot-refill engine: the beam count, the
    slots' beam state, beam step 0 where a group is inserted and the re-rank
    each decode step. Both beam engines list it before their greedy base
    (:class:`ContinuousBeamBatchingServer`,
    :class:`PrefixPoolContinuousBeamBatchingServer`), so these methods take
    the place of the greedy ones; each calls ``_init_beam`` at construction.
    """

    supports_progress = False  # hypotheses finalize at the end of the search

    def _init_beam(self, num_beams: Optional[int]) -> None:
        """The beam count (default the model's) and the per-slot search."""
        self.num_beams = int(num_beams or self.model.num_beams)
        assert self.num_beams >= 1
        if self.sample:
            raise ValueError("do_sample requires the greedy engine — beam-sampling is not "
                             "supported (as MSR3D.generate)")
        model = self.model
        _, _, self._step0, self._rerank = _hf_beam_machinery(
            K=self.num_beams, V=self._llm_cfg().vocab_size, S_g=self.max_new,
            eos=model.tokenizer.eos_id, pad=model.tokenizer.eos_id,  # generate pads with eos
            lp=model.length_penalty, rp=model.repetition_penalty,
            eos_bias=model.eos_logit_bias, device=model.device)

    def _slot_state(self, gen_len: int, ids_len: int):
        cfg, dev = self._llm_cfg(), self.model.device
        b, k, s_g = self.num_slots, self.num_beams, self.max_new
        pad = self.model.tokenizer.eos_id
        return dict(
            # the beams' generated KV rows never reorder: the ancestry map does
            gen_kv=_make_cache(cfg, b * k, gen_len, dev),
            anc=torch.zeros((b * k, s_g), dtype=torch.int32, device=dev),
            generated=torch.full((b, s_g), pad, dtype=torch.int32, device=dev),
            beam_tokens=torch.full((b * k, s_g), pad, dtype=torch.int32, device=dev),
            beam_scores=torch.full((b * k,), _NEG, dtype=torch.float32, device=dev),
            hyp_tokens=torch.full((b, k, s_g), pad, dtype=torch.int32, device=dev),
            hyp_scores=torch.full((b, k), _NEG, dtype=torch.float32, device=dev),
            seen=torch.zeros((b * k, cfg.vocab_size), dtype=torch.bool, device=dev),
            cnt=torch.zeros(b, dtype=torch.long, device=dev),
            pos=torch.zeros(b, dtype=torch.long, device=dev),
            finished=torch.ones(b, dtype=torch.bool, device=dev),
            active=torch.zeros(b, dtype=torch.bool, device=dev),
            budget=torch.zeros(b, dtype=torch.long, device=dev),
        )

    def _insert_rows(self, state, first, next_pos, slots, valid, budgets, ids=None, rids=None):
        """Start a group's beam searches at ``slots``: beam step 0 on
        ``first`` (R, V), count 1, position and budget."""
        k = self.num_beams
        r = slots.shape[0]
        pad = self.model.tokenizer.eos_id
        gen_rows, score_rows, hyp_tok, hyp_score, seen_rows, fin0, out0 = self._step0(
            first, budgets)
        rows = (slots[:, None] * k + torch.arange(k, device=slots.device)).reshape(-1)
        state["generated"][slots] = torch.where(fin0[:, None], out0, pad)
        state["beam_tokens"][rows] = gen_rows.reshape(r * k, -1)
        state["beam_scores"][rows] = score_rows.reshape(-1)
        state["hyp_tokens"][slots] = hyp_tok
        state["hyp_scores"][slots] = hyp_score
        state["seen"][rows] = seen_rows.reshape(r * k, -1)
        state["cnt"][slots] = 1
        state["pos"][slots] = next_pos.long()
        state["finished"][slots] = torch.where(valid, fin0, True)
        state["active"][slots] = valid
        state["budget"][slots] = budgets

    def _decode_chunk(self, prompt_ctx, state) -> int:
        prompt_kv, prompt_mask = prompt_ctx
        k = self.num_beams
        dev = state["cnt"].device
        rows_k = torch.arange(self.num_slots * k, device=dev)
        own = (rows_k % k).to(torch.int32)
        slot_iota = torch.arange(self.max_new, device=dev)[None, :]
        steps = 0
        while steps < self.chunk_steps:
            run = self._running(state)
            if run is None:
                break
            cnt_k = state["cnt"].repeat_interleave(k)
            tok = state["beam_tokens"][rows_k, (cnt_k - 1).clamp(min=0)]
            gen_index = torch.where(run.repeat_interleave(k), cnt_k - 1, -1)  # idle: no write
            # this step's KV lands in the row itself; idle rows leave the map
            _write_rows({"anc": state["anc"]}, {"anc": own}, gen_index)
            logits = self.model.network.decode_step_beam_anc(
                tok[:, None].long(), state["pos"].repeat_interleave(k)[:, None], prompt_kv,
                prompt_mask, state["gen_kv"], gen_index, slot_iota < cnt_k[:, None],
                state["anc"], k)
            state.update(self._rerank(state, logits, run, state["cnt"]))
            steps += 1
        return steps


class ContinuousBeamBatchingServer(_BeamSlots, ContinuousBatchingServer):
    """Slot-refill continuous batching for beam-search serving, the
    reference's eval decode (``num_beams`` 5, repetition penalty 3.0).

    Each slot owns a beam group: ``num_beams`` rows of the generated KV
    segment and the slot's pool of hypotheses. A slot runs the per-request
    search of ``beam_search_decode_shared`` (HF semantics, the ancestry map
    over generated rows that never move) at its own depth: per-slot
    ``cnt``/``pos``, per-row KV writes, per-slot done latching. A slot
    finalizes as soon as its own search ends, which is where the fixed
    loop ends at batch 1, and refills at once.

    Against the greedy engine's state: ``state["generated"]`` holds each
    slot's finalized best hypothesis (written on the step it finishes);
    the live beams are ``state["beam_tokens"]`` (B·K, S_g). The prompt KV
    stays at B slot rows, shared by a slot's beams. The host loop is the
    greedy engine's.
    """

    def __init__(
        self,
        model,
        num_slots: int,
        *,
        num_beams: Optional[int] = None,
        refill_group: int = 4,
        chunk_steps: int = 16,
        max_new_tokens: Optional[int] = None,
        prompt_len: Optional[int] = None,
        drain_between_batches: bool = False,
        lookahead: int = 1,
    ):
        super().__init__(model, num_slots, refill_group=refill_group, chunk_steps=chunk_steps,
                         max_new_tokens=max_new_tokens, prompt_len=prompt_len,
                         drain_between_batches=drain_between_batches, lookahead=lookahead)
        self._init_beam(num_beams)


# ---------------------------------------------------------------------------
# Prefix-pool engines: slot refill over a shared scene-prefix KV pool
# ---------------------------------------------------------------------------


class PrefixPoolContinuousBatchingServer(ContinuousBatchingServer):
    """Continuous batching over a shared pool of scene-prefix KV blocks: the
    MSQA serving shape, many questions a scene arriving as a stream.

    The plain engine prefills every request's whole prompt (preamble, scene
    and image tokens, question) into a per-slot prompt segment, so the scene
    encode and the prefix's attention repeat for each question. Here:

    - ``pool``: ``num_prefixes`` blocks G of ``prefix_len`` S_pre slots. A
      block holds one (scene, situation) prefix, the prompt up to and with
      its last scene or image placeholder, prefilled once (K1 and K2f) when
      it first appears and kept resident after its last request ends (LRU),
      so a scene that returns later is free.
    - a request's suffix (its question and the trailing bos) runs as one
      left-padded window of T = ``suffix_len`` W over its block's prefix
      (``window_valid`` hides the pad tokens); its k/v fill the head of the
      slot's generated segment, so a slot's own KV is W + S_g wide.
    - decode attends the pool as a batch-1 (1, G·S_pre) segment, a view of
      the pool that every slot reads, with a visibility row per slot that
      admits its own block's rows (the decode step's per-query
      ``prompt_mask``).

    A block's key is (``scene_fingerprint`` of the scene arrays, the prefix's
    token bytes): two requests share a block only if the prefill they would
    run is the same. A ``group_key`` is ignored for the key, so a miskeyed one
    never makes two scenes share a prefill. Prompts without a placeholder
    share one block that stays empty (the whole prompt rides the window).

    Scheduling is the slot-refill loop of the base engine. One new stall:
    when the next request needs a new block and every block is referenced
    by a running slot, refill waits (head-of-line blocking) until a slot
    frees one; a pool that can never take the request raises. Greedy, and
    with ``spec_k`` > 0 speculative (n-gram drafts over the request's
    prefix, suffix and generated tokens; repetition penalty 1.0); sampling
    stays on the plain engine.

    Counterpart of the JAX package's engine of the same name, with its host
    loop and its tokens request for request.
    """

    supports_progress = True
    _EMPTY_KEY = ("__no_placeholder_prefix__",)

    def __init__(
        self,
        model,
        num_slots: int,
        *,
        num_prefixes: int = 8,
        prefix_len: Optional[int] = None,
        suffix_len: int = 32,
        refill_group: int = 4,
        chunk_steps: int = 16,
        max_new_tokens: Optional[int] = None,
        drain_between_batches: bool = False,
        lookahead: int = 1,
        spec_k: int = 0,
        spec_ngram: int = 3,
    ):
        super().__init__(model, num_slots, refill_group=refill_group, chunk_steps=chunk_steps,
                         max_new_tokens=max_new_tokens,
                         prompt_len=prefix_len or model.prompt_pad_to,
                         drain_between_batches=drain_between_batches, lookahead=lookahead,
                         spec_k=spec_k, spec_ngram=spec_ngram)
        if self.sample:
            # a request's logits reduce over the whole pool width, so which
            # block it lands in moves its rounding: the plain engine's
            # (seed, request id) contract would not hold
            raise ValueError("do_sample serving is a plain-continuous-engine feature: the "
                             "(seed, request-id) determinism contract cannot be kept across "
                             "pool-block assignments")
        self.num_prefixes = int(num_prefixes)
        assert self.num_prefixes >= 1
        self.prefix_len = self.prompt_len  # the prefix bucket S_pre (no trailing bos)
        self.suffix_len = int(suffix_len)
        self._reset_pool()

    def _reset_pool(self) -> None:
        """Empty host bookkeeping of the pool (a run starts with a new pool)."""
        g = self.num_prefixes
        self._block_of: Dict[Any, int] = {}  # resident key -> block
        self._block_key: List[Any] = [None] * g
        self._block_ref = [0] * g  # running slots on each block
        self._free_tick = [0] * g  # LRU order among unreferenced blocks
        self._tick = 0
        self._slot_block: Dict[int, int] = {}
        # rid -> (block, needs prefill, prefix, suffix, sample)
        self._resolved: Dict[int, tuple] = {}
        self._split_cache: Dict[int, tuple] = {}  # rid -> (key, prefix, suffix)
        self._empty_bid: Optional[int] = None  # the block of prompts without a placeholder
        self.prefix_prefills = 0  # prefix-prefill calls of the run

    # -- host side: the pool ----------------------------------------------

    def _split_sample(self, sample: Dict[str, Any]):
        """(key, prefix token ids, suffix token ids) of one request. The split
        is after the last scene or image placeholder (special tokens, never
        merged), so requests whose text before the question and scene arrays
        match share the prefix tokens; the suffix is text alone. Raises
        ``ValueError`` where a part exceeds its bucket (the HTTP front end
        answers 400)."""
        tok = self.model.tokenizer
        texts = self.model.build_text_prompt(_collate([sample]))
        enc = tok.encode_batch(texts, padding_side="left", add_bos=True, pad_to=None)
        row = enc.input_ids[0][enc.attention_mask[0].astype(bool)]
        placeholders = {tok.scene_token_id, tok.img_token_id}
        last = -1
        for i, t in enumerate(row):
            if int(t) in placeholders:
                last = i
        if last < 0:
            prefix = np.zeros((0,), np.int32)
            key = self._EMPTY_KEY
        else:
            prefix = np.asarray(row[: last + 1], np.int32)
            arrays = {k: v for k, v in sample.items() if k != "group_key"}
            key = (scene_fingerprint(arrays), prefix.tobytes())
        suffix = [int(t) for t in row[last + 1:]] + [tok.bos_id]
        if len(prefix) > self.prefix_len:
            raise ValueError(f"scene prefix ({len(prefix)} tokens) exceeds the engine's prefix "
                             f"bucket ({self.prefix_len}); raise prefix_len")
        if len(suffix) > self.suffix_len:
            raise ValueError(f"question suffix ({len(suffix)} tokens incl. trailing bos) "
                             f"exceeds the engine's suffix bucket ({self.suffix_len}); raise "
                             "suffix_len")
        return key, prefix, suffix

    def _alloc_block(self, key) -> Optional[int]:
        """Claim a block for ``key``: a virgin block if any, else the least
        recently freed resident one (evicted). None: every block is taken."""
        virgin = None
        lru_bid, lru_tick = None, None
        for bid in range(self.num_prefixes):
            if self._block_ref[bid] > 0 or bid == self._empty_bid:
                continue
            if self._block_key[bid] is None:
                virgin = bid
                break
            if lru_tick is None or self._free_tick[bid] < lru_tick:
                lru_bid, lru_tick = bid, self._free_tick[bid]
        bid = virgin if virgin is not None else lru_bid
        if bid is None:
            return None
        old = self._block_key[bid]
        if old is not None:
            del self._block_of[old]
        self._block_key[bid] = key
        self._block_of[key] = bid
        return bid

    def _take_group(self, queue: deque) -> list:
        group = []
        group_new: Dict[Any, int] = {}  # key -> block claimed by this group
        while queue and len(group) < self.refill_group:
            rid, sample, budget = queue[0]
            pre_split = sample.get("_pool_split")
            if pre_split is not None:  # split by the HTTP front end's validation
                key, prefix, suffix = pre_split
            elif rid in self._split_cache:
                key, prefix, suffix = self._split_cache[rid]
            else:
                key, prefix, suffix = self._split_sample(sample)
                self._split_cache[rid] = (key, prefix, suffix)
            if key == self._EMPTY_KEY:
                if self._empty_bid is None:
                    # a permanent all-masked block, never prefilled
                    bid = self._alloc_block(key)
                    if bid is None:
                        break
                    self._empty_bid = bid
                bid, needs = self._empty_bid, False
            elif key in self._block_of:
                bid, needs = self._block_of[key], False
            elif key in group_new:
                bid, needs = group_new[key], False
            else:
                bid = self._alloc_block(key)
                if bid is None:
                    if not self._slot_block and not group:
                        # nothing runs and nothing is scheduled: no slot will
                        # ever free a block
                        raise RuntimeError(
                            "prefix pool exhausted with no active slots — "
                            f"num_prefixes={self.num_prefixes} cannot schedule this request "
                            "mix; raise num_prefixes")
                    break  # head-of-line blocked until a slot frees
                group_new[key] = bid
                needs = True
            queue.popleft()
            self._split_cache.pop(rid, None)
            self._block_ref[bid] += 1
            self._resolved[rid] = (bid, needs, prefix, suffix, sample)
            group.append((rid, sample, budget))
        return group

    def _on_slot_free(self, slot: int) -> None:
        bid = self._slot_block.pop(slot, None)
        if bid is not None:
            self._block_ref[bid] -= 1
            if self._block_ref[bid] == 0:
                self._tick += 1
                self._free_tick[bid] = self._tick

    # -- device side --------------------------------------------------------

    def _engine_init(self):
        """((pool k/v (L, G, S_pre, hkv, D), pool mask (G, S_pre), the
        prefixes' next positions (G,)), slot state)."""
        self._reset_pool()
        cfg, dev = self._llm_cfg(), self.model.device
        g, s_pre = self.num_prefixes, self.prefix_len
        pool = (_make_cache(cfg, g, s_pre, dev),
                torch.zeros((g, s_pre), dtype=torch.bool, device=dev),
                torch.zeros(g, dtype=torch.long, device=dev))
        return pool, self._pool_slot_state()

    def _pool_slot_state(self):
        """The slots: a generated KV segment of W + S_g slots a row whose
        first W hold the question window, the window's mask ``sufmask`` (B,
        W), each slot's block ``assign``; with ``spec_k`` the drafts' context
        of S_pre + W prompt ids."""
        b, w, dev = self.num_slots, self.suffix_len, self.model.device
        state = self._slot_state(w + self.max_new, self.prefix_len + w)
        state.update(sufmask=torch.zeros((b, w), dtype=torch.bool, device=dev),
                     assign=torch.zeros(b, dtype=torch.long, device=dev))
        return state

    def _engine_refill(self, prompt_ctx, state, group, slots):
        res = [self._resolved.pop(rid) for rid, _, _ in group]
        # each new key comes once with needs=True
        new = [(bid, pre, smp) for bid, needs, pre, _, smp in res if needs]
        if new:
            self._prefix_prefill(prompt_ctx, new)
        self._suffix_insert(prompt_ctx, state, group, res, slots)
        return prompt_ctx, state

    def _prefix_prefill(self, pool, new) -> None:
        """Prefill the group's new prefixes at batch R, left-padded to S_pre
        without a trailing bos (rows past them repeat one and are computed,
        not written), and write each new row into its block: k/v (with
        their scales in an int8 cache), mask, next position."""
        model = self.model
        r, width = self.refill_group, self.prefix_len
        ids = np.full((r, width), model.tokenizer.pad_id, np.int64)
        attn = np.zeros((r, width), np.int32)
        samples = []
        for j, (_, pre, smp) in enumerate(new):
            ids[j, width - len(pre):] = pre
            attn[j, width - len(pre):] = 1
            samples.append(smp)
        ids[len(new):], attn[len(new):] = ids[0], attn[0]
        samples += [samples[-1]] * (r - len(new))
        dev = model.device
        _, kv, mask, next_pos = model.network.prefill(
            torch.as_tensor(ids, device=dev), torch.as_tensor(attn, device=dev),
            **model._gen_scene_batch(_collate(samples)), bos_id=model.tokenizer.bos_id,
            max_cache_len=width, append_bos=False)
        self.prefix_prefills += 1
        pool_kv, pool_mask, pool_npre = pool
        n = len(new)
        blocks = torch.as_tensor([bid for bid, _, _ in new], dtype=torch.long, device=dev)
        for key, arr in pool_kv.items():
            arr[:, blocks] = kv[key][:, :n].to(arr.dtype)
        pool_mask[blocks] = mask[:n]
        pool_npre[blocks] = next_pos[:n].long()

    def _suffix_insert(self, pool, state, group, res, slots) -> None:
        """The group's suffixes as one window of T = W over their blocks'
        prefixes (gathered, R rows), then the slots: the window's k/v, its
        mask and the block at each slot, the first token from the window's
        last logits (rows past the group mirror row 0 and insert idle)."""
        model = self.model
        r, w = self.refill_group, self.suffix_len
        pad_id = model.tokenizer.pad_id
        sids = np.full((r, w), pad_id, np.int64)
        wv = np.zeros((r, w), bool)
        blocks = np.zeros(r, np.int64)
        budgets = np.ones(r, np.int64)
        for j, ((_, _, budget), (bid, _, _, suffix, _)) in enumerate(zip(group, res)):
            sids[j, w - len(suffix):] = suffix
            wv[j, w - len(suffix):] = True
            blocks[j] = bid
            budgets[j] = budget
            self._slot_block[slots[j]] = bid
        n = len(group)
        sids[n:], wv[n:], blocks[n:] = sids[0], wv[0], blocks[0]
        dev = model.device
        pool_kv, pool_mask, pool_npre = pool
        blocks_t = torch.as_tensor(blocks, device=dev)
        wv_t = torch.as_tensor(wv, device=dev)
        npre = pool_npre[blocks_t]
        win_pos = (npre[:, None] + torch.cumsum(wv_t.long(), dim=1) - 1).clamp(min=0)
        win_kv = _make_cache(self._llm_cfg(), r, w, dev)
        logits = model.network.decode_step_shared(
            torch.as_tensor(sids, device=dev), win_pos,
            {key: val[:, blocks_t] for key, val in pool_kv.items()}, pool_mask[blocks_t],
            win_kv, 0, torch.zeros((r, w), dtype=torch.bool, device=dev), wv_t)
        slots_t = torch.as_tensor(slots, dtype=torch.long, device=dev)
        self._store_window(state, win_kv, slots_t)
        state["sufmask"][slots_t] = wv_t
        state["assign"][slots_t] = blocks_t
        ids = None
        if self.spec_k:  # the drafts' context: prefix + suffix, left-padded
            cw = self.prefix_len + w
            ctx = np.full((r, cw), pad_id, np.int64)
            for j, (_, _, prefix, suffix, _) in enumerate(res):
                seq = [int(t) for t in prefix] + list(suffix)
                ctx[j, cw - len(seq):] = seq
            ctx[n:] = ctx[0]
            ids = torch.as_tensor(ctx, device=dev)
        self._insert_rows(state, logits[:, -1, :].float(), npre + wv_t.long().sum(dim=1),
                          slots_t, torch.arange(r, device=dev) < n,
                          torch.as_tensor(budgets, device=dev), ids=ids)

    def _gen_offset(self, state) -> int:
        return self.suffix_len  # the question window heads the segment

    def _gen_mask(self, state, visible: torch.Tensor) -> torch.Tensor:
        return torch.cat([state["sufmask"], visible], dim=1)

    def _store_window(self, state, win_kv, slots) -> None:
        """The window's k/v at the head of each slot's generated segment."""
        w = self.suffix_len
        for key, arr in state["gen_kv"].items():
            arr[:, slots, :w] = win_kv[key]

    def _pool_view(self, pool, state):
        """What a decode chunk reads of the pool: the (L, 1, G·S_pre) view
        that every slot shares, and each slot's visibility of its own
        block's valid rows (B, G·S_pre), fixed within a chunk."""
        pool_kv, pool_mask, _ = pool
        g, s_pre = self.num_prefixes, self.prefix_len
        flat = {key: val.view((val.shape[0], 1, g * s_pre) + val.shape[3:])
                for key, val in pool_kv.items()}
        own = state["assign"][:, None] == torch.arange(g, device=pool_mask.device)[None, :]
        return flat, (own[:, :, None] & pool_mask[None]).reshape(self.num_slots, g * s_pre)

    def _engine_decode(self, prompt_ctx, state):
        return self._decode_chunk(self._pool_view(prompt_ctx, state), state), state


class PrefixPoolContinuousBeamBatchingServer(_BeamSlots, PrefixPoolContinuousBatchingServer):
    """The prefix-pool engine for beam search, the reference's eval decode
    (beam 5, repetition penalty 3.0), with each scene's prefix prefilled once
    and slot refill.

    Against the greedy pool engine:

    - each slot's question window k/v live in their own (B, W) pool, read
      as a second batch-1 (1, B·W) segment beside the block pool: stored
      once a slot, never copied into its K beam rows;
    - the generated segment is (B·K, S_g), read through the ancestry map as
      in :class:`ContinuousBeamBatchingServer`, whose per-slot search (step
      0 on the window's last logits, the re-rank a step) this engine runs.

    The host side of the pool is the greedy pool engine's.
    """

    def __init__(
        self,
        model,
        num_slots: int,
        *,
        num_beams: Optional[int] = None,
        num_prefixes: int = 8,
        prefix_len: Optional[int] = None,
        suffix_len: int = 32,
        refill_group: int = 4,
        chunk_steps: int = 16,
        max_new_tokens: Optional[int] = None,
        drain_between_batches: bool = False,
        lookahead: int = 1,
    ):
        super().__init__(model, num_slots, num_prefixes=num_prefixes, prefix_len=prefix_len,
                         suffix_len=suffix_len, refill_group=refill_group,
                         chunk_steps=chunk_steps, max_new_tokens=max_new_tokens,
                         drain_between_batches=drain_between_batches, lookahead=lookahead)
        self._init_beam(num_beams)

    def _pool_slot_state(self):
        """The beam slots of :class:`ContinuousBeamBatchingServer`, plus the
        question windows' k/v ``suf_kv`` (L, B, W, hkv, D), their mask and
        each slot's block."""
        b, w, dev = self.num_slots, self.suffix_len, self.model.device
        state = self._slot_state(self.max_new, 0)
        state.update(suf_kv=_make_cache(self._llm_cfg(), b, w, dev),
                     sufmask=torch.zeros((b, w), dtype=torch.bool, device=dev),
                     assign=torch.zeros(b, dtype=torch.long, device=dev))
        return state

    def _store_window(self, state, win_kv, slots) -> None:
        for key, arr in state["suf_kv"].items():
            arr[:, slots] = win_kv[key]

    def _engine_decode(self, prompt_ctx, state):
        pool_flat, vis_pool = self._pool_view(prompt_ctx, state)
        b, w = self.num_slots, self.suffix_len
        suf_flat = {key: val.view((val.shape[0], 1, b * w) + val.shape[3:])
                    for key, val in state["suf_kv"].items()}
        own = torch.eye(b, dtype=torch.bool, device=vis_pool.device)
        vis_suf = (own[:, :, None] & state["sufmask"][None]).reshape(b, b * w)
        # a row per beam query over the pool, then every slot's window
        mask = torch.cat([vis_pool, vis_suf], dim=1).repeat_interleave(self.num_beams, dim=0)
        return self._decode_chunk(((pool_flat, suf_flat), mask), state), state
