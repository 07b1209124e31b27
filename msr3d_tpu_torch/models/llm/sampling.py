"""Greedy, sampled, beam and speculative decoding over a split KV cache.

Counterpart of ``greedy_decode_shared``, ``beam_search_decode_shared``,
``ngram_propose`` and ``ngram_speculative_decode`` in
``msr3d_tpu/models/llm/sampling.py``, with the HF logits processing they
use (CTRL repetition penalty over the generated ids, an additive EOS bias,
the min-length EOS mask) and HF's sampling warpers (temperature, top-k,
top-p, ``sample_filter_logits``). The JAX loops are ``lax.while_loop``s on
the device; here each is a Python loop over device tensors with the same
exit test (one host read a step), writing the generated KV segment in
place, with the same EOS padding after EOS. ``pick_next_rows`` and
``pick_next_rows_sampled`` pick with each row at its own step, for the
continuous serving engines. Sampling draws JAX's threefry stream
(``prng.py``), so a seed gives JAX's tokens.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from msr3d_tpu_torch.models.llm import prng

_NEG = -1e9  # the score of a dead beam or an empty hypothesis slot


def apply_repetition_penalty(
    logits: torch.Tensor, seen: torch.Tensor, penalty: float
) -> torch.Tensor:
    """CTRL penalty on the ids marked in ``seen`` (B, V): positive logits
    divided by ``penalty``, negative ones multiplied."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _mask_min_length(
    logits: torch.Tensor, step: int, min_length: int, eos_id: int, eos_bias: float = 0.0
) -> torch.Tensor:
    """``eos_bias`` added to the EOS logit, then the EOS logit to -inf below
    ``min_length``."""
    if eos_bias:
        logits = logits.clone()
        logits[:, eos_id] += eos_bias
    if min_length <= 1 or step >= min_length - 1:
        return logits
    logits = logits.clone()
    logits[:, eos_id] = float("-inf")
    return logits


def pick_next_rows(
    logits: torch.Tensor,  # (B, V) fp32
    seen: torch.Tensor,  # (B, V) bool
    steps: torch.Tensor,  # (B,) each row's emission step (0 = first token)
    *,
    eos_id: int,
    repetition_penalty: float = 1.0,
    eos_logit_bias: float = 0.0,
    min_length: int = 1,
) -> torch.Tensor:
    """Per-row greedy pick → (B,) int32, each row at its own step (the
    continuous engines' slots refill independently, so the min-length gate
    is a row's own): row for row the ``pick`` of ``greedy_decode_shared``
    where the steps agree."""
    logits = apply_repetition_penalty(logits, seen, repetition_penalty)
    if eos_logit_bias:
        logits = logits.clone()
        logits[:, eos_id] += eos_logit_bias
    if min_length > 1:
        logits = logits.clone()
        logits[:, eos_id] = torch.where(steps < min_length - 1, float("-inf"),
                                        logits[:, eos_id])
    return logits.argmax(dim=-1).to(torch.int32)


def sample_filter_logits(
    logits: torch.Tensor,  # (B, V) fp32
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """HF's warper chain, temperature → top-k → top-p, in JAX's value-
    threshold form: a logit below the threshold becomes -inf, and every
    logit equal to it is kept. Top-k's threshold is the k-th largest value;
    top-p's is the smallest logit of the descending prefix whose mass before
    it (the fp32 cumsum of the sorted softmax, minus its own probability)
    is below ``top_p``, so the most probable token always stays. The
    temperature multiplies by its fp32 reciprocal, as XLA compiles JAX's
    divide by a constant."""
    dev = logits.device
    if temperature != 1.0:
        # XLA folds JAX's divide by the constant fp32 temperature into a
        # multiply by its fp32 reciprocal; so does this
        inv = torch.tensor(1.0) / torch.tensor(max(float(temperature), 1e-6))
        logits = logits * inv.to(dev)
    if top_k:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < torch.tensor(
            top_p, dtype=torch.float32, device=dev)
        thresh = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, float("-inf"), logits)
    return logits


def pick_next_rows_sampled(
    logits: torch.Tensor,  # (B, V) fp32
    seen: torch.Tensor,  # (B, V) bool
    steps: torch.Tensor,  # (B,) each row's emission step (0 = first token)
    keys: torch.Tensor,  # (B, 2) each row's threefry key
    *,
    eos_id: int,
    repetition_penalty: float = 1.0,
    eos_logit_bias: float = 0.0,
    min_length: int = 1,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Per-row sampled pick → (B,) int32, the sampled sibling of
    ``pick_next_rows``: the penalty, the EOS processing, the warpers, then
    a categorical draw for each row from its own key (``jax.vmap`` of
    ``jax.random.categorical``), so a request's tokens depend on its key
    alone, not on its slot or on what else is scheduled."""
    logits = apply_repetition_penalty(logits, seen, repetition_penalty)
    if eos_logit_bias:
        logits = logits.clone()
        logits[:, eos_id] += eos_logit_bias
    if min_length > 1:
        logits = logits.clone()
        logits[:, eos_id] = torch.where(steps < min_length - 1, float("-inf"),
                                        logits[:, eos_id])
    logits = sample_filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    return prng.categorical_rows(keys, logits).to(torch.int32)


def greedy_decode_shared(
    decode_step_shared: Callable,
    next_positions: torch.Tensor,  # (B,)
    first_token_logits: torch.Tensor,  # (B, V) fp32
    gen_kv: Dict[str, torch.Tensor],  # k/v (L, B, gen_base + max_new, hkv, D)
    *,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    min_length: int = 1,
    repetition_penalty: float = 1.0,
    eos_logit_bias: float = 0.0,
    sample_key: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    gen_base: int = 0,
    gen_mask_base: Optional[torch.Tensor] = None,  # (B, gen_base + max_new)
) -> torch.Tensor:
    """``decode_step_shared(token_ids (B, 1), positions (B, 1), gen_kv,
    gen_index, gen_mask (B, S_g)) → logits (B, 1, V)``, writing the step's
    k/v into ``gen_kv`` in place.

    With ``sample_key`` (a (2,) threefry key) each step samples from the
    warped distribution instead of taking the argmax: the key is split once
    a step and the step's draw is one (B, V) categorical, as JAX's loop
    draws it. ``gen_base > 0`` is the grouped path: slots [0, gen_base)
    hold each row's question suffix (``gen_mask_base`` marks its real
    tokens) and generation writes from slot ``gen_base``; the defaults are
    the plain loop.

    Returns the generated ids (B, max_new_tokens) int32, EOS kept and
    ``pad_id`` after it."""
    b, v = first_token_logits.shape
    device = first_token_logits.device
    rows = torch.arange(b, device=device)
    s_g = gen_base + max_new_tokens
    slot = torch.arange(s_g, device=device)[None, :]
    base_mask = (gen_mask_base.bool() if gen_mask_base is not None
                 else torch.zeros((b, s_g), dtype=torch.bool, device=device))
    key = sample_key

    def pick(logits: torch.Tensor, seen: torch.Tensor, step: int, sub) -> torch.Tensor:
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)
        logits = _mask_min_length(logits, step, min_length, eos_id, eos_logit_bias)
        if sub is not None:
            logits = sample_filter_logits(logits, temperature=temperature, top_k=top_k,
                                          top_p=top_p)
            return prng.categorical(sub, logits)
        return logits.argmax(dim=-1)

    def next_sub():
        nonlocal key
        if key is None:
            return None
        key, sub = prng.split(key)
        return sub

    generated = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32, device=device)
    seen = torch.zeros((b, v), dtype=torch.bool, device=device)
    tok = pick(first_token_logits, seen, 0, next_sub())
    generated[:, 0] = tok.to(torch.int32)
    seen[rows, tok] = True
    finished = tok == eos_id
    positions = next_positions.to(torch.int64)

    step = 1
    while step < max_new_tokens and not bool(finished.all()):
        gen_mask = base_mask | ((slot >= gen_base) & (slot < gen_base + step))
        logits = decode_step_shared(
            generated[:, step - 1 : step].long(), positions[:, None], gen_kv,
            gen_base + step - 1, gen_mask,
        )
        nxt = pick(logits[:, -1, :].float(), seen, step, next_sub())
        nxt = torch.where(finished, torch.full_like(nxt, pad_id), nxt)
        generated[:, step] = nxt.to(torch.int32)
        seen[rows, nxt] = seen[rows, nxt] | ~finished  # finished rows mark nothing
        finished = finished | (nxt == eos_id)
        positions = positions + 1
        step += 1
    return generated


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values and their
    indices, equal values lowest index first (a stable descending sort;
    ``torch.topk`` does not promise that order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _expand_cache(cache: torch.Tensor, k: int) -> torch.Tensor:
    """(L, B, S, ...) → (L, B·K, S, ...), each batch row repeated K times."""
    return cache.repeat_interleave(k, dim=1)


def beam_search_decode_shared(
    decode_step_shared: Callable,
    next_positions: torch.Tensor,  # (B,)
    first_token_logits: torch.Tensor,  # (B, V) fp32
    gen_kv: Dict[str, torch.Tensor],  # k/v (L, B·K, gen_base + max_new, hkv, D)
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    min_length: int = 1,
    repetition_penalty: float = 1.0,
    eos_logit_bias: float = 0.0,
    length_penalty: float = 1.0,
    gen_base: int = 0,
    gen_mask_base: Optional[torch.Tensor] = None,  # (B·K, gen_base + max_new)
    decode_step_anc: Optional[Callable] = None,
) -> torch.Tensor:
    """HF beam search (``early_stopping=False``) over a split KV cache: the
    prompt KV stays at batch B inside ``decode_step_shared``; the generated
    segment ``gen_kv`` holds B·K rows, row ``b·K + j`` for beam j of
    request b, and is written in place.

    ``decode_step_shared(token_ids (B·K, 1), positions (B·K, 1), gen_kv,
    gen_index, gen_mask (B·K, S_g)) → logits (B·K, 1, V)``. After each
    re-rank the rows of ``gen_kv`` are reordered (``index_select`` along
    the batch axis). With ``decode_step_anc(..., gen_mask, anc)`` the rows
    never move: ``anc`` (B·K, S_g) int32 names the row of the request's K
    block whose slot s is on the query's path, and only ``anc`` reorders.

    The penalty and the EOS bias act on log-probabilities, as HF's beam
    search applies its processors after ``log_softmax``. ``gen_base`` and
    ``gen_mask_base`` are the grouped path's suffix slots, as in
    ``greedy_decode_shared``: each row's suffix k/v, the same in the K rows
    of a request, so a reorder keeps them. Returns the best
    hypothesis a request (B, max_new_tokens) int32, EOS kept, ``pad_id``
    after it."""
    b, v = first_token_logits.shape
    k = num_beams
    bk = b * k
    device = first_token_logits.device
    rows = torch.arange(bk, device=device)
    block = torch.arange(b, device=device)[:, None] * k  # first row of each request
    s_g = gen_base + max_new_tokens
    slot = torch.arange(s_g, device=device)[None, :]
    base_mask = (gen_mask_base.bool() if gen_mask_base is not None
                 else torch.zeros((bk, s_g), dtype=torch.bool, device=device))
    own = torch.arange(k, dtype=torch.int32, device=device).repeat(b)  # row within its block
    # every row's suffix slots were written into (replicated in) itself
    anc = own[:, None].expand(bk, s_g).clone()

    def unflat(x):
        return x.reshape((b, k) + x.shape[1:])

    # the fp32 length normalization n ** length_penalty, a device tensor so
    # that scores are divided by it (a Python float divisor turns into a
    # multiply by its reciprocal on the GPU)
    norm = (torch.arange(max_new_tokens + 1, dtype=torch.float32) ** length_penalty).to(device)

    def score_logits(logits, seen_, step):
        logp = torch.log_softmax(logits, dim=-1)
        logp = apply_repetition_penalty(logp, seen_, repetition_penalty)
        return _mask_min_length(logp, step, min_length, eos_id, eos_logit_bias)

    def running_done(beam_scores_, hyp_scores_, step):
        # done when the best live score, normalized at the current length,
        # cannot beat the worst of K finished hypotheses
        best_live = unflat(beam_scores_).amax(dim=1) / norm[step + 1]
        worst_hyp = hyp_scores_.amin(dim=1)
        full = (hyp_scores_ > _NEG / 2).sum(dim=1) >= k
        return full & (worst_hyp >= best_live)

    # step 0: the K best first tokens (HF: only beam 0 is live)
    logp0 = torch.log_softmax(
        _mask_min_length(first_token_logits, 0, min_length, eos_id, eos_logit_bias), dim=-1)
    top_logp, top_tok = _top_k(logp0, k)
    generated = torch.full((bk, max_new_tokens), pad_id, dtype=torch.int32, device=device)
    generated[:, 0] = top_tok.reshape(-1).to(torch.int32)
    seen = torch.zeros((bk, v), dtype=torch.bool, device=device)
    seen[rows, top_tok.reshape(-1)] = True
    beam_scores = top_logp.reshape(-1)
    is_eos0 = top_tok.reshape(-1) == eos_id
    hyp_tokens = torch.where(unflat(is_eos0)[..., None], unflat(generated), pad_id)
    hyp_scores = torch.where(unflat(is_eos0), unflat(beam_scores), _NEG)
    beam_scores = torch.where(is_eos0, _NEG, beam_scores)
    positions = next_positions.to(torch.int64).repeat_interleave(k)

    step = 1
    while step < max_new_tokens and not bool(running_done(beam_scores, hyp_scores, step).all()):
        tok = generated[:, step - 1:step].long()
        gen_index = gen_base + step - 1
        gen_mask = base_mask | ((slot >= gen_base) & (slot < gen_base + step))
        if decode_step_anc is not None:
            anc[:, gen_index] = own  # this step's k/v land in the row itself
            logits = decode_step_anc(tok, positions[:, None], gen_kv, gen_index, gen_mask, anc)
        else:
            logits = decode_step_shared(tok, positions[:, None], gen_kv, gen_index, gen_mask)
        logp = score_logits(logits[:, -1, :].float(), seen, step)
        total = (beam_scores[:, None] + logp).reshape(b, k * v)
        cand_scores, cand_idx = _top_k(total, 2 * k)
        cand_beam = cand_idx // v
        cand_tok = (cand_idx % v).to(torch.int32)
        cand_is_eos = cand_tok == eos_id

        # EOS candidates join the pool of finished hypotheses
        cand_seqs = generated[(block + cand_beam).reshape(-1)].reshape(b, 2 * k, -1)
        cand_seqs[:, :, step] = torch.where(cand_is_eos, eos_id, pad_id).to(torch.int32)
        cand_norm = torch.where(cand_is_eos, cand_scores / norm[step + 1], _NEG)
        pool_scores = torch.cat([hyp_scores, cand_norm], dim=1)
        pool_tokens = torch.cat([hyp_tokens, cand_seqs], dim=1)
        hyp_scores, pool_idx = _top_k(pool_scores, k)
        hyp_tokens = torch.take_along_dim(pool_tokens, pool_idx[:, :, None], dim=1)

        # the best K other candidates go on; with fewer than K, the rest
        # carry pad at a dead score
        _, live_pick = _top_k(torch.where(cand_is_eos, _NEG, cand_scores), k)
        valid_live = torch.gather(~cand_is_eos, 1, live_pick)
        new_tok = torch.where(valid_live, torch.gather(cand_tok, 1, live_pick), pad_id)
        new_scores = torch.where(valid_live, torch.gather(cand_scores, 1, live_pick), _NEG)
        gather = (block + torch.gather(cand_beam, 1, live_pick)).reshape(-1)
        generated = generated[gather]
        seen = seen[gather]
        if decode_step_anc is not None:
            anc = anc[gather]
        else:
            for key, val in gen_kv.items():
                gen_kv[key] = val.index_select(1, gather)
        new_tok = new_tok.reshape(-1)
        generated[:, step] = new_tok.to(torch.int32)
        seen[rows, new_tok.long()] = True  # dead rows mark their pad, as in JAX
        beam_scores = new_scores.reshape(-1)
        positions = positions + 1
        step += 1

    # the live beams compete at the full length
    live_norm = unflat(beam_scores) / norm[max_new_tokens]
    all_scores = torch.cat([hyp_scores, live_norm], dim=1)
    all_tokens = torch.cat([hyp_tokens, unflat(generated)], dim=1)
    best = all_scores.argmax(dim=1)
    return all_tokens[torch.arange(b, device=device), best]


def ngram_propose(ctx: torch.Tensor, cur: torch.Tensor, *, ngram_n: int, k: int,
                  pad_id: int) -> torch.Tensor:
    """Prompt-lookup drafts: match the ``ngram_n``-gram ending at ``cur-1``
    of each row's context ``ctx`` (B, L) against every earlier position and
    return the ``k`` tokens after the most recent earlier match, ``pad_id``
    where there is none → (B, k) int32. Index arithmetic only, no model
    call."""
    dev = ctx.device
    l_ctx = ctx.shape[1]
    cur = cur.long()
    gidx = (cur[:, None] - ngram_n + torch.arange(ngram_n, device=dev)[None, :]).clamp(min=0)
    gram = torch.gather(ctx, 1, gidx)  # (B, n)
    lw = l_ctx - ngram_n + 1
    windows = torch.stack([ctx[:, i:i + lw] for i in range(ngram_n)], dim=-1)  # (B, Lw, n)
    match = (windows == gram[:, None, :]).all(dim=-1)
    p_pos = torch.arange(lw, device=dev)[None, :]
    ok = match & (p_pos <= (cur - ngram_n - 1)[:, None])
    pbest = torch.where(ok, p_pos, -1).amax(dim=1)  # (B,), -1: no match
    pidx = (pbest[:, None] + ngram_n + torch.arange(k, device=dev)[None, :]).clamp(0, l_ctx - 1)
    return torch.where(pbest[:, None] >= 0, torch.gather(ctx, 1, pidx),
                       torch.full_like(pidx, pad_id)).to(torch.int32)


def _scatter_drop(arr: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """``arr.at[rows, idx].set(val, mode="drop")`` for (B, N) ``arr`` and
    (B, T) non-negative ``idx``: indices at or past N write nothing."""
    n = arr.shape[1]
    out = torch.cat([arr, arr[:, :1]], dim=1)  # one spare column takes the drops
    out[rows, idx.clamp(max=n)] = val.to(arr.dtype)
    return out[:, :n]


def spec_accept(props: torch.Tensor, y: torch.Tensor, steps_idx: torch.Tensor,
                limit: torch.Tensor, live: torch.Tensor, eos_id: int):
    """Which tokens of a verify window to emit: the model's picks ``y`` (B,
    K+1) over [last token, drafts ``props`` (B, K)] emit the longest prefix
    of drafts the picks agree with and the pick after it, cut before any
    token after an EOS, at emission index ``steps_idx`` (B, K+1) below
    ``limit`` (a bound or a (B, 1) budget), and only in ``live`` rows.
    Returns (emit (B, K+1), acc (B, K) the accepted-prefix flags, is_eos
    (B, K+1))."""
    k = props.shape[1]
    acc = torch.cumprod((props == y[:, :k]).to(torch.int32), dim=1)
    is_eos = y == eos_id
    before_eos = torch.cumsum(is_eos.to(torch.int32), dim=1) - is_eos.to(torch.int32)
    win = torch.arange(k + 1, device=y.device)
    emit = ((win[None, :] <= acc.sum(dim=1)[:, None]) & (before_eos == 0)
            & (steps_idx < limit) & live[:, None])
    return emit, acc, is_eos


def ngram_speculative_decode(
    decode_step: Callable,
    kv_caches: Dict[str, torch.Tensor],
    cache_mask: torch.Tensor,  # (B, S) valid context slots only
    next_positions: torch.Tensor,  # (B,)
    first_token_logits: torch.Tensor,  # (B, V)
    prompt_ids: torch.Tensor,  # (B, P) the context mined for drafts
    *,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    prompt_len: int,
    spec_k: int = 4,
    ngram_n: int = 3,
    min_length: int = 1,
    eos_logit_bias: float = 0.0,
    return_stats: bool = False,
):
    """Greedy decoding with n-gram (prompt-lookup) speculative drafts.

    Each iteration proposes ``spec_k`` drafts with ``ngram_propose`` over
    the prompt ids and the tokens so far, runs ONE verify forward over the
    window [last token, drafts] and emits the longest prefix of drafts the
    model's own argmax agrees with, plus the model's next pick: 1 to
    spec_k + 1 tokens a model call, the same tokens as greedy decoding.
    Rows advance at their own pace: row b's window is written from cache
    slot ``prompt_len + n_emitted[b] - 1`` (a finished row writes nothing),
    and only the slots of accepted tokens become valid in ``cache_mask``;
    a rejected draft's slot stays masked and a later window overwrites it.

    ``decode_step(token_ids (B, T), positions (B, T), kv_caches, cache_index
    (B,), cache_mask) → logits (B, T, V)``, writing ``kv_caches`` in place;
    ``cache_mask`` marks only accepted context (the step masks the window
    causally from ``cache_index`` itself). No repetition penalty: it would
    make pick t depend on the drafts accepted before it in the window.

    Returns the generated ids (B, max_new_tokens) int32, and with
    ``return_stats`` also {"emitted": tokens produced, "accepted_drafts":
    drafts emitted, "verify_calls": model calls} as 0-dim tensors."""
    b, v = first_token_logits.shape
    dev = first_token_logits.device
    k = spec_k
    rows = torch.arange(b, device=dev)
    s_total = cache_mask.shape[1]
    prompt_ids = prompt_ids.to(device=dev, dtype=torch.int32)
    p_len_ids = prompt_ids.shape[1]
    win = torch.arange(k + 1, device=dev)

    def mask_eos(logits: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        # logits (B, T, V); steps (B, T): the emission index of each pick
        if eos_logit_bias:
            logits = logits.clone()
            logits[..., eos_id] += eos_logit_bias
        if min_length > 1:
            logits = logits.clone()
            logits[..., eos_id] = torch.where(steps < min_length - 1, float("-inf"),
                                              logits[..., eos_id])
        return logits

    first = mask_eos(first_token_logits.float()[:, None],
                     torch.zeros((b, 1), dtype=torch.long, device=dev))[:, 0]
    tok0 = first.argmax(dim=-1).to(torch.int32)
    generated = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    generated[:, 0] = tok0
    finished = (tok0 == eos_id) | (max_new_tokens <= 1)
    n_emitted = torch.ones(b, dtype=torch.long, device=dev)
    cmask = cache_mask.bool().clone()
    accepted = torch.zeros((), dtype=torch.long, device=dev)
    iters = 0
    positions = next_positions.to(device=dev, dtype=torch.long)

    while not bool(finished.all()):
        j = n_emitted - 1  # the index of the last emitted token
        last_tok = generated[rows, j]
        ctx = torch.cat([prompt_ids, generated], dim=1)
        props = ngram_propose(ctx, p_len_ids + n_emitted, ngram_n=ngram_n, k=k, pad_id=pad_id)
        verify = torch.cat([last_tok[:, None], props], dim=1).long()  # (B, K+1)
        pos = (positions + j)[:, None] + win
        start = prompt_len + j  # the slot of last_tok's k/v
        logits = decode_step(verify, pos, kv_caches, torch.where(finished, -1, start), cmask)

        steps_idx = n_emitted[:, None] + win  # (B, K+1)
        y = mask_eos(logits.float(), steps_idx).argmax(dim=-1).to(torch.int32)
        emit, acc, is_eos_y = spec_accept(props, y, steps_idx, max_new_tokens, ~finished, eos_id)
        generated = _scatter_drop(generated, rows[:, None],
                                  torch.where(emit, steps_idx, max_new_tokens),
                                  torch.where(emit, y, pad_id))
        # slot start holds last_tok, slot start+1+t draft t == y[t]: valid
        # iff y[t] was emitted
        slot_valid = torch.cat([~finished[:, None], emit[:, :k]], dim=1)
        cmask = _scatter_drop(cmask, rows[:, None],
                              torch.where(slot_valid, start[:, None] + win, s_total),
                              torch.ones_like(slot_valid))
        n_new = emit.sum(dim=1)
        finished = (finished | (emit & is_eos_y).any(dim=1)
                    | (n_emitted + n_new >= max_new_tokens))
        n_emitted = n_emitted + n_new
        accepted = accepted + (emit[:, :k] & acc.bool()).sum()
        iters += 1
    if return_stats:
        return generated, {"emitted": n_emitted.sum(), "accepted_drafts": accepted,
                           "verify_calls": torch.tensor(iters)}
    return generated
