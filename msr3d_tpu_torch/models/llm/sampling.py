"""Greedy and beam decoding over a split KV cache.

Counterpart of ``greedy_decode_shared`` and ``beam_search_decode_shared``
in ``msr3d_tpu/models/llm/sampling.py``, with the HF logits processing
they use (CTRL repetition penalty over the generated ids, an additive EOS
bias, the min-length EOS mask). The JAX loops are ``lax.while_loop``s on
the device; here each is a Python loop over device tensors with the same
exit test (one host read a step), writing the generated KV segment in
place, with the same EOS padding after EOS.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

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


def greedy_decode_shared(
    decode_step_shared: Callable,
    next_positions: torch.Tensor,  # (B,)
    first_token_logits: torch.Tensor,  # (B, V) fp32
    gen_kv: Dict[str, torch.Tensor],  # k/v (L, B, max_new, hkv, D), zeros
    *,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    min_length: int = 1,
    repetition_penalty: float = 1.0,
    eos_logit_bias: float = 0.0,
) -> torch.Tensor:
    """``decode_step_shared(token_ids (B, 1), positions (B, 1), gen_kv,
    gen_index, gen_mask (B, S_g)) → logits (B, 1, V)``, writing the step's
    k/v into ``gen_kv`` in place.

    Returns the generated ids (B, max_new_tokens) int32, EOS kept and
    ``pad_id`` after it."""
    b, v = first_token_logits.shape
    device = first_token_logits.device
    rows = torch.arange(b, device=device)
    slot = torch.arange(max_new_tokens, device=device)[None, :]

    def pick(logits: torch.Tensor, seen: torch.Tensor, step: int) -> torch.Tensor:
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)
        logits = _mask_min_length(logits, step, min_length, eos_id, eos_logit_bias)
        return logits.argmax(dim=-1)

    generated = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32, device=device)
    seen = torch.zeros((b, v), dtype=torch.bool, device=device)
    tok = pick(first_token_logits, seen, 0)
    generated[:, 0] = tok.to(torch.int32)
    seen[rows, tok] = True
    finished = tok == eos_id
    positions = next_positions.to(torch.int64)

    step = 1
    while step < max_new_tokens and not bool(finished.all()):
        gen_mask = (slot < step).expand(b, max_new_tokens)
        logits = decode_step_shared(
            generated[:, step - 1 : step].long(), positions[:, None], gen_kv, step - 1,
            gen_mask,
        )
        nxt = pick(logits[:, -1, :].float(), seen, step)
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
    gen_kv: Dict[str, torch.Tensor],  # k/v (L, B·K, max_new, hkv, D), zeros
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    min_length: int = 1,
    repetition_penalty: float = 1.0,
    eos_logit_bias: float = 0.0,
    length_penalty: float = 1.0,
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
    search applies its processors after ``log_softmax``. Returns the best
    hypothesis a request (B, max_new_tokens) int32, EOS kept, ``pad_id``
    after it."""
    b, v = first_token_logits.shape
    k = num_beams
    bk = b * k
    device = first_token_logits.device
    rows = torch.arange(bk, device=device)
    block = torch.arange(b, device=device)[:, None] * k  # first row of each request
    slot = torch.arange(max_new_tokens, device=device)[None, :]
    own = torch.arange(k, dtype=torch.int32, device=device).repeat(b)  # row within its block
    anc = own[:, None].expand(bk, max_new_tokens).clone()

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
        gen_mask = (slot < step).expand(bk, max_new_tokens)
        if decode_step_anc is not None:
            anc[:, step - 1] = own  # this step's k/v land in the row itself
            logits = decode_step_anc(tok, positions[:, None], gen_kv, step - 1, gen_mask, anc)
        else:
            logits = decode_step_shared(tok, positions[:, None], gen_kv, step - 1, gen_mask)
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
