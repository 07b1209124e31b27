"""Greedy decoding over a split KV cache.

Counterpart of ``greedy_decode_shared`` in
``msr3d_tpu/models/llm/sampling.py``, with the HF logits processing it
uses (CTRL repetition penalty over the generated ids, min-length EOS
mask). The JAX loop is a ``lax.while_loop`` on the device; here it is a
Python loop over device tensors with the same early exit once every row
has emitted EOS (one host read of the finished flags per step), and the
same EOS padding after EOS.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


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
    logits: torch.Tensor, step: int, min_length: int, eos_id: int
) -> torch.Tensor:
    """EOS logit to -inf below ``min_length``."""
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
        logits = _mask_min_length(logits, step, min_length, eos_id)
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
