"""Pipeline-parallel execution of the LLM's blocks (teacher forcing).

Counterpart of ``msr3d_tpu/parallel/llm_pp.py``: ``run_stage`` of
``scan_blocks``, ``stage_masks`` of ``_positions_and_bias``,
``llm_logits_from_blocks`` and ``make_pp_loss_fn`` of ``make_pp_apply_fn``.
JAX stacks the L blocks into (L, ...) leaves and splits them into S = pp
stages of K = L/S; the port's stage holds its K blocks in its own model
(``LlamaConfig.pp_size``/``pp_rank``, ``StageLayers``) and no stacked
layout is needed. L % S must be 0 and the batch must split into the M
micro-batches, as JAX asserts.

Placement (JAX's ``pp_state_shardings``): everything outside the blocks is
on every pp rank: the point encoder, the prompter, the image tower,
``embed_tokens``, the final norm and ``lm_head``. Stage 0 alone runs
``embeds_for_loss`` and sends each micro-batch's (mb, T, H) hidden state and
its joint attention mask down the pipe (``parallel/pipeline.py``); the last
stage runs the answer-window norm, head and ``sequence_ce_loss_windowed``
with ``answer_start = T_in`` and sends the loss to the other stages, for
the logs. The pp path is training only, as JAX's: no KV cache.

JAX's pp path differs from its plain forward in three ways, and so does
this one (ROADMAP.md §3 lists them as JAX's behaviour, not faults):

* the blocks run deterministically: ``scan_blocks`` applies them without
  ``deterministic=False``, so LoRA dropout is off in the blocks even with
  ``lora_dropout > 0`` (dropout before the blocks, in ``embeds_for_loss``,
  stays on);
* ``remat`` takes the ``full`` policy whatever ``remat_policy`` says (the
  pp branch passes none);
* with ``flash_attention`` the blocks get no ``key_valid``, so the kernels
  mask causally only: a query may attend to the padded prompt keys in the
  middle of the sequence, which the plain flash path masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from msr3d_tpu_torch.models.llm.llama import (
    LlamaBlock,
    LlamaModel,
    StageLayers,
    _bias,
    _remat_block,
)
from msr3d_tpu_torch.parallel import mesh, pipeline

# the side input's dtype on the wire (the joint attention mask)
_MASK_DTYPE = torch.int32


def stage_masks(llm: LlamaModel, attention_mask: torch.Tensor):
    """(positions, attn_bias, key_valid) of the pp path: HF positions; the
    dense route's causal and padding bias; under ``flash_attention`` no
    bias and no ``key_valid`` (all keys valid: JAX's pp flash path)."""
    positions = llm._positions(attention_mask)
    if llm.cfg.flash_attention:
        return positions, None, None
    t = attention_mask.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=attention_mask.device).tril()
    return positions, _bias(causal[None, None] & attention_mask.bool()[:, None, None, :]), None


def run_stage(llm: LlamaModel, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """This stage's blocks over the hidden state ``x`` (B, T, H), in
    order, with no generator (the callers hold the blocks in eval mode:
    ``deterministic``); with ``remat`` and grad enabled each block under the
    ``full`` policy."""
    positions, attn_bias, key_valid = stage_masks(llm, attention_mask)
    remat = llm.cfg.remat and torch.is_grad_enabled()
    for block in llm.layer:
        if remat:
            x = _remat_block(block, "full", x, positions, attn_bias, key_valid)
        else:
            x = block(x, positions, attn_bias, key_valid)
    return x


@contextlib.contextmanager
def deterministic(module: torch.nn.Module):
    """``module`` in eval mode for the duration (its LoRA dropout off), the
    mode restored after; the pipelined step's backward (a remat recompute)
    runs inside it too."""
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


def _split(t: torch.Tensor, n_micro: int) -> List[torch.Tensor]:
    if t.shape[0] % n_micro:
        raise ValueError(f"batch {t.shape[0]} not divisible into {n_micro} microbatches")
    return list(t.chunk(n_micro, dim=0))


def _head(llm: LlamaModel, hidden: torch.Tensor, answer_start: Optional[int]) -> torch.Tensor:
    """The answer window (positions ``answer_start-1 .. T-2``) or every
    position, through the final norm and the head, in fp32."""
    if answer_start is not None:
        hidden = hidden[:, answer_start - 1:-1]
    return llm.logits(llm.final_norm(hidden)).float()


def llm_logits_from_blocks(llm: LlamaModel, inputs_embeds: Optional[torch.Tensor],
                           attention_mask: torch.Tensor, *, microbatches: int = 1,
                           answer_start: Optional[int] = None) -> torch.Tensor:
    """Teacher-forcing logits (fp32) through the pipelined blocks, on every
    stage (the last stage's, broadcast: JAX's ring ends in a ``psum``).
    Stage 0 gives ``inputs_embeds`` (B, T, H), the others None; every stage
    gives the ``attention_mask`` (B, T)."""
    cfg = llm.cfg
    b, t = attention_mask.shape
    mb = b // microbatches
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible into {microbatches} microbatches")
    device = attention_mask.device
    inputs = None
    if mesh.pp_rank() == 0:
        inputs = list(zip(_split(inputs_embeds.to(cfg.dtype), microbatches),
                          _split(attention_mask.to(_MASK_DTYPE), microbatches)))
    with deterministic(llm.layer):
        outs, _ = pipeline.gpipe(lambda x, side: run_stage(llm, x, side), inputs,
                                 (mb, t, cfg.hidden_size), cfg.dtype, _MASK_DTYPE, device,
                                 microbatches)
    width = t if answer_start is None else t - answer_start
    logits = torch.empty((b, width, cfg.vocab_size), dtype=torch.float32, device=device)
    if outs is not None:
        torch.cat([_head(llm, y, answer_start) for y in outs], dim=0, out=logits)
    return pipeline.broadcast_from_last(logits)


LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]], torch.Tensor]


def make_pp_loss_fn(network, microbatches: int) -> LossFn:
    """The loss of one (accumulation) micro-batch with the blocks pipelined
    over this rank's pp group, forward and backward: ``loss_fn(batch,
    generator)`` runs the GPipe schedule over ``microbatches`` micro-batches
    of the batch, leaves every trainable gradient of this stage in ``.grad``
    (the parameters before the blocks get theirs on stage 0 only) and
    returns the batch's mean per-sequence loss, detached, on every stage.
    The counterpart of ``make_pp_apply_fn`` (the answer-window loss)."""
    from msr3d_tpu_torch.models.msr3d import build_targets, sequence_ce_loss_windowed

    llm = network.llm
    cfg = llm.cfg

    def loss_fn(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        input_ids = batch["input_ids"]
        targets = _split(build_targets(input_ids, batch["output_ids"], batch["output_mask"]),
                         microbatches)  # every stage checks that the batch splits
        mb, t = targets[0].shape
        answer_start = int(input_ids.shape[1])
        device = input_ids.device
        inputs = x = None
        if mesh.pp_rank() == 0:
            full_embeds, full_attn, _ = network.embeds_for_loss(**batch, generator=generator)
            x = full_embeds.to(cfg.dtype)
            leaves = [part.detach().requires_grad_(x.requires_grad)
                      for part in _split(x, microbatches)]
            inputs = list(zip(leaves, _split(full_attn.to(_MASK_DTYPE), microbatches)))

        def micro_loss(y: torch.Tensor, m: int) -> torch.Tensor:
            logits = _head(llm, y, answer_start)
            return sequence_ce_loss_windowed(logits, targets[m], answer_start).mean() / microbatches

        with deterministic(llm.layer):
            losses, grads = pipeline.gpipe(lambda h, side: run_stage(llm, h, side), inputs,
                                           (mb, t, cfg.hidden_size), cfg.dtype, _MASK_DTYPE,
                                           device, microbatches, micro_loss)
        if x is not None and x.requires_grad:
            torch.autograd.backward(x, torch.cat(grads, dim=0))
        loss = (torch.stack(losses).sum() if losses is not None
                else torch.zeros((), dtype=torch.float32, device=device))
        return pipeline.broadcast_from_last(loss.float().reshape(1))[0]

    return loss_fn


def gather_whole_llm(llm: LlamaModel) -> Optional[LlamaModel]:
    """Every pp rank calls it. On pp rank 0: the whole LLM (pp = 1 in its
    config) made of this stage's blocks and every other stage's, received
    whole over the pp group (their frozen base and their LoRA factors, each
    tensor of each block in name order), beside this stage's embedding, norm
    and head (shared, not copied); JAX unstacks its trained blocks into the
    whole model for generation. Elsewhere: sends this stage's blocks to pp
    rank 0 and returns None."""
    cfg = llm.cfg
    if mesh.pp_rank() != 0:
        for _, t in sorted(llm.layer.state_dict().items()):
            pipeline.send(t, 0)
        return None
    device = llm.final_norm.weight.device
    blocks = dict(zip(cfg.stage_layers, llm.layer))
    for stage in range(1, cfg.pp_size):
        held = StageLayers({i: LlamaBlock(cfg, device) for i in
                            dataclasses.replace(cfg, pp_rank=stage).stage_layers})
        with torch.no_grad():
            for _, t in sorted(held.state_dict().items()):
                pipeline.recv_into(t, stage)
        blocks.update(zip(dataclasses.replace(cfg, pp_rank=stage).stage_layers, held))
    whole = LlamaModel(dataclasses.replace(cfg, pp_size=1, pp_rank=0), device="meta")
    whole.embed_tokens, whole.final_norm, whole.lm_head = (llm.embed_tokens, llm.final_norm,
                                                           llm.lm_head)
    whole.layer = StageLayers({i: blocks[i] for i in range(cfg.num_hidden_layers)})
    return whole.train(llm.training)
