"""MSR3D: the 3D-scene multimodal LLM, training loss, greedy and beam generation.

Counterpart of ``msr3d_tpu/models/msr3d.py``:

  * ``MSR3DNetwork`` holds the device compute: the scene prompter
    (``OSE3DSituation``, kernel K1 inside), the scene projection, the image
    encoder (ConvNeXt ``Backbone2D``, frozen) with its projection
    ``llm_proj_img``, the rank-gather splices of scene and image embeddings
    into the token embeddings, the training forward with the per-sequence
    answer CE (kernels K2f, K2dq and K2dkv with ``flash_attention``), the
    Llama prefill (K2f) and the split-cache decode steps (greedy, beam and
    beam with ancestry);
  * ``MSR3D`` is the host side: prompt building with placeholder
    expansion, tokenization into 32-multiple buckets (prompts left-padded,
    answers with bos + eos right-padded), ``forward`` → per-sequence loss,
    the greedy, sampled (``do_sample``, JAX's threefry stream), speculative
    (``spec_k``, n-gram drafts) and beam decode loops (over a bf16 or int8
    KV cache) and detokenization, grouped generation over a shared scene
    prefix (``generate_scene_group``), ``compact_transfer`` (points sent to
    the device as int16 xyz + int8 rgb), retrieval scoring over an answer
    vocabulary (``predict_answers``), the trainable set, and in-place
    weight-only quantization of the LLM for serving (``quantize_llm``).

The serving engines over this model (slot refill, the prefix-pool engines,
the fixed and the scene-grouped batchers, the HTTP front end) are in
``msr3d_tpu_torch/serving.py``. JAX's ``layered_gen_cache`` (greedy's
generated KV as a tuple of per-layer caches) works around XLA's copies of
the stacked cache; this port writes the stacked cache in place, so it has no
such option.

Under sequence parallelism (the LLM's ``sp_size`` > 1) the point encoder,
the prompter, the image encoder and the splices run whole on every sp rank
of a dp index, on one batch with one generator (so their dropout masks
agree); the LLM's training forward runs on the rank's sequence block and
the per-sequence CE sums its token NLLs over the sp group before dividing
by the whole sequence's count (``sequence_ce_loss_sp``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from msr3d_tpu_torch.convert import load_jax_params
from msr3d_tpu_torch.device import resolve_device
from msr3d_tpu_torch.models.llm.convert import quantize_kernel
from msr3d_tpu_torch.models.llm.llama import (
    LlamaBlock,
    LlamaConfig,
    LlamaModel,
    LoraDense,
    RMSNorm,
    StageLayers,
    _make_cache,
)
from msr3d_tpu_torch.models.llm import prng
from msr3d_tpu_torch.models.llm.sampling import (
    beam_search_decode_shared,
    greedy_decode_shared,
    ngram_speculative_decode,
)
from msr3d_tpu_torch.models.llm.tokenizer import (
    IMAGE_PLACEHOLDER,
    SCENE_PLACEHOLDER,
    BaseTokenizer,
    ByteTokenizer,
)
from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig, OSE3DSituation
from msr3d_tpu_torch.models.vision2d import Backbone2D, ConvNeXtBlock
from msr3d_tpu_torch.nn.pointnet import BatchNorm
from msr3d_tpu_torch.parallel.sharding import Spec, shard_tensor

_SCENE_KEYS = ("obj_fts", "obj_masks", "obj_locs", "anchor_locs", "anchor_orientation")
_PACKED = ("obj_fts_xyz_q", "obj_fts_rgb_q")  # compact_transfer's int16 and int8 points
_IGNORE = -100


@dataclasses.dataclass(frozen=True)
class MSR3DNetworkConfig:
    prompter: OSE3DConfig
    llm: LlamaConfig
    backbone_name: str = "convnext_base"
    image_pooling: str = "avg"
    freeze_image_encoder: bool = True
    scene_token_id: int = 6
    img_token_id: int = 4
    # training loss over the answer window only: exactly equal (prompt
    # targets are -100), but the fp32 logits shrink from T to T_out
    answer_window_loss: bool = False


def splice_embeddings(
    token_embeds: torch.Tensor,  # (B, T, D)
    input_ids: torch.Tensor,  # (B, T)
    placeholder_id: int,
    insert_embeds: torch.Tensor,  # (B, N, D)
    insert_mask: Optional[torch.Tensor],  # (B, N) 1 = valid
    attention_mask: torch.Tensor,  # (B, T)
):
    """The k-th ``placeholder_id`` of a row receives ``insert_embeds[row,
    k]`` and the attention mask ``insert_mask[row, k]``."""
    is_ph = input_ids == placeholder_id
    rank = (torch.cumsum(is_ph.long(), dim=1) - 1).clamp(0, insert_embeds.shape[1] - 1)
    gathered = torch.gather(
        insert_embeds, 1, rank[..., None].expand(-1, -1, insert_embeds.shape[-1])
    )
    embeds = torch.where(is_ph[..., None], gathered.to(token_embeds.dtype), token_embeds)
    if insert_mask is not None:
        gathered_mask = torch.gather(insert_mask.to(attention_mask.dtype), 1, rank)
        attention_mask = torch.where(is_ph, gathered_mask, attention_mask)
    return embeds, attention_mask


def build_targets(input_ids: torch.Tensor, output_ids: torch.Tensor,
                  output_mask: torch.Tensor) -> torch.Tensor:
    """CE targets (B, T_in + T_out): -100 everywhere except answer tokens;
    the first output position (bos) is conditioning, not predicted."""
    prompt = torch.full(input_ids.shape, _IGNORE, dtype=torch.long, device=input_ids.device)
    answer = torch.where(output_mask.bool(), output_ids.long(), _IGNORE)
    answer[:, 0] = _IGNORE
    return torch.cat([prompt, answer], dim=1)


def _per_sequence_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL over each row's targets >= 0; logits and targets aligned."""
    valid = targets >= 0
    safe = torch.where(valid, targets, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum(dim=1) / valid.sum(dim=1).clamp(min=1)


def sequence_ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sequence mean CE over target positions >= 0. ``logits`` fp32
    (B, T, V); returns (B,)."""
    return _per_sequence_nll(logits[:, :-1], targets[:, 1:])


def sequence_ce_loss_sp(logits: torch.Tensor, targets: torch.Tensor, lo: int,
                        hi: int) -> torch.Tensor:
    """Per-sequence CE (B,) under sequence parallelism: ``logits`` (B, hi -
    lo, V) fp32 cover the global positions [lo, hi) this sp rank holds
    (``LlamaModel.sp_window``); their token NLLs against ``targets[:, lo+1 :
    hi+1]`` (the sequence's last position predicts nothing) are summed over
    the sp group (each position on exactly one rank), then divided by the
    number of targets >= 0 of the whole sequence (the whole ``targets`` is
    on every rank). Equals :func:`sequence_ce_loss` on the whole logits;
    every sp rank returns it."""
    from msr3d_tpu_torch.parallel.ring_attention import sum_over_sp

    window = targets[:, lo + 1:hi + 1]
    valid = window >= 0
    logp = torch.log_softmax(logits[:, :window.shape[1]], dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, window, 0)[..., None])[..., 0]
    total = sum_over_sp(torch.where(valid, nll, 0.0).sum(dim=1))
    return total / (targets[:, 1:] >= 0).sum(dim=1).clamp(min=1)


def sequence_ce_loss_windowed(window_logits: torch.Tensor, targets: torch.Tensor,
                              start: int) -> torch.Tensor:
    """Per-sequence CE from logits covering only positions ``start-1 ..
    start-1+W`` (the answer window). Equals :func:`sequence_ce_loss` on the
    full-width logits, since every target outside the window is -100."""
    w = window_logits.shape[1]
    return _per_sequence_nll(window_logits, targets[:, start:start + w])


class MSR3DNetwork(nn.Module):
    def __init__(self, cfg: MSR3DNetworkConfig, device=None):
        super().__init__()
        if cfg.prompter.use_attn_flat:
            raise ValueError(
                "use_attn_flat (AttFlat) pools the scene into one (B, attn_flat_out_size) "
                "vector, which llm_proj and the scene-placeholder splice cannot place (the "
                "JAX MSR3DNetwork fails on it too); the prompter alone runs it")
        self.cfg = cfg
        self.visual_prompter = OSE3DSituation(cfg.prompter, device)
        self.llm = LlamaModel(cfg.llm, device)
        self.llm_proj = nn.Linear(cfg.prompter.hidden_size, cfg.llm.hidden_size, device=device)
        self.image_encoder = Backbone2D(cfg.backbone_name, cfg.image_pooling,
                                        cfg.freeze_image_encoder, device)
        self.llm_proj_img = nn.Linear(self.image_encoder.out_channels, cfg.llm.hidden_size,
                                      device=device)

    def tp_dims(self) -> Dict[str, Spec]:
        """name → the spec of each tensor sharded over tp (the LLM's;
        everything else is replicated)."""
        return {f"llm.{name}": dim for name, dim in self.llm.tp_dims().items()}

    def tp_partial(self) -> List[str]:
        """The replicated parameters whose per-rank gradient is a partial
        sum over the tp group (``LlamaModel.tp_partial``)."""
        return [f"llm.{name}" for name in self.llm.tp_partial()]

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, M, H, W, 3) → projected image embeddings (B, M, ·), one token
        an image with ``avg``, ``conv`` or ``attn`` pooling."""
        b, m = images.shape[:2]
        feats = self.image_encoder(images.reshape((b * m,) + images.shape[2:]))
        return self.llm_proj_img(feats).reshape(b, m, -1)

    def build_embeds(self, input_ids, attention_mask, obj_fts, obj_masks, obj_locs,
                     anchor_locs, anchor_orientation, images=None, image_masks=None,
                     generator=None):
        """Token embeddings with the scene tokens spliced at the scene
        placeholders and, given ``images`` (B, M, H, W, 3) with
        ``image_masks`` (B, M), the k-th image at the k-th image
        placeholder, its mask in the attention mask."""
        scene = self.visual_prompter(obj_fts, obj_masks, obj_locs, anchor_locs,
                                     anchor_orientation, generator)
        embeds, attention_mask = splice_embeddings(
            self.llm.embed(input_ids), input_ids, self.cfg.scene_token_id,
            self.llm_proj(scene["obj_tokens"]), scene["obj_masks"], attention_mask,
        )
        if images is not None:
            embeds, attention_mask = splice_embeddings(
                embeds, input_ids, self.cfg.img_token_id, self.encode_images(images),
                image_masks, attention_mask,
            )
        return embeds, attention_mask

    def embeds_for_loss(self, input_ids, attention_mask, output_ids, output_mask, obj_fts,
                        obj_masks, obj_locs, anchor_locs, anchor_orientation, images=None,
                        image_masks=None, generator=None):
        """Spliced prompt+answer embeds, the joint attention mask and the CE
        targets: everything before the LLM blocks."""
        embeds, attn = self.build_embeds(input_ids, attention_mask, obj_fts, obj_masks,
                                         obj_locs, anchor_locs, anchor_orientation, images,
                                         image_masks, generator)
        full_embeds = torch.cat([embeds, self.llm.embed(output_ids)], dim=1)
        full_attn = torch.cat([attn, output_mask.to(attn.dtype)], dim=1)
        return full_embeds, full_attn, build_targets(input_ids, output_ids, output_mask)

    def forward(self, input_ids, attention_mask, output_ids, output_mask, obj_fts, obj_masks,
                obj_locs, anchor_locs, anchor_orientation, images=None, image_masks=None, *,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Teacher-forced pass over ``[prompt ‖ answer]`` → {"loss": per-
        sequence CE (B,), "logits": fp32}. In ``train()`` mode dropout draws
        from ``generator``. Under sp the logits are this rank's positions
        (``LlamaModel.sp_window``) and the loss is the whole sequence's on
        every sp rank."""
        full_embeds, full_attn, targets = self.embeds_for_loss(
            input_ids, attention_mask, output_ids, output_mask, obj_fts, obj_masks, obj_locs,
            anchor_locs, anchor_orientation, images, image_masks, generator,
        )
        if self.cfg.llm.sp_size > 1:
            start = input_ids.shape[1] if self.cfg.answer_window_loss else None
            logits = self.llm(full_embeds, full_attn, answer_start=start,
                              generator=generator).float()
            lo, hi = self.llm.sp_window(full_embeds.shape[1], start)
            return {"loss": sequence_ce_loss_sp(logits, targets, lo, hi), "logits": logits}
        if self.cfg.answer_window_loss:
            start = input_ids.shape[1]
            logits = self.llm(full_embeds, full_attn, answer_start=start,
                              generator=generator).float()
            return {"loss": sequence_ce_loss_windowed(logits, targets, start), "logits": logits}
        logits = self.llm(full_embeds, full_attn, generator=generator).float()
        return {"loss": sequence_ce_loss(logits, targets), "logits": logits}

    def prefill(self, input_ids, attention_mask, obj_fts, obj_masks, obj_locs,
                anchor_locs, anchor_orientation, images=None, image_masks=None, *,
                bos_id: int, max_cache_len: int, append_bos: bool = True):
        """Spliced embeds + trailing bos → (first-token logits (B, V) fp32,
        prompt KV cache, cache mask, next positions). ``append_bos=False``
        prefills a shared scene prefix (grouped generation), whose bos
        belongs after each question's suffix."""
        embeds, attn = self.build_embeds(input_ids, attention_mask, obj_fts, obj_masks,
                                         obj_locs, anchor_locs, anchor_orientation, images,
                                         image_masks)
        if append_bos:
            b = embeds.shape[0]
            bos = torch.full((b, 1), bos_id, dtype=input_ids.dtype, device=input_ids.device)
            embeds = torch.cat([embeds, self.llm.embed(bos)], dim=1)
            attn = torch.cat([attn, torch.ones((b, 1), dtype=attn.dtype, device=attn.device)],
                             dim=1)
        logits, _, caches, cache_mask, next_pos = self.llm.prefill_with_cache(
            embeds, attn, max_cache_len, logits_last_only=True
        )
        return logits[:, -1, :].float(), caches, cache_mask, next_pos

    def decode_step_shared(self, token_ids, positions, prompt_kv, prompt_mask, gen_kv,
                           gen_index, gen_mask, window_valid=None):
        """Split-cache decode step: the prompt KV at batch B (or a batch-1
        segment with a per-query ``prompt_mask``), the generated KV at batch
        B·K, a window of T >= 1 tokens. See ``LlamaModel.decode_step_shared``."""
        return self.llm.decode_step_shared(
            self.llm.embed(token_ids), positions, prompt_kv, prompt_mask, gen_kv,
            gen_index, gen_mask, window_valid,
        )

    def decode_step_beam_anc(self, token_ids, positions, prompt_kv, prompt_mask, gen_kv,
                             gen_index, gen_mask, anc, num_beams: int):
        """Beam decode step over a generated KV whose rows never reorder,
        read through the ancestry map ``anc``; ``prompt_kv`` may be a tuple
        of segments under a per-query ``prompt_mask``. See
        ``LlamaModel.decode_step_beam_anc``."""
        return self.llm.decode_step_beam_anc(
            self.llm.embed(token_ids), positions, prompt_kv, prompt_mask, gen_kv,
            gen_index, gen_mask, anc, num_beams,
        )


@torch.no_grad()
def init_network_params(network: MSR3DNetwork, generator: torch.Generator) -> None:
    """Random weights of the JAX initialisers' kinds, drawn from
    ``generator``: Dense and Conv ~ N(0, 1/fan_in) (a conv's fan_in is
    kh·kw·I/groups), Llama projections, embeddings and head ~ N(0, 0.02),
    LoRA A ~ He-uniform, LoRA B = 0, norms 1/0, BatchNorm statistics 0/1,
    ConvNeXt's layer scale 1e-6, the orientation feature 0, the anchor
    token ~ N(0, 0.02) and its size 1.

    A quantized projection draws the same N(0, 0.02) weight as its bf16
    counterpart and quantizes it (the JAX initialiser's int8 zeros with
    scale 1 would make a dead base), so a quantized model initialised from
    a seed equals the bf16 one initialised from it, then quantized.

    Under tensor parallelism each rank draws every sharded tensor whole, as
    tp = 1 draws it, and keeps its shard (a quantized projection quantizes
    its whole weight, then keeps its shards of the values and scales), so
    the ranks' draws stay in step and their shards join into the tp = 1
    model. A pipeline stage draws the blocks of the other stages too, in
    their place, and throws them away: every stage's replicated tensors are
    the same draws, and its blocks are the whole model's."""
    g = dict(generator=generator)
    cfg = network.cfg.llm
    dims = network.tp_dims()

    def draw(name: str, param: torch.Tensor, fill) -> None:
        # fill(t) draws into t; a sharded param draws its whole, then slices
        dim = dims.get(name)
        if dim is None:
            fill(param)
            return
        shape = list(param.shape)
        shape[dim] *= cfg.tp_size
        whole = torch.empty(shape, dtype=param.dtype, device=param.device)
        fill(whole)
        param.copy_(shard_tensor(whole, dim, cfg.tp_rank, cfg.tp_size))

    for prefix, mod in _init_order(network):
        if isinstance(mod, LoraDense):
            if mod.bits:
                weight = torch.empty((mod.full_out, mod.full_in), dtype=mod.param_dtype,
                                     device=mod.weight_q.device).normal_(0.0, 0.02, **g)
                q, scale = quantize_kernel(weight.t(), mod.bits, mod.group)
                del weight
                for leaf, value in (("weight_q", q), ("weight_scale", scale)):
                    getattr(mod, leaf).copy_(shard_tensor(value, dims.get(f"{prefix}.{leaf}"),
                                                          cfg.tp_rank, cfg.tp_size))
            else:
                draw(f"{prefix}.weight", mod.weight, lambda t: t.normal_(0.0, 0.02, **g))
            if mod.scale:
                limit = math.sqrt(6.0 / mod.full_in)
                draw(f"{prefix}.lora_a", mod.lora_a, lambda t: t.uniform_(-limit, limit, **g))
                mod.lora_b.zero_()
        elif isinstance(mod, nn.Embedding):
            draw(f"{prefix}.weight", mod.weight, lambda t: t.normal_(0.0, 0.02, **g))
        elif isinstance(mod, nn.Conv2d):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight[0].numel()), **g)
            mod.bias.zero_()
        elif isinstance(mod, ConvNeXtBlock):
            mod.gamma.fill_(mod.layer_scale_init)
        elif isinstance(mod, nn.Linear):
            if mod is network.llm.lm_head:
                draw(f"{prefix}.weight", mod.weight, lambda t: t.normal_(0.0, 0.02, **g))
            else:
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), **g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            if mod.weight is None:  # DiTBlock's norms have neither scale nor bias
                continue
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
    prompter = network.visual_prompter
    if prompter.cfg.use_orientation:
        prompter.object_orientation_feat.zero_()
    if prompter.prepend_anchor:
        prompter.anchor_feat.normal_(0.0, 0.02, **g)
        prompter.anchor_size.fill_(1.0)


def _init_order(network: nn.Module):
    """(name, module) of every module of ``network`` in the order the whole
    model's ``named_modules`` gives: ``StageLayers`` yields every block of
    the model in turn, on a pipeline stage the other stages' built for the
    draw on the stage's device and dropped after it."""
    cfg = network.cfg.llm
    seen = set()

    def walk(prefix: str, module: nn.Module):
        if id(module) in seen:
            return
        seen.add(id(module))
        yield prefix, module
        if isinstance(module, StageLayers):
            held = dict(module.named_children())
            device = next(module.parameters()).device
            for i in range(cfg.num_hidden_layers):
                block = held.get(str(i)) or LlamaBlock(cfg, device)
                yield from walk(f"{prefix}.{i}", block)
            return
        for name, child in module.named_children():
            yield from walk(f"{prefix}.{name}" if prefix else name, child)

    return walk("", network)


class MSR3D:
    """Host wrapper with the reference's model contract:
    ``forward(data_dict) → data_dict['loss']`` and ``generate(data_dict) →
    data_dict['output_tokens']`` (and ``'output_text'``), beam search by
    default (``num_beams`` 5, repetition penalty 3.0: the reference's eval
    decode).

    The serving knobs are JAX's, with its defaults and its checks:
    ``spec_k`` > 0 runs greedy decoding with n-gram speculative drafts
    (``spec_ngram``-grams; needs ``repetition_penalty`` 1.0); ``do_sample``
    samples the greedy path (``temperature``, ``top_k``, ``top_p``), each
    call from the key ``fold_in(PRNGKey(sample_seed), calls so far)``;
    ``compact_transfer`` sends the generation paths' points to the device as
    int16 xyz + int8 rgb (9 bytes a point, not 24) and unpacks them there.
    """

    def __init__(
        self,
        network_cfg: MSR3DNetworkConfig,
        tokenizer: Optional[BaseTokenizer] = None,
        *,
        scene_token_len: int = 60,
        image_token_len: int = 1,
        max_context_len: int = 256,  # stored; prompts are not truncated to it (as in JAX)
        max_out_len: int = 256,
        prompt_pad_to: int = 256,  # the serving engines' prompt width, trailing bos included
        num_beams: int = 5,
        repetition_penalty: float = 3.0,
        length_penalty: float = 1.0,
        beam_ancestry: bool = True,  # generated KV read through an ancestry
        # map, no per-step reorder of it; False reorders it (index_select)
        eos_logit_bias: float = 0.0,  # additive on the EOS logit, greedy and beam
        compact_transfer: bool = False,
        spec_k: int = 0,  # drafts a verify window of speculative greedy (0: off)
        spec_ngram: int = 3,  # n of the suffix n-gram looked up for drafts
        do_sample: bool = False,  # sample the greedy path (HF do_sample)
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        sample_seed: int = 0,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or ByteTokenizer()
        self.cfg = dataclasses.replace(
            network_cfg,
            scene_token_id=self.tokenizer.scene_token_id,
            img_token_id=self.tokenizer.img_token_id,
        )
        self.network = MSR3DNetwork(self.cfg, device=self.device).eval()
        self._mark_trainable()
        self.scene_token_len = scene_token_len
        self.image_token_len = image_token_len
        self.max_context_len = max_context_len
        self.max_out_len = max_out_len
        self.prompt_pad_to = prompt_pad_to
        self.num_beams = num_beams
        self.repetition_penalty = repetition_penalty
        self.length_penalty = length_penalty
        self.beam_ancestry = bool(beam_ancestry)
        self.eos_logit_bias = eos_logit_bias
        if spec_k > 0 and repetition_penalty != 1.0:
            raise ValueError(
                "speculative greedy (spec_k > 0) requires repetition_penalty == 1.0 — the "
                "penalty serializes verification (pick t depends on in-window acceptance)")
        if do_sample and spec_k > 0:
            raise ValueError("do_sample and spec_k are mutually exclusive — n-gram "
                             "verification accepts drafts against the argmax pick")
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.sample_seed = int(sample_seed)
        self._sample_calls = 0  # each sampled call folds its count into the key
        self.compact_transfer = bool(compact_transfer)
        self._seed = seed

    def _mark_trainable(self) -> None:
        trainable = set(self.trainable_parameter_names())
        for name, param in self.network.named_parameters():
            param.requires_grad_(name in trainable)

    # -- weights -----------------------------------------------------------

    def init_params(self, seed: Optional[int] = None) -> None:
        """Random weights on the model's device from a seeded generator
        (the JAX package's shapes; no checkpoint needed)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed if seed is None else seed)
        init_network_params(self.network, gen)

    def load_jax_params(self, variables: Mapping[str, Any]) -> List[str]:
        """Load the JAX package's flax variables (nested numpy dicts).
        Returns the JAX keys skipped as not on this path."""
        return load_jax_params(self.network, variables)

    @torch.no_grad()
    def shard_for_serving(self, *, tensor_parallel: bool = False) -> None:
        """Serve over the ranks of ``parallel/mesh.py``'s mesh (after
        ``init_mesh``), the counterpart of the JAX package's
        ``shard_for_serving``. Its dp mode, the params replicated over the
        devices one process drives, is already what a rank holds here, so it
        does nothing. ``tensor_parallel=True`` splits the LLM's weights of
        this full model over the tp group in the megatron layout
        (``parallel/sharding.py``), a quantized base included: the rank
        rebuilds its LLM at the shard shapes and keeps its shards; every tp
        rank then runs ``generate`` and the engines on the same requests,
        and their tokens are the unsharded model's."""
        from msr3d_tpu_torch.parallel import mesh

        if not tensor_parallel or mesh.tp_size() == 1:
            return
        if self.cfg.llm.tp_size > 1:
            raise ValueError("shard_for_serving: the LLM is tp-sharded already")
        self._reshard_llm(mesh.tp_size(), mesh.tp_rank(), 1, 0)

    @torch.no_grad()
    def shard_for_training(self) -> None:
        """Split this full model over the mesh's tp and pp ranks (after
        ``init_mesh``): the LLM keeps this rank's tp shards of its pipeline
        stage's blocks (``LlamaConfig.pp_size``/``pp_rank``) beside the
        embedding, norm and head, and takes its sp block
        (``sp_size``/``sp_rank``: nothing splits over sp); everything else
        stays whole. ``LeoTrainer`` does it for a full model it is given
        under pp or sp."""
        from msr3d_tpu_torch.parallel import mesh

        llm = self.cfg.llm
        if (llm.tp_size, llm.pp_size, llm.sp_size) != (1, 1, 1):
            raise ValueError("shard_for_training: the LLM is split already")
        self._reshard_llm(mesh.tp_size(), mesh.tp_rank(), mesh.pp_size(), mesh.pp_rank(),
                          mesh.sp_size(), mesh.sp_rank())

    def _reshard_llm(self, tp: int, tp_rank: int, pp: int, pp_rank: int, sp: int = 1,
                     sp_rank: int = 0) -> None:
        from msr3d_tpu_torch.parallel.sharding import shard_like

        llm_cfg = dataclasses.replace(self.cfg.llm, tp_size=tp, tp_rank=tp_rank, pp_size=pp,
                                      pp_rank=pp_rank, sp_size=sp, sp_rank=sp_rank)
        llm = LlamaModel(llm_cfg, device=self.device)
        keep = set(llm.state_dict())
        llm.load_state_dict(shard_like(llm, {n: t for n, t in self.network.llm.state_dict()
                                             .items() if n in keep}))
        self.network.llm = llm.train(self.network.training)  # frees the full LLM
        self.cfg = dataclasses.replace(self.cfg, llm=llm_cfg)
        self.network.cfg = self.cfg
        self._mark_trainable()

    @torch.no_grad()
    def quantize_llm(self, bits: int = 8, group: Optional[int] = None, *,
                     act_quantize: bool = False, kv_quantize: bool = False) -> None:
        """Quantize the LLM's base projections of an initialised or loaded
        bf16/fp32 model in place, on its device, through
        ``models/llm/convert.py::quantize_kernel`` (each projection's weight
        is freed as its quantized form lands, so the peak is one projection
        above the quantized model), and switch the config to the quantized
        serving options. A split model raises: quantize the whole model,
        then shard it (``shard_for_serving``), as a shard's scales need its
        whole layer."""
        if (self.cfg.llm.tp_size, self.cfg.llm.pp_size) != (1, 1):
            raise ValueError("quantize_llm: quantize the whole model, then shard it")
        llm = dataclasses.replace(self.cfg.llm, quantize=True, quantize_bits=bits,
                                  quantize_group=group, act_quantize=act_quantize,
                                  kv_quantize=kv_quantize)
        for mod in self.network.llm.modules():
            if isinstance(mod, LoraDense):
                mod.quantize_(bits, group, act_quantize)
        self.cfg = dataclasses.replace(self.cfg, llm=llm)
        self.network.cfg = self.cfg
        for mod in self.network.llm.modules():
            if hasattr(mod, "cfg"):
                mod.cfg = llm

    # -- prompts -----------------------------------------------------------

    def build_text_prompt(self, data_dict: Dict[str, Any]) -> List[str]:
        scene_holder = SCENE_PLACEHOLDER * self.scene_token_len
        image_holder = IMAGE_PLACEHOLDER * self.image_token_len
        if "msr3d_prompt" in data_dict:
            return [
                p.replace(SCENE_PLACEHOLDER, scene_holder).replace(IMAGE_PLACEHOLDER, image_holder)
                for p in data_dict["msr3d_prompt"]
            ]
        return [
            f"{before} {mid1}{image_holder}. {mid2} {scene_holder}. {after}"
            for before, mid1, mid2, after in zip(
                data_dict["prompt_before_obj"], data_dict["prompt_middle_1"],
                data_dict["prompt_middle_2"], data_dict["prompt_after_obj"],
            )
        ]

    def _encode_prompts(self, prompts: List[str]):
        enc = self.tokenizer.encode_batch(prompts, padding_side="left", add_bos=True)
        return enc.input_ids, enc.attention_mask

    def _encode_answers(self, answers: List[str]):
        enc = self.tokenizer.encode_batch(
            answers, padding_side="right", add_bos=True, add_eos=True,
            max_length=self.max_out_len, truncation_side="right",
        )
        return enc.input_ids, enc.attention_mask

    def _pad_to_bucket(self, ids: np.ndarray, mask: np.ndarray, *, side: str):
        """Pad ids + mask to the next multiple of 32 with pad_id / mask 0."""
        pad_to = max(32, -(-ids.shape[1] // 32) * 32)
        if ids.shape[1] >= pad_to:
            return ids, mask
        b, extra = ids.shape[0], pad_to - ids.shape[1]
        pad_ids = np.full((b, extra), self.tokenizer.pad_id, ids.dtype)
        pad_mask = np.zeros((b, extra), mask.dtype)
        if side == "left":
            return np.concatenate([pad_ids, ids], 1), np.concatenate([pad_mask, mask], 1)
        return np.concatenate([ids, pad_ids], 1), np.concatenate([mask, pad_mask], 1)

    def _host_scene_batch(self, data_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """The scene inputs as numpy and, where the request carries them,
        ``images`` (B, M, H, W, 3) and ``image_masks`` (B, M): the MSR3D
        ``msr3d_imgs`` with ``msr3d_img_masks``, or else the LEO single view
        ``img_fts`` (B, H, W, 3) as M = 1 with ``img_masks`` (ones when
        absent)."""
        batch = {k: np.asarray(data_dict[k]) for k in _SCENE_KEYS}
        if data_dict.get("msr3d_imgs") is not None:
            batch["images"] = np.asarray(data_dict["msr3d_imgs"])
            batch["image_masks"] = np.asarray(data_dict["msr3d_img_masks"])
        elif data_dict.get("img_fts") is not None:
            imgs = np.asarray(data_dict["img_fts"])
            if imgs.ndim == 4:  # (B, H, W, 3) → (B, 1, H, W, 3)
                imgs = imgs[:, None]
            batch["images"] = imgs
            batch["image_masks"] = np.asarray(
                data_dict.get("img_masks", np.ones(imgs.shape[:2], bool))
            ).reshape(imgs.shape[:2])
        return batch

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host scene batch on the model's device: masks bool, the packed
        points of ``_maybe_pack`` in their integer types, the rest fp32."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v, device=self.device)
            if k in ("obj_masks", "image_masks"):
                t = t.to(torch.bool)
            elif k not in _PACKED:
                t = t.to(torch.float32)
            out[k] = t
        return out

    def _scene_batch(self, data_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The scene inputs of ``_host_scene_batch`` on the model's device."""
        return self._to_device(self._host_scene_batch(data_dict))

    def _maybe_pack(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """``compact_transfer``: ``obj_fts`` (..., 6) fp32 → int16 xyz (×
        32767) + int8 rgb (× 127), 9 bytes a point, not 24; the points are
        normalized to the unit sphere, so a fixed scale holds. JAX's numpy,
        so the same bits."""
        if not self.compact_transfer or "obj_fts" not in batch:
            return batch
        batch = dict(batch)
        fts = batch.pop("obj_fts")
        batch["obj_fts_xyz_q"] = np.clip(np.round(fts[..., :3] * 32767.0), -32767,
                                         32767).astype(np.int16)
        batch["obj_fts_rgb_q"] = np.clip(np.round(fts[..., 3:6] * 127.0), -127,
                                         127).astype(np.int8)
        return batch

    @staticmethod
    def _unpack_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The device side of ``_maybe_pack``: each part to fp32 times the
        fp32 constant 1/32767 or 1/127, as JAX computes it (a multiply, not a
        divide)."""
        if "obj_fts_xyz_q" not in batch:
            return batch
        batch = dict(batch)
        xyz = batch.pop("obj_fts_xyz_q")
        rgb = batch.pop("obj_fts_rgb_q")
        scale = torch.tensor([1.0 / 32767.0, 1.0 / 127.0], dtype=torch.float32,
                             device=xyz.device)
        batch["obj_fts"] = torch.cat([xyz.float() * scale[0], rgb.float() * scale[1]], dim=-1)
        return batch

    def _gen_scene_batch(self, data_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The generation paths' scene inputs on the device: with
        ``compact_transfer`` the points cross to the device packed and are
        unpacked there (JAX packs on these paths only, not for the loss)."""
        if not self.compact_transfer:
            return self._scene_batch(data_dict)
        return self._unpack_batch(self._to_device(self._maybe_pack(
            self._host_scene_batch(data_dict))))

    def loss_batch(self, data_dict: Dict[str, Any], input_ids: np.ndarray, attn: np.ndarray,
                   output_ids: np.ndarray, output_mask: np.ndarray) -> Dict[str, torch.Tensor]:
        """The network's loss inputs on the model's device."""
        batch = self._scene_batch(data_dict)
        for key, val in (("input_ids", input_ids), ("attention_mask", attn),
                         ("output_ids", output_ids), ("output_mask", output_mask)):
            batch[key] = torch.as_tensor(val, dtype=torch.long if "ids" in key else torch.int32,
                                         device=self.device)
        return batch

    # -- training contract ---------------------------------------------------

    def forward(self, data_dict: Dict[str, Any], *,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Sets ``data_dict['loss']``, the per-sequence answer CE (B,), with
        prompt and answer widths bucketed to multiples of 32. The network's
        mode decides dropout (``eval()`` after construction, as the JAX
        package's deterministic ``forward``); in ``train()`` mode it draws
        from ``generator``."""
        input_ids, attn = self._encode_prompts(self.build_text_prompt(data_dict))
        output_ids, output_mask = self._encode_answers(data_dict["text_output"])
        input_ids, attn = self._pad_to_bucket(input_ids, attn, side="left")
        output_ids, output_mask = self._pad_to_bucket(output_ids, output_mask, side="right")
        batch = self.loss_batch(data_dict, input_ids, attn, output_ids, output_mask)
        data_dict["loss"] = self.network(**batch, generator=generator)["loss"]
        return data_dict

    def trainable_parameter_names(self) -> List[str]:
        """The parameters that train, the counterpart of the JAX
        ``get_opt_params_mask``: LoRA A/B, ``llm_proj``, ``llm_proj_img`` and
        the scene prompter, except the point encoder when ``vision_freeze``;
        never the base LLM (embeddings, norms, base projections,
        ``lm_head``) nor the image encoder (its pooling layers included)."""
        def trainable(name: str) -> bool:
            if "lora_a" in name or "lora_b" in name:
                return True
            if name.startswith(("llm.", "image_encoder.")):
                return False
            if "obj_encoder" in name and self.cfg.prompter.vision_freeze:
                return False
            return True

        return [name for name, _ in self.network.named_parameters() if trainable(name)]

    # -- generation ----------------------------------------------------------

    def generate(
        self,
        data_dict: Dict[str, Any],
        *,
        use_beam: Optional[bool] = None,
        max_new_tokens: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Prefill over the prompt segment, then the split-cache decode loop:
        beam search with ``num_beams`` beams unless ``use_beam`` is False
        (``None`` follows ``num_beams``), else greedy. Sets
        ``output_tokens`` (B, max_new) and ``output_text``. Exactly
        ``generate_async(...)()``."""
        return self.generate_async(data_dict, use_beam=use_beam,
                                   max_new_tokens=max_new_tokens)()

    @torch.no_grad()
    def generate_async(
        self,
        data_dict: Dict[str, Any],
        *,
        use_beam: Optional[bool] = None,
        max_new_tokens: Optional[int] = None,
    ) -> Callable[[], Dict[str, Any]]:
        """``generate`` split in two: runs the prefill and the decode loop
        and returns ``finalize()``, which copies the tokens to the host,
        detokenizes and sets ``output_tokens`` and ``output_text`` (and, on
        the speculative path, ``spec_stats``: tokens emitted, drafts
        accepted, verify calls).

        This gives the fixed batcher and the trainer's eval loop the JAX
        package's request-pipelining interface, but little overlap: the
        decode loops read the host every step (the exit test), so by the
        time this returns all but the last step's kernels have run. Only
        the device-to-host copy and the detokenize wait for ``finalize``.

        The greedy path samples with ``do_sample`` and speculates with
        ``spec_k`` > 0; sampling with beams, or with ``spec_k``, raises."""
        beams = self.num_beams if use_beam is None else (self.num_beams if use_beam else 1)
        if self.do_sample and beams > 1:
            raise ValueError("do_sample requires the greedy path (num_beams == 1 or "
                             "use_beam=False) — beam-sampling is not supported")
        sample = self.do_sample
        if sample and self.spec_k > 0:
            raise ValueError("do_sample and spec_k are mutually exclusive — n-gram "
                             "verification accepts drafts against the argmax pick")
        self.network.eval()  # no dropout, also right after training steps
        input_ids, attn = self._encode_prompts(self.build_text_prompt(data_dict))
        input_ids, attn = self._pad_to_bucket(input_ids, attn, side="left")
        scene = self._gen_scene_batch(data_dict)
        max_new = max_new_tokens or self.max_out_len
        eos_id = self.tokenizer.eos_id
        ids_t = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)

        first, prompt_kv, prompt_mask, next_pos = self.network.prefill(
            ids_t, torch.as_tensor(attn, dtype=torch.int32, device=self.device),
            **scene, bos_id=self.tokenizer.bos_id, max_cache_len=input_ids.shape[1] + 1,
        )
        # the prompt cache stays at batch B; the generated segment holds a
        # row a beam, int8 with scales when the LLM's config says kv_quantize
        gen_kv = _make_cache(self.network.llm.cfg, first.shape[0] * beams, max_new, self.device)

        def decode_shared(token_ids, positions, gkv, gidx, gmask):
            return self.network.decode_step_shared(
                token_ids, positions, prompt_kv, prompt_mask, gkv, gidx, gmask
            )

        common = dict(max_new_tokens=max_new, eos_id=eos_id, pad_id=eos_id, min_length=1,
                      repetition_penalty=self.repetition_penalty,
                      eos_logit_bias=self.eos_logit_bias)
        spec_stats = None
        if beams > 1:
            def decode_anc(token_ids, positions, gkv, gidx, gmask, anc):
                return self.network.decode_step_beam_anc(
                    token_ids, positions, prompt_kv, prompt_mask, gkv, gidx, gmask, anc, beams
                )

            tokens = beam_search_decode_shared(
                decode_shared, next_pos, first, gen_kv, num_beams=beams,
                length_penalty=self.length_penalty,
                decode_step_anc=decode_anc if self.beam_ancestry else None, **common,
            )
        elif self.spec_k > 0:
            # the generated segment's slots start at 0 (prompt_len 0): the
            # prompt lives in the shared prompt segment
            common.pop("repetition_penalty")
            tokens, spec_stats = ngram_speculative_decode(
                decode_shared, gen_kv,
                torch.zeros((first.shape[0], max_new), dtype=torch.bool, device=self.device),
                next_pos, first, ids_t, prompt_len=0, spec_k=self.spec_k,
                ngram_n=self.spec_ngram, return_stats=True, **common,
            )
        else:
            sample_kw = {}
            if sample:
                key = prng.fold_in(prng.prng_key(self.sample_seed, self.device),
                                   self._sample_calls)
                self._sample_calls += 1
                sample_kw = dict(sample_key=key, temperature=self.temperature,
                                 top_k=self.top_k, top_p=self.top_p)
            tokens = greedy_decode_shared(decode_shared, next_pos, first, gen_kv, **common,
                                          **sample_kw)

        def finalize() -> Dict[str, Any]:
            data_dict["output_tokens"] = tokens.cpu().numpy()
            data_dict["output_text"] = self.batch_detokenize(data_dict["output_tokens"])
            if spec_stats is not None:
                data_dict["spec_stats"] = {k: int(v) for k, v in spec_stats.items()}
            return data_dict

        return finalize

    # -- grouped generation: Q questions over one shared scene prefix --------

    def generate_scene_group(
        self,
        data_dict: Dict[str, Any],
        *,
        use_beam: Optional[bool] = None,
        max_new_tokens: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Blocking grouped generate, ``generate_scene_group_async(...)()``."""
        return self.generate_scene_group_async(data_dict, use_beam=use_beam,
                                               max_new_tokens=max_new_tokens)()

    @torch.no_grad()
    def generate_scene_group_async(
        self,
        data_dict: Dict[str, Any],
        *,
        use_beam: Optional[bool] = None,
        max_new_tokens: Optional[int] = None,
    ) -> Callable[[], Dict[str, Any]]:
        """Answer groups of questions that share a scene, each scene's prefix
        prefilled once.

        ``data_dict`` holds scene arrays with leading dim G (one row a scene)
        and ``msr3d_prompt`` as a list of G lists of questions (or, for G =
        1, a flat list). Each group's prompts are tokenized whole and split
        at their longest common token prefix, which must hold every scene
        and image placeholder (else ``ValueError``). Then, as JAX's
        ``_make_group_fn``:

          1. the G prefixes, left-padded to a bucket of 32, prefill at batch
             G without a trailing bos (K1 and K2f: one scene encode a scene);
          2. the G·Q suffixes with their bos, left-padded to a bucket of 8 (Q
             padded to a bucket of 4 with copies of the group's first
             question), run as ONE window of T = W over their group's prefix,
             ``window_valid`` hiding the pad tokens; their k/v fill slots
             [0, W) of the generated segment;
          3. greedy decoding, or beam search with the suffix k/v repeated K
             times beam-minor, writes from slot W (``gen_base``).

        Token for token what per-question ``generate`` gives in exact
        arithmetic. Speculative and sampled decoding are not grouped
        (``ValueError``). Returns ``finalize()``, which sets the G·Q real
        rows' ``output_tokens`` and ``output_text``, scene-major."""
        if self.spec_k > 0 or self.do_sample:
            raise ValueError("generate_scene_group supports greedy and beam decoding — "
                             "spec_k and do_sample are not supported in grouped mode")
        beams = self.num_beams if use_beam is None else (self.num_beams if use_beam else 1)
        raw = data_dict["msr3d_prompt"]
        nested = ([list(grp) for grp in raw] if raw and isinstance(raw[0], (list, tuple))
                  else [list(raw)])
        n_groups = len(nested)
        group_sizes = [len(grp) for grp in nested]
        if min(group_sizes) < 1:
            raise ValueError("every scene group needs at least one prompt")

        tok = self.tokenizer
        placeholders = {tok.scene_token_id, tok.img_token_id}
        group_rows, group_lc = [], []
        for grp in nested:
            enc = tok.encode_batch(self.build_text_prompt({"msr3d_prompt": grp}),
                                   padding_side="left", add_bos=True, pad_to=None)
            rows = [enc.input_ids[i][enc.attention_mask[i].astype(bool)]
                    for i in range(len(grp))]
            m = min(len(r) for r in rows)
            stacked = np.stack([r[:m] for r in rows])
            eq = np.all(stacked == stacked[0:1], axis=0)
            lc = m if eq.all() else int(np.argmin(eq))  # the longest common prefix
            for r in rows:
                if any(int(t) in placeholders for t in r[lc:]):
                    raise ValueError(
                        "grouped prompts diverge before the scene/image placeholders — every "
                        "placeholder must sit in the shared prefix (group prompts by scene AND "
                        "situation)")
            group_rows.append(rows)
            group_lc.append(lc)

        p = max(32, -(-max(group_lc) // 32) * 32)
        prefix_ids = np.full((n_groups, p), tok.pad_id, np.int64)
        prefix_attn = np.zeros((n_groups, p), np.int32)
        for gi, (rows, lc) in enumerate(zip(group_rows, group_lc)):
            prefix_ids[gi, p - lc:] = rows[0][:lc]
            prefix_attn[gi, p - lc:] = 1
        group_sufs = [[list(map(int, r[lc:])) + [tok.bos_id] for r in rows]
                      for rows, lc in zip(group_rows, group_lc)]
        w = max(8, -(-max(len(x) for sufs in group_sufs for x in sufs) // 8) * 8)
        q_pad = max(1, -(-max(group_sizes) // 4) * 4)
        bq = n_groups * q_pad
        suffix_ids = np.full((bq, w), tok.pad_id, np.int64)
        window_valid = np.zeros((bq, w), np.int32)
        for gi, sufs in enumerate(group_sufs):
            for j in range(q_pad):
                suf = sufs[j] if j < len(sufs) else sufs[0]
                suffix_ids[gi * q_pad + j, w - len(suf):] = suf
                window_valid[gi * q_pad + j, w - len(suf):] = 1

        lead = np.asarray(data_dict[_SCENE_KEYS[0]]).shape[0]
        if lead != n_groups:
            raise ValueError(f"generate_scene_group expects ONE scene row per prompt group: "
                             f"got {lead} scene rows for {n_groups} groups")
        self.network.eval()
        scene = self._gen_scene_batch(data_dict)
        max_new = max_new_tokens or self.max_out_len
        eos_id = tok.eos_id
        dev = self.device
        net = self.network

        # 1. the shared prefixes at batch G, no trailing bos
        _, prefix_kv, prefix_mask, next_pre = net.prefill(
            torch.as_tensor(prefix_ids, device=dev),
            torch.as_tensor(prefix_attn, device=dev), **scene, bos_id=tok.bos_id,
            max_cache_len=p, append_bos=False)
        # 2. every suffix in one window over its group's prefix; row g·Q + j
        # belongs to scene g (the decode step's bk // b repeat)
        s_g = w + max_new
        gen_kv = _make_cache(net.llm.cfg, bq, s_g, dev)
        wv_t = torch.as_tensor(window_valid, device=dev)
        n_pre = next_pre.long().repeat_interleave(q_pad)
        win_pos = (n_pre[:, None] + torch.cumsum(wv_t.long(), dim=1) - 1).clamp(min=0)
        logits = net.decode_step_shared(
            torch.as_tensor(suffix_ids, device=dev), win_pos, prefix_kv, prefix_mask, gen_kv,
            0, torch.zeros((bq, s_g), dtype=torch.bool, device=dev), wv_t.bool())
        first = logits[:, -1, :].float()
        next_positions = n_pre + wv_t.long().sum(dim=1)
        gen_mask_base = torch.nn.functional.pad(wv_t.bool(), (0, max_new))

        # 3. decoding over the prefixes at batch G and the suffixes' slots
        def decode_shared(token_ids, positions, gkv, gidx, gmask):
            return net.decode_step_shared(token_ids, positions, prefix_kv, prefix_mask, gkv,
                                          gidx, gmask)

        common = dict(max_new_tokens=max_new, eos_id=eos_id, pad_id=eos_id, min_length=1,
                      repetition_penalty=self.repetition_penalty,
                      eos_logit_bias=self.eos_logit_bias, gen_base=w)
        if beams > 1:
            gen_kv = {key: val.repeat_interleave(beams, dim=1) for key, val in gen_kv.items()}

            def decode_anc(token_ids, positions, gkv, gidx, gmask, anc):
                return net.decode_step_beam_anc(token_ids, positions, prefix_kv, prefix_mask,
                                                gkv, gidx, gmask, anc, beams)

            tokens = beam_search_decode_shared(
                decode_shared, next_positions, first, gen_kv, num_beams=beams,
                length_penalty=self.length_penalty,
                gen_mask_base=gen_mask_base.repeat_interleave(beams, dim=0),
                decode_step_anc=decode_anc if self.beam_ancestry else None, **common)
        else:
            tokens = greedy_decode_shared(decode_shared, next_positions, first, gen_kv,
                                          gen_mask_base=gen_mask_base, **common)

        def finalize() -> Dict[str, Any]:
            out = tokens.cpu().numpy().reshape(n_groups, q_pad, -1)
            flat = np.concatenate([out[gi, :sz] for gi, sz in enumerate(group_sizes)], axis=0)
            data_dict["output_tokens"] = flat
            data_dict["output_text"] = self.batch_detokenize(flat)
            return data_dict

        return finalize

    @torch.no_grad()
    def predict_answers(self, data_dict: Dict[str, Any], answer_list: List[str],
                        num_ans_candidates: int = 128, chunk_size: int = 16) -> Dict[str, Any]:
        """Retrieval scoring over ``answer_list``: the prefill's first-token
        probabilities of each candidate's first real token pick the top
        ``num_ans_candidates`` a sample; each of those is scored by the
        per-sequence answer loss of ``MSR3DNetwork.forward`` (``chunk_size``
        candidates a forward, the batch repeated for each), and the argmin
        is the answer. Sets ``answers_id`` (B,), ``answers`` and
        ``answer_scores`` (B, len(answer_list)): −loss at the scored
        candidates, −1e9 at the others."""
        num_ans_candidates = min(num_ans_candidates, len(answer_list))
        self.network.eval()
        input_ids, attn = self._encode_prompts(self.build_text_prompt(data_dict))
        scene = self._scene_batch(data_dict)
        bsz = input_ids.shape[0]
        ans_ids, ans_mask = self._encode_answers(answer_list)  # (A, T)
        ids_t = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        attn_t = torch.as_tensor(attn, dtype=torch.int32, device=self.device)

        first, _, _, _ = self.network.prefill(
            ids_t, attn_t, **scene, bos_id=self.tokenizer.bos_id,
            max_cache_len=input_ids.shape[1] + 1,
        )
        probs = torch.softmax(first, dim=-1).cpu().numpy()  # (B, V)
        cand_probs = probs[:, ans_ids[:, 1]]  # each candidate's token after bos
        topk_ids = np.argsort(-cand_probs, axis=1)[:, :num_ans_candidates]

        losses = np.zeros((bsz, num_ans_candidates), np.float32)
        for start in range(0, num_ans_candidates, chunk_size):
            chunk = topk_ids[:, start:start + chunk_size]  # (B, C)
            c = chunk.shape[1]
            batch = {k: v.repeat_interleave(c, dim=0) for k, v in scene.items()}
            batch.update(
                input_ids=ids_t.repeat_interleave(c, dim=0),
                attention_mask=attn_t.repeat_interleave(c, dim=0),
                output_ids=torch.as_tensor(ans_ids[chunk.reshape(-1)], dtype=torch.long,
                                           device=self.device),
                output_mask=torch.as_tensor(ans_mask[chunk.reshape(-1)], dtype=torch.int32,
                                            device=self.device),
            )
            loss = self.network(**batch)["loss"]
            losses[:, start:start + c] = loss.float().cpu().numpy().reshape(bsz, c)

        answer_ids = topk_ids[np.arange(bsz), losses.argmin(axis=1)]
        data_dict["answers_id"] = answer_ids
        data_dict["answers"] = [answer_list[int(i)] for i in answer_ids]
        scores = np.full((bsz, len(answer_list)), -1e9, np.float32)
        np.put_along_axis(scores, topk_ids, -losses, axis=1)
        data_dict["answer_scores"] = scores
        return data_dict

    def batch_detokenize(self, tokens: np.ndarray) -> List[str]:
        """Decode generated ids, stopping at the first EOS."""
        out = []
        for row in tokens:
            ids = []
            for t in row:
                if t == self.tokenizer.eos_id:
                    break
                ids.append(int(t))
            out.append(self.tokenizer.decode(ids).strip())
        return out
