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
    the greedy and beam decode loops (over a bf16 or int8 KV cache) and
    detokenization, the trainable set, and in-place weight-only
    quantization of the LLM for serving (``quantize_llm``).

Not ported yet (see ROADMAP.md): sampling, speculative and grouped-scene
decoding, the prefix-pool serving engines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from msr3d_tpu_torch.convert import load_jax_params
from msr3d_tpu_torch.device import resolve_device
from msr3d_tpu_torch.models.llm.llama import (
    LlamaConfig,
    LlamaModel,
    LoraDense,
    RMSNorm,
    _make_cache,
)
from msr3d_tpu_torch.models.llm.sampling import beam_search_decode_shared, greedy_decode_shared
from msr3d_tpu_torch.models.llm.tokenizer import (
    IMAGE_PLACEHOLDER,
    SCENE_PLACEHOLDER,
    BaseTokenizer,
    ByteTokenizer,
)
from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig, OSE3DSituation
from msr3d_tpu_torch.models.vision2d import Backbone2D, ConvNeXtBlock
from msr3d_tpu_torch.nn.pointnet import BatchNormInference

_SCENE_KEYS = ("obj_fts", "obj_masks", "obj_locs", "anchor_locs", "anchor_orientation")
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
        self.cfg = cfg
        self.visual_prompter = OSE3DSituation(cfg.prompter, device)
        self.llm = LlamaModel(cfg.llm, device)
        self.llm_proj = nn.Linear(cfg.prompter.hidden_size, cfg.llm.hidden_size, device=device)
        self.image_encoder = Backbone2D(cfg.backbone_name, cfg.image_pooling,
                                        cfg.freeze_image_encoder, device)
        self.llm_proj_img = nn.Linear(self.image_encoder.out_channels, cfg.llm.hidden_size,
                                      device=device)

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
        from ``generator``."""
        full_embeds, full_attn, targets = self.embeds_for_loss(
            input_ids, attention_mask, output_ids, output_mask, obj_fts, obj_masks, obj_locs,
            anchor_locs, anchor_orientation, images, image_masks, generator,
        )
        if self.cfg.answer_window_loss:
            start = input_ids.shape[1]
            logits = self.llm(full_embeds, full_attn, answer_start=start,
                              generator=generator).float()
            return {"loss": sequence_ce_loss_windowed(logits, targets, start), "logits": logits}
        logits = self.llm(full_embeds, full_attn, generator=generator).float()
        return {"loss": sequence_ce_loss(logits, targets), "logits": logits}

    def prefill(self, input_ids, attention_mask, obj_fts, obj_masks, obj_locs,
                anchor_locs, anchor_orientation, images=None, image_masks=None, *,
                bos_id: int, max_cache_len: int):
        """Spliced embeds + trailing bos → (first-token logits (B, V) fp32,
        prompt KV cache, cache mask, next positions)."""
        embeds, attn = self.build_embeds(input_ids, attention_mask, obj_fts, obj_masks,
                                         obj_locs, anchor_locs, anchor_orientation, images,
                                         image_masks)
        b = embeds.shape[0]
        bos = torch.full((b, 1), bos_id, dtype=input_ids.dtype, device=input_ids.device)
        embeds = torch.cat([embeds, self.llm.embed(bos)], dim=1)
        attn = torch.cat([attn, torch.ones((b, 1), dtype=attn.dtype, device=attn.device)], dim=1)
        logits, _, caches, cache_mask, next_pos = self.llm.prefill_with_cache(
            embeds, attn, max_cache_len, logits_last_only=True
        )
        return logits[:, -1, :].float(), caches, cache_mask, next_pos

    def decode_step_shared(self, token_ids, positions, prompt_kv, prompt_mask, gen_kv,
                           gen_index, gen_mask):
        """Split-cache decode step: the prompt KV at batch B, the generated
        KV at batch B·K. See ``LlamaModel.decode_step_shared``."""
        return self.llm.decode_step_shared(
            self.llm.embed(token_ids), positions, prompt_kv, prompt_mask, gen_kv,
            gen_index, gen_mask,
        )

    def decode_step_beam_anc(self, token_ids, positions, prompt_kv, prompt_mask, gen_kv,
                             gen_index, gen_mask, anc, num_beams: int):
        """Beam decode step over a generated KV whose rows never reorder,
        read through the ancestry map ``anc``. See
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
    ConvNeXt's layer scale 1e-6, the orientation feature 0.

    A quantized projection draws the same N(0, 0.02) weight as its bf16
    counterpart and quantizes it (the JAX initialiser's int8 zeros with
    scale 1 would make a dead base), so a quantized model initialised from
    a seed equals the bf16 one initialised from it, then quantized."""
    g = dict(generator=generator)
    for mod in network.modules():
        if isinstance(mod, LoraDense):
            if mod.bits:
                weight = torch.empty((mod.out_features, mod.in_features), dtype=mod.param_dtype,
                                     device=mod.weight_q.device).normal_(0.0, 0.02, **g)
                mod.quantize_(mod.bits, mod.group, mod.act_quant, weight=weight)
            else:
                mod.weight.normal_(0.0, 0.02, **g)
            if mod.scale:
                limit = math.sqrt(6.0 / mod.lora_a.shape[1])
                mod.lora_a.uniform_(-limit, limit, **g)
                mod.lora_b.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, **g)
        elif isinstance(mod, nn.Conv2d):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight[0].numel()), **g)
            mod.bias.zero_()
        elif isinstance(mod, ConvNeXtBlock):
            mod.gamma.fill_(mod.layer_scale_init)
        elif isinstance(mod, nn.Linear):
            if mod is network.llm.lm_head:
                mod.weight.normal_(0.0, 0.02, **g)
            else:
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), **g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, BatchNormInference)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNormInference):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
    network.visual_prompter.object_orientation_feat.zero_()


class MSR3D:
    """Host wrapper with the reference's model contract:
    ``forward(data_dict) → data_dict['loss']`` and ``generate(data_dict) →
    data_dict['output_tokens']`` (and ``'output_text'``), beam search by
    default (``num_beams`` 5, repetition penalty 3.0: the reference's eval
    decode)."""

    def __init__(
        self,
        network_cfg: MSR3DNetworkConfig,
        tokenizer: Optional[BaseTokenizer] = None,
        *,
        scene_token_len: int = 60,
        image_token_len: int = 1,
        max_context_len: int = 256,  # stored; prompts are not truncated to it (as in JAX)
        max_out_len: int = 256,
        num_beams: int = 5,
        repetition_penalty: float = 3.0,
        length_penalty: float = 1.0,
        beam_ancestry: bool = True,  # generated KV read through an ancestry
        # map, no per-step reorder of it; False reorders it (index_select)
        eos_logit_bias: float = 0.0,  # additive on the EOS logit, greedy and beam
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
        trainable = set(self.trainable_parameter_names())
        for name, param in self.network.named_parameters():
            param.requires_grad_(name in trainable)
        self.scene_token_len = scene_token_len
        self.image_token_len = image_token_len
        self.max_context_len = max_context_len
        self.max_out_len = max_out_len
        self.num_beams = num_beams
        self.repetition_penalty = repetition_penalty
        self.length_penalty = length_penalty
        self.beam_ancestry = bool(beam_ancestry)
        self.eos_logit_bias = eos_logit_bias
        self._seed = seed

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
    def quantize_llm(self, bits: int = 8, group: Optional[int] = None, *,
                     act_quantize: bool = False, kv_quantize: bool = False) -> None:
        """Quantize the LLM's base projections of an initialised or loaded
        bf16/fp32 model in place, on its device, through
        ``models/llm/convert.py::quantize_kernel`` (each projection's weight
        is freed as its quantized form lands, so the peak is one projection
        above the quantized model), and switch the config to the quantized
        serving options."""
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

    def _scene_batch(self, data_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The scene inputs on the model's device and, where the request
        carries them, ``images`` (B, M, H, W, 3) and ``image_masks`` (B, M):
        the MSR3D ``msr3d_imgs`` with ``msr3d_img_masks``, or else the LEO
        single view ``img_fts`` (B, H, W, 3) as M = 1 with ``img_masks``
        (ones when absent)."""
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
        bools = ("obj_masks", "image_masks")
        return {k: torch.as_tensor(v, device=self.device).to(
                    torch.bool if k in bools else torch.float32)
                for k, v in batch.items()}

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

    @torch.no_grad()
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
        ``output_tokens`` (B, max_new) and ``output_text``."""
        beams = self.num_beams if use_beam is None else (self.num_beams if use_beam else 1)
        self.network.eval()  # no dropout, also right after training steps
        input_ids, attn = self._encode_prompts(self.build_text_prompt(data_dict))
        input_ids, attn = self._pad_to_bucket(input_ids, attn, side="left")
        scene = self._scene_batch(data_dict)
        max_new = max_new_tokens or self.max_out_len
        eos_id = self.tokenizer.eos_id

        first, prompt_kv, prompt_mask, next_pos = self.network.prefill(
            torch.as_tensor(input_ids, dtype=torch.long, device=self.device),
            torch.as_tensor(attn, dtype=torch.int32, device=self.device),
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
        else:
            tokens = greedy_decode_shared(decode_shared, next_pos, first, gen_kv, **common)
        data_dict["output_tokens"] = tokens.cpu().numpy()
        data_dict["output_text"] = self.batch_detokenize(data_dict["output_tokens"])
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
