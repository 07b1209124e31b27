"""Llama (Vicuna-7B family) with LoRA adapters, for training and generation.

Counterpart of ``msr3d_tpu/models/llm/llama.py`` on the LoRA training and
greedy serving paths: RMSNorm (fp32 inside), rotary embeddings in the HF
half-split layout, unquantized LoRA projections (with LoRA dropout),
SwiGLU MLP, the training forward (``LlamaModel.forward``), a prefill that
captures each layer's rope'd k/v, and the split-cache decode step (a prompt
KV segment plus a generated segment, T = 1). With ``flash_attention`` the
training forward runs through the autograd Function of kernels K2f, K2dq
and K2dkv, and the prefill through K2f; otherwise, and in decode, attention
is dense with a -1e30 additive bias, as in the JAX package.

The base LLM is frozen as in the JAX package (``stop_gradient``): the
embeddings, RMSNorm scales, base projection weights and ``lm_head`` are
created with ``requires_grad=False``; only the LoRA A/B matrices train.

Not ported yet (raise): int8/int4 weights, the int8 KV cache, sequence
parallelism, activation checkpointing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.nn.layers import dropout
from msr3d_tpu_torch.ops.flash_attention import flash_attention, flash_attention_train

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None → MHA (Vicuna-7B)
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    lora_rank: int = 0  # 0 → no LoRA
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    lora_targets: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    )
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32  # storage of the frozen base
    flash_attention: bool = False  # training/prefill attention through K2f (+ K2dq, K2dkv)
    # JAX-package options this port does not run yet; setting one raises
    quantize: bool = False
    kv_quantize: bool = False
    sp_axis: Optional[str] = None
    remat: bool = False

    def __post_init__(self):
        unported = [f for f in ("quantize", "kv_quantize", "sp_axis", "remat")
                    if getattr(self, f)]
        if unported:
            raise NotImplementedError(
                f"LlamaConfig options {unported} are not ported yet (see ROADMAP.md)"
            )

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Small config for tests."""
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
        )
        base.update(kw)
        return LlamaConfig(**base)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, param_dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype, device=device),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight).to(self.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D), positions (B, T) → rotated x, fp32 inside."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].float() * freqs  # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LoraDense(nn.Module):
    """Frozen base projection plus a LoRA delta, PEFT semantics:
    ``y = x·Wᵀ + (α/r)·(dropout(x)·Aᵀ)·Bᵀ``, all in the compute dtype.
    Weights are torch-layout (out, in); LoRA A is (r, in), B is (out, r),
    fp32. LoRA dropout is active only in ``train()`` mode."""

    def __init__(self, in_features: int, out_features: int, cfg: LlamaConfig,
                 use_lora: bool, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, dtype=cfg.param_dtype, device=device),
            requires_grad=False,
        )
        self.scale = 0.0
        self.lora_dropout = cfg.lora_dropout
        if use_lora:
            r = cfg.lora_rank
            self.lora_a = nn.Parameter(torch.empty(r, in_features, device=device))
            self.lora_b = nn.Parameter(torch.empty(out_features, r, device=device))
            self.scale = cfg.lora_alpha / r

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.linear(x, self.weight.to(self.dtype))
        if self.scale:
            h = dropout(x, self.lora_dropout, self.training, generator)
            y = y + F.linear(
                F.linear(h, self.lora_a.to(self.dtype)), self.lora_b.to(self.dtype)
            ) * self.scale
        return y


def _proj(cfg: LlamaConfig, name: str, n_in: int, n_out: int, device) -> LoraDense:
    return LoraDense(n_in, n_out, cfg, cfg.lora_rank > 0 and name in cfg.lora_targets, device)


def _attn_scale(head_dim: int, device) -> torch.Tensor:
    # 1 / sqrt(D) rounded as the JAX dense path rounds it (fp32 sqrt, fp32 divide)
    return 1.0 / torch.sqrt(torch.tensor(float(head_dim), device=device))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = _proj(cfg, "q_proj", h, cfg.num_attention_heads * hd, device)
        self.k_proj = _proj(cfg, "k_proj", h, cfg.kv_heads * hd, device)
        self.v_proj = _proj(cfg, "v_proj", h, cfg.kv_heads * hd, device)
        self.o_proj = _proj(cfg, "o_proj", cfg.num_attention_heads * hd, h, device)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor, generator=None):
        cfg = self.cfg
        b, t, _ = x.shape
        q = self.q_proj(x, generator).view(b, t, cfg.num_attention_heads, cfg.head_dim)
        k = self.k_proj(x, generator).view(b, t, cfg.kv_heads, cfg.head_dim)
        v = self.v_proj(x, generator).view(b, t, cfg.kv_heads, cfg.head_dim)
        return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v

    def _rep(self, x: torch.Tensor) -> torch.Tensor:
        n_rep = self.cfg.num_attention_heads // self.cfg.kv_heads
        return x.repeat_interleave(n_rep, dim=2) if n_rep > 1 else x

    def _out(self, out: torch.Tensor, generator=None) -> torch.Tensor:
        b, t = out.shape[:2]
        return self.o_proj(out.reshape(b, t, -1), generator)

    def _dense(self, q, k, v, attn_bias: torch.Tensor) -> torch.Tensor:
        """Dense attention with the (B, 1, T, S) additive bias; the scores
        are rounded to the compute dtype before the fp32 softmax, as the
        JAX dense route does."""
        scale = _attn_scale(self.cfg.head_dim, q.device)
        logits = torch.einsum("bthd,bshd->bhts", q, self._rep(k)).float() * scale
        weights = torch.softmax(logits + attn_bias, dim=-1)
        return torch.einsum("bhts,bshd->bthd", weights.to(self.cfg.dtype), self._rep(v))

    def forward(self, x, positions, attn_bias: Optional[torch.Tensor],
                key_valid: Optional[torch.Tensor], generator=None) -> torch.Tensor:
        """Training attention. ``attn_bias`` None → the flash autograd
        Function (K2f forward, K2dq/K2dkv backward) with causality and
        ``key_valid`` applied inside; else dense with the additive bias."""
        q, k, v = self._qkv(x, positions, generator)
        if attn_bias is None:
            out = flash_attention_train(q, k, v, key_valid=key_valid)
        else:
            out = self._dense(q, k, v, attn_bias)
        return self._out(out, generator)

    def prefill(self, x, positions, attn_bias: Optional[torch.Tensor],
                key_valid: Optional[torch.Tensor]):
        """Prompt attention. ``attn_bias`` None → kernel K2f with causality
        and ``key_valid`` applied inside; else dense with the (B, 1, T, T)
        additive bias. Returns (out, rope'd k, v) for the cache."""
        q, k, v = self._qkv(x, positions)
        if attn_bias is None:
            out, _ = flash_attention(q, k, v, key_valid=key_valid)
        else:
            out = self._dense(q, k, v, attn_bias)
        return self._out(out), k, v

    def decode_shared(self, x, positions, attn_bias, prompt_k, prompt_v, gen_k, gen_v,
                      gen_index: int):
        """One decode token over a split cache: the prompt segment (B, S_p,
        hkv, D) and the generated segment (B, S_g, hkv, D), into which this
        token's k/v are written in place at ``gen_index``. ``attn_bias``
        (B, 1, 1, S_p + S_g) masks both segments."""
        q, k, v = self._qkv(x, positions)
        gen_k[:, gen_index] = k[:, 0]
        gen_v[:, gen_index] = v[:, 0]
        scale = _attn_scale(self.cfg.head_dim, x.device)
        lp = torch.einsum("bthd,bshd->bhts", q, self._rep(prompt_k)).float() * scale
        lg = torch.einsum("bthd,bshd->bhts", q, self._rep(gen_k)).float() * scale
        weights = torch.softmax(torch.cat([lp, lg], dim=-1) + attn_bias, dim=-1)
        weights = weights.to(self.cfg.dtype)
        s_p = prompt_k.shape[1]
        out = torch.einsum("bhts,bshd->bthd", weights[..., :s_p], self._rep(prompt_v))
        out = out + torch.einsum("bhts,bshd->bthd", weights[..., s_p:], self._rep(gen_v))
        return self._out(out)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _proj(cfg, "gate_proj", h, m, device)
        self.up_proj = _proj(cfg, "up_proj", h, m, device)
        self.down_proj = _proj(cfg, "down_proj", m, h, device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = F.silu(self.gate_proj(x, generator)) * self.up_proj(x, generator)
        return self.down_proj(h, generator)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        norm = dict(eps=cfg.rms_norm_eps, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                    device=device)
        self.input_norm = RMSNorm(cfg.hidden_size, **norm)
        self.attn = LlamaAttention(cfg, device)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, **norm)
        self.mlp = LlamaMLP(cfg, device)

    def _mlp_residual(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return x + self.mlp(self.post_attn_norm(x), generator)

    def forward(self, x, positions, attn_bias, key_valid, generator=None):
        h = self.attn(self.input_norm(x), positions, attn_bias, key_valid, generator)
        return self._mlp_residual(x + h, generator)

    def prefill(self, x, positions, attn_bias, key_valid):
        h, k, v = self.attn.prefill(self.input_norm(x), positions, attn_bias, key_valid)
        return self._mlp_residual(x + h), k, v

    def decode_shared(self, x, positions, attn_bias, prompt_k, prompt_v, gen_k, gen_v,
                      gen_index):
        h = self.attn.decode_shared(self.input_norm(x), positions, attn_bias, prompt_k,
                                    prompt_v, gen_k, gen_v, gen_index)
        return self._mlp_residual(x + h)


def _make_cache(cfg: LlamaConfig, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _bias(valid: torch.Tensor) -> torch.Tensor:
    """bool mask → fp32 additive bias (0 where valid, -1e30 elsewhere)."""
    return torch.zeros(valid.shape, dtype=torch.float32, device=valid.device).masked_fill(
        ~valid, _NEG_INF
    )


class LlamaModel(nn.Module):
    """Decoder-only Llama driven by ``inputs_embeds`` (the MSR3D model
    splices scene embeddings between the token embeddings)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size,
            _weight=torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype,
                                device=device),
        )
        self.embed_tokens.weight.requires_grad_(False)
        self.layer = nn.ModuleList(LlamaBlock(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                                  cfg.param_dtype, device)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype, device=device)
        self.lm_head.weight.requires_grad_(False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.cfg.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.linear(hidden, self.lm_head.weight.to(self.cfg.dtype))

    def _positions(self, attention_mask: torch.Tensor) -> torch.Tensor:
        """HF left-padding positions: cumsum(mask) - 1, floored at 0."""
        return (torch.cumsum(attention_mask.long(), dim=1) - 1).clamp(min=0)

    def _attention_masks(self, attention_mask: torch.Tensor):
        """(attn_bias, key_valid) of a causal pass over the whole sequence:
        the flash kernels take the key mask and apply causality themselves;
        the dense route takes the (B, 1, T, T) additive bias."""
        mask = attention_mask.bool()
        if self.cfg.flash_attention:
            return None, mask
        t = mask.shape[1]
        causal = torch.ones((t, t), dtype=torch.bool, device=mask.device).tril()
        return _bias(causal[None, None] & mask[:, None, None, :]), None

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # (B, T, H)
        attention_mask: torch.Tensor,  # (B, T) 1 = attend
        *,
        answer_start: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Training forward → logits (B, T, V). ``answer_start`` computes
        logits only for positions ``answer_start-1 .. T-2``, the
        answer-predicting window (every target before it is -100).
        ``generator`` feeds LoRA dropout in ``train()`` mode."""
        positions = self._positions(attention_mask)
        attn_bias, key_valid = self._attention_masks(attention_mask)
        x = inputs_embeds.to(self.cfg.dtype)
        for block in self.layer:
            x = block(x, positions, attn_bias, key_valid, generator)
        x = self.final_norm(x)
        return self.logits(x if answer_start is None else x[:, answer_start - 1:-1])

    def prefill_with_cache(
        self,
        inputs_embeds: torch.Tensor,  # (B, T, H)
        attention_mask: torch.Tensor,  # (B, T) 1 = attend
        max_cache_len: int,
        *,
        logits_last_only: bool = False,
    ):
        """Prefill and capture the KV cache. Returns (logits, hidden,
        {"k","v"}: (L, B, max_cache_len, hkv, D), cache_mask (B,
        max_cache_len), next_positions (B,)). Positions follow HF left
        padding: cumsum(mask) - 1."""
        cfg = self.cfg
        b, t, _ = inputs_embeds.shape
        if t > max_cache_len:
            raise ValueError(f"prompt length {t} exceeds max_cache_len {max_cache_len}")
        mask = attention_mask.bool()
        positions = self._positions(attention_mask)
        attn_bias, key_valid = self._attention_masks(attention_mask)

        x = inputs_embeds.to(cfg.dtype)
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for block in self.layer:
            x, k, v = block.prefill(x, positions, attn_bias, key_valid)
            ks.append(k)
            vs.append(v)
        x = self.final_norm(x)
        logits = self.logits(x[:, -1:] if logits_last_only else x)
        pad = max_cache_len - t
        caches = {
            name: F.pad(torch.stack(seq), (0, 0, 0, 0, 0, pad))
            for name, seq in (("k", ks), ("v", vs))
        }
        cache_mask = F.pad(mask, (0, pad))
        return logits, x, caches, cache_mask, positions[:, -1] + 1

    def decode_step_shared(
        self,
        inputs_embeds: torch.Tensor,  # (B, 1, H)
        positions: torch.Tensor,  # (B, 1)
        prompt_kv: Dict[str, torch.Tensor],  # k/v (L, B, S_p, hkv, D), read-only
        prompt_mask: torch.Tensor,  # (B, S_p)
        gen_kv: Dict[str, torch.Tensor],  # k/v (L, B, S_g, hkv, D), written in place
        gen_index: int,
        gen_mask: torch.Tensor,  # (B, S_g), including the slot written now
    ) -> torch.Tensor:
        """One greedy decode step over the split cache → logits (B, 1, V).

        The generated segment is updated in place (the JAX loop carries it
        functionally); only T = 1 with prompt and query batch equal (no
        beams) is ported."""
        b, t, _ = inputs_embeds.shape
        if t != 1 or prompt_mask.shape[0] != b:
            raise NotImplementedError(
                "decode_step_shared: only T = 1 without beams is ported (see ROADMAP.md)"
            )
        attn_bias = torch.cat(
            [_bias(prompt_mask.bool()), _bias(gen_mask.bool())], dim=-1
        )[:, None, None, :]
        x = inputs_embeds.to(self.cfg.dtype)
        for i, block in enumerate(self.layer):
            x = block.decode_shared(
                x, positions, attn_bias, prompt_kv["k"][i], prompt_kv["v"][i],
                gen_kv["k"][i], gen_kv["v"][i], gen_index,
            )
        return self.logits(self.final_norm(x))
