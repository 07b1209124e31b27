"""Llama (Vicuna-7B family) with LoRA adapters, for training and generation.

Counterpart of ``msr3d_tpu/models/llm/llama.py`` on the LoRA training,
greedy and beam serving paths: RMSNorm (fp32 inside), rotary embeddings in
the HF half-split layout, LoRA projections (with LoRA dropout) over a
bf16/fp32 or weight-only quantized base, SwiGLU MLP, the training forward
(``LlamaModel.forward``), a prefill that captures each layer's rope'd k/v,
and the split-cache decode steps (a prompt KV segment at batch B shared by
the K beams of each row plus a generated segment at batch B·K, T = 1),
the generated segment read directly or through a beam ancestry map. With
``flash_attention`` the training forward runs through the autograd
Function of kernels K2f, K2dq and K2dkv, and the prefill through K2f;
otherwise, and in decode, attention is dense with a -1e30 additive bias, as
in the JAX package.

Quantized serving (``quantize``, ``act_quantize``, ``kv_quantize``) is
plain PyTorch on every device, as the JAX package computes it in XLA
outside any Pallas kernel, in the same rounding order (see ``LoraDense``).
Kernels K3 and K4 (``ops/w8_matmul.py``, ``ops/w4_matmul.py``) are not
called here: the JAX package does not call its own either.

The base LLM is frozen as in the JAX package (``stop_gradient``): the
embeddings, RMSNorm scales, base projection weights and ``lm_head`` are
created with ``requires_grad=False`` (quantized weights are buffers); only
the LoRA A/B matrices train.

Not ported yet (raise): sequence parallelism, activation checkpointing.
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
    # weight-only quantized base (serving): int8 per output channel, or int4
    # split-nibble packed with per-channel or ``quantize_group`` scales along
    # the input dim; ``act_quantize`` adds per-token int8 activations (s8×s8)
    quantize: bool = False
    quantize_bits: int = 8
    quantize_group: Optional[int] = None
    act_quantize: bool = False
    kv_quantize: bool = False  # int8 KV cache with a per-(position, head) bf16 scale
    # JAX-package options this port does not run yet; setting one raises
    sp_axis: Optional[str] = None
    remat: bool = False

    def __post_init__(self):
        unported = [f for f in ("sp_axis", "remat") if getattr(self, f)]
        if unported:
            raise NotImplementedError(
                f"LlamaConfig options {unported} are not ported yet (see ROADMAP.md)"
            )
        if self.act_quantize and not self.quantize:
            raise ValueError(
                "act_quantize (s8×s8) requires quantize=True — without the "
                "int8 base it would silently run the plain bf16 path"
            )
        if self.quantize_bits not in (4, 8):
            raise ValueError("quantize_bits must be 4 or 8")
        if self.quantize_group is not None:
            if self.quantize_bits != 4:
                raise ValueError("quantize_group is an int4-only knob")
            if self.act_quantize:
                raise ValueError(
                    "quantize_group + act_quantize unsupported: group "
                    "scales do not commute out of the s8×s8 dot"
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
    ``y = base(x) + (α/r)·(dropout(x)·Aᵀ)·Bᵀ``, all in the compute dtype.
    LoRA A is (r, in), B is (out, r), fp32. LoRA dropout is active only in
    ``train()`` mode.

    The base is one of (``bits``):

    * 0: ``weight`` (out, in) in torch's layout, ``base(x) = x·Wᵀ``;
    * 8: buffers ``weight_q`` int8 (in, out) and ``weight_scale`` fp32
      (out,), the JAX package's ``kernel_q``/``kernel_scale`` layout (the
      layout kernel K3 takes). ``base(x) = x @ (bf16(q) · bf16(s))``: the
      weight is dequantized and rounded to the compute dtype before the
      product;
    * 4: ``weight_q`` int8 (in/2, out), split-nibble packed (low nibbles
      input rows [0, in/2), high nibbles [in/2, in), both two's
      complement), and ``weight_scale`` fp32 (out,) or (in/G, out) with
      ``group`` G. Per channel: ``(x_lo @ lo + x_hi @ hi) · s``, the scale
      on the sum of the two half-products in the compute dtype; by group:
      each half's weights scaled per group, then the two products summed.

    With ``act_quant`` (s8×s8, per-channel scales only) x is quantized per
    token by absmax/127, the product is exact in int32 and rescaled in
    fp32. The scale is kept as loaded (fp32, or a bf16 value) and rounded to
    the compute dtype inside the forward, as the JAX module does.
    """

    def __init__(self, in_features: int, out_features: int, cfg: LlamaConfig,
                 use_lora: bool, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = cfg.dtype
        self.param_dtype = cfg.param_dtype
        self.bits, self.group, self.act_quant = 0, None, False
        if cfg.quantize:
            self._quantized_buffers(cfg.quantize_bits, cfg.quantize_group, cfg.act_quantize,
                                    device)
        else:
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

    def _quantized_buffers(self, bits: int, group: Optional[int], act_quant: bool,
                           device) -> None:
        n_in, n_out = self.in_features, self.out_features
        if bits == 4:
            if n_in % 2 or (group and (n_in // 2) % group):
                raise ValueError(
                    f"int4 packing needs an even input dim and a group dividing its half, "
                    f"got in={n_in}, group={group}"
                )
            rows, scale_shape = n_in // 2, ((n_in // group, n_out) if group else (n_out,))
        else:
            rows, scale_shape = n_in, (n_out,)
        self.bits, self.group, self.act_quant = bits, group, act_quant
        self.register_buffer("weight_q", torch.empty(rows, n_out, dtype=torch.int8,
                                                     device=device))
        self.register_buffer("weight_scale", torch.empty(scale_shape, dtype=torch.float32,
                                                         device=device))

    @torch.no_grad()
    def quantize_(self, bits: int, group: Optional[int] = None, act_quant: bool = False,
                  weight: Optional[torch.Tensor] = None) -> None:
        """Replace the bf16/fp32 base by its quantized form, in place, through
        :func:`msr3d_tpu_torch.models.llm.convert.quantize_kernel` on the
        weight's device. ``weight`` (out, in) overrides the module's own (the
        initialiser of a quantized module passes the weight it drew)."""
        from msr3d_tpu_torch.models.llm.convert import quantize_kernel

        if weight is None:
            if self.bits:
                raise ValueError("LoraDense.quantize_: the base is quantized already")
            weight = self.weight
            del self.weight
        q, s = quantize_kernel(weight.t(), bits, group)
        del weight
        if not self.bits:
            self._quantized_buffers(bits, group, act_quant, q.device)
        self.weight_q.copy_(q)
        self.weight_scale.copy_(s)

    def _act_quant(self, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-token absmax int8 quantization of x (rows, in): the max stays
        in x's dtype (as ``jnp.maximum`` of a bf16 amax does), the divide is
        fp32."""
        amax = x2.abs().amax(dim=-1, keepdim=True)
        x_scale = torch.clamp_min(amax, 1e-6).float() / 127.0
        xq = torch.clamp(torch.round(x2.float() / x_scale), -127, 127).to(torch.int8)
        return xq, x_scale

    def _unpack(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sign-extending nibble unpack (int8 arithmetic shifts) → (lo, hi)."""
        return (self.weight_q << 4) >> 4, self.weight_q >> 4

    def base_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The frozen base's output, without LoRA."""
        if not self.bits:
            return F.linear(x, self.weight.to(self.dtype))
        half = self.in_features // 2
        if self.act_quant:
            lead = x.shape[:-1]
            xq, x_scale = self._act_quant(x.reshape(-1, self.in_features))
            if self.bits == 4:
                lo, hi = self._unpack()
                y32 = int8_matmul(xq[:, :half], lo) + int8_matmul(xq[:, half:], hi)
            else:
                y32 = int8_matmul(xq, self.weight_q)
            y = (y32.float() * x_scale * self.weight_scale.float()[None, :]).to(self.dtype)
            return y.reshape(*lead, self.out_features)
        if self.bits == 8:
            return x @ (self.weight_q.to(self.dtype) * self.weight_scale.to(self.dtype))
        lo, hi = self._unpack()
        x_lo, x_hi = x[..., :half], x[..., half:]
        if self.group:
            g, n_g = self.group, half // self.group
            gs = self.weight_scale.to(self.dtype)
            k_lo = (lo.to(self.dtype).reshape(n_g, g, -1) * gs[:n_g, None, :]).reshape(half, -1)
            k_hi = (hi.to(self.dtype).reshape(n_g, g, -1) * gs[n_g:, None, :]).reshape(half, -1)
            return x_lo @ k_lo + x_hi @ k_hi
        return (x_lo @ lo.to(self.dtype) + x_hi @ hi.to(self.dtype)) * self.weight_scale.to(
            self.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.base_forward(x)
        if self.scale:
            h = dropout(x, self.lora_dropout, self.training, generator)
            y = y + F.linear(
                F.linear(h, self.lora_a.to(self.dtype)), self.lora_b.to(self.dtype)
            ) * self.scale
        return y


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int8 → int32 product (rows, K) @ (K, N). On the CPU as
    int32 operands (an int8 ``torch.mm`` returns int8 and overflows); on
    the card through ``torch._int_mm``, which takes more than 16 rows and K,
    N multiples of 8, so the rows are padded with zeros (the JAX package
    leaves this product to XLA, outside any Pallas kernel)."""
    if xq.device.type != "cuda":
        return torch.mm(xq.to(torch.int32), wq.to(torch.int32))
    rows = xq.shape[0]
    padded = max(24, -(-rows // 8) * 8)
    if padded != rows:
        xq = F.pad(xq, (0, 0, 0, padded - rows))
    return torch._int_mm(xq, wq)[:rows]


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

    def decode_shared(self, x, positions, attn_bias, prompt: Dict[str, torch.Tensor],
                      gen: Dict[str, torch.Tensor], gen_index: int,
                      anc_rows: Optional[torch.Tensor] = None):
        """One decode token over a split cache: the prompt segment (k/v of
        (B', S_p, hkv, D)), shared by blocks of B / B' consecutive queries
        (the beams of one request), and the generated segment (B, S_g, hkv,
        D), into which this token's k/v are written in place at
        ``gen_index``. ``attn_bias`` (B, 1, 1, S_p + S_g) masks both
        segments.

        With ``anc_rows`` (B·S_g,) (beam ancestry) query r reads slot s of
        the generated segment from the flat (row, slot) entry
        ``anc_rows[r·S_g + s]``: the segment is gathered into each query's
        own history after the write, a layer at a time, and attended as
        rows are.

        An int8 segment carries ``k_scale``/``v_scale`` (B, S, hkv) bf16 and
        is read without a dequantized copy (``llama.py:592-714`` of the JAX
        package): the scores are ``fp32(q·bf16(kq)) · scale · k_scale``, the
        softmax weights times ``v_scale`` in fp32, cast to the compute dtype
        before the product with bf16(vq)."""
        q, k, v = self._qkv(x, positions)
        _cache_write(gen, k, v, gen_index)
        if anc_rows is not None:
            gen = {key: val.flatten(0, 1).index_select(0, anc_rows).view(val.shape)
                   for key, val in gen.items()}
        segments = (prompt, gen)
        weights = torch.softmax(
            torch.cat([self._seg_scores(q, seg) for seg in segments], dim=-1) + attn_bias,
            dim=-1)
        out, start = 0, 0
        for seg in segments:
            width = seg["k"].shape[1]
            out = out + self._seg_out(weights[..., start:start + width], seg)
            start += width
        return self._out(out)

    def _seg_scores(self, q: torch.Tensor, seg: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Scores (B, H, T, S) of the queries against a (B', S, hkv, D)
        segment shared by blocks of B / B' consecutive queries."""
        b, t, h, d = q.shape
        k_seg = self._rep(seg["k"].to(self.cfg.dtype))
        bp = k_seg.shape[0]
        logits = torch.einsum("bkhd,bshd->bkhs", q.reshape(bp, b // bp * t, h, d), k_seg)
        logits = logits.float() * _attn_scale(self.cfg.head_dim, q.device)
        if "k_scale" in seg:
            logits = logits * self._seg_scale(seg["k_scale"])
        return logits.reshape(b, t, h, -1).transpose(1, 2)

    def _seg_out(self, weights: torch.Tensor, seg: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, H, T, S) softmax weights times a (B', S, hkv, D) segment's
        values → (B, T, H, D)."""
        b, h, t, _ = weights.shape
        v_seg = self._rep(seg["v"].to(self.cfg.dtype))
        bp = v_seg.shape[0]
        w = weights.transpose(1, 2).reshape(bp, b // bp * t, h, -1)
        if "v_scale" in seg:
            w = w * self._seg_scale(seg["v_scale"])
        return torch.einsum("bkhs,bshd->bkhd", w.to(self.cfg.dtype), v_seg).reshape(b, t, h, -1)

    def _seg_scale(self, scale: torch.Tensor) -> torch.Tensor:
        """A (B', S, hkv) cache scale → (B', 1, H, S) fp32 against the scores."""
        return self._rep(scale[..., None])[..., 0].float().transpose(1, 2)[:, None]


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

    def decode_shared(self, x, positions, attn_bias, prompt, gen, gen_index, anc_rows=None):
        h = self.attn.decode_shared(self.input_norm(x), positions, attn_bias, prompt, gen,
                                    gen_index, anc_rows)
        return self._mlp_residual(x + h)


def _make_cache(cfg: LlamaConfig, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """An empty cache, k/v (L, B, max_len, hkv, D) zeros in the compute
    dtype, or with ``kv_quantize`` the int8 layout of the zeros: values 0
    and every scale bf16(1e-6 / 127), as ``quantize_kv_cache`` gives them."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    if cfg.kv_quantize:
        zero_scale = (torch.tensor(1e-6, dtype=torch.float32) / 127.0).to(torch.bfloat16)
        cache = {key: torch.zeros(shape, dtype=torch.int8, device=device) for key in ("k", "v")}
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.full(shape[:-1], zero_scale.item(), dtype=torch.bfloat16,
                                    device=device)
        return cache
    return {key: torch.zeros(shape, dtype=cfg.dtype, device=device) for key in ("k", "v")}


def _quantize_kv(arr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., h, d) → (int8 values, per-(..., h) bf16 scale): absmax / 127
    over the head dim, the scale rounded to bf16 BEFORE the fp32 divide, so
    that quantization and dequantization use the same value."""
    amax = arr.float().abs().amax(dim=-1)
    scale = (torch.clamp_min(amax, 1e-6) / 127.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(arr.float() / scale.float()[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv_cache(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{"k", "v"} → the int8 layout {"k", "v", "k_scale", "v_scale"}."""
    kq, ks = _quantize_kv(cache["k"])
    vq, vs = _quantize_kv(cache["v"])
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _cache_write(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                 index: int) -> None:
    """Write one token's k/v (B, 1, hkv, D) at slot ``index`` of a (B, S,
    hkv, D) cache, in place; into an int8 cache quantized, with its scales
    (the scalar-index path of the JAX ``_cache_write``)."""
    if "k_scale" in cache:
        new = quantize_kv_cache({"k": k, "v": v})
    else:
        new = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    for key, val in new.items():
        cache[key][:, index] = val[:, 0]


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
        padding: cumsum(mask) - 1. With ``kv_quantize`` each layer's k/v are
        quantized before padding and the cache also holds ``k_scale`` and
        ``v_scale`` (L, B, max_cache_len, hkv); padding slots are 0, scales
        included."""
        cfg = self.cfg
        b, t, _ = inputs_embeds.shape
        if t > max_cache_len:
            raise ValueError(f"prompt length {t} exceeds max_cache_len {max_cache_len}")
        mask = attention_mask.bool()
        positions = self._positions(attention_mask)
        attn_bias, key_valid = self._attention_masks(attention_mask)

        x = inputs_embeds.to(cfg.dtype)
        pad = max_cache_len - t
        layers: List[Dict[str, torch.Tensor]] = []
        for block in self.layer:
            x, k, v = block.prefill(x, positions, attn_bias, key_valid)
            layer = {"k": k, "v": v}
            if cfg.kv_quantize:
                layer = quantize_kv_cache(layer)
            # zero-pad the sequence axis (1): values and, int8, scales alike
            layers.append({key: F.pad(val, (0, 0) * (val.dim() - 2) + (0, pad))
                           for key, val in layer.items()})
        x = self.final_norm(x)
        logits = self.logits(x[:, -1:] if logits_last_only else x)
        caches = {key: torch.stack([layer[key] for layer in layers]) for key in layers[0]}
        cache_mask = F.pad(mask, (0, pad))
        return logits, x, caches, cache_mask, positions[:, -1] + 1

    def _attn_bias(self, inputs_embeds, prompt_kv, prompt_mask, gen_mask) -> torch.Tensor:
        """The (B·K, 1, 1, S_p + S_g) additive bias of a decode step: the
        prompt's (B, S_p) mask repeated for the K queries of each prompt row,
        then the generated segment's (B·K, S_g) mask. Raises on what is not
        ported: a tuple of prompt segments or a per-query prompt mask (the
        prefix-pool serving engines) and windows of T > 1 (speculative and
        grouped-scene decoding)."""
        if isinstance(prompt_kv, (list, tuple)):
            raise NotImplementedError(
                "a tuple-of-segments prompt_kv (the prefix-pool serving engines) is not "
                "ported yet (see ROADMAP.md)")
        bk, t, _ = inputs_embeds.shape
        b = prompt_kv["k"].shape[1]
        if t != 1:
            raise NotImplementedError(
                "decode windows of T > 1 (speculative and grouped-scene decoding) are not "
                "ported yet (see ROADMAP.md)")
        if prompt_mask.shape[0] != b or bk % b:
            raise NotImplementedError(
                f"a prompt mask of batch {prompt_mask.shape[0]} for a prompt cache of batch "
                f"{b} and {bk} queries: per-query prompt masks (the prefix-pool serving "
                "engines) are not ported yet (see ROADMAP.md)")
        prompt_bias = _bias(prompt_mask.bool().repeat_interleave(bk // b, dim=0))
        return torch.cat([prompt_bias, _bias(gen_mask.bool())], dim=-1)[:, None, None, :]

    def _decode_layers(self, inputs_embeds, positions, attn_bias, prompt_kv, gen_kv,
                       gen_index, anc_rows=None) -> torch.Tensor:
        x = inputs_embeds.to(self.cfg.dtype)
        for i, block in enumerate(self.layer):
            x = block.decode_shared(
                x, positions, attn_bias, {key: val[i] for key, val in prompt_kv.items()},
                {key: val[i] for key, val in gen_kv.items()}, gen_index, anc_rows,
            )
        return self.logits(self.final_norm(x))

    def decode_step_shared(
        self,
        inputs_embeds: torch.Tensor,  # (B·K, 1, H)
        positions: torch.Tensor,  # (B·K, 1)
        prompt_kv: Dict[str, torch.Tensor],  # k/v (L, B, S_p, hkv, D) [+ scales], read-only
        prompt_mask: torch.Tensor,  # (B, S_p)
        gen_kv: Dict[str, torch.Tensor],  # k/v (L, B·K, S_g, hkv, D) [+ scales], written in place
        gen_index: int,
        gen_mask: torch.Tensor,  # (B·K, S_g), including the slot written now
    ) -> torch.Tensor:
        """One decode step over the split cache → logits (B·K, 1, V): the
        prompt segment at batch B, shared by the K beams of each row (K = 1
        greedy), and the generated segment at batch B·K, updated in place
        (the JAX loop carries it functionally)."""
        return self._decode_layers(inputs_embeds, positions,
                                   self._attn_bias(inputs_embeds, prompt_kv, prompt_mask, gen_mask),
                                   prompt_kv, gen_kv, gen_index)

    def decode_step_beam_anc(
        self,
        inputs_embeds: torch.Tensor,  # (B·K, 1, H)
        positions: torch.Tensor,  # (B·K, 1)
        prompt_kv: Dict[str, torch.Tensor],  # k/v (L, B, S_p, hkv, D) [+ scales], read-only
        prompt_mask: torch.Tensor,  # (B, S_p)
        gen_kv: Dict[str, torch.Tensor],  # k/v (L, B·K, S_g, hkv, D) [+ scales], written in place
        gen_index: int,
        gen_mask: torch.Tensor,  # (B·K, S_g) valid generated slots
        anc: torch.Tensor,  # (B·K, S_g) int32, the ancestor row within the K block
        num_beams: int,
    ) -> torch.Tensor:
        """One beam step whose generated rows never reorder → logits (B·K,
        1, V). ``anc[r, s]`` names the row of query r's K block that wrote
        r's history at slot s; the step's own k/v land in row r itself.

        The JAX package attends over all K rows' slots of a block as one
        (K·S_g) pair segment with a bias that admits the pairs on the path.
        That sums the same terms in another order than the reordered cache
        does, and in bf16 the two ways' tokens part (the flagship on an
        H100, PERF.md §6, PR 11). Here each layer gathers every query's
        history into a row after the step's write, and attends over it as
        the reordered cache is attended: the same arithmetic, so the same
        tokens, without moving the cache's rows (a layer's gathered copy is
        the only extra memory)."""
        bk, s_g = gen_mask.shape
        block = torch.arange(bk, device=anc.device)[:, None] // num_beams * num_beams
        slots = torch.arange(s_g, device=anc.device)[None, :]
        anc_rows = ((block + anc.long()) * s_g + slots).reshape(-1)
        return self._decode_layers(inputs_embeds, positions,
                                   self._attn_bias(inputs_embeds, prompt_kv, prompt_mask, gen_mask),
                                   prompt_kv, gen_kv, gen_index, anc_rows)
