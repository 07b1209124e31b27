"""Llama (Vicuna-7B family) with LoRA adapters, for training and generation.

Counterpart of ``msr3d_tpu/models/llm/llama.py`` on the LoRA training,
greedy and beam serving paths: RMSNorm (fp32 inside), rotary embeddings in
the HF half-split layout, LoRA projections (with LoRA dropout) over a
bf16/fp32 or weight-only quantized base, SwiGLU MLP, the training forward
(``LlamaModel.forward``), a prefill that captures each layer's rope'd k/v,
and the split-cache decode steps (a prompt KV segment at batch B shared by
the K beams of each row plus a generated segment at batch B·K), the
generated segment read directly or through a beam ancestry map, and written
at one slot for every row or at each row's own slot (the continuous serving
engines). A decode step takes a window of T > 1 tokens (speculative
verification, the grouped path's question suffixes): query t also sees the
window's own slots up to its own, and ``window_valid`` hides pad tokens of
the window. The prompt side may be one segment shared by blocks of queries,
a segment at batch 1 with a visibility row per query, or a tuple of such
segments (the prefix-pool engines' block pool and per-slot suffixes). With
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
the LoRA A/B matrices train. Over a quantized base (QLoRA) the product
with the dequantized weight runs, under autograd, through ``_QuantizedBase``,
which keeps the int8/int4 buffers for the backward and not the weight it
rebuilt.

``remat`` runs each block of the training forward under activation
checkpointing (``torch.utils.checkpoint``), with the JAX package's three
``remat_policy`` choices (see ``_remat_block``). Prefill and decode never
checkpoint, as JAX generates through a remat-stripped copy of the network.

Tensor parallelism (``tp_size`` > 1, this rank ``tp_rank`` of the tp group
of ``parallel/mesh.py``) is JAX's megatron layout (``parallel/sharding.py``)
with the collectives written out (``parallel/tensor_parallel.py``): q/k/v
and gate/up are column-parallel (the rank's Hq/tp and Hkv/tp heads, I/tp
columns), their input passes through ``copy_to_tp``; o and down are
row-parallel and end in one ``reduce_from_tp`` over the base and LoRA
partial sums; the embeddings are looked up vocab-parallel, the logits
computed over the rank's vocab slice and gathered. The config stays the
global one (``head_dim`` is the full model's), and the ``local_*``
properties give a rank's counts. Which tensors split is decided once, in
``parallel/sharding.py``'s ``llm_tp_dims``: a group of leaves whose dim
does not divide by tp replicates, as JAX's fallback does. The replicated
LoRA factors inside the tp region (column-parallel A, row-parallel B) get
per-rank partial gradients, which ``TrainStep`` sums over the tp group.

A quantized base under tp keeps JAX's (in, out) layout split as JAX splits
it: a row-parallel int4 rank holds its input rows repacked into its own
nibble halves. A half that holds whole groups (always so at tp = 1) is
scaled by broadcasting over its groups; one that cuts a group takes each
row's scale by its global row (2752 rows of the 7B ``down_proj``'s 5504 at
tp = 2 is 21.5 groups of 128). s8×s8 takes each token's absmax as the max over the tp
group and sums the rank's int32 partial products over it as integers, so
its output is tp = 1's bit for bit. The int8 KV cache splits with the heads.

Pipeline parallelism (``pp_size`` > 1): a stage's model holds the blocks
``stage_layers`` of the global ``num_hidden_layers`` (under their global
indices, ``layer.16`` …) beside the whole embedding, final norm and head,
and ``parallel/llm_pp.py`` drives them; the model's own forward, prefill
and decode need every block and raise on a stage.

Sequence parallelism (``sp_size`` > 1, this rank ``sp_rank`` of the sp
group of ``parallel/mesh.py``): the training forward takes this rank's
block of the sequence (the whole embeddings and mask are given; positions
are cut from the whole mask's cumsum) and its attention runs
``parallel/ring_attention.py`` over the sp group, before the flash check,
as JAX's ``sp_axis`` route does, so the step launches no K2f, K2dq or
K2dkv. Its logits cover the positions this rank holds (``sp_window``).
Prefill and decode run the whole sequence, dense or flash, as JAX's
generation never takes the ring. In ``train()`` mode under sp (the training
forward, the only train-mode path) LoRA dropout draws each input's mask for
the whole sequence and keeps the block's rows, so the masks are sp = 1's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from msr3d_tpu_torch.nn.layers import dropout
from msr3d_tpu_torch.ops.flash_attention import flash_attention, flash_attention_train
from msr3d_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp,
    gather_last_dim,
    max_over_tp,
    reduce_from_tp,
    sum_int_over_tp,
    vocab_parallel_embed,
)
from msr3d_tpu_torch.parallel.ring_attention import ring_attention, sequence_block
from msr3d_tpu_torch.parallel.sharding import Spec, llm_tp_dims

_NEG_INF = -1e30
REMAT_POLICIES = ("full", "dots", "residuals")


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
    # activation checkpointing of the training forward's blocks: "full"
    # (the block input saved), "dots" (the no-batch-dim products' outputs
    # saved too), "residuals" (the block input and the attention branch's
    # output saved, each branch recomputed from its input)
    remat: bool = False
    remat_policy: str = "full"
    # tensor parallelism: this rank's index in a tp group of tp_size ranks
    tp_size: int = 1
    tp_rank: int = 0
    # pipeline parallelism: this rank's stage of pp_size (its blocks only)
    pp_size: int = 1
    pp_rank: int = 0
    # sequence parallelism: this rank's block of a sequence split over an sp
    # group of sp_size ranks (JAX's sp_axis): the training forward's ring
    sp_size: int = 1
    sp_rank: int = 0

    def __post_init__(self):
        if not 0 <= self.sp_rank < self.sp_size:
            raise ValueError(f"sp_rank {self.sp_rank} outside an sp group of {self.sp_size}")
        if self.sp_size > 1 and self.pp_size > 1:
            raise NotImplementedError("pp × sp: the JAX package's pipeline asserts 'pp × sp "
                                      "composition not supported yet', and so does the port")
        if not 0 <= self.tp_rank < self.tp_size:
            raise ValueError(f"tp_rank {self.tp_rank} outside a tp group of {self.tp_size}")
        if not 0 <= self.pp_rank < self.pp_size:
            raise ValueError(f"pp_rank {self.pp_rank} outside a pipeline of {self.pp_size}")
        if self.num_hidden_layers % self.pp_size:
            raise ValueError(f"{self.num_hidden_layers} layers not divisible into "
                             f"pp={self.pp_size} stages")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy: {self.remat_policy!r}")
        if self.remat and self.lora_rank > 0 and self.lora_dropout > 0:
            raise ValueError(
                "remat with lora_dropout > 0: the JAX package cannot trace it (under "
                "nn.remat LoRA dropout's `deterministic` becomes a tracer, "
                "TracerBoolConversionError), so neither runs it"
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

    @property
    def stage_layers(self) -> range:
        """The global indices of this pipeline stage's blocks (all at pp = 1)."""
        k = self.num_hidden_layers // self.pp_size
        return range(self.pp_rank * k, (self.pp_rank + 1) * k)

    def _splits(self, name: str) -> bool:
        """Whether tensor ``name`` is split over tp (``llm_tp_dims``)."""
        return self.tp_size > 1 and name in llm_tp_dims(self)

    def _base(self, proj: str) -> str:
        """The name of a projection's base tensor in layer 0."""
        return f"layer.0.{proj}.{'weight_q' if self.quantize else 'weight'}"

    @property
    def tp_attn(self) -> bool:
        """q/k/v column- and o row-parallel, by whole heads."""
        return self._splits(self._base("attn.q_proj"))

    @property
    def tp_mlp(self) -> bool:
        return self._splits(self._base("mlp.gate_proj"))

    @property
    def tp_vocab(self) -> bool:
        return self._splits("embed_tokens.weight")

    @property
    def local_heads(self) -> int:
        return self.num_attention_heads // (self.tp_size if self.tp_attn else 1)

    @property
    def local_kv_heads(self) -> int:
        return self.kv_heads // (self.tp_size if self.tp_attn else 1)

    @property
    def local_vocab(self) -> int:
        return self.vocab_size // (self.tp_size if self.tp_vocab else 1)

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

    Under tensor parallelism ``tp_mode`` ``"col"`` holds the rank's
    out/tp output rows of the weight and of B (A replicated); ``"row"`` the
    rank's in/tp input columns of the weight and of A (B replicated), takes
    the rank's slice of the input, and ends in one ``reduce_from_tp`` of
    the base and LoRA partial sums. ``in_features``/``out_features`` are
    the rank's; ``full_in``/``full_out`` the layer's. A quantized base holds
    the rank's columns (``"col"``) or input rows (``"row"``; int4 repacked
    into the rank's own halves) of ``weight_q``; a 1-D scale whole (a
    column-parallel rank reads its outputs' slice); a group scale its
    columns, or (``"row"``) its groups when ``scale_split``, else all of
    them (JAX's fallback where the groups do not divide by tp). Each row
    takes the scale of its global row's group (``_group_scaled``). s8×s8 in
    ``"row"`` mode takes the token's absmax over the tp group and sums the
    int32 partial products over it, so its output is the whole layer's bit
    for bit; its LoRA partial sums are reduced apart, before B.
    """

    def __init__(self, in_features: int, out_features: int, cfg: LlamaConfig,
                 use_lora: bool, device=None, tp_mode: Optional[str] = None,
                 scale_split: bool = True):
        super().__init__()
        self.full_in, self.full_out = in_features, out_features
        self.tp_mode = tp_mode if cfg.tp_size > 1 else None
        self.tp_rank, self.tp_size = cfg.tp_rank, cfg.tp_size
        self.scale_split = scale_split
        if self.tp_mode == "col":
            out_features //= cfg.tp_size
        elif self.tp_mode == "row":
            in_features //= cfg.tp_size
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
        self.sp_size, self.sp_rank = cfg.sp_size, cfg.sp_rank
        if use_lora:
            r = cfg.lora_rank
            self.lora_a = nn.Parameter(torch.empty(r, in_features, device=device))
            self.lora_b = nn.Parameter(torch.empty(out_features, r, device=device))
            self.scale = cfg.lora_alpha / r

    def _quantized_buffers(self, bits: int, group: Optional[int], act_quant: bool,
                           device) -> None:
        n_in, n_out = self.in_features, self.out_features
        if bits == 4 and (n_in % 2 or (group and (self.full_in // 2) % group)):
            raise ValueError(
                f"int4 packing needs an even input dim and a group dividing its half, "
                f"got in={self.full_in} ({n_in} a rank), group={group}"
            )
        rows = n_in // 2 if bits == 4 else n_in
        if group:
            n_g = self.full_in // group
            split = self.tp_mode == "row" and self.scale_split
            scale_shape = (n_g // self.tp_size if split else n_g, n_out)
        else:
            scale_shape = (self.full_out,)
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

        if self.tp_mode is not None:
            raise ValueError("LoraDense.quantize_: quantize the whole model, then shard it "
                             "(MSR3D.shard_for_serving); a shard's scales need the whole layer")
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
        fp32. A row-parallel rank's row is a slice: its max is taken over
        the tp group, which gives the whole row's."""
        amax = x2.abs().amax(dim=-1, keepdim=True)
        if self.tp_mode == "row":
            amax = max_over_tp(amax)
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
        if self.act_quant:
            half = self.in_features // 2
            lead = x.shape[:-1]
            xq, x_scale = self._act_quant(x.reshape(-1, self.in_features))
            if self.bits == 4:
                lo, hi = self._unpack()
                y32 = int8_matmul(xq[:, :half], lo) + int8_matmul(xq[:, half:], hi)
            else:
                y32 = int8_matmul(xq, self.weight_q)
            if self.tp_mode == "row":  # integer partial sums: the sum is exact
                y32 = sum_int_over_tp(y32)
            y = (y32.float() * x_scale * self._channel_scale().float()[None, :]).to(self.dtype)
            return y.reshape(*lead, self.out_features)
        if torch.is_grad_enabled() and x.requires_grad:
            return _QuantizedBase.apply(x, self)
        return self._dequant_product(x)

    def _channel_scale(self) -> torch.Tensor:
        """The per-channel scale of this rank's outputs (a column-parallel
        rank holds the whole 1-D scale and reads its slice)."""
        if self.tp_mode != "col":
            return self.weight_scale
        n = self.out_features
        return self.weight_scale[self.tp_rank * n:(self.tp_rank + 1) * n]

    def _group_scaled(self, w: torch.Tensor, first: int) -> torch.Tensor:
        """``w`` (rows, out), an unpacked half whose first input row has the
        global index ``first``, times each row's group scale in the compute
        dtype. A half that starts on a group boundary and holds whole groups
        (always so at tp = 1) multiplies by broadcasting over its groups; a
        row-parallel half that cuts a group takes each row's scale by the
        row's index (a replicated scale holds every group)."""
        g, rows = self.group, w.shape[0]
        scales = self.weight_scale.to(self.dtype)
        split = self.tp_mode == "row" and self.scale_split
        local = first - (self.tp_rank * self.in_features if split else 0)
        w = w.to(self.dtype)
        if first % g == 0 and rows % g == 0:
            n_g, g0 = rows // g, local // g
            return (w.reshape(n_g, g, -1) * scales[g0:g0 + n_g, None, :]).reshape(rows, -1)
        index = torch.arange(local, local + rows, device=scales.device) // g
        return w * scales.index_select(0, index)

    def _dequant_kernels(self):
        """The dequantized weights in the compute dtype: int8 → (K,); int4
        per channel → (lo, hi) unscaled (the scale multiplies the sum of
        the half-products); int4 by group → (K_lo, K_hi), each row scaled by
        its group's scale (the products JAX's reshape by groups takes)."""
        if self.bits == 8:
            return (self.weight_q.to(self.dtype) * self._channel_scale().to(self.dtype),)
        lo, hi = self._unpack()
        if not self.group:
            return lo.to(self.dtype), hi.to(self.dtype)
        half = self.in_features // 2
        first = self.tp_rank * self.in_features if self.tp_mode == "row" else 0
        return self._group_scaled(lo, first), self._group_scaled(hi, first + half)

    def _dequant_product(self, x: torch.Tensor) -> torch.Tensor:
        """x @ the dequantized weight, in the JAX package's rounding order:
        the weight rebuilt in the compute dtype, then the product (int4:
        the two half-products summed, then scaled per channel)."""
        kernels = self._dequant_kernels()
        if self.bits == 8:
            return x @ kernels[0]
        half = self.in_features // 2
        y = x[..., :half] @ kernels[0] + x[..., half:] @ kernels[1]
        return y if self.group else y * self._channel_scale().to(self.dtype)

    def _dequant_product_grad(self, gy: torch.Tensor) -> torch.Tensor:
        """d/dx of :meth:`_dequant_product` given dy, the products autograd
        takes over the forward's ops (``dy · Kᵀ`` on the folded rows; int4
        per channel: dy scaled first, the input halves concatenated), with
        the weight rebuilt here."""
        kernels = self._dequant_kernels()
        if self.bits == 4 and not self.group:
            gy = gy * self._channel_scale().to(self.dtype)
        g = gy.reshape(-1, self.out_features)
        gx = torch.cat([g.mm(k.t()) for k in kernels], dim=-1)
        return gx.view(*gy.shape[:-1], self.in_features)

    def tp_partial(self) -> Tuple[str, ...]:
        """The replicated LoRA factor whose gradient on a rank is a partial
        sum over the tp group (column-parallel A, row-parallel B)."""
        if not self.scale:
            return ()
        return {"col": ("lora_a",), "row": ("lora_b",)}.get(self.tp_mode, ())

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.base_forward(x)
        # a row-parallel rank's partial sums end in one reduce; the s8×s8
        # base has summed its integer partials already
        row_partial = self.tp_mode == "row" and not self.act_quant
        if self.scale:
            # a row-parallel input is the rank's slice of the full one, and
            # under sp (train mode) its rows the rank's sequence block: its
            # dropout mask is the full mask's slice
            whole = ((self.full_in, self.tp_rank * self.in_features)
                     if self.tp_mode == "row" else None)
            block = ((x.shape[1] * self.sp_size, self.sp_rank * x.shape[1])
                     if self.sp_size > 1 else None)
            h = F.linear(dropout(x, self.lora_dropout, self.training, generator, whole, block),
                         self.lora_a.to(self.dtype))
            if self.tp_mode == "row" and not row_partial:
                # beside the reduced s8×s8 base, the LoRA's (rows, r) partial
                # sums are reduced before B, where XLA's partitioner reduces
                # them: an ulp more or less here moves the next layer's int8
                # activations a whole step
                h = reduce_from_tp(h)
            y = y + F.linear(h, self.lora_b.to(self.dtype)) * self.scale
        return reduce_from_tp(y) if row_partial else y


class _QuantizedBase(torch.autograd.Function):
    """The product with a quantized ``LoraDense`` base, differentiable in x.

    Autograd over the plain ops would keep the dequantized weight (the
    rebuilt ``bf16(q)·bf16(s)``, 2 bytes a weight) for dx until the
    backward: some 12 GiB at the 7B width, more than the int8 buffers
    themselves. This Function keeps a reference to the module (its int8/int4
    buffers, which exist anyway) and rebuilds the weight in the backward
    with the forward's arithmetic, so its output and dx equal those of
    autograd over the plain ops. The buffers get no gradient."""

    @staticmethod
    def forward(ctx, x, module):
        ctx.module = module
        return module._dequant_product(x)

    @staticmethod
    def backward(ctx, gy):
        return ctx.module._dequant_product_grad(gy), None


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


def _proj(cfg: LlamaConfig, name: str, n_in: int, n_out: int, device,
          tp_mode: Optional[str] = None) -> LoraDense:
    block = "mlp" if name in ("gate_proj", "up_proj", "down_proj") else "attn"
    split = f"layer.0.{block}.{name}.weight_scale" in llm_tp_dims(cfg)
    return LoraDense(n_in, n_out, cfg, cfg.lora_rank > 0 and name in cfg.lora_targets, device,
                     tp_mode, scale_split=split)


def _attn_scale(head_dim: int, device) -> torch.Tensor:
    # 1 / sqrt(D) rounded as the JAX dense path rounds it (fp32 sqrt, fp32 divide)
    return 1.0 / torch.sqrt(torch.tensor(float(head_dim), device=device))


class LlamaAttention(nn.Module):
    """Self-attention over the rank's ``local_heads`` query and
    ``local_kv_heads`` key/value heads (all of them at tp = 1)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        col, row = ("col", "row") if cfg.tp_attn else (None, None)
        self.q_proj = _proj(cfg, "q_proj", h, cfg.num_attention_heads * hd, device, col)
        self.k_proj = _proj(cfg, "k_proj", h, cfg.kv_heads * hd, device, col)
        self.v_proj = _proj(cfg, "v_proj", h, cfg.kv_heads * hd, device, col)
        self.o_proj = _proj(cfg, "o_proj", cfg.num_attention_heads * hd, h, device, row)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor, generator=None):
        cfg = self.cfg
        b, t, _ = x.shape
        if cfg.tp_attn:
            x = copy_to_tp(x)
        q = self.q_proj(x, generator).view(b, t, cfg.local_heads, cfg.head_dim)
        k = self.k_proj(x, generator).view(b, t, cfg.local_kv_heads, cfg.head_dim)
        v = self.v_proj(x, generator).view(b, t, cfg.local_kv_heads, cfg.head_dim)
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
        """Training attention. Under sp, x is this rank's sequence block and
        ``key_valid`` the whole sequence's: ring attention over the sp group
        (the un-repeated kv heads travel). Else ``attn_bias`` None → the
        flash autograd Function (K2f forward, K2dq/K2dkv backward) with
        causality and ``key_valid`` applied inside; else dense with the
        additive bias."""
        q, k, v = self._qkv(x, positions, generator)
        if self.cfg.sp_size > 1:
            out = ring_attention(q, k, v, causal=True, key_valid=key_valid)
        elif attn_bias is None:
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

    def decode_shared(self, x, positions, attn_bias, prompt, gen: Dict[str, torch.Tensor],
                      gen_index, anc_rows: Optional[torch.Tensor] = None):
        """One decode token over a split cache: the prompt segment (k/v of
        (B', S_p, hkv, D)), shared by blocks of B / B' consecutive queries
        (the beams of one request; B' = 1: every query), or a tuple of such
        segments, and the generated segment (B, S_g, hkv, D), into which
        this token's k/v are written in place at ``gen_index``: an int, or a
        (B,) tensor of each row's slot (rows out of range write nothing).
        ``attn_bias`` (B, 1, T, ΣS_p + S_g) masks the segments, in the
        order ``(*prompt, gen)``.

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
        segments = (*prompt, gen) if isinstance(prompt, (list, tuple)) else (prompt, gen)
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
        self.tp = cfg.tp_mlp
        col, row = ("col", "row") if self.tp else (None, None)
        self.gate_proj = _proj(cfg, "gate_proj", h, m, device, col)
        self.up_proj = _proj(cfg, "up_proj", h, m, device, col)
        self.down_proj = _proj(cfg, "down_proj", m, h, device, row)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if self.tp:
            x = copy_to_tp(x)
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

    def _attn_branch(self, x, positions, attn_bias, key_valid, generator=None):
        """The attention branch's output (JAX's ``attn_out``)."""
        return self.attn(self.input_norm(x), positions, attn_bias, key_valid, generator)

    def _after_attn(self, x, attn_out, generator=None):
        return self._mlp_residual(x + attn_out, generator)

    def forward(self, x, positions, attn_bias, key_valid, generator=None):
        return self._after_attn(x, self._attn_branch(x, positions, attn_bias, key_valid,
                                                     generator), generator)

    def prefill(self, x, positions, attn_bias, key_valid):
        h, k, v = self.attn.prefill(self.input_norm(x), positions, attn_bias, key_valid)
        return self._mlp_residual(x + h), k, v

    def decode_shared(self, x, positions, attn_bias, prompt, gen, gen_index, anc_rows=None):
        h = self.attn.decode_shared(self.input_norm(x), positions, attn_bias, prompt, gen,
                                    gen_index, anc_rows)
        return self._mlp_residual(x + h)


# the outputs the "dots" policy keeps: products without batch dims (the
# projections and the LoRA products; F.linear and x @ W fold the leading dims
# into aten.mm), not the attention's batched products (aten.bmm), as JAX's
# dots_with_no_batch_dims_saveable. A kernel launched through ctypes is no
# dispatcher op, so no policy can keep its output: K2f reruns in the recompute
# and its output tensor is allocated anew there.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_block(block: LlamaBlock, policy: str, x, positions, attn_bias, key_valid,
                 generator=None) -> torch.Tensor:
    """One block of the training forward under activation checkpointing,
    equal in value to ``block(...)``:

    * ``full``: the block input is kept, the whole block reruns in the
      backward;
    * ``dots``: the outputs of the products without batch dims are kept too
      (a selective-checkpoint policy), everything else reruns;
    * ``residuals``: the block input and the attention branch's output
      (JAX's ``attn_out``) are kept, and each branch reruns from its own
      input. JAX's policy names ``mlp_out`` as well, but no backward op reads
      it (the next block's input carries it), so ``jax.checkpoint`` keeps the
      same two (B, T, H) tensors a layer.

    The blocks draw no random numbers under remat (LoRA dropout is refused),
    so no RNG state is stashed."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "residuals":
        attn_out = checkpoint(block._attn_branch, x, positions, attn_bias, key_valid,
                              generator, **kw)
        return checkpoint(block._after_attn, x, attn_out, generator, **kw)
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(list(_DOTS))
    return checkpoint(block, x, positions, attn_bias, key_valid, generator, **kw)


def _make_cache(cfg: LlamaConfig, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """An empty cache of the rank's kv heads (all of them at tp = 1), k/v
    (L, B, max_len, hkv, D) zeros in the compute
    dtype, or with ``kv_quantize`` the int8 layout of the zeros: values 0
    and every scale bf16(1e-6 / 127), as ``quantize_kv_cache`` gives them."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.local_kv_heads, cfg.head_dim)
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
                 index) -> None:
    """Write a window's k/v (B, T, hkv, D) into a (B, S, hkv, D) cache at
    consecutive slots, in place; into an int8 cache quantized per token,
    with its scales. ``index`` is an int: every row writes slots ``index ..
    index+T-1``, the start clamped to [0, S - T] as JAX's
    ``dynamic_update_slice`` clamps it. Or a (B,) integer tensor: row b
    writes from ``index[b]`` (``_cache_write_rows`` of the JAX package),
    with JAX's drop rules: a negative start drops the whole window (an idle
    slot, a finished speculative row), and the part of a window past the
    segment's end is dropped while the rest is written."""
    if "k_scale" in cache:
        new = quantize_kv_cache({"k": k, "v": v})
    else:
        new = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    t = k.shape[1]
    s = cache["k"].shape[1]
    if not isinstance(index, torch.Tensor):
        start = min(max(int(index), 0), s - t)
        for key, val in new.items():
            cache[key][:, start:start + t] = val
        return
    if t == 1:
        _write_rows(cache, {key: val[:, 0] for key, val in new.items()}, index)
        return
    if t > s:  # a window wider than the segment: token by token
        for j in range(t):
            _write_rows(cache, {key: val[:, j] for key, val in new.items()},
                        torch.where(index < 0, -1, index + j))
        return
    b = k.shape[0]
    offs = torch.arange(t, device=index.device)
    idx = index[:, None] + offs  # (B, T)
    ok = (index[:, None] >= 0) & (idx < s)
    # a dropped token stores back what slot start-1 (0 for a dropped row)
    # holds, a slot none of its row's kept tokens writes (t <= s); its
    # duplicates store the same value, so the write is deterministic
    spare = torch.where(index >= 1, index - 1, torch.zeros_like(index))[:, None]
    slot = torch.where(ok, idx, spare).reshape(-1).long()
    rows = torch.arange(b, device=index.device).repeat_interleave(t)
    for key, val in new.items():
        arr = cache[key]
        flat = val.reshape((b * t,) + val.shape[2:]).to(arr.dtype)
        keep = ok.reshape((-1,) + (1,) * (flat.dim() - 1))
        arr[rows, slot] = torch.where(keep, flat, arr[rows, slot])


def _write_rows(arrays: Dict[str, torch.Tensor], rows_new: Dict[str, torch.Tensor],
                index: torch.Tensor) -> None:
    """``arrays[key][b, index[b]] = rows_new[key][b]`` in place, for the rows
    whose index lies in [0, S) only: a row at -1 (an idle slot) or at S
    writes nothing, as JAX's scatter ``mode="drop"`` (where a negative index
    would wrap to the last slot). The write is masked, not clamped: a row
    out of range stores back what its slot 0 holds, so no host read of the
    index is needed."""
    first = next(iter(arrays.values()))
    s = first.shape[1]
    ok = (index >= 0) & (index < s)
    rows = torch.arange(first.shape[0], device=index.device)
    slot = torch.where(ok, index, torch.zeros_like(index)).long()
    for key, val in rows_new.items():
        arr = arrays[key]
        keep = ok.view((-1,) + (1,) * (val.dim() - 1))
        arr[rows, slot] = torch.where(keep, val.to(arr.dtype), arr[rows, slot])


def _bias(valid: torch.Tensor) -> torch.Tensor:
    """bool mask → fp32 additive bias (0 where valid, -1e30 elsewhere)."""
    return torch.zeros(valid.shape, dtype=torch.float32, device=valid.device).masked_fill(
        ~valid, _NEG_INF
    )


class StageLayers(nn.ModuleList):
    """The blocks a model holds (a pipeline stage's, or every block at
    pp = 1) under their global indices: ``layer.16`` of the whole model is
    ``layer.16`` of the stage that holds it, so names, checkpoints and the
    tp layout are the whole model's. Iterates in order; ``[i]`` is the i-th
    block held."""

    def __init__(self, blocks: Dict[int, nn.Module]):
        super().__init__()
        for index, block in blocks.items():
            self.add_module(str(index), block)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


class LlamaModel(nn.Module):
    """Decoder-only Llama driven by ``inputs_embeds`` (the MSR3D model
    splices scene embeddings between the token embeddings). Under tp the
    embedding table and ``lm_head`` hold the rank's ``local_vocab`` rows;
    ``layer`` holds the stage's blocks (all of them at pp = 1)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        vocab = cfg.local_vocab
        self.embed_tokens = nn.Embedding(
            vocab, cfg.hidden_size,
            _weight=torch.empty(vocab, cfg.hidden_size, dtype=cfg.param_dtype, device=device),
        )
        self.embed_tokens.weight.requires_grad_(False)
        self.layer = StageLayers({i: LlamaBlock(cfg, device) for i in cfg.stage_layers})
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                                  cfg.param_dtype, device)
        self.lm_head = nn.Linear(cfg.hidden_size, vocab, bias=False,
                                 dtype=cfg.param_dtype, device=device)
        self.lm_head.weight.requires_grad_(False)

    def tp_dims(self) -> Dict[str, Spec]:
        """name (inside the LLM) → the spec of each tensor sharded over tp
        (``llm_tp_dims``: a dim, or ``PACKED_ROWS``); every other tensor is
        replicated (empty at tp = 1)."""
        return dict(llm_tp_dims(self.cfg))

    def tp_partial(self) -> List[str]:
        """The replicated parameters (inside the LLM) whose per-rank gradient
        is a partial sum over the tp group (``LoraDense.tp_partial``)."""
        return [f"{prefix}.{leaf}" for prefix, mod in self.named_modules()
                if isinstance(mod, LoraDense) for leaf in mod.tp_partial()]

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.cfg.tp_vocab:
            start = self.cfg.tp_rank * self.cfg.local_vocab
            return vocab_parallel_embed(input_ids, self.embed_tokens.weight,
                                        start).to(self.cfg.dtype)
        return self.embed_tokens(input_ids).to(self.cfg.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(…, V) over the whole vocab; under a vocab-parallel head the
        rank's slice, gathered over the tp group."""
        if self.cfg.tp_vocab:
            local = F.linear(copy_to_tp(hidden), self.lm_head.weight.to(self.cfg.dtype))
            return gather_last_dim(local)
        return F.linear(hidden, self.lm_head.weight.to(self.cfg.dtype))

    def _whole(self, what: str) -> None:
        if self.cfg.pp_size > 1:
            layers = self.cfg.stage_layers
            raise RuntimeError(f"{what} runs every block; pipeline stage {self.cfg.pp_rank} "
                               f"holds blocks {layers.start}..{layers.stop - 1} only "
                               "(parallel/llm_pp.py drives a stage)")

    def _positions(self, attention_mask: torch.Tensor) -> torch.Tensor:
        """HF left-padding positions: cumsum(mask) - 1, floored at 0."""
        return (torch.cumsum(attention_mask.long(), dim=1) - 1).clamp(min=0)

    def _attention_masks(self, attention_mask: torch.Tensor, ring: bool = False):
        """(attn_bias, key_valid) of a causal pass over the whole sequence:
        the ring (``ring``) and the flash kernels take the key mask and apply
        causality themselves; the dense route takes the (B, 1, T, T)
        additive bias."""
        mask = attention_mask.bool()
        if ring or self.cfg.flash_attention:
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
        ``generator`` feeds LoRA dropout in ``train()`` mode. With ``remat``
        and grad enabled each block runs under activation checkpointing.

        Under sp the whole ``inputs_embeds`` and ``attention_mask`` are
        given; the blocks run on this rank's sequence block, and the logits
        cover the positions ``sp_window(T, answer_start)`` of it (every
        position of the block without a window)."""
        self._whole("the training forward")
        cfg = self.cfg
        positions = self._positions(attention_mask)
        attn_bias, key_valid = self._attention_masks(attention_mask, ring=cfg.sp_size > 1)
        x = inputs_embeds.to(cfg.dtype)
        if cfg.sp_size > 1:
            t = x.shape[1]
            x = sequence_block(x, cfg.sp_size, cfg.sp_rank)
            positions = sequence_block(positions, cfg.sp_size, cfg.sp_rank)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.layer:
            if remat:
                x = _remat_block(block, self.cfg.remat_policy, x, positions, attn_bias,
                                 key_valid, generator)
            else:
                x = block(x, positions, attn_bias, key_valid, generator)
        x = self.final_norm(x)
        if cfg.sp_size > 1:
            lo, hi = self.sp_window(t, answer_start)
            first = cfg.sp_rank * x.shape[1]
            return self.logits(x[:, lo - first:hi - first])
        return self.logits(x if answer_start is None else x[:, answer_start - 1:-1])

    def sp_window(self, t: int, answer_start: Optional[int] = None) -> Tuple[int, int]:
        """The global positions [lo, hi) whose logits this rank's sp forward
        computes over a sequence of ``t``: its block's, or those of them
        inside the answer window ``answer_start-1 .. t-2`` (lo = hi where
        the block holds none)."""
        s = t // self.cfg.sp_size
        first = self.cfg.sp_rank * s
        if answer_start is None:
            return first, first + s
        lo = max(first, answer_start - 1)
        return lo, max(lo, min(first + s, t - 1))

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
        self._whole("prefill")
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

    def _attn_bias(self, inputs_embeds, prompt_kv, prompt_mask, gen_mask, gen_index=0,
                   window_valid=None) -> torch.Tensor:
        """The (B·K, 1, T, S_p + S_g) additive bias of a decode step: the
        prompt's (B, S_p) mask repeated for the K queries of each prompt row,
        or taken as it is when it has a row per query (B·K, S_p), then the
        generated segment's (B·K, S_g) mask. A tuple of prompt segments takes
        a per-query mask over their summed widths, as JAX asserts. In a
        window of T > 1 query t also sees the generated slots ``start ..
        start+t`` (``start`` = ``gen_index``, an int or (B·K,)), and with
        ``window_valid`` (B·K, T) only those whose window token is real: slot
        start+j carries window token j, the j of a slot outside the window
        clipped to [0, T-1] as JAX clips it."""
        bk, t, _ = inputs_embeds.shape
        if isinstance(prompt_kv, (list, tuple)):
            if prompt_mask.shape[0] != bk:
                raise ValueError("a tuple of prompt segments needs a per-query prompt mask "
                                 f"({bk} rows), got {prompt_mask.shape[0]} rows")
            pm = prompt_mask.bool()
        else:
            b = prompt_kv["k"].shape[1]
            pm = (prompt_mask.bool() if prompt_mask.shape[0] == bk
                  else prompt_mask.bool().repeat_interleave(bk // b, dim=0))
        prompt_bias = _bias(pm)
        valid_g = gen_mask.bool()[:, None, :]  # (B·K, 1, S_g)
        if t > 1:
            dev = gen_mask.device
            s_g = gen_mask.shape[1]
            start = torch.as_tensor(gen_index, device=dev)
            start = start[:, None, None] if start.dim() == 1 else start.reshape(1, 1, 1)
            s_idx = torch.arange(s_g, device=dev)[None, None, :]
            tq = torch.arange(t, device=dev)[None, :, None]
            win = (s_idx >= start) & (s_idx <= start + tq)  # (B·K | 1, T, S_g)
            if window_valid is not None:
                j = (s_idx - start).clamp(0, t - 1).expand(bk, 1, s_g)
                win = win & torch.gather(window_valid.bool()[:, None, :], 2, j)
            valid_g = valid_g | win
        return torch.cat([prompt_bias[:, None, None, :].expand(bk, 1, t, -1),
                          _bias(valid_g)[:, None].expand(bk, 1, t, -1)], dim=-1)

    def _decode_layers(self, inputs_embeds, positions, attn_bias, prompt_kv, gen_kv,
                       gen_index, anc_rows=None) -> torch.Tensor:
        self._whole("a decode step")
        x = inputs_embeds.to(self.cfg.dtype)
        segmented = isinstance(prompt_kv, (list, tuple))
        for i, block in enumerate(self.layer):
            layer_prompt = (tuple({key: val[i] for key, val in seg.items()} for seg in prompt_kv)
                            if segmented else {key: val[i] for key, val in prompt_kv.items()})
            x = block.decode_shared(
                x, positions, attn_bias, layer_prompt,
                {key: val[i] for key, val in gen_kv.items()}, gen_index, anc_rows,
            )
        return self.logits(self.final_norm(x))

    def decode_step_shared(
        self,
        inputs_embeds: torch.Tensor,  # (B·K, 1, H)
        positions: torch.Tensor,  # (B·K, 1)
        prompt_kv: Dict[str, torch.Tensor],  # k/v (L, B, S_p, hkv, D) [+ scales], read-only
        prompt_mask: torch.Tensor,  # (B, S_p), or (B·K, S_p) a row per query
        gen_kv: Dict[str, torch.Tensor],  # k/v (L, B·K, S_g, hkv, D) [+ scales], written in place
        gen_index,  # int, or (B·K,) each row's start slot (negative: no write)
        gen_mask: torch.Tensor,  # (B·K, S_g); T = 1: including the slot written now
        window_valid: Optional[torch.Tensor] = None,  # (B·K, T) bool, real window tokens
    ) -> torch.Tensor:
        """One decode step over the split cache → logits (B·K, T, V): the
        prompt segment at batch B, shared by the K beams of each row (K = 1
        greedy), and the generated segment at batch B·K, updated in place
        (the JAX loop carries it functionally). T > 1 is a window: the
        speculative verify window (``gen_index`` then (B,), rows at their
        own depths) or the grouped path's suffix pass, where
        ``window_valid`` keeps the left-pad tokens of each row's window
        unseen.

        A ``prompt_mask`` of batch B·K is a visibility row per query: the
        prefix-pool engines pass their (G, S_pre) block pool as a batch-1
        (1, G·S_pre) segment (a view of the pool), which every slot reads,
        and admit each slot's own block's rows only."""
        return self._decode_layers(
            inputs_embeds, positions,
            self._attn_bias(inputs_embeds, prompt_kv, prompt_mask, gen_mask, gen_index,
                            window_valid),
            prompt_kv, gen_kv, gen_index)

    def decode_step_beam_anc(
        self,
        inputs_embeds: torch.Tensor,  # (B·K, 1, H)
        positions: torch.Tensor,  # (B·K, 1)
        prompt_kv,  # k/v (L, B, S_p, hkv, D) [+ scales], or a tuple of such; read-only
        prompt_mask: torch.Tensor,  # (B, S_p), or (B·K, ΣS_p) a row per query
        gen_kv: Dict[str, torch.Tensor],  # k/v (L, B·K, S_g, hkv, D) [+ scales], written in place
        gen_index,  # int, or (B·K,) each row's slot (out of range: no write)
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
        the only extra memory).

        ``prompt_kv`` may be a tuple of segments, attended in order before
        the generated one, with a per-query ``prompt_mask`` over their summed
        widths: the prefix-pool beam engine's block pool and its per-slot
        question suffixes, each a batch-1 view, so a suffix is stored once a
        slot and never copied into its K beam rows. JAX sums the generated
        pairs first and the prompt segments after, so with two prompt
        segments the two packages' outputs part by fp32 rounding."""
        if inputs_embeds.shape[1] != 1:
            raise ValueError("the ancestry beam step takes one token a row (T = 1)")
        bk, s_g = gen_mask.shape
        block = torch.arange(bk, device=anc.device)[:, None] // num_beams * num_beams
        slots = torch.arange(s_g, device=anc.device)[None, :]
        anc_rows = ((block + anc.long()) * s_g + slots).reshape(-1)
        return self._decode_layers(inputs_embeds, positions,
                                   self._attn_bias(inputs_embeds, prompt_kv, prompt_mask, gen_mask),
                                   prompt_kv, gen_kv, gen_index, anc_rows)
