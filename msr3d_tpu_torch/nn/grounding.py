"""The legacy grounding stack: BERT text encoder, spatial cross encoders and
the grounding, QA and pretraining heads.

Counterpart of ``msr3d_tpu/nn/grounding.py``, registered under the same
names. Object features (a point encoder's) and BERT text features go
through a spatial cross encoder to heads whose outputs feed
``optim/losses.py`` (og3d_logits, txt_cls_logits, obj_cls_*_logits,
answer_scores, txt_lm_cls_logits). Submodules carry the JAX modules' names
(``layer_3`` is ``layer[3]``), so ``convert.load_jax_params`` loads a flax
tree as it is; ``load_hf_bert_state_dict`` loads a Hugging Face BERT
state dict into ``BERTLanguageEncoder``.

The attention here is plain attention (``nn/transformers.py``), as it is in
the JAX package, outside any Pallas kernel. Dropout is active only in
``train()`` mode and draws from the ``generator`` the caller passes.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.nn.layers import AttFlat, MLPHead, dropout
from msr3d_tpu_torch.nn.transformers import (
    FeedForward,
    MultiHeadAttention,
    MultiHeadAttentionSpatial,
    TransformerEncoderLayer,
)
from msr3d_tpu_torch.ops.geometry import calc_pairwise_locs
from msr3d_tpu_torch.registry import GROUNDING_REGISTRY, HEADS_REGISTRY, LANGUAGE_REGISTRY

# ---------------------------------------------------------------------------
# BERT text encoder: a truncated BertModel over the wrapper's txt_ids/txt_masks


class BertLayer(nn.Module):
    """Post-LN BERT layer: attention, residual, LayerNorm (eps 1e-12), then
    the exact-gelu FFN, residual, LayerNorm."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.attention = MultiHeadAttention(hidden_size, num_heads, dropout, device)
        self.attn_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.intermediate = nn.Linear(hidden_size, intermediate_size, device=device)
        self.output = nn.Linear(intermediate_size, hidden_size, device=device)
        self.ffn_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn_out, _ = self.attention(x, x, x, key_padding_mask, generator=generator)
        x = self.attn_norm(x + dropout(attn_out, self.dropout, self.training, generator))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.ffn_norm(x + dropout(h, self.dropout, self.training, generator))


@LANGUAGE_REGISTRY.register(name="BERTLanguageEncoder")
class BERTLanguageEncoder(nn.Module):
    """Truncated BERT: word + position + token-type embeddings, LayerNorm,
    ``num_hidden_layers`` post-LN layers. txt_ids (B, T), txt_masks (B, T)
    1 = token → (B, T, hidden_size)."""

    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 3,
                 num_attention_heads: int = 12, vocab_size: int = 30522,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size, device=device)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size,
                                                device=device)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size, device=device)
        self.embeddings_norm = nn.LayerNorm(hidden_size, eps=1e-12, device=device)
        self.layer = nn.ModuleList(
            BertLayer(hidden_size, num_attention_heads, 4 * hidden_size, dropout, device)
            for _ in range(num_hidden_layers)
        )
        self.dropout = dropout

    def forward(self, txt_ids: torch.Tensor, txt_masks: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = txt_ids.shape[1]
        x = (self.word_embeddings(txt_ids.long())
             + self.position_embeddings.weight[:t][None]
             + self.token_type_embeddings.weight[0])
        x = dropout(self.embeddings_norm(x), self.dropout, self.training, generator)
        pad = ~txt_masks.bool()
        for layer in self.layer:
            x = layer(x, key_padding_mask=pad, generator=generator)
        return x


def load_hf_bert_state_dict(module: BERTLanguageEncoder,
                            sd: Mapping[str, torch.Tensor]) -> None:
    """Load a Hugging Face ``BertModel`` (or ``BertFor*``, keys under
    ``bert.``) state dict into ``module``: its embeddings and its first
    ``len(module.layer)`` layers. Both sides are torch ``Linear`` layouts,
    so nothing is transposed; every parameter of ``module`` must be found."""
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""
    names = {
        "word_embeddings.weight": "embeddings.word_embeddings.weight",
        "position_embeddings.weight": "embeddings.position_embeddings.weight",
        "token_type_embeddings.weight": "embeddings.token_type_embeddings.weight",
        "embeddings_norm.weight": "embeddings.LayerNorm.weight",
        "embeddings_norm.bias": "embeddings.LayerNorm.bias",
    }
    per_layer = {
        "attention.q_proj": "attention.self.query",
        "attention.k_proj": "attention.self.key",
        "attention.v_proj": "attention.self.value",
        "attention.out_proj": "attention.output.dense",
        "attn_norm": "attention.output.LayerNorm",
        "intermediate": "intermediate.dense",
        "output": "output.dense",
        "ffn_norm": "output.LayerNorm",
    }
    for i in range(len(module.layer)):
        for ours, theirs in per_layer.items():
            for leaf in ("weight", "bias"):
                names[f"layer.{i}.{ours}.{leaf}"] = f"encoder.layer.{i}.{theirs}.{leaf}"
    state = {ours: sd[pre + theirs].detach() for ours, theirs in names.items()}
    module.load_state_dict(state, strict=True)


# ---------------------------------------------------------------------------
# decoder layers: pre-norm, with the residuals added outside each branch


class TransformerDecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention over ``memory`` and FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu", device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, device)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout, device)
        self.ffn = FeedForward(d_model, dim_feedforward, activation, dropout, device)
        self.dropout = dropout

    def forward(self, tgt, memory, tgt_key_padding_mask=None, memory_key_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        drop = lambda x: dropout(x, self.dropout, self.training, generator)  # noqa: E731
        tgt2 = self.norm1(tgt)
        tgt2, self_w = self.self_attn(tgt2, tgt2, tgt2, tgt_key_padding_mask,
                                      generator=generator)
        tgt = tgt + drop(tgt2)
        tgt2 = self.norm2(tgt)
        tgt2, cross_w = self.multihead_attn(tgt2, memory, memory, memory_key_padding_mask,
                                            generator=generator)
        tgt = tgt + drop(tgt2)
        tgt = tgt + drop(self.ffn(self.norm3(tgt), generator))
        return tgt, self_w, cross_w


class TransformerSpatialDecoderLayer(nn.Module):
    """Pre-norm decoder whose self-attention is the spatial fusion attention.
    The spatial attention applies its own inner residual + LayerNorm, and
    the outer residual adds on top, as in the JAX package."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "gelu", spatial_multihead: bool = True,
                 spatial_dim: int = 5, spatial_attn_fusion: str = "cond", device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.self_attn = MultiHeadAttentionSpatial(
            d_model, nhead, spatial_multihead, spatial_dim, spatial_attn_fusion, dropout, device)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout, device)
        self.ffn = FeedForward(d_model, dim_feedforward, activation, dropout, device)
        self.dropout = dropout

    def forward(self, tgt, memory, tgt_pairwise_locs, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, generator: Optional[torch.Generator] = None):
        drop = lambda x: dropout(x, self.dropout, self.training, generator)  # noqa: E731
        tgt2 = self.norm1(tgt)
        tgt2, self_w = self.self_attn(tgt2, tgt_pairwise_locs, tgt_key_padding_mask, generator)
        tgt = tgt + drop(tgt2)
        tgt2 = self.norm2(tgt)
        tgt2, cross_w = self.multihead_attn(tgt2, memory, memory, memory_key_padding_mask,
                                            generator=generator)
        tgt = tgt + drop(tgt2)
        tgt = tgt + drop(self.ffn(self.norm3(tgt), generator))
        return tgt, self_w, cross_w


class _LocLayer(nn.Module):
    """Linear over the object locations, then LayerNorm (eps 1e-5)."""

    def __init__(self, dim_loc: int, hidden_size: int, device=None):
        super().__init__()
        self.dense = nn.Linear(dim_loc, hidden_size, device=device)
        self.norm = nn.LayerNorm(hidden_size, eps=1e-5, device=device)

    def forward(self, obj_locs: torch.Tensor) -> torch.Tensor:
        return self.norm(self.dense(obj_locs))


@GROUNDING_REGISTRY.register(name="EntitySpatialCrossEncoder")
class EntitySpatialCrossEncoder(nn.Module):
    """Objects attend spatially among themselves and cross-attend to the
    text features, which pass through unchanged."""

    def __init__(self, hidden_size: int = 768, num_attention_heads: int = 12,
                 spatial_dim: int = 5, num_layers: int = 4, dim_loc: int = 6,
                 pairwise_rel_type: str = "center", device=None):
        super().__init__()
        self.pairwise_rel_type = pairwise_rel_type
        self.loc_layer = _LocLayer(dim_loc, hidden_size, device)
        self.layer = nn.ModuleList(
            TransformerSpatialDecoderLayer(hidden_size, num_attention_heads,
                                           spatial_dim=spatial_dim, device=device)
            for _ in range(num_layers)
        )

    def forward(self, txt_embeds, txt_masks, obj_embeds, obj_locs, obj_masks,
                generator: Optional[torch.Generator] = None):
        pairwise_locs = calc_pairwise_locs(obj_locs[:, :, :3], obj_locs[:, :, 3:],
                                           pairwise_rel_type=self.pairwise_rel_type)
        out = obj_embeds
        for layer in self.layer:
            out = out + self.loc_layer(obj_locs)
            out, _, _ = layer(out, txt_embeds, pairwise_locs,
                              tgt_key_padding_mask=~obj_masks.bool(),
                              memory_key_padding_mask=~txt_masks.bool(), generator=generator)
        return txt_embeds, out


@GROUNDING_REGISTRY.register(name="UnifiedSpatialCrossEncoderV1")
class UnifiedSpatialCrossEncoderV1(nn.Module):
    """Interleaved object and text streams: each block runs a spatial
    decoder over the objects (cross to the text) and a plain decoder over
    the text (cross to the objects)."""

    def __init__(self, hidden_size: int = 768, num_attention_heads: int = 12,
                 spatial_dim: int = 5, num_layers: int = 4, dim_loc: int = 6,
                 pairwise_rel_type: str = "center", device=None):
        super().__init__()
        self.pairwise_rel_type = pairwise_rel_type
        self.loc_layer = _LocLayer(dim_loc, hidden_size, device)
        self.pc_layer = nn.ModuleList(
            TransformerSpatialDecoderLayer(hidden_size, num_attention_heads,
                                           spatial_dim=spatial_dim, device=device)
            for _ in range(num_layers)
        )
        self.lang_layer = nn.ModuleList(
            TransformerDecoderLayer(hidden_size, num_attention_heads, device=device)
            for _ in range(num_layers)
        )

    def forward(self, txt_embeds, txt_masks, obj_embeds, obj_locs, obj_masks,
                generator: Optional[torch.Generator] = None):
        pairwise_locs = calc_pairwise_locs(obj_locs[:, :, :3], obj_locs[:, :, 3:],
                                           pairwise_rel_type=self.pairwise_rel_type)
        obj_pad, txt_pad = ~obj_masks.bool(), ~txt_masks.bool()
        for pc_layer, lang_layer in zip(self.pc_layer, self.lang_layer):
            obj_in = obj_embeds + self.loc_layer(obj_locs)
            obj_out, _, _ = pc_layer(obj_in, txt_embeds, pairwise_locs,
                                     tgt_key_padding_mask=obj_pad,
                                     memory_key_padding_mask=txt_pad, generator=generator)
            txt_out, _, _ = lang_layer(txt_embeds, obj_in, tgt_key_padding_mask=txt_pad,
                                       memory_key_padding_mask=obj_pad, generator=generator)
            obj_embeds, txt_embeds = obj_out, txt_out
        return txt_embeds, obj_embeds


@GROUNDING_REGISTRY.register(name="UnifiedSpatialCrossEncoderV2")
class UnifiedSpatialCrossEncoderV2(nn.Module):
    """Joint-sequence fusion: per block the objects gain their location and
    token-type-1 embeddings, the text the token-type-0 embedding, and both
    streams run as ONE sequence through a post-norm encoder layer, then
    split back. No spatial attention."""

    def __init__(self, hidden_size: int = 768, num_attention_heads: int = 12,
                 num_layers: int = 4, dim_loc: int = 6, device=None):
        super().__init__()
        self.loc_layer = _LocLayer(dim_loc, hidden_size, device)
        self.token_type_embeddings = nn.Embedding(2, hidden_size, device=device)
        self.layer = nn.ModuleList(
            TransformerEncoderLayer(hidden_size, num_attention_heads, device=device)
            for _ in range(num_layers)
        )

    def forward(self, txt_embeds, txt_masks, obj_embeds, obj_locs, obj_masks,
                generator: Optional[torch.Generator] = None):
        txt_len = txt_embeds.shape[1]
        joint_pad = ~torch.cat([txt_masks.bool(), obj_masks.bool()], dim=1)
        txt_type, obj_type = self.token_type_embeddings.weight
        for layer in self.layer:
            obj_in = obj_embeds + self.loc_layer(obj_locs) + obj_type
            joint = torch.cat([txt_embeds + txt_type, obj_in], dim=1)
            joint, _ = layer(joint, key_padding_mask=joint_pad, generator=generator)
            txt_embeds, obj_embeds = joint[:, :txt_len], joint[:, txt_len:]
        return txt_embeds, obj_embeds


# ---------------------------------------------------------------------------
# heads


@HEADS_REGISTRY.register(name="GroundHeadV1")
class GroundHeadV1(nn.Module):
    """The og3d head (padded objects at -inf) and the text, post- and
    pre-encoder object classification heads. Returns (txt_cls, obj_cls,
    obj_cls_pre, og3d)."""

    def __init__(self, input_size: int = 768, hidden_size: int = 768,
                 sem_cls_size: int = 607, dropout: float = 0.3,
                 detach_all_aux_loss: bool = False, device=None):
        super().__init__()
        self.og3d_head = MLPHead(input_size, hidden_size, 1, dropout, device)
        self.txt_clf_head = MLPHead(input_size, hidden_size, sem_cls_size, dropout, device)
        self.obj3d_clf_head = MLPHead(input_size, hidden_size, sem_cls_size, dropout, device)
        self.obj3d_clf_pre_head = MLPHead(input_size, hidden_size, sem_cls_size, dropout, device)
        self.detach_all_aux_loss = detach_all_aux_loss

    def forward(self, txt_embeds, obj_embeds, obj_pre_embeds, obj_masks,
                generator: Optional[torch.Generator] = None):
        og3d = self.og3d_head(obj_embeds, generator)[..., 0]
        og3d = og3d.masked_fill(~obj_masks.bool(), float("-inf"))
        if self.detach_all_aux_loss:
            txt_embeds, obj_embeds = txt_embeds.detach(), obj_embeds.detach()
            obj_pre_embeds = obj_pre_embeds.detach()
        txt_cls = self.txt_clf_head(txt_embeds[:, 0], generator)
        obj_cls = self.obj3d_clf_head(obj_embeds, generator)
        obj_cls_pre = self.obj3d_clf_pre_head(obj_pre_embeds, generator)
        return txt_cls, obj_cls, obj_cls_pre, og3d


@HEADS_REGISTRY.register(name="QAHeadV1")
class QAHeadV1(nn.Module):
    """AttFlat pooling of both streams, summed and normed → answer scores
    (B, num_answers)."""

    def __init__(self, hidden_size: int = 768, mlp_size: int = 256, glimpse: int = 1,
                 flat_out_size: int = 512, num_answers: int = 8864, dropout: float = 0.3,
                 device=None):
        super().__init__()
        self.attflat_visual = AttFlat(hidden_size, mlp_size, glimpse, flat_out_size, 0.1, device)
        self.attflat_lang = AttFlat(hidden_size, mlp_size, glimpse, flat_out_size, 0.1, device)
        self.fusion_norm = nn.LayerNorm(flat_out_size, eps=1e-5, device=device)
        self.answer_fc1 = nn.Linear(flat_out_size, hidden_size, device=device)
        self.answer_fc2 = nn.Linear(hidden_size, num_answers, device=device)
        self.dropout = dropout

    def forward(self, obj_embeds, obj_masks, txt_embeds, txt_masks,
                generator: Optional[torch.Generator] = None):
        vis, _ = self.attflat_visual(obj_embeds, ~obj_masks.bool(), generator)
        lang, _ = self.attflat_lang(txt_embeds, ~txt_masks.bool(), generator)
        h = F.gelu(self.answer_fc1(self.fusion_norm(vis + lang)))
        return self.answer_fc2(dropout(h, self.dropout, self.training, generator))


@HEADS_REGISTRY.register(name="PretrainHeadV1")
class PretrainHeadV1(nn.Module):
    """BERT's LM prediction head over the text features: dense, exact gelu,
    LayerNorm (eps 1e-5), then the vocabulary decoder plus its own bias."""

    def __init__(self, hidden_size: int = 768, vocab_size: int = 30522, device=None):
        super().__init__()
        self.transform_dense = nn.Linear(hidden_size, hidden_size, device=device)
        self.transform_norm = nn.LayerNorm(hidden_size, eps=1e-5, device=device)
        self.decoder = nn.Linear(hidden_size, vocab_size, bias=False, device=device)
        self.bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, txt_embeds: torch.Tensor, **_) -> torch.Tensor:
        h = self.transform_norm(F.gelu(self.transform_dense(txt_embeds)))
        return self.decoder(h) + self.bias
