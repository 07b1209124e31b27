"""PointTokenizeEncoder: a PointNet++ object encoder whose features are
"tokenized" through a semantic classifier, with a mixup curriculum.

Counterpart of ``msr3d_tpu/nn/pcd_tokenize.py``, registered under the same
name. PointNet++ (``nn/pointnet.py``, FPS by kernel K1 at npoint 32 and 16)
encodes each object; a 607-way classifier's softmax, detached and
optionally mixed with the gold labels, picks (or, with
``use_matmul_label``, weighs) rows of a (607, 300) category table whose
embedding is added back to the object feature; objects whose semantics
are masked carry a learned mask embedding instead; ``num_layers`` spatial
attention layers reason over the result.

Mixup: ``all_mixup`` replaces every prediction with its gold one-hot;
``linear_decay`` replaces each one with probability annealed from 1 to 0
between ``mixup_stage1`` and ``mixup_stage2`` of the schedule, drawn with
JAX's threefry stream (``models/llm/prng.py``) from the key the caller
passes, so that the draws equal the JAX module's for the key its
``make_rng("mixup")`` gives.

The category table is the GloVe table of ``cat2glove42b.json`` when the
caller passes it (``cat2vec``, (categories, glove_dim)), a constant then,
else a learned parameter ``int2mat``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from msr3d_tpu_torch.models.llm import prng
from msr3d_tpu_torch.nn.layers import MLPHead, dropout
from msr3d_tpu_torch.nn.pointnet import PointNetPP
from msr3d_tpu_torch.nn.transformers import TransformerSpatialEncoderLayer
from msr3d_tpu_torch.ops.geometry import calc_pairwise_locs
from msr3d_tpu_torch.registry import VISION_REGISTRY


def _gold_onehot(obj_sem_cls_pred: torch.Tensor, obj_labels: torch.Tensor) -> torch.Tensor:
    return F.one_hot(obj_labels.long().clamp_min(0),
                     obj_sem_cls_pred.shape[-1]).to(obj_sem_cls_pred.dtype)


def all_mixup(obj_sem_cls_pred: torch.Tensor, obj_labels: torch.Tensor) -> torch.Tensor:
    """Gold one-hots wherever a label exists (>= 0), zeros elsewhere."""
    valid = (obj_labels >= 0)[..., None]
    return torch.where(valid, _gold_onehot(obj_sem_cls_pred, obj_labels),
                       torch.zeros_like(obj_sem_cls_pred))


def linear_decay_mixup(obj_sem_cls_pred: torch.Tensor, obj_labels: torch.Tensor,
                       cur_step, total_steps, stage1: float, stage2: float,
                       key: torch.Tensor) -> torch.Tensor:
    """Per-object gold replacement with probability 1 before ``stage1``·T,
    falling linearly to 0 at ``stage2``·T. ``key`` is a threefry key (two
    32-bit words, ``prng.prng_key``); the uniforms are
    ``jax.random.uniform(key, obj_labels.shape)``'s."""
    t1 = total_steps * stage1
    t2 = total_steps * stage2
    dev = obj_sem_cls_pred.device
    num = torch.as_tensor(t2 - cur_step, dtype=torch.float32, device=dev)
    den = torch.as_tensor(max(t2 - t1, 1e-6), dtype=torch.float32, device=dev)
    ratio = torch.clamp(num / den, 0.0, 1.0)
    ratio = torch.where(torch.as_tensor(cur_step < t1, device=dev), 1.0, ratio)
    rand = prng.uniform(key.to(dev), tuple(obj_labels.shape))
    replace = ((rand < ratio) & (obj_labels >= 0))[..., None]
    return torch.where(replace, _gold_onehot(obj_sem_cls_pred, obj_labels), obj_sem_cls_pred)


@VISION_REGISTRY.register(name="PointTokenizeEncoder")
class PointTokenizeEncoder(nn.Module):
    """(B, O, P, 6) object clouds → (obj_embeds (B, O, H), obj_embeds_pre
    (B, O, H), obj_sem_cls (B, O, num_semantic_classes)). PointNet++'s
    BatchNorm reads its running statistics, as the JAX module's does."""

    def __init__(self, hidden_size: int = 768, num_attention_heads: int = 12,
                 spatial_dim: int = 5, num_layers: int = 4, dim_loc: int = 6,
                 pairwise_rel_type: str = "center", freeze: bool = False,
                 use_matmul_label: bool = False, mixup_strategy: Optional[str] = None,
                 mixup_stage1: float = 0.0, mixup_stage2: float = 0.0,
                 num_semantic_classes: int = 607, glove_dim: int = 300,
                 sa_mlps=((3, 64, 64, 128), (128, 128, 128, 256), (256, 256, 512, 768)),
                 cat2vec: Optional[np.ndarray] = None, device=None):
        super().__init__()
        if sa_mlps[-1][-1] != hidden_size:
            raise ValueError("PointNetPP output width must equal hidden_size")
        if mixup_strategy not in (None, "all_mixup", "linear_decay"):
            raise NotImplementedError(mixup_strategy)
        self.pairwise_rel_type, self.spatial_dim = pairwise_rel_type, spatial_dim
        self.freeze, self.use_matmul_label = freeze, use_matmul_label
        self.mixup_strategy = mixup_strategy
        self.mixup_stage1, self.mixup_stage2 = mixup_stage1, mixup_stage2
        self.point_feature_extractor = PointNetPP(
            (32, 16, None), (32, 32, None), (0.2, 0.4, None), sa_mlps,
            in_features=sa_mlps[0][0], device=device)
        self.point_cls_head = MLPHead(hidden_size, hidden_size // 2, num_semantic_classes,
                                      dropout=0.3, device=device)
        if cat2vec is not None:  # the GloVe table: a constant, not in the state dict
            self.register_buffer("int2mat", torch.as_tensor(np.asarray(cat2vec, np.float32),
                                                            device=device), persistent=False)
        else:
            self.int2mat = nn.Parameter(
                torch.randn(num_semantic_classes, glove_dim, device=device) * 0.02)
        self.sem_cls_fc = nn.Linear(glove_dim, hidden_size, device=device)
        self.sem_cls_norm = nn.LayerNorm(hidden_size, eps=1e-5, device=device)
        self.sem_mask_embeddings = nn.Embedding(1, hidden_size, device=device)
        self.loc_fc = nn.Linear(dim_loc, hidden_size, device=device)
        self.loc_norm = nn.LayerNorm(hidden_size, eps=1e-5, device=device)
        self.spatial_layer = nn.ModuleList(
            TransformerSpatialEncoderLayer(
                hidden_size, num_attention_heads, dim_feedforward=2048, activation="gelu",
                spatial_dim=spatial_dim, spatial_attn_fusion="cond", dropout=0.1,
                device=device)
            for _ in range(num_layers)
        )

    def forward(self, obj_pcds, obj_locs, obj_masks, obj_sem_masks, obj_labels=None,
                cur_step=None, max_steps=None, mixup_key: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b, o = obj_pcds.shape[:2]
        drop = lambda x, rate: dropout(x, rate, self.training, generator)  # noqa: E731
        feats = self.point_feature_extractor(obj_pcds.reshape(b * o, *obj_pcds.shape[2:]))
        obj_embeds = drop(feats.reshape(b, o, -1), 0.1)
        if self.freeze:
            obj_embeds = obj_embeds.detach()

        # the tokenizer: a detached softmax class distribution
        sem_logits = self.point_cls_head(obj_embeds, generator)
        obj_sem_cls = torch.softmax(sem_logits, dim=2).detach()
        if self.mixup_strategy is None:
            mixed = obj_sem_cls
        elif self.mixup_strategy == "all_mixup":
            mixed = all_mixup(obj_sem_cls, obj_labels)
        else:
            if mixup_key is None:
                raise ValueError("mixup_strategy 'linear_decay' draws from mixup_key: pass it")
            mixed = linear_decay_mixup(obj_sem_cls, obj_labels, cur_step, max_steps,
                                       self.mixup_stage1, self.mixup_stage2, mixup_key)

        if self.use_matmul_label:
            sem_embeds = mixed @ self.int2mat
        else:
            sem_embeds = self.int2mat[mixed.argmax(dim=2)]
        sem_embeds = drop(self.sem_cls_norm(self.sem_cls_fc(sem_embeds)), 0.1)
        obj_embeds = obj_embeds + sem_embeds

        # semantic masking: masked objects carry only the mask embedding
        vis = obj_sem_masks.bool()[..., None]
        mask_embed = self.sem_mask_embeddings.weight[0]
        obj_embeds = (torch.where(vis, obj_embeds, 0.0)
                      + torch.where(vis, 0.0, mask_embed.expand_as(obj_embeds)))
        obj_embeds_pre = obj_embeds

        pairwise_locs = calc_pairwise_locs(
            obj_locs[:, :, :3], obj_locs[:, :, 3:], pairwise_rel_type=self.pairwise_rel_type,
            spatial_dist_norm=True, spatial_dim=self.spatial_dim)
        pad = ~obj_masks.bool()
        for layer in self.spatial_layer:
            obj_embeds = obj_embeds + self.loc_norm(self.loc_fc(obj_locs))
            obj_embeds, _ = layer(obj_embeds, pairwise_locs, key_padding_mask=pad,
                                  generator=generator)
        return obj_embeds, obj_embeds_pre, obj_sem_cls

