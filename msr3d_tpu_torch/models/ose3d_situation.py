"""OSE3DSituation: the object-centric scene prompter.

Counterpart of ``msr3d_tpu/models/ose3d_situation.py``: object point clouds
go through the PointNet++ encoder (kernel K1 inside), get a type and an
orientation embedding, and a stack of spatial attention layers (or plain
encoder layers with ``use_spatial_attn: False``) mixes them. The situation
(the agent's location and orientation) enters in one of six modes:

  * ``as_object``: the anchor is prepended as a token of its own (a learned
    ``anchor_feat``, its location ‖ a learned ``anchor_size``, its
    orientation through ``orientation_encoder``), so N objects give N + 1
    tokens (the LEO configs);
  * ``as_object_add_loc``: the same, with Fourier location and size
    embeddings added as the query position;
  * ``as_embedding``: the situation's Fourier features added to every
    object's query position;
  * ``as_transform_for_objects`` (the flagship's): object centers rotated
    into the agent frame, then Fourier-embedded;
  * ``as_cross_attention``: a ``CrossAttentionLayer`` over the situation
    features before each layer (its memory is unmasked, as in JAX);
  * ``as_dit_attention``: a ``DiTBlock`` conditioned on them before each
    layer (the branch the reference's case mismatch left dead runs, as in
    JAX).

The module creates exactly the parameters the JAX module's flax init
creates for the same options (flax creates a submodule's parameters at its
first call), so ``load_jax_params`` stays strict. Options the JAX module
cannot run raise a ``ValueError`` here.

Masks at this interface are valid-convention (1 = real object). Dropout is
active only in ``train()`` mode and draws from the ``generator`` the caller
passes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from msr3d_tpu_torch.nn.layers import AttFlat
from msr3d_tpu_torch.nn.pointnet import PcdObjEncoder
from msr3d_tpu_torch.nn.transformers import (
    CrossAttentionLayer,
    DiTBlock,
    TransformerEncoderLayer,
    TransformerSpatialEncoderLayer,
)
from msr3d_tpu_torch.ops.geometry import (
    calc_pairwise_locs,
    fourier_feature_dim,
    generate_fourier_features,
    transform_to_agent_coor,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SITUATION_TYPES = (
    "as_object",
    "as_object_add_loc",
    "as_embedding",
    "as_transform_for_objects",
    "as_cross_attention",
    "as_dit_attention",
)
# the modes whose query position is a Fourier location + size embedding
_FOURIER_QUERY_TYPES = ("as_object_add_loc", "as_embedding", "as_transform_for_objects")
_COND_TYPES = ("as_cross_attention", "as_dit_attention")


@dataclasses.dataclass(frozen=True)
class SpatialEncoderConfig:
    dim_loc: int = 6
    num_attention_heads: int = 8
    dim_feedforward: int = 2048
    dropout: float = 0.1
    activation: str = "gelu"
    spatial_multihead: bool = True
    spatial_dim: int = 5
    spatial_dist_norm: bool = True
    spatial_attn_fusion: str = "cond"
    num_layers: int = 3
    obj_loc_encoding: str = "same_all"  # same_0 | same_all | diff_all
    pairwise_rel_type: str = "center"


@dataclasses.dataclass(frozen=True)
class OSE3DConfig:
    hidden_size: int = 256
    situation_type: str = "as_transform_for_objects"
    use_spatial_attn: bool = True
    use_anchor: bool = True  # the anchor as an object: as_object and as_object_add_loc
    use_orientation: bool = True
    # the widths of the Fourier features of the quaternion and of xyz: read
    # from the YAML, and, as in JAX, not used (the layers take 4 + 4·10·2 and
    # 3 + 3·10·2 inputs whatever they say)
    fourier_size: int = 84
    loc_fourier_dim: int = 63
    spatial_encoder: SpatialEncoderConfig = SpatialEncoderConfig()
    sa_n_points: Tuple[Optional[int], ...] = (32, 16, None)
    sa_n_samples: Tuple[Optional[int], ...] = (32, 32, None)
    sa_radii: Tuple[Optional[float], ...] = (0.2, 0.4, None)
    sa_mlps: Tuple[Tuple[int, ...], ...] = (
        (3, 64, 64, 128),
        (128, 128, 128, 256),
        (256, 256, 512, 768),
    )
    vision_dropout: float = 0.1  # the JAX point encoder's semantic head only
    vision_freeze: bool = True  # the point encoder runs without autograd
    # the reference runs the frozen point encoder under bf16 autocast and
    # the spatial encoder in fp32; the parity tests pin "float32"
    obj_encoder_dtype: str = "bfloat16"
    # the AttFlat pooling of the object tokens into one (B, out) vector (off
    # in every shipped config; the network cannot splice it)
    use_attn_flat: bool = False
    attn_flat_mlp_size: int = 512
    attn_flat_glimpses: int = 1
    attn_flat_out_size: int = 1024

    @staticmethod
    def from_config(cfg) -> "OSE3DConfig":
        """From the YAML's ``model.prompter.model`` node, as the JAX
        package reads it (the point encoder's dtype keeps its default)."""
        se = cfg.spatial_encoder
        vision_args = cfg.vision.args
        return OSE3DConfig(
            hidden_size=cfg.hidden_size,
            situation_type=cfg.get("situation_type", "as_object"),
            use_spatial_attn=cfg.use_spatial_attn,
            use_anchor=cfg.use_anchor,
            use_orientation=cfg.use_orientation,
            fourier_size=cfg.fourier_size,
            loc_fourier_dim=cfg.get("loc_fourier_dim", 63),
            spatial_encoder=SpatialEncoderConfig(
                dim_loc=se.dim_loc,
                num_attention_heads=se.num_attention_heads,
                dim_feedforward=se.dim_feedforward,
                dropout=se.dropout,
                activation=se.activation,
                spatial_multihead=se.spatial_multihead,
                spatial_dim=se.spatial_dim,
                spatial_dist_norm=se.spatial_dist_norm,
                spatial_attn_fusion=se.spatial_attn_fusion,
                num_layers=se.num_layers,
                obj_loc_encoding=se.obj_loc_encoding,
                pairwise_rel_type=se.pairwise_rel_type,
            ),
            sa_n_points=tuple(vision_args.sa_n_points),
            sa_n_samples=tuple(vision_args.sa_n_samples),
            sa_radii=tuple(vision_args.sa_radii),
            sa_mlps=tuple(tuple(m) for m in vision_args.sa_mlps),
            vision_dropout=vision_args.get("dropout", 0.1),
            vision_freeze=vision_args.get("freeze", True),
            use_attn_flat=cfg.attn_flat.use_attn_flat,
            attn_flat_mlp_size=cfg.attn_flat.mcan_flat_mlp_size,
            attn_flat_glimpses=cfg.attn_flat.mcan_flat_glimpses,
            attn_flat_out_size=cfg.attn_flat.mcan_flat_out_size,
        )


class LocLayer(nn.Module):
    """Linear + LayerNorm location embedding."""

    def __init__(self, in_features: int, hidden_size: int, device=None):
        super().__init__()
        self.dense = nn.Linear(in_features, hidden_size, device=device)
        self.norm = nn.LayerNorm(hidden_size, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.dense(x))


def _uses_situation_feature(cfg: OSE3DConfig) -> bool:
    """The per-token situation feature (the anchor's location ‖
    orientation): the conditioning modes' memory, or ``as_embedding``'s
    query position outside ``diff_all``."""
    return cfg.situation_type in _COND_TYPES or (
        cfg.situation_type == "as_embedding"
        and cfg.spatial_encoder.obj_loc_encoding != "diff_all")


def check_situation_options(cfg: OSE3DConfig) -> None:
    """Raise a ValueError on the options the JAX module cannot run."""
    se = cfg.spatial_encoder
    if cfg.situation_type not in SITUATION_TYPES:
        raise ValueError(f"situation_type={cfg.situation_type!r}: not one of {SITUATION_TYPES}")
    if se.obj_loc_encoding not in ("same_0", "same_all", "diff_all"):
        raise ValueError(f"obj_loc_encoding={se.obj_loc_encoding!r}")
    if _uses_situation_feature(cfg) and not cfg.use_orientation:
        raise ValueError(
            f"situation_type={cfg.situation_type!r} with use_orientation: False: the "
            "situation feature encodes the anchor's orientation through orientation_encoder, "
            "which exists only with use_orientation (the JAX module fails with a NameError)")


class OSE3DSituation(nn.Module):
    def __init__(self, cfg: OSE3DConfig, device=None):
        super().__init__()
        check_situation_options(cfg)
        se = cfg.spatial_encoder
        self.cfg = cfg
        h = cfg.hidden_size
        kind = cfg.situation_type
        diff_all = se.obj_loc_encoding == "diff_all"
        self.prepend_anchor = cfg.use_anchor and kind in ("as_object", "as_object_add_loc")
        self.obj_encoder = PcdObjEncoder(
            cfg.sa_n_points, cfg.sa_n_samples, cfg.sa_radii, cfg.sa_mlps,
            compute_dtype=_DTYPES[cfg.obj_encoder_dtype], freeze=cfg.vision_freeze,
            device=device,
        )
        self.obj_linear_projection = nn.Linear(cfg.sa_mlps[-1][-1], h, device=device)
        self.object_type_embedding = nn.Embedding(2, h, device=device)
        if cfg.use_orientation:
            self.object_orientation_feat = nn.Parameter(torch.zeros(1, 1, h, device=device))
        if self.prepend_anchor:
            self.anchor_feat = nn.Parameter(torch.zeros(1, 1, h, device=device))
            self.anchor_size = nn.Parameter(torch.ones(1, 1, 3, device=device))
        self.uses_situation_feature = _uses_situation_feature(cfg)
        if cfg.use_orientation and (self.prepend_anchor or self.uses_situation_feature):
            self.orientation_encoder = nn.Linear(fourier_feature_dim(4), h, device=device)
        self.fourier_query_pos = kind in _FOURIER_QUERY_TYPES and not diff_all
        if self.fourier_query_pos or self.uses_situation_feature:
            self.loc_embedding_encoder = LocLayer(fourier_feature_dim(3), h, device)
        if self.fourier_query_pos:
            self.size_embedding_encoder = LocLayer(3, h, device)
        n_loc = se.num_layers if diff_all else (0 if self.fourier_query_pos else 1)
        if n_loc:
            self.loc_layer = nn.ModuleList(LocLayer(6, h, device) for _ in range(n_loc))
        if kind == "as_cross_attention":
            self.situation_condition = nn.ModuleList(
                CrossAttentionLayer(h, se.num_attention_heads, se.dim_feedforward, se.dropout,
                                    se.activation, device=device)
                for _ in range(se.num_layers))
        elif kind == "as_dit_attention":
            self.situation_condition = nn.ModuleList(
                DiTBlock(h, se.num_attention_heads, device=device)
                for _ in range(se.num_layers))
        if cfg.use_spatial_attn:
            loc_dim = 12 if se.pairwise_rel_type == "mlp" else se.spatial_dim
            self.spatial_layer = nn.ModuleList(
                TransformerSpatialEncoderLayer(
                    h, se.num_attention_heads, se.dim_feedforward, se.activation,
                    se.spatial_multihead, se.spatial_dim, se.spatial_attn_fusion, se.dropout,
                    device, loc_dim,
                )
                for _ in range(se.num_layers)
            )
        else:
            self.spatial_layer = nn.ModuleList(
                TransformerEncoderLayer(h, se.num_attention_heads, se.dim_feedforward,
                                        se.dropout, se.activation, device=device)
                for _ in range(se.num_layers)
            )
        if cfg.use_attn_flat:
            self.attflat_visual = AttFlat(h, cfg.attn_flat_mlp_size, cfg.attn_flat_glimpses,
                                          cfg.attn_flat_out_size, pdrop=0.1, device=device)

    def _orientation(self, quat: torch.Tensor) -> torch.Tensor:
        return self.orientation_encoder(generate_fourier_features(quat))

    def forward(
        self,
        obj_fts: torch.Tensor,  # (B, N, P, 6) object point clouds
        obj_masks: torch.Tensor,  # (B, N) 1 = valid
        obj_locs: torch.Tensor,  # (B, N, 6) center ‖ size
        anchor_locs: torch.Tensor,  # (B, 3)
        anchor_orientation: torch.Tensor,  # (B, 4) xyzw
        generator: Optional[torch.Generator] = None,  # dropout in train() mode
        precomputed_obj_embeds: Optional[torch.Tensor] = None,  # (B, N, D) skips the encoder
    ) -> Dict[str, torch.Tensor]:
        """{"obj_tokens": (B, N', H), "obj_masks": (B, N')}, N' = N + 1 when
        the anchor is a token; with ``use_attn_flat`` "obj_tokens" is the
        pooled (B, out) and "oatt" the pooling weights (B, N', G)."""
        cfg = self.cfg
        se = cfg.spatial_encoder
        kind = cfg.situation_type
        obj_embeds = (self.obj_encoder(obj_fts) if precomputed_obj_embeds is None
                      else precomputed_obj_embeds)
        feat = self.obj_linear_projection(obj_embeds)
        pad = ~obj_masks.bool()
        b, n, h = feat.shape
        type_weight = self.object_type_embedding.weight
        all_type = type_weight[0].expand(b, n, h)
        all_loc = obj_locs
        if cfg.use_orientation:
            all_ori = self.object_orientation_feat.expand(b, n, h)
        if self.prepend_anchor:
            anchor_size = self.anchor_size.detach().expand(b, 1, 3)  # no gradient, as in JAX
            all_loc = torch.cat([torch.cat([anchor_locs[:, None, :], anchor_size], dim=-1),
                                 obj_locs], dim=1)
            feat = torch.cat([self.anchor_feat.expand(b, 1, h), feat], dim=1)
            pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
            all_type = torch.cat([type_weight[1].expand(b, 1, h), all_type], dim=1)
            if cfg.use_orientation:
                all_ori = torch.cat([self._orientation(anchor_orientation[:, None, :]),
                                     all_ori], dim=1)
        feat = feat + all_ori + all_type if cfg.use_orientation else feat + all_type
        n_all = all_loc.shape[1]
        centers, sizes = all_loc[..., :3], all_loc[..., 3:]

        if cfg.use_spatial_attn:
            pairwise_locs = calc_pairwise_locs(
                centers, sizes, pairwise_rel_type=se.pairwise_rel_type,
                spatial_dist_norm=se.spatial_dist_norm, spatial_dim=se.spatial_dim,
            )
        situation = None
        if self.uses_situation_feature:
            sit_loc = anchor_locs[:, None, :].expand(b, n_all, 3)
            sit_ori = anchor_orientation[:, None, :].expand(b, n_all, 4)
            situation = (self.loc_embedding_encoder(generate_fourier_features(sit_loc))
                         + self._orientation(sit_ori))
        # outside diff_all the query position is the same for every layer
        query_pos = None
        if self.fourier_query_pos:
            if kind == "as_transform_for_objects":
                centers = transform_to_agent_coor(centers, anchor_locs, anchor_orientation)
            query_pos = (self.loc_embedding_encoder(generate_fourier_features(centers))
                         + self.size_embedding_encoder(sizes))
            if kind == "as_embedding":
                query_pos = query_pos + situation
        elif se.obj_loc_encoding != "diff_all":
            query_pos = self.loc_layer[0](all_loc)

        attn_out = None
        for i, layer in enumerate(self.spatial_layer):
            if se.obj_loc_encoding == "diff_all":
                feat = feat + self.loc_layer[i](all_loc)
            elif se.obj_loc_encoding == "same_all" or i == 0:
                feat = feat + query_pos
            if kind == "as_cross_attention":
                # JAX passes the object mask as tgt_key_padding_mask, which
                # the layer never reads: the situation memory is unmasked
                feat, _ = self.situation_condition[i](feat, situation, generator=generator)
            elif kind == "as_dit_attention":
                feat = self.situation_condition[i](feat, situation)
            if cfg.use_spatial_attn:
                feat, attn_out = layer(feat, pairwise_locs, pad, generator)
            else:
                feat, attn_out = layer(feat, pad, generator)

        out: Dict[str, torch.Tensor] = {}
        if cfg.use_attn_flat:
            out["obj_tokens"], out["oatt"] = self.attflat_visual(feat, pad, generator)
        else:
            out["obj_tokens"] = feat
        out["obj_masks"] = ~pad
        return out
