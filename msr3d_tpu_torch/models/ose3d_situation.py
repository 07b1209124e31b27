"""OSE3DSituation: the object-centric scene prompter.

Counterpart of ``msr3d_tpu/models/ose3d_situation.py`` in the flagship's
situation mode ``as_transform_for_objects``: object point clouds go
through the PointNet++ encoder (kernel K1 inside), object centers are
rotated into the agent frame and Fourier-embedded, and three spatial
attention layers in ``cond`` fusion mix the objects. The other situation
modes raise and are queued in ROADMAP.md.

Masks at this interface are valid-convention (1 = real object). The
spatial layers' dropout is active only in ``train()`` mode and draws from
the ``generator`` the caller passes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from msr3d_tpu_torch.nn.pointnet import PcdObjEncoder
from msr3d_tpu_torch.nn.transformers import TransformerSpatialEncoderLayer
from msr3d_tpu_torch.ops.geometry import (
    calc_pairwise_locs,
    generate_fourier_features,
    transform_to_agent_coor,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    obj_loc_encoding: str = "same_all"  # same_0 | same_all
    pairwise_rel_type: str = "center"


@dataclasses.dataclass(frozen=True)
class OSE3DConfig:
    hidden_size: int = 256
    situation_type: str = "as_transform_for_objects"
    use_spatial_attn: bool = True
    use_anchor: bool = True  # the anchor as an object: the other situation modes only
    use_orientation: bool = True
    fourier_size: int = 84  # Fourier features of the quaternion: the other modes only
    loc_fourier_dim: int = 63  # Fourier features of xyz: 3 + 3·10·2
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
    # the AttFlat pooling of the object tokens (off in every shipped config)
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


class OSE3DSituation(nn.Module):
    def __init__(self, cfg: OSE3DConfig, device=None):
        super().__init__()
        se = cfg.spatial_encoder
        if cfg.situation_type != "as_transform_for_objects":
            raise NotImplementedError(
                f"situation_type={cfg.situation_type!r}: only "
                "'as_transform_for_objects' is ported (see ROADMAP.md)"
            )
        if not (cfg.use_spatial_attn and cfg.use_orientation):
            raise NotImplementedError("only use_spatial_attn=use_orientation=True is ported")
        if cfg.use_attn_flat:
            raise NotImplementedError("use_attn_flat (AttFlat) is not ported yet (see ROADMAP.md)")
        if se.obj_loc_encoding not in ("same_0", "same_all"):
            raise NotImplementedError(f"obj_loc_encoding={se.obj_loc_encoding!r}")
        self.cfg = cfg
        h = cfg.hidden_size
        self.obj_encoder = PcdObjEncoder(
            cfg.sa_n_points, cfg.sa_n_samples, cfg.sa_radii, cfg.sa_mlps,
            compute_dtype=_DTYPES[cfg.obj_encoder_dtype], freeze=cfg.vision_freeze,
            device=device,
        )
        self.obj_linear_projection = nn.Linear(cfg.sa_mlps[-1][-1], h, device=device)
        self.object_type_embedding = nn.Embedding(2, h, device=device)
        self.object_orientation_feat = nn.Parameter(torch.zeros(1, 1, h, device=device))
        self.loc_embedding_encoder = LocLayer(cfg.loc_fourier_dim, h, device)
        self.size_embedding_encoder = LocLayer(3, h, device)
        self.spatial_layer = nn.ModuleList(
            TransformerSpatialEncoderLayer(
                h, se.num_attention_heads, se.dim_feedforward, se.activation,
                se.spatial_multihead, se.spatial_dim, se.spatial_attn_fusion, se.dropout,
                device,
            )
            for _ in range(se.num_layers)
        )

    def forward(
        self,
        obj_fts: torch.Tensor,  # (B, N, P, 6) object point clouds
        obj_masks: torch.Tensor,  # (B, N) 1 = valid
        obj_locs: torch.Tensor,  # (B, N, 6) center ‖ size
        anchor_locs: torch.Tensor,  # (B, 3)
        anchor_orientation: torch.Tensor,  # (B, 4) xyzw
        generator: Optional[torch.Generator] = None,  # dropout in train() mode
    ) -> Dict[str, torch.Tensor]:
        se = self.cfg.spatial_encoder
        object_feat = self.obj_linear_projection(self.obj_encoder(obj_fts))
        pad = ~obj_masks.bool()
        b, n, h = object_feat.shape
        type_embed = self.object_type_embedding.weight[0].expand(b, n, h)
        feat = object_feat + self.object_orientation_feat.expand(b, n, h) + type_embed

        centers, sizes = obj_locs[..., :3], obj_locs[..., 3:]
        pairwise_locs = calc_pairwise_locs(
            centers, sizes, pairwise_rel_type=se.pairwise_rel_type,
            spatial_dist_norm=se.spatial_dist_norm, spatial_dim=se.spatial_dim,
        )
        # the query position is the same for every layer: compute it once
        transformed = transform_to_agent_coor(centers, anchor_locs, anchor_orientation)
        query_pos = self.loc_embedding_encoder(
            generate_fourier_features(transformed)
        ) + self.size_embedding_encoder(sizes)
        for i, layer in enumerate(self.spatial_layer):
            if se.obj_loc_encoding == "same_all" or i == 0:
                feat = feat + query_pos
            feat, _ = layer(feat, pairwise_locs, pad, generator)
        return {"obj_tokens": feat, "obj_masks": ~pad}
