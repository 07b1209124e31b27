"""Vision-registry adapters: the configs' encoder names → the port's modules.

Counterpart of ``msr3d_tpu/nn/build.py``: ``registry.build_module('vision',
cfg)`` resolves these by ``cfg.name``, and each maps the YAML args onto the
module's arguments as the JAX adapter does. ``PCDSwin3DEncoder`` is
registered and raises until ``nn/swin3d.py`` is ported.
"""

from __future__ import annotations

from msr3d_tpu_torch.models.vision2d import Backbone2D as _Backbone2D
from msr3d_tpu_torch.nn.pointbert import PointBERTPcdObjEncoder as _PointBERT
from msr3d_tpu_torch.nn.pointnet import PcdObjEncoder as _PcdObjEncoder
from msr3d_tpu_torch.registry import VISION_REGISTRY


@VISION_REGISTRY.register(name="PcdObjEncoder")
def build_pcd_obj_encoder(cfg, device=None):
    """``args.dropout`` is read by no layer of the JAX module either."""
    args = cfg.args
    return _PcdObjEncoder(
        sa_n_points=tuple(args.sa_n_points),
        sa_n_samples=tuple(args.sa_n_samples),
        sa_radii=tuple(args.sa_radii),
        sa_mlps=tuple(tuple(m) for m in args.sa_mlps),
        freeze=args.get("freeze", True),
        device=device,
    )


@VISION_REGISTRY.register(name="PointBERTPcdObjEncoder")
def build_pointbert_encoder(cfg, device=None):
    args = cfg.args
    return _PointBERT(
        trans_dim=args.trans_dim,
        depth=args.depth,
        num_heads=args.num_heads,
        group_size=args.group_size,
        num_group=args.num_group,
        encoder_dims=args.encoder_dims,
        add_rgb=args.get("add_RGB", True),
        freeze=args.get("freeze", False),
        device=device,
    )


@VISION_REGISTRY.register(name="PCDSwin3DEncoder")
def build_swin3d_encoder(cfg, device=None):
    raise NotImplementedError(
        "PCDSwin3DEncoder (msr3d_tpu/nn/swin3d.py) is not ported yet "
        "(ROADMAP.md, queue 1: modules that no config builds, swin3d)")


@VISION_REGISTRY.register(name="Backbone2D")
def build_backbone2d(cfg, device=None):
    args = cfg.args
    return _Backbone2D(
        backbone_name=args.get("backbone_name", "convnext_base"),
        pooling=args.get("pooling", "avg"),
        freeze=cfg.get("freeze", True),
        device=device,
    )
