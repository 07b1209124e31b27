"""Vision-registry adapters: the configs' encoder names → the port's modules.

Counterpart of ``msr3d_tpu/nn/build.py``: ``registry.build_module('vision',
cfg)`` resolves these by ``cfg.name``, and each maps the YAML args onto the
module's arguments as the JAX adapter does, defaults included
(``PCDSwin3DEncoder``'s ``stem_transformer`` is False here, where the
class's default is True). Importing this module also registers SRT's
encoder and decoder (``nn/srt.py``).
"""

from __future__ import annotations

from msr3d_tpu_torch.models.vision2d import Backbone2D as _Backbone2D
from msr3d_tpu_torch.nn.pointbert import PointBERTPcdObjEncoder as _PointBERT
from msr3d_tpu_torch.nn import srt as _srt  # noqa: F401 (registers SRTEncoder, SRTDecoder)
from msr3d_tpu_torch.nn.pointnet import PcdObjEncoder as _PcdObjEncoder
from msr3d_tpu_torch.nn.swin3d import PCDSwin3DEncoder as _PCDSwin3DEncoder
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
    """The sparse-voxel Swin3D UNet, on the GPU unless ``device`` says
    otherwise."""
    args = cfg.args
    return _PCDSwin3DEncoder(
        depths=tuple(args.depths),
        channels=tuple(args.channels),
        num_heads=tuple(args.num_heads),
        window_sizes=tuple(args.window_sizes),
        up_k=args.get("up_k", 3),
        quant_size=args.get("quant_size", 4),
        num_layers=args.get("num_layers", 4),
        num_classes=args.get("num_classes", 13),
        stem_transformer=args.get("stem_transformer", False),
        upsample=args.get("upsample", "deconv"),
        down_stride=args.get("down_stride", 2),
        signal=args.get("signal", True),
        in_channels=args.get("in_channels", 6),
        use_offset=args.get("use_offset", False),
        device=device,
    )


@VISION_REGISTRY.register(name="Backbone2D")
def build_backbone2d(cfg, device=None):
    args = cfg.args
    return _Backbone2D(
        backbone_name=args.get("backbone_name", "convnext_base"),
        pooling=args.get("pooling", "avg"),
        freeze=cfg.get("freeze", True),
        device=device,
    )
