"""2D image backbone (ConvNeXt) and its pooling, ``Backbone2D``.

Counterpart of ``msr3d_tpu/models/vision2d.py``: depthwise 7x7 + LayerNorm
+ pointwise MLP blocks with a per-channel layer scale ``gamma``, stages
3/3/27/3 at dims 128/256/512/1024 for ``convnext_base``, a 4x4 stride-4 stem
and 2x2 stride-2 downsampling convs with flax's default ``padding="SAME"``,
LayerNorm eps 1e-6, exact GELU, all in fp32 (flax's default dtypes).

Layout: images come in NHWC, as in the JAX package, and activations stay
NHWC (channels last), so LayerNorm and the pointwise MLP act on the last
axis. Each convolution sees a ``permute(0, 3, 1, 2)`` view of the NHWC
tensor: NCHW shape with channels-last strides, which cuDNN runs without a
copy, and its output is permuted back the same way. SAME padding is applied
explicitly: ``total = max((ceil(n/s) - 1)·s + k - n, 0)``, ``total // 2``
before and the rest after (``F.conv2d``'s own padding is symmetric).

``freeze`` is the JAX ``stop_gradient`` on the backbone's features: the
backbone then runs without autograd, so a training step keeps no graph of
it. The port's network never trains the image encoder (pooling layers
included); see ``MSR3D.trainable_parameter_names``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CONVNEXT_SPECS = {
    # name: (depths, dims)
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    # tiny config for tests
    "convnext_test": ((1, 1, 1, 1), (8, 16, 32, 64)),
}


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of flax's ``padding="SAME"`` along one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC tensor → NHWC (channels-last views, no copy)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SameConv2d(nn.Conv2d):
    """A stride-``k`` patch conv with flax's SAME padding, NHWC in and out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[1], kh, sh)
        left, right = _same_pads(x.shape[2], kw, sw)
        if top or bottom or left or right:
            x = F.pad(x, (0, 0, left, right, top, bottom))
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6, device=None):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, device=device)
        self.norm = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.pwconv1 = nn.Linear(dim, 4 * dim, device=device)
        self.pwconv2 = nn.Linear(4 * dim, dim, device=device)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        h = self.norm(_conv_nhwc(self.dwconv, x))
        h = self.pwconv2(F.gelu(self.pwconv1(h), approximate="none"))
        return x + self.gamma * h


class ConvNeXt(nn.Module):
    """(B, H, W, 3) → (B, ⌈H/32⌉, ⌈W/32⌉, dims[-1]). Module names follow the
    flax tree through ``msr3d_tpu_torch.convert`` (``stage_2_block_5`` is
    entry 5 of ``stage_2_block``; ``downsample_*`` entry 0 is empty)."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int], device=None):
        super().__init__()
        self.stem_conv = SameConv2d(3, dims[0], 4, stride=4, device=device)
        self.stem_norm = nn.LayerNorm(dims[0], eps=1e-6, device=device)
        self.downsample_norm = nn.ModuleList(
            [nn.Identity()] + [nn.LayerNorm(dims[s - 1], eps=1e-6, device=device)
                               for s in range(1, 4)])
        self.downsample_conv = nn.ModuleList(
            [nn.Identity()] + [SameConv2d(dims[s - 1], dims[s], 2, stride=2, device=device)
                               for s in range(1, 4)])
        for s in range(4):
            setattr(self, f"stage_{s}_block", nn.ModuleList(
                ConvNeXtBlock(dims[s], device=device) for _ in range(depths[s])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(self.stem_conv(x))
        for s in range(4):
            if s > 0:
                x = self.downsample_conv[s](self.downsample_norm[s](x))
            for block in getattr(self, f"stage_{s}_block"):
                x = block(x)
        return x


class Backbone2D(nn.Module):
    """Image backbone + pooling. Images NHWC fp32, normalized by the data
    pipeline. Output (B, out_channels) for ``avg``, ``conv`` and ``attn``
    pooling (one token an image), (B, H'·W', C) for ``none``."""

    def __init__(self, backbone_name: str = "convnext_base", pooling: str = "avg",
                 freeze: bool = True, device=None):
        super().__init__()
        if pooling == "attention":
            pooling = "attn"
        if pooling not in ("avg", "conv", "attn", "none"):
            raise NotImplementedError(f"pooling {pooling!r}")
        self.backbone_name, self.pooling, self.freeze = backbone_name, pooling, freeze
        depths, dims = CONVNEXT_SPECS[backbone_name]
        self.backbone = ConvNeXt(depths, dims, device)
        c = dims[-1]
        if pooling == "conv":
            self.pool_conv1 = nn.Linear(c, 64, device=device)
            self.pool_conv2 = nn.Linear(64, 32, device=device)
        elif pooling == "attn":
            self.attn_conv1 = nn.Linear(c, c, device=device)
            self.attn_conv2 = nn.Linear(c, c, device=device)

    @property
    def out_channels(self) -> int:
        if self.pooling == "conv":
            return 32 * 7 * 7  # the reference hard-codes 7x7 maps (224² images)
        return CONVNEXT_SPECS[self.backbone_name][1][-1]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze):
            feats = self.backbone(images)  # (B, H, W, C)
        b, h, w, c = feats.shape
        if self.pooling == "avg":
            return feats.mean(dim=(1, 2))
        if self.pooling == "conv":  # 1x1 conv stack, then flatten
            return self.pool_conv2(F.relu(self.pool_conv1(feats))).reshape(b, -1)
        if self.pooling == "attn":  # softmax over H·W per channel, weighted sum
            attn = self.attn_conv2(F.relu(self.attn_conv1(feats)))
            attn = torch.softmax(attn.reshape(b, h * w, c), dim=1)
            return torch.einsum("bnc,bnc->bc", feats.reshape(b, h * w, c), attn)
        return feats.reshape(b, h * w, c)


def convert_convnext_state_dict(sd: Dict[str, Any], depths: Sequence[int]) -> Dict[str, Any]:
    """timm ConvNeXt state dict → the JAX package's flax-layout tree of the
    backbone (``{"backbone": ...}``, numpy fp32), which
    ``models/load_weights.py`` overlays through ``msr3d_tpu_torch.convert``.

    timm names: stem.0/stem.1, stages.{s}.blocks.{b}.{conv_dw, norm, mlp.fc1,
    mlp.fc2, gamma}, stages.{s}.downsample.{0,1}; some checkpoints name the
    block's layers dwconv/pwconv1/pwconv2. A torch conv weight (O, I, kh,
    kw) becomes flax's (kh, kw, I, O); a depthwise (O, 1, kh, kw) becomes
    (kh, kw, 1, O)."""

    def _np(t):
        if isinstance(t, np.ndarray):
            return t
        return t.detach().cpu().float().numpy()

    def conv(name):
        out = {"kernel": np.transpose(_np(sd[f"{name}.weight"]), (2, 3, 1, 0))}
        if f"{name}.bias" in sd:
            out["bias"] = _np(sd[f"{name}.bias"])
        return out

    def ln(name):
        return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}

    def dense(name):
        return {"kernel": _np(sd[f"{name}.weight"]).T, "bias": _np(sd[f"{name}.bias"])}

    params: Dict[str, Any] = {"stem_conv": conv("stem.0"), "stem_norm": ln("stem.1")}
    for s in range(4):
        if s > 0:
            params[f"downsample_norm_{s}"] = ln(f"stages.{s}.downsample.0")
            params[f"downsample_conv_{s}"] = conv(f"stages.{s}.downsample.1")
        for b in range(depths[s]):
            base = f"stages.{s}.blocks.{b}"
            dw = "conv_dw" if f"{base}.conv_dw.weight" in sd else "dwconv"
            mlp1 = "mlp.fc1" if f"{base}.mlp.fc1.weight" in sd else "pwconv1"
            mlp2 = "mlp.fc2" if f"{base}.mlp.fc2.weight" in sd else "pwconv2"
            params[f"stage_{s}_block_{b}"] = {
                "dwconv": conv(f"{base}.{dw}"),
                "norm": ln(f"{base}.norm"),
                "pwconv1": dense(f"{base}.{mlp1}"),
                "pwconv2": dense(f"{base}.{mlp2}"),
                "gamma": _np(sd[f"{base}.gamma"]),
            }
    return {"backbone": params}
