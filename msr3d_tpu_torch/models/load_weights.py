"""Pretrained weights → the port's ``MSR3DNetwork``: HF Llama checkpoints,
PEFT adapters, timm ConvNeXt checkpoints, the reference's PointNet++
``pointnetpp.pt`` and learnable-only scene-encoder ``best.pth`` /
``pytorch_model.bin``, and ``load_pretrained_from_config``, which loads what
a YAML config names.

Counterpart of ``msr3d_tpu/models/load_weights.py``. The JAX functions
overlay a flax variables tree; these overlay the network's parameters and
buffers, through flax-layout trees (``models/llm/convert.py``,
``models/vision2d.py`` and the torch-module converters below, copies of
``msr3d_tpu/utils/torch_convert.py``'s) and the names of
``msr3d_tpu_torch.convert``. As in JAX, only entries the network has are
written (shape-checked, cast to the destination's dtype and device);
anything absent keeps its value.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from msr3d_tpu_torch.convert import _flatten, torch_name
from msr3d_tpu_torch.models.llm.convert import (
    _safetensors_tensors,
    load_hf_checkpoint,
    merge_peft_lora,
    quantize_llm_params,
)
from msr3d_tpu_torch.models.vision2d import CONVNEXT_SPECS, convert_convnext_state_dict


@torch.no_grad()
def _overlay(network: torch.nn.Module, module: str, params: Dict[str, Any],
             collection: str = "params") -> None:
    """Copy a flax-layout tree of ``network.<module>`` (``module`` a
    ``/``-path) into the network where names match; leaves the network does
    not have are skipped, as the JAX overlay skips keys its tree lacks. A
    ``kernel_scale`` lands rounded to bf16, the dtype the JAX model tree
    stores it in (its overlay casts to that), so a loaded quantized model
    equals the JAX one loaded from the same checkpoint."""
    targets = dict(network.named_parameters())
    targets.update(network.named_buffers())
    for path, value in _flatten(params).items():
        if value is None:
            continue
        try:
            name, transpose = torch_name(f"{collection}/{module}/{path}")
        except KeyError:
            continue
        if name not in targets:
            continue
        value = torch.as_tensor(value)
        if transpose:  # Dense (in, out) → (out, in); Conv (kh, kw, I, O) → (O, I, kh, kw)
            value = value.permute(3, 2, 0, 1) if value.dim() == 4 else value.t()
        if path.endswith("kernel_scale"):
            value = value.to(torch.bfloat16)
        dst = targets[name]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch at {name}: checkpoint {tuple(value.shape)} vs "
                             f"model {tuple(dst.shape)}")
        dst.copy_(value)


def load_llm_weights(network: torch.nn.Module, cfg_path, llm_cfg,
                     dtype: torch.dtype = torch.float32) -> None:
    """Overlay HF Llama weights into ``network.llm`` in place. With a
    quantized serving config (``llm_cfg.quantize``) the network holds
    ``weight_q``/``weight_scale`` buffers, so the checkpoint's kernels are
    quantized to that layout first (without it every projection would be
    skipped, leaving random base weights)."""
    _, params = load_hf_checkpoint(cfg_path, dtype=dtype)
    if llm_cfg.quantize:
        params = quantize_llm_params(params, llm_cfg)
    _overlay(network, "llm", params)
    got = network.llm.embed_tokens.weight[:1, :4].float().cpu()
    want = params["embed_tokens"]["embedding"][:1, :4].float()
    if not torch.allclose(got, want, atol=1e-2):
        raise RuntimeError("LLM overlay failed to land")


def load_peft_lora(network: torch.nn.Module, adapter_path) -> None:
    """Overlay a PEFT adapter's lora_A/lora_B into ``network.llm`` in place.
    ``adapter_path`` is the adapter file or the directory holding
    ``adapter_model.*`` (``.safetensors`` or a torch ``.bin``)."""
    path = Path(adapter_path)
    if path.is_dir():
        candidates = sorted(path.glob("adapter_model.*"))
        if not candidates:
            raise FileNotFoundError(f"no adapter_model.* under {path}")
        path = candidates[0]
    if path.suffix == ".safetensors":
        sd = dict(_safetensors_tensors(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    _overlay(network, "llm", merge_peft_lora({}, sd))


def load_convnext_weights(network: torch.nn.Module, path, depths) -> None:
    """Overlay a local timm ConvNeXt checkpoint (a state dict saved with
    ``torch.save``) into ``network.image_encoder`` in place. The prefixes
    ``model.`` and ``module.`` are stripped; the block layers may carry
    timm's names (``conv_dw``, ``mlp.fc1``, ``mlp.fc2``) or ``dwconv``,
    ``pwconv1``, ``pwconv2``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.replace("model.", "").replace("module.", ""): v for k, v in sd.items()}
    _overlay(network, "image_encoder", convert_convnext_state_dict(sd, depths))


# -- the reference's torch modules → flax-layout trees ------------------------


def _t2n(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()


def _linear(sd: Dict[str, Any], name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t2n(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["bias"] = _t2n(sd[f"{name}.bias"])
    return out


def _conv1x1(sd: Dict[str, Any], name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t2n(sd[f"{name}.weight"])[:, :, 0, 0].T}  # (out, in, 1, 1)
    if f"{name}.bias" in sd:
        out["bias"] = _t2n(sd[f"{name}.bias"])
    return out


def _layernorm(sd: Dict[str, Any], name: str) -> Dict[str, np.ndarray]:
    return {"scale": _t2n(sd[f"{name}.weight"]), "bias": _t2n(sd[f"{name}.bias"])}


def _batchnorm(sd: Dict[str, Any], name: str):
    params = {"scale": _t2n(sd[f"{name}.weight"]), "bias": _t2n(sd[f"{name}.bias"])}
    stats = {"mean": _t2n(sd[f"{name}.running_mean"]), "var": _t2n(sd[f"{name}.running_var"])}
    return params, stats


def _spatial_attention(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    p = {
        "w_qs": _linear(sd, f"{prefix}w_qs"),
        "w_ks": _linear(sd, f"{prefix}w_ks"),
        "w_vs": _linear(sd, f"{prefix}w_vs"),
        "fc": _linear(sd, f"{prefix}fc"),
        "layer_norm": _layernorm(sd, f"{prefix}layer_norm"),
    }
    for extra in ("lang_cond_fc", "pairwise_loc_fc"):
        if f"{prefix}{extra}.weight" in sd:
            p[extra] = _linear(sd, f"{prefix}{extra}")
    return p


def _spatial_encoder_layer(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        "self_attn": _spatial_attention(sd, f"{prefix}self_attn."),
        "ffn": {"linear1": _linear(sd, f"{prefix}linear1"),
                "linear2": _linear(sd, f"{prefix}linear2")},
        "norm1": _layernorm(sd, f"{prefix}norm1"),
        "norm2": _layernorm(sd, f"{prefix}norm2"),
    }


def _pointnetpp(sd: Dict[str, Any], sa_mlps, prefix: str = "") -> Dict[str, Any]:
    """The reference PointNetPP (``{prefix}encoder.{i}.mlps.0.layer{j}.conv``
    / ``.bn.bn`` and ``{prefix}fc``) → {"params", "batch_stats"}."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i, mlp in enumerate(sa_mlps):
        p, st = {}, {}
        for j in range(len(mlp) - 1):
            layer = f"{prefix}encoder.{i}.mlps.0.layer{j}"
            p[f"dense_{j}"] = _conv1x1(sd, f"{layer}.conv")
            p[f"bn_{j}"], st[f"bn_{j}"] = _batchnorm(sd, f"{layer}.bn.bn")
        params[f"sa_{i}"] = {"mlp": p}
        stats[f"sa_{i}"] = {"mlp": st}
    params["fc"] = _linear(sd, f"{prefix}fc")
    return {"params": params, "batch_stats": stats}


def _pcd_obj_encoder(sd: Dict[str, Any], sa_mlps) -> Dict[str, Any]:
    """The reference PcdObjEncoder (``pcd_net.*`` and the semantic head
    ``obj3d_clf_pre_head.{0,2,4}``, which the port does not run)."""
    inner = _pointnetpp(sd, sa_mlps, prefix="pcd_net.")
    params: Dict[str, Any] = {"pcd_net": inner["params"]}
    if "obj3d_clf_pre_head.0.weight" in sd:
        params["sem_head"] = {
            "fc1": _linear(sd, "obj3d_clf_pre_head.0"),
            "norm": _layernorm(sd, "obj3d_clf_pre_head.2"),
            "fc2": _linear(sd, "obj3d_clf_pre_head.4"),
        }
    return {"params": params, "batch_stats": {"pcd_net": inner["batch_stats"]}}


def _torch_load(path) -> Dict[str, Any]:
    """A reference checkpoint: a state dict, or a module saved whole."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_pointnet_weights(network: torch.nn.Module, path, sa_mlps) -> None:
    """A reference ``pointnetpp.pt``-style state dict → the point encoder
    (``visual_prompter.obj_encoder``): parameters and BatchNorm statistics.
    Takes a bare PointNetPP state dict or a PcdObjEncoder one (keys
    prefixed ``pcd_net.``)."""
    sd = _torch_load(path)
    if any(k.startswith("pcd_net.") for k in sd):
        tree = _pcd_obj_encoder(sd, sa_mlps)
    else:
        inner = _pointnetpp(sd, sa_mlps)
        tree = {"params": {"pcd_net": inner["params"]},
                "batch_stats": {"pcd_net": inner["batch_stats"]}}
    module = "visual_prompter/obj_encoder"
    _overlay(network, module, tree["params"])
    _overlay(network, module, tree["batch_stats"], collection="batch_stats")


def _convert_prompter_state(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The ``visual_prompter.*`` keys of a reference checkpoint → the
    prompter's flax-layout tree."""
    pre = "visual_prompter."
    sub = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    out: Dict[str, Any] = {}
    if not sub:
        return out
    if "obj_linear_projection.weight" in sub:
        out["obj_linear_projection"] = _linear(sub, "obj_linear_projection")
    if "object_type_embedding.weight" in sub:
        out["object_type_embedding"] = {"embedding": _t2n(sub["object_type_embedding.weight"])}
    if "orientation_encoder.weight" in sub:
        out["orientation_encoder"] = _linear(sub, "orientation_encoder")
    for p in ("object_orientation_feat", "anchor_feat", "anchor_size"):
        if p in sub:
            out[p] = _t2n(sub[p])
    i = 0
    while f"loc_layers.{i}.0.weight" in sub:
        out[f"loc_layer_{i}"] = {"dense": _linear(sub, f"loc_layers.{i}.0"),
                                 "norm": _layernorm(sub, f"loc_layers.{i}.1")}
        i += 1
    for enc in ("loc_embedding_encoder", "size_embedding_encoder"):
        if f"{enc}.0.weight" in sub:
            out[enc] = {"dense": _linear(sub, f"{enc}.0"), "norm": _layernorm(sub, f"{enc}.1")}
    i = 0
    while f"spatial_encoder.{i}.self_attn.w_qs.weight" in sub:
        out[f"spatial_layer_{i}"] = _spatial_encoder_layer(sub, f"spatial_encoder.{i}.")
        i += 1
    return out


def load_scene_encoder_weights(network: torch.nn.Module, path) -> None:
    """A reference learnable-only ``best.pth`` / ``pytorch_model.bin`` (the
    prompter, ``llm_proj``, ``llm_proj_img``) → the matching modules
    (``module.`` prefixes stripped). Its LoRA entries are not read, as in
    JAX."""
    sd = {k.replace("module.", ""): v for k, v in _torch_load(path).items()}
    _overlay(network, "visual_prompter", _convert_prompter_state(sd))
    for name in ("llm_proj", "llm_proj_img"):
        if f"{name}.weight" in sd:
            _overlay(network, name, _linear(sd, name))


def load_all(model, *, llm_path: str = "", lora_path: str = "", pointnet_path: str = "",
             scene_encoder_path: str = "", convnext_path: str = "") -> None:
    """Every named checkpoint into ``model.network`` in place, in JAX's
    order: LLM, PEFT adapter, PointNet++, scene encoder, ConvNeXt."""
    network = model.network
    if llm_path:
        load_llm_weights(network, llm_path, model.cfg.llm, dtype=model.cfg.llm.param_dtype)
    if lora_path:
        load_peft_lora(network, lora_path)
    if pointnet_path:
        load_pointnet_weights(network, pointnet_path, model.cfg.prompter.sa_mlps)
    if scene_encoder_path:
        load_scene_encoder_weights(network, scene_encoder_path)
    if convnext_path:
        load_convnext_weights(network, convnext_path, CONVNEXT_SPECS[model.cfg.backbone_name][0])


def load_pretrained_from_config(model, cfg) -> list:
    """Load the checkpoints a YAML config names, after the parameters are
    initialised:

      - ``pretrain_ckpt_path`` (a file, or a directory with
        ``pytorch_model.bin``) → the learnable-only scene-encoder state;
      - ``model.prompter.model.vision.args.path`` → PointNet++;
      - ``model.llm.cfg_path`` when it holds ``*.bin`` or ``*.safetensors``
        → the HF Llama base.

    Returns the sources loaded."""
    loaded = []
    kw: Dict[str, str] = {}
    pretrain = str(cfg.get("pretrain_ckpt_path", "") or "")
    if pretrain:
        p = Path(pretrain)
        if p.is_dir():
            p = p / "pytorch_model.bin"
        if p.exists():
            kw["scene_encoder_path"] = str(p)
            loaded.append(f"pretrain_ckpt:{p}")
    try:
        pn_path = str(cfg.model.prompter.model.vision.args.get("path", "") or "")
    except (AttributeError, KeyError):
        pn_path = ""
    if pn_path and Path(pn_path).exists():
        kw["pointnet_path"] = pn_path
        loaded.append(f"pointnet:{pn_path}")
    llm_path = str(cfg.get("model", {}).get("llm", {}).get("cfg_path", "") or "")
    if llm_path and Path(llm_path).is_dir():
        if list(Path(llm_path).glob("*.bin")) or list(Path(llm_path).glob("*.safetensors")):
            kw["llm_path"] = llm_path
            loaded.append(f"llm:{llm_path}")
    if kw:
        load_all(model, **kw)
    return loaded
