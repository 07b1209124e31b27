"""Pretrained LLM weights: HF Llama checkpoints and PEFT adapters → the port's
``MSR3DNetwork``.

Counterpart of ``load_llm_weights`` and ``load_peft_lora`` in
``msr3d_tpu/models/load_weights.py``. The JAX functions overlay a flax
variables tree; these overlay the network's parameters and buffers, through
the flax-layout tree of ``models/llm/convert.py`` and the names of
``msr3d_tpu_torch.convert``. As in JAX, only entries the network has are
written (shape-checked, cast to the destination's dtype and device);
anything absent keeps its value. The point-encoder and ConvNeXt loaders are
not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import torch

from msr3d_tpu_torch.convert import _flatten, torch_name
from msr3d_tpu_torch.models.llm.convert import (
    _safetensors_tensors,
    load_hf_checkpoint,
    merge_peft_lora,
    quantize_llm_params,
)


@torch.no_grad()
def _overlay_llm(network: torch.nn.Module, params: Dict[str, Any]) -> None:
    """Copy a flax-layout LLM tree into ``network.llm`` where names match.
    A ``kernel_scale`` lands rounded to bf16, the dtype the JAX model tree
    stores it in (its overlay casts to that), so a loaded quantized model
    equals the JAX one loaded from the same checkpoint."""
    targets = dict(network.named_parameters())
    targets.update(network.named_buffers())
    for path, value in _flatten(params).items():
        name, transpose = torch_name(f"params/llm/{path}")
        if name not in targets:
            continue
        value = value.t() if transpose else value
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
    _overlay_llm(network, params)
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
    _overlay_llm(network, merge_peft_lora({}, sd))
