"""Model builders: the YAML config → a port ``MSR3D``.

Counterpart of ``msr3d_tpu/models/build.py``, with the same registered
names (``model.name: MSR3D``; the prompter nodes ``OSE3DSituation``,
``OSE3D`` and ``OSE3DORIG``) and the same reading of the config:

  * ``model.llm.cfg_path`` gives the tokenizer (``build_tokenizer``) and,
    where it holds a ``config.json``, the LLM geometry (``config_from_hf``);
    otherwise a tiny LLM sized to the tokenizer;
  * ``model.llm.{lora, param_dtype, quantize, quantize_bits,
    quantize_group, flash_attention}`` as the JAX builder reads them;
  * the generation knobs ``eval_num_beams``, ``eval_repetition_penalty``,
    ``eval_length_penalty`` and ``eval_eos_logit_bias``.

What the port does not run raises ``NotImplementedError`` when it is set
to anything but its default: ``model.llm.remat`` (ROADMAP.md, QLoRA and
the training-memory options), ``parallel.sp > 1`` (parallelism), and the
serving knobs ``eval_spec_k``, ``eval_do_sample``, ``eval_top_k``,
``eval_top_p`` and ``compact_transfer`` (the serving engines).

The model lands on ``cfg.device`` (``cuda`` when unset; ``device=cpu``
picks the CPU), through ``resolve_device``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import torch

from msr3d_tpu_torch.models.llm.convert import config_from_hf
from msr3d_tpu_torch.models.llm.llama import LlamaConfig
from msr3d_tpu_torch.models.llm.tokenizer import BaseTokenizer, build_tokenizer
from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig, OSE3DSituation
from msr3d_tpu_torch.registry import MODEL_REGISTRY

# serving knobs of the JAX MSR3D that the port lacks: (config key, default)
_UNPORTED_SERVING = (
    ("eval_spec_k", 0),
    ("eval_do_sample", False),
    ("eval_top_k", 0),
    ("eval_top_p", 1.0),
    ("compact_transfer", False),
)


def build_llm_config(llm_cfg, tokenizer: BaseTokenizer,
                     dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """``cfg.model.llm`` → LlamaConfig: the HF ``config.json`` geometry when
    ``cfg_path`` holds one, else the tiny LLM of the debug configs."""
    lora = llm_cfg.get("lora")
    lora_kw: dict = {}
    if lora is not None and lora.get("flag", False):
        lora_kw = dict(
            lora_rank=lora.rank,
            lora_alpha=lora.alpha,
            lora_dropout=lora.get("dropout", 0.0),
            lora_targets=tuple(lora.target_modules),
        )
    extra = dict(
        param_dtype=torch.bfloat16 if llm_cfg.get("param_dtype", "bf16") == "bf16"
        else torch.float32,
        quantize=bool(llm_cfg.get("quantize", False)),
        quantize_bits=int(llm_cfg.get("quantize_bits", 8)),
        quantize_group=llm_cfg.get("quantize_group", None),
        remat=bool(llm_cfg.get("remat", False)),  # LlamaConfig raises on True
        flash_attention=bool(llm_cfg.get("flash_attention", False)),
    )
    cfg_path = llm_cfg.get("cfg_path", "")
    if cfg_path and Path(cfg_path, "config.json").exists():
        hf = json.loads(Path(cfg_path, "config.json").read_text())
        return config_from_hf(hf, dtype=dtype, **lora_kw, **extra)
    return LlamaConfig.tiny(vocab_size=max(tokenizer.vocab_size, 263), dtype=dtype,
                            **lora_kw, **extra)


def _check_ported(cfg) -> None:
    for key, default in _UNPORTED_SERVING:
        value = cfg.get(key, default)
        if value is not None and type(default)(value) != default:
            raise NotImplementedError(
                f"{key}={value!r} is not ported yet (ROADMAP.md, queue: the serving engines)")
    if int(cfg.get("parallel", {}).get("sp", 1)) > 1:
        raise NotImplementedError("parallel.sp > 1 (ring attention) is not ported yet "
                                  "(ROADMAP.md, queue: parallelism)")


def build_msr3d_from_config(cfg, device=None) -> MSR3D:
    """The full config (``configs/msr3d.yaml`` layout) → a port MSR3D on
    ``device`` (default ``cfg.device``, else CUDA), parameters not yet
    initialised."""
    _check_ported(cfg)
    model_cfg = cfg.model
    llm_cfg = model_cfg.llm
    tokenizer = build_tokenizer(llm_cfg.get("cfg_path", ""),
                                truncation_side=llm_cfg.get("truncation_side", "right"))
    prompter_cfg = OSE3DConfig.from_config(model_cfg.prompter.model)
    llama_cfg = build_llm_config(llm_cfg, tokenizer)

    vision2d = model_cfg.get("vision_2d")
    backbone_name, freeze_2d = "convnext_base", True
    if vision2d is not None:
        backbone_name = vision2d.args.get("backbone_name", "convnext_base")
        freeze_2d = vision2d.get("freeze", True)
    net_cfg = MSR3DNetworkConfig(prompter=prompter_cfg, llm=llama_cfg,
                                 backbone_name=backbone_name, freeze_image_encoder=freeze_2d)
    return MSR3D(
        net_cfg,
        tokenizer,
        scene_token_len=model_cfg.prompter.model.get("scene_token_len", 60),
        max_context_len=llm_cfg.get("max_context_len", 256),
        max_out_len=llm_cfg.get("max_out_len", 256),
        num_beams=cfg.get("eval_num_beams", 5),
        repetition_penalty=float(cfg.get("eval_repetition_penalty", 3.0)),
        length_penalty=float(cfg.get("eval_length_penalty", 1.0)),
        eos_logit_bias=float(cfg.get("eval_eos_logit_bias", 0.0)),
        device=device if device is not None else cfg.get("device"),
    )


def _build_ose3d(cfg, situation_type: Optional[str] = None, device=None) -> OSE3DSituation:
    """Prompter-node builder of the OSE3D family (``cfg`` has ``.model``)."""
    ose_cfg = OSE3DConfig.from_config(cfg.model)
    if situation_type is not None:
        ose_cfg = dataclasses.replace(ose_cfg, situation_type=situation_type)
    return OSE3DSituation(ose_cfg, device=device)


MODEL_REGISTRY.register(build_msr3d_from_config, name="MSR3D")
MODEL_REGISTRY.register(lambda cfg, device=None: _build_ose3d(cfg, device=device),
                        name="OSE3DSituation")
# the LEO prompters: the anchor as an object (the port raises on that mode)
MODEL_REGISTRY.register(lambda cfg, device=None: _build_ose3d(cfg, "as_object", device),
                        name="OSE3D")
MODEL_REGISTRY.register(lambda cfg, device=None: _build_ose3d(cfg, "as_object", device),
                        name="OSE3DORIG")


def build_model(cfg, device=None) -> Any:
    """``cfg.model.name``'s builder on the full config."""
    return MODEL_REGISTRY.get(cfg.model.name)(cfg, device=device)
