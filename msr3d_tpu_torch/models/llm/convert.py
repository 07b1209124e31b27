"""HF Llama / PEFT-LoRA checkpoints and weight quantization.

Counterpart of ``msr3d_tpu/models/llm/convert.py``. The checkpoint loader
assembles the JAX package's LLM parameter tree, framework-neutral nested
dicts in flax layout (``embed_tokens/embedding``, ``layer_<i>/attn/q_proj/
kernel`` (in, out), ``final_norm/scale``, ``lm_head/kernel``), with torch
tensors as leaves; ``msr3d_tpu_torch.convert`` maps such a tree onto the
port's modules. Supported sources:

  * on-disk HF checkpoints: ``pytorch_model*.bin`` shards through
    ``torch.load(mmap=True, weights_only=True)``, and ``*.safetensors``
    shards through a reader of this module's own (an 8-byte little-endian
    header length, a JSON header, then the raw bytes), one tensor at a time;
  * PEFT LoRA adapters (``lora_A``/``lora_B`` per target module).

Quantization (:func:`quantize_kernel`, :func:`quantize_llm_params`) runs on
the tensor's device in torch and gives the JAX package's numpy values bit
for bit: fp32 absmax per output channel (or per group of ``quantize_group``
input rows), a scale of absmax/127 (int8) or absmax/7 (int4, rounded to
bf16 before quantizing), 0 → 1, an fp32 divide, round half to even, clip.
One function stands for both JAX quantizers, the host one and the
on-device int8 twin (the same math).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from msr3d_tpu_torch.models.llm.llama import LlamaConfig

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _tensor(t: Any) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))


def config_from_hf(hf_cfg: Dict[str, Any], **overrides) -> LlamaConfig:
    """Build LlamaConfig from an HF config.json dict. Tied word embeddings
    (an ``lm_head`` that is the embedding matrix) are not ported."""
    if hf_cfg.get("tie_word_embeddings", False):
        raise NotImplementedError("tied word embeddings are not ported yet (see ROADMAP.md)")
    kw = dict(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_hidden_layers=hf_cfg["num_hidden_layers"],
        num_attention_heads=hf_cfg["num_attention_heads"],
        num_key_value_heads=hf_cfg.get("num_key_value_heads"),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-6),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


_HF_LAYER_RE = re.compile(
    r"^model\.layers\.(\d+)\.(self_attn|mlp|input_layernorm|"
    r"post_attention_layernorm)\.(?:(\w+_proj)\.)?weight$"
)


def hf_name_to_tree_path(name: str) -> Optional[Tuple[Tuple[str, ...], bool]]:
    """HF LlamaForCausalLM param name → (path tuple into the flax-layout
    tree, needs_transpose). None for names not mapped (e.g. the rotary
    ``inv_freq`` buffers some checkpoints persist)."""
    if name == "model.embed_tokens.weight":
        return ("embed_tokens", "embedding"), False
    if name == "model.norm.weight":
        return ("final_norm", "scale"), False
    if name == "lm_head.weight":
        return ("lm_head", "kernel"), True
    m = _HF_LAYER_RE.match(name)
    if not m:
        return None
    i, block, proj = m.groups()
    layer = f"layer_{i}"
    if block == "self_attn":
        return (layer, "attn", proj, "kernel"), True
    if block == "mlp":
        return (layer, "mlp", proj, "kernel"), True
    if block == "input_layernorm":
        return (layer, "input_norm", "scale"), False
    return (layer, "post_attn_norm", "scale"), False


def _tree_set(params: Dict[str, Any], path, value) -> None:
    node = params
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def params_from_hf_stream(stream, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Assemble the params tree from a (name, tensor) iterator with at most
    one tensor in flight (a real 7B checkpoint is 13.5 GB). The JAX
    package's ``stack_layers`` layout serves pipeline parallelism and comes
    with it (ROADMAP.md queue)."""
    params: Dict[str, Any] = {}
    for name, arr in stream:
        mapped = hf_name_to_tree_path(name)
        if mapped is None:
            continue
        path, transpose = mapped
        arr = _tensor(arr)
        _tree_set(params, path, (arr.t() if transpose else arr).to(dtype).contiguous())
    missing = [k for k in ("embed_tokens", "final_norm", "layer_0") if k not in params]
    if missing:
        raise ValueError(f"checkpoint stream missing {missing}")
    return params


_PEFT_RE = re.compile(
    r"(?:base_model\.model\.)?model\.layers\.(\d+)\."
    r"(self_attn|mlp)\.(\w+_proj)\.lora_(A|B)(?:\.\w+)?\.weight"
)


def merge_peft_lora(params: Dict[str, Any], lora_sd: Dict[str, Any],
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Insert PEFT lora_A (r, in) / lora_B (out, r) weights into a param
    tree as lora_a (in, r) / lora_b (r, out), creating the projection's
    node where the tree has none."""
    for key, val in lora_sd.items():
        m = _PEFT_RE.match(key)
        if not m:
            continue
        layer, block, proj, ab = m.groups()
        block_name = "attn" if block == "self_attn" else "mlp"
        dst = params.setdefault(f"layer_{layer}", {}).setdefault(block_name, {}).setdefault(
            proj, {})
        dst["lora_a" if ab == "A" else "lora_b"] = _tensor(val).to(dtype).t().contiguous()
    return params


def init_lora_params(params: Dict[str, Any], cfg: LlamaConfig, seed: int = 0) -> Dict[str, Any]:
    """Add freshly initialised LoRA A/B to every target projection (A ~
    He-uniform from ``numpy.random.default_rng(seed)``, as the JAX package
    draws it; B = 0)."""
    rng = np.random.default_rng(seed)
    for i in range(cfg.num_hidden_layers):
        for block, projs in (
            ("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
            ("mlp", ("gate_proj", "up_proj", "down_proj")),
        ):
            for proj in projs:
                if proj not in cfg.lora_targets:
                    continue
                dst = params[f"layer_{i}"][block][proj]
                if "kernel" in dst:
                    fan_in, fan_out = dst["kernel"].shape
                else:  # a quantized base: int4 packs two input rows a byte
                    fan_in = dst["kernel_q"].shape[0] * (2 if cfg.quantize_bits == 4 else 1)
                    fan_out = dst["kernel_q"].shape[1]
                bound = np.sqrt(6.0 / fan_in)
                dst["lora_a"] = torch.from_numpy(
                    rng.uniform(-bound, bound, size=(fan_in, cfg.lora_rank)).astype(np.float32))
                dst["lora_b"] = torch.zeros((cfg.lora_rank, fan_out), dtype=torch.float32)
    return params


def _safetensors_tensors(file: Path) -> Iterator[Tuple[str, torch.Tensor]]:
    """Each tensor of a ``.safetensors`` file, read one at a time: an 8-byte
    little-endian header length, the JSON header (name → dtype, shape,
    [begin, end) offsets into the data after it), then the raw bytes."""
    with open(file, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
        base = 8 + n
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            begin, end = meta["data_offsets"]
            fh.seek(base + begin)
            buf = bytearray(fh.read(end - begin))
            dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            yield name, t.reshape(meta["shape"])


def iter_hf_checkpoint_tensors(path: Path) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) over an HF checkpoint dir without loading the
    whole state dict. Shard order follows the index json when there is one
    (the real 7B layout)."""
    path = Path(path)
    shard_files: list = []
    for idx in (path / "model.safetensors.index.json", path / "pytorch_model.bin.index.json"):
        if idx.exists():
            with open(idx) as fh:
                weight_map = json.load(fh)["weight_map"]
            shard_files = [path / f for f in sorted(set(weight_map.values()))]
            break
    if not shard_files:
        shard_files = sorted(path.glob("*.safetensors")) or sorted(path.glob("pytorch_model*.bin"))
    if not shard_files:
        raise FileNotFoundError(f"no weight files found under {path}")
    for file in shard_files:
        if file.suffix == ".safetensors":
            yield from _safetensors_tensors(file)
        else:
            shard = torch.load(file, map_location="cpu", weights_only=True, mmap=True)
            for key, val in shard.items():
                yield key, val.float()
            del shard


def load_hf_checkpoint(path, dtype: torch.dtype = torch.float32, **config_overrides):
    """An on-disk HF Llama checkpoint directory → (cfg, params), streamed
    one tensor at a time (``dtype=torch.bfloat16`` lands 7B in ~13.5 GB)."""
    path = Path(path)
    with open(path / "config.json") as fh:
        hf_cfg = json.load(fh)
    cfg = config_from_hf(hf_cfg, **config_overrides)
    return cfg, params_from_hf_stream(iter_hf_checkpoint_tensors(path), dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(in, F) int4-valued int8 → (in/2, F) split-nibble packed int8: low
    nibbles rows [0, in/2), high nibbles rows [in/2, in), the layout the
    int4 ``LoraDense`` unpacks with two sign-extending shifts."""
    if q.shape[0] % 2:
        raise ValueError(f"pack_int4: the input dim must be even, got {q.shape[0]}")
    half = q.shape[0] // 2
    q = q.to(torch.int8)
    return (q[:half] & 0x0F) | (q[half:] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`."""
    packed = packed.to(torch.int8)
    return torch.cat([(packed << 4) >> 4, packed >> 4], dim=0)


def shard_int4_rows(packed: torch.Tensor, tp_rank: int, tp_size: int) -> torch.Tensor:
    """A row-parallel rank's shard of a split-nibble packed (in/2, F) kernel:
    its input rows [r·in/tp, (r+1)·in/tp) (the column-parallel layer before
    it hands the rank that contiguous slice), unpacked from the whole and
    packed again into the rank's own low and high halves, (in/(2·tp), F).
    A plain slice of the packed rows would pair the rank's rows with rows
    of other ranks."""
    rows = unpack_int4(packed)
    if rows.shape[0] % (2 * tp_size):
        raise ValueError(f"shard_int4_rows: {rows.shape[0]} input rows do not split into "
                         f"{tp_size} ranks of whole packed bytes")
    return pack_int4(rows.chunk(tp_size, dim=0)[tp_rank].contiguous())


def gather_int4_rows(shards) -> torch.Tensor:
    """The inverse of :func:`shard_int4_rows` over every rank's shard, rank
    0's first: JAX's packed bits of the whole kernel."""
    return pack_int4(torch.cat([unpack_int4(s) for s in shards], dim=0))


def quantize_kernel(kernel: torch.Tensor, bits: int, group: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flax-layout kernel (in, out) → (values, fp32 scale) on its
    device: int8 (in, out) with scales (out,), or int4 packed by
    :func:`pack_int4` (in/2, out) with scales (out,) or, with ``group``,
    (in/group, out)."""
    k = kernel.float()
    if bits == 4:
        if group:
            d = k.shape[0]
            if d % group or (d // 2) % group:
                raise ValueError(f"group {group} must divide the input dim {d} and its half")
            kg = k.reshape(d // group, group, -1)
            scale = kg.abs().amax(dim=1) / 7.0  # (d/G, F)
            scale = torch.where(scale == 0, 1.0, scale)
            # the scale at its bf16 storage precision BEFORE quantizing
            scale = scale.to(torch.bfloat16).float()
            q = torch.clamp(torch.round(kg / scale[:, None, :]), -8, 7).to(torch.int8)
            q = q.reshape(d, -1)
        else:
            scale = k.abs().amax(dim=0) / 7.0
            scale = torch.where(scale == 0, 1.0, scale)
            scale = scale.to(torch.bfloat16).float()
            q = torch.clamp(torch.round(k / scale), -8, 7).to(torch.int8)
        return pack_int4(q), scale
    if bits != 8:
        raise ValueError("quantize bits must be 4 or 8")
    scale = k.abs().amax(dim=0) / 127.0  # per output channel
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_llm_params(params: Dict[str, Any], cfg: LlamaConfig) -> Dict[str, Any]:
    """Every projection's ``kernel`` → ``kernel_q`` + ``kernel_scale`` in
    the layout of the quantized ``LoraDense`` (``cfg.quantize_bits``,
    ``cfg.quantize_group``); norms, embeddings, the LM head and LoRA stay as
    they are. Runs on each kernel's device; returns a new tree."""
    out = dict(params)
    for i in range(cfg.num_hidden_layers):
        layer = out[f"layer_{i}"] = {k: dict(v) for k, v in params[f"layer_{i}"].items()}
        for block in ("attn", "mlp"):
            for proj, p in list(layer[block].items()):
                if "kernel" not in p:
                    continue
                p = dict(p)
                q, scale = quantize_kernel(_tensor(p.pop("kernel")), cfg.quantize_bits,
                                           cfg.quantize_group)
                p["kernel_q"], p["kernel_scale"] = q, scale
                layer[block][proj] = p
    return out
