"""Turn the JAX package's parameter tree into this port's state dict.

Input: the flax variables of ``MSR3DNetwork``, or of any module of the
legacy grounding stack (``nn/grounding.py``, ``nn/pcd_tokenize.py``,
``nn/pointbert.py``), of SRT (``nn/srt.py``) or of the Swin3D UNet
(``nn/swin3d.py``, its BatchNorms' ``batch_stats`` included), as nested dicts of numpy arrays (``{"params": ...,
"batch_stats": ...}``). Rules, per leaf:

  * a path segment ``name_<i>`` (``layer_3``, ``sa_0``, ``dense_1``) is
    entry ``i`` of the port's ``nn.ModuleList`` ``name``;
  * ``kernel`` (Dense, flax (in, out)) → ``weight``, transposed to torch's
    (out, in); ``lora_a`` (in, r) and ``lora_b`` (r, out) are transposed
    the same way; a Conv ``kernel`` (kh, kw, I, O) becomes torch's (O, I,
    kh, kw) (a depthwise (kh, kw, 1, O) becomes (O, 1, kh, kw)); the
    sparse-voxel convolution's raw ``kernel`` (27, Cin, Cout) stays as it
    is (``nn/swin3d.py``'s ``SparseConvBNRelu`` multiplies by it as JAX
    does);
  * a quantized projection's ``kernel_q`` → ``weight_q`` and
    ``kernel_scale`` → ``weight_scale``, NOT transposed: the port keeps the
    JAX layout for the quantized base, int8 (in, out) or int4 split-nibble
    packed (in/2, out), with scales (out,) or, by group, (in/G, out), since
    that is the layout kernels K3/K4 read (contiguous along the outputs).
    The bytes are copied exactly: the int8 values as they are, the scale
    into an fp32 buffer (a bf16 scale converts exactly), so trees quantized
    without LoRA (``lora_rank=0``, the merged-LoRA deployment) and with it
    load alike;
  * ``scale`` (LayerNorm, BatchNorm, RMSNorm) → ``weight``; ``embedding``
    (Embed) → ``weight``; ``bias``, the prompter's ``object_orientation_feat``,
    ``anchor_feat`` and ``anchor_size``, ConvNeXt's layer scale ``gamma``,
    PointBERT's ``cls_token`` and ``cls_pos``, PointTokenizeEncoder's
    ``int2mat`` and Swin3D's cRSE tables ``{query,key,value}_{xyz,rgb}_table``
    (3, 2L, H, hd) keep their names and layouts;
  * ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``.

Subtrees the port does not run would be skipped and listed
(``SKIPPED_SUBTREES``); since the point encoder's semantic head is ported
there are none. Any key the rules do not know raises.

flax creates a submodule's parameters at its first call, so a JAX model
initialised on a batch without images has no ``image_encoder`` and no
``llm_proj_img``. ``load_jax_params`` then leaves the port's image encoder
and projection as they are; a tree that holds either must hold all of both.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from msr3d_tpu_torch.parallel.sharding import shard_like

SKIPPED_SUBTREES: Tuple[str, ...] = ()
# created by flax only when a batch with images reaches the network
IMAGE_MODULES = ("image_encoder.", "llm_proj_img.")

_PARAM_LEAVES = {
    "kernel": ("weight", True),
    "kernel_q": ("weight_q", False),
    "kernel_scale": ("weight_scale", False),
    "lora_a": ("lora_a", True),
    "lora_b": ("lora_b", True),
    "scale": ("weight", False),
    "embedding": ("weight", False),
    "bias": ("bias", False),
    "object_orientation_feat": ("object_orientation_feat", False),
    "anchor_feat": ("anchor_feat", False),
    "anchor_size": ("anchor_size", False),
    "gamma": ("gamma", False),
    # PointBERT's class token and its position, PointTokenizeEncoder's
    # learned category table
    "cls_token": ("cls_token", False),
    "cls_pos": ("cls_pos", False),
    "int2mat": ("int2mat", False),
}
_PARAM_LEAVES.update({f"{p}_{g}_table": (f"{p}_{g}_table", False)
                      for p in ("query", "key", "value") for g in ("xyz", "rgb")})
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = val
    return flat


def _to_tensor(arr: Any, transpose: bool) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind not in "fiu":  # e.g. ml_dtypes bfloat16
        arr = arr.astype(np.float32)
    if transpose:
        if arr.ndim == 4:  # Conv (kh, kw, I, O) → (O, I, kh, kw)
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        elif arr.ndim != 3:  # 3-D: the sparse convolution's taps, as they are
            raise ValueError(f"expected a 2-, 3- or 4-D kernel, got shape {arr.shape}")
    return torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def torch_name(path: str) -> Tuple[str, bool]:
    """A JAX leaf path (``params/llm/layer_0/attn/q_proj/kernel``) → (the
    port's state-dict name, whether the value is transposed). Raises
    KeyError on a leaf it does not know."""
    collection, *mods, leaf = path.split("/")
    if collection == "params" and leaf in _PARAM_LEAVES:
        name, transpose = _PARAM_LEAVES[leaf]
    elif collection == "batch_stats" and leaf in _STAT_LEAVES:
        name, transpose = _STAT_LEAVES[leaf], False
    else:
        raise KeyError(f"unknown JAX parameter {path!r}")
    mods = [re.sub(r"_(\d+)$", r".\1", m) for m in mods]
    return ".".join(mods + [name]), transpose


def jax_to_torch_state_dict(
    variables: Mapping[str, Any],
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Returns (state dict, skipped JAX keys). Raises KeyError on a key it
    does not know."""
    state: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    for path, arr in sorted(_flatten(variables).items()):
        if path.startswith(SKIPPED_SUBTREES):
            skipped.append(path)
            continue
        name, transpose = torch_name(path)
        state[name] = _to_tensor(arr, transpose)
    return state, skipped


def load_jax_params(module: torch.nn.Module, variables: Mapping[str, Any]) -> List[str]:
    """Load converted JAX variables into ``module`` (strict: every port
    parameter and buffer must be covered, nothing extra, except that a tree
    without images leaves the image encoder and ``llm_proj_img`` as they
    are). Values are cast to each parameter's dtype and device; a module
    under tensor parallelism takes its shards of them. Returns the skipped
    JAX keys."""
    state, skipped = jax_to_torch_state_dict(variables)
    state = shard_like(module, state)
    if not any(name.startswith(IMAGE_MODULES) for name in state):
        state.update((name, val) for name, val in module.state_dict().items()
                     if name.startswith(IMAGE_MODULES))
    module.load_state_dict(state, strict=True)
    return skipped
