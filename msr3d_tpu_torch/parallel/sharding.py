"""The megatron layout of the LLM over the tp ranks, by parameter name.

Counterpart of ``msr3d_tpu/parallel/sharding.py`` over the port's names and
torch's layouts (a Dense weight is (out, in), LoRA A (r, in), LoRA B (out,
r)); a spec is the dim of a tensor that is split over the tp ranks, or None
for a replicated one:

  q/k/v/gate/up ``weight`` (out, in)  → dim 0 (column-parallel)
  their ``lora_a`` (r, in)            → replicated; ``lora_b`` (out, r) → dim 0
  o/down ``weight`` (out, in)         → dim 1 (row-parallel)
  their ``lora_a`` (r, in)            → dim 1; ``lora_b`` (out, r) → replicated
  ``embed_tokens.weight`` (V, h)      → dim 0 (over the vocab)
  ``lm_head.weight`` (V, h)           → dim 0
  everything else (the norms, the scene prompter, the point encoder, the
  image tower)                        → replicated

A quantized base keeps JAX's (in, out) layout (``weight_q``), so its spec is
JAX's as it stands; the port does not run it under tp (``LlamaConfig``
raises). As in JAX, a 1-D leaf replicates, and a leaf whose split dim does
not divide by tp falls back to replication, with one warning that lists the
leaves (the tiny and debug configs' vocab of 263 is prime, so their
embeddings and ``lm_head`` replicate at tp = 2).

``llm_tp_dims`` is the one place where the layout of a model is decided:
``LlamaModel`` builds the shards it names (``LlamaConfig.tp_attn``,
``tp_mlp`` and ``tp_vocab`` read it), and the fallback's warning is given
there, once a config. Attention splits by whole heads, so q/k/v/o split
only together and where both head counts divide by tp; a layout that would
split inside a head raises.

``shard_state_dict`` turns a full state dict into one rank's shards,
``gather_state_dict`` the ranks' shards back into the full one (the two give
back the same bits), and ``gather_full_state_dict`` gathers this rank's
tensors over its tp group. Optimizer moments follow their parameters.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, Mapping, Optional, Sequence

import torch

from msr3d_tpu_torch.parallel import mesh
from msr3d_tpu_torch.parallel.tensor_parallel import gather_along

_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_PARALLEL = ("o_proj", "down_proj")
logger = logging.getLogger("msr3d_tpu_torch.sharding")


def llama_param_spec(name: str) -> Optional[int]:
    """The dim split over tp of one LLM parameter (its name inside the LLM
    or the network), or None: replicated."""
    parts = name.split(".")
    leaf = parts[-1]
    for proj in _COL_PARALLEL:
        if proj in parts:
            if leaf == "lora_a":
                return None
            return 1 if leaf == "weight_q" else 0
    for proj in _ROW_PARALLEL:
        if proj in parts:
            if leaf == "lora_b":
                return None
            return 0 if leaf == "weight_q" else 1
    if "embed_tokens" in parts or "lm_head" in parts:
        return 0
    return None


def network_param_spec(name: str, ndim: int) -> Optional[int]:
    """The spec of a network parameter: the LLM's by ``llama_param_spec``
    (a 1-D leaf replicated), everything outside ``llm.`` replicated."""
    if not name.startswith("llm."):
        return None
    dim = llama_param_spec(name)
    return dim if dim is not None and dim < ndim else None


def shard_dims(shapes: Mapping[str, Sequence[int]], tp_size: int) -> Dict[str, Optional[int]]:
    """name → the dim split over ``tp_size`` ranks (None: replicated) for the
    full ``shapes`` of a network's state dict; a split dim that does not
    divide falls back to replication, reported in one warning."""
    dims, fallbacks = {}, []
    for name, shape in shapes.items():
        dim = network_param_spec(name, len(shape)) if tp_size > 1 else None
        if dim is not None and shape[dim] % tp_size:
            fallbacks.append(f"{name} shape={tuple(shape)} dim={dim}")
            dim = None
        dims[name] = dim
    if fallbacks:
        logger.warning(
            "shard_dims: %d leaves fell back to full replication (dim not divisible by "
            "tp=%d): %s", len(fallbacks), tp_size,
            "; ".join(fallbacks[:8]) + ("; ..." if len(fallbacks) > 8 else ""))
    return dims


@functools.lru_cache(maxsize=None)
def llm_tp_dims(cfg) -> Dict[str, int]:
    """name (inside the LLM) → the split dim of each tensor that a Llama of
    ``cfg`` (a ``LlamaConfig``) splits over its ``tp_size`` ranks: JAX's
    layout over the full model's shapes (a build on the meta device), with
    its fallback and warning; empty at tp = 1. Raises where attention would
    split inside a head."""
    if cfg.tp_size == 1:
        return {}
    from msr3d_tpu_torch.models.llm.llama import LlamaModel

    full = LlamaModel(dataclasses.replace(cfg, tp_size=1, tp_rank=0), device="meta")
    dims = shard_dims({f"llm.{n}": tuple(t.shape) for n, t in full.state_dict().items()},
                      cfg.tp_size)
    dims = {n[len("llm."):]: d for n, d in dims.items() if d is not None}
    split = {f"layer.0.attn.{p}.weight" in dims for p in ("q_proj", "k_proj", "v_proj", "o_proj")}
    if True in split and (False in split or cfg.num_attention_heads % cfg.tp_size
                          or cfg.kv_heads % cfg.tp_size):
        raise NotImplementedError(
            f"tp={cfg.tp_size} would split q/k/v inside a head (heads "
            f"{cfg.num_attention_heads}, kv heads {cfg.kv_heads}): not ported "
            "(ROADMAP.md, queue: parallelism)")
    return dims


def shard_tensor(value: torch.Tensor, dim: Optional[int], tp_rank: int,
                 tp_size: int) -> torch.Tensor:
    """Rank ``tp_rank``'s slice of a full tensor along ``dim`` (a contiguous
    copy), or the tensor itself when replicated."""
    if dim is None or tp_size == 1:
        return value
    return value.chunk(tp_size, dim=dim)[tp_rank].contiguous()


def shard_state_dict(full: Mapping[str, torch.Tensor], tp_rank: int,
                     tp_size: int) -> Dict[str, torch.Tensor]:
    """A full network state dict → rank ``tp_rank``'s shards."""
    dims = shard_dims({n: tuple(v.shape) for n, v in full.items()}, tp_size)
    return {n: shard_tensor(v, dims[n], tp_rank, tp_size) for n, v in full.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                      dims: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """Every tp rank's shards, rank 0's first → the full state dict; ``dims``
    are the split dims (``MSR3DNetwork.tp_dims`` or ``shard_dims``), a name
    absent from them replicated (rank 0's tensor)."""
    out = {}
    for name, value in shards[0].items():
        dim = dims.get(name)
        out[name] = value if dim is None else torch.cat([s[name] for s in shards], dim=dim)
    return out


def shard_like(module: torch.nn.Module,
               full: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full tensors (names of ``module``'s state dict) → the shards that
    ``module`` holds (its ``tp_dims``; a module without them takes them as
    they are)."""
    dims = module.tp_dims() if hasattr(module, "tp_dims") else {}
    if not dims:
        return dict(full)
    cfg = module.llm.cfg if hasattr(module, "llm") else module.cfg
    return {n: shard_tensor(v, dims.get(n), cfg.tp_rank, cfg.tp_size) for n, v in full.items()}


def gather_full_state_dict(local: Mapping[str, torch.Tensor],
                           dims: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """This rank's tensors → the full ones, gathered over the tp group (the
    replicated ones as they are); the identity at tp = 1. Every tp rank
    calls it, in one order."""
    if mesh.tp_size() == 1:
        return dict(local)
    return {n: (v if dims.get(n) is None else gather_along(v, dims[n]))
            for n, v in local.items()}
