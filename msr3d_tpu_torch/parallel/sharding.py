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

A quantized base keeps JAX's (in, out) layout, so its specs are JAX's as
they stand: a column-parallel ``weight_q`` splits dim 1 and a row-parallel
one dim 0; a group scale (in/G, out) follows its weight (dim 1 for a
column-parallel layer, dim 0 for a row-parallel one); a 1-D per-channel
scale replicates (a column-parallel rank reads its outputs' slice of it).
As in JAX, a 1-D leaf replicates, and a leaf whose split dim does not divide
by tp falls back to replication, with one warning that lists the leaves (the
tiny and debug configs' vocab of 263 is prime, so their embeddings and
``lm_head`` replicate at tp = 2).

Two layouts need more than a slice. A row-parallel int4 ``weight_q`` is
split-nibble packed (rows [0, in/2) in the low nibbles, [in/2, in) in the
high ones), while a rank's input is the contiguous rows [r·in/tp,
(r+1)·in/tp): its spec is ``PACKED_ROWS``, and a rank's shard is its rows
unpacked from the whole and packed again into its own halves
(``models/llm/convert.py``'s ``shard_int4_rows``); gathering undoes it, so
shard-then-gather gives back JAX's packed bits. And a row-parallel group
scale whose group count does not divide by tp replicates, as JAX's fallback
replicates it (``(in/G) % tp`` is 86 % 4 = 2 for the 7B ``down_proj`` at G
= 128 and tp = 4): the layer then takes each row's scale by its global row
index. A row-parallel int4 layer whose packed rows do not divide by tp
while the rest of its block splits raises a ``ValueError`` naming it.

``llm_tp_dims`` is the one place where the layout of a model is decided:
``LlamaModel`` builds the shards it names (``LlamaConfig.tp_attn``,
``tp_mlp`` and ``tp_vocab`` read it, and ``LoraDense`` its scale's split),
and the fallback's warning is given there, once a config. Attention splits
by whole heads, so q/k/v/o split only together and where both head counts
divide by tp; a layout that would split inside a head raises.

``shard_state_dict`` turns a full state dict into one rank's shards,
``gather_state_dict`` the ranks' shards back into the full one (the two give
back the same bits), and ``gather_full_state_dict`` gathers this rank's
tensors over its tp group. Optimizer moments follow their parameters.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, Mapping, Optional, Sequence, Union

import torch

from msr3d_tpu_torch.parallel import mesh
from msr3d_tpu_torch.parallel.tensor_parallel import gather_along

_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_PARALLEL = ("o_proj", "down_proj")
_QUANTIZED = ("weight_q", "weight_scale")  # JAX's (in, out) layout
PACKED_ROWS = "packed_rows"  # the spec of a row-parallel int4 weight_q: dim 0, repacked
Spec = Union[int, str, None]
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
            return 1 if leaf in _QUANTIZED else 0
    for proj in _ROW_PARALLEL:
        if proj in parts:
            if leaf == "lora_b":
                return None
            return 0 if leaf in _QUANTIZED else 1
    if "embed_tokens" in parts or "lm_head" in parts:
        return 0
    return None


def network_param_spec(name: str, ndim: int) -> Optional[int]:
    """The spec of a network parameter: the LLM's by ``llama_param_spec``
    (a 1-D leaf replicated, as JAX's rank guard replicates it), everything
    outside ``llm.`` replicated."""
    if not name.startswith("llm.") or ndim < 2:
        return None
    return llama_param_spec(name)


def shard_dims(shapes: Mapping[str, Sequence[int]], tp_size: int,
               int4: bool = False) -> Dict[str, Spec]:
    """name → the spec over ``tp_size`` ranks (a dim, ``PACKED_ROWS``, or
    None: replicated) for the full ``shapes`` of a network's state dict
    (``int4``: its quantized base is int4-packed); a split dim that does not
    divide falls back to replication, reported in one warning."""
    dims, fallbacks = {}, []
    for name, shape in shapes.items():
        dim = network_param_spec(name, len(shape)) if tp_size > 1 else None
        if dim is not None and shape[dim] % tp_size:
            fallbacks.append(f"{name} shape={tuple(shape)} dim={dim}")
            dim = None
        if dim == 0 and int4 and name.endswith("weight_q"):
            dim = PACKED_ROWS
        dims[name] = dim
    if fallbacks:
        logger.warning(
            "shard_dims: %d leaves fell back to full replication (dim not divisible by "
            "tp=%d): %s", len(fallbacks), tp_size,
            "; ".join(fallbacks[:8]) + ("; ..." if len(fallbacks) > 8 else ""))
    return dims


_BLOCKS = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
           "mlp": ("gate_proj", "up_proj", "down_proj")}


@functools.lru_cache(maxsize=None)
def llm_tp_dims(cfg) -> Dict[str, Spec]:
    """name (inside the LLM) → the spec of each tensor that a Llama of
    ``cfg`` (a ``LlamaConfig``) splits over its ``tp_size`` ranks: JAX's
    layout over the full model's shapes (a build on the meta device, every
    layer, quantized buffers included), with its fallback and warning; empty
    at tp = 1. Raises where attention would split inside a head, and where a
    block would split some of its projections' bases but not the others (an
    int4 row-parallel layer whose packed rows do not divide)."""
    if cfg.tp_size == 1:
        return {}
    from msr3d_tpu_torch.models.llm.llama import LlamaModel

    full = LlamaModel(dataclasses.replace(cfg, tp_size=1, tp_rank=0, pp_size=1, pp_rank=0),
                      device="meta")
    dims = shard_dims({f"llm.{n}": tuple(t.shape) for n, t in full.state_dict().items()},
                      cfg.tp_size, int4=cfg.quantize and cfg.quantize_bits == 4)
    dims = {n[len("llm."):]: d for n, d in dims.items() if d is not None}
    base = "weight_q" if cfg.quantize else "weight"
    for block, projs in _BLOCKS.items():
        split = {p: f"layer.0.{block}.{p}.{base}" in dims for p in projs}
        if not any(split.values()):
            continue
        whole = sorted(p for p, s in split.items() if not s)
        if block == "attn" and (cfg.num_attention_heads % cfg.tp_size
                                or cfg.kv_heads % cfg.tp_size or (whole and not cfg.quantize)):
            raise NotImplementedError(
                f"tp={cfg.tp_size} would split q/k/v inside a head (heads "
                f"{cfg.num_attention_heads}, kv heads {cfg.kv_heads}): not ported "
                "(ROADMAP.md, queue: parallelism)")
        if whole:
            raise ValueError(
                f"tp={cfg.tp_size}: the {block} block splits over tp but the base ({base}) of "
                f"{', '.join(f'layer.*.{block}.{p}' for p in whole)} does not divide by tp: "
                "the rank's input rows would not pack into whole int4 bytes")
    return dims


def shard_tensor(value: torch.Tensor, dim: Spec, tp_rank: int,
                 tp_size: int) -> torch.Tensor:
    """Rank ``tp_rank``'s slice of a full tensor along ``dim`` (a contiguous
    copy; ``PACKED_ROWS``: the rank's input rows repacked), or the tensor
    itself when replicated."""
    if dim is None or tp_size == 1:
        return value
    if dim == PACKED_ROWS:
        from msr3d_tpu_torch.models.llm.convert import shard_int4_rows

        return shard_int4_rows(value, tp_rank, tp_size)
    return value.chunk(tp_size, dim=dim)[tp_rank].contiguous()


def join_shards(parts: Sequence[torch.Tensor], dim: Spec) -> torch.Tensor:
    """The tp ranks' shards of one tensor, rank 0's first → the full tensor
    (the inverse of ``shard_tensor``)."""
    if dim == PACKED_ROWS:
        from msr3d_tpu_torch.models.llm.convert import gather_int4_rows

        return gather_int4_rows(parts)
    return torch.cat(list(parts), dim=dim)


def shard_state_dict(full: Mapping[str, torch.Tensor], tp_rank: int,
                     tp_size: int, int4: bool = False) -> Dict[str, torch.Tensor]:
    """A full network state dict → rank ``tp_rank``'s shards (``int4``: its
    quantized base is int4-packed)."""
    dims = shard_dims({n: tuple(v.shape) for n, v in full.items()}, tp_size, int4)
    return {n: shard_tensor(v, dims[n], tp_rank, tp_size) for n, v in full.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                      dims: Mapping[str, Spec]) -> Dict[str, torch.Tensor]:
    """Every tp rank's shards, rank 0's first → the full state dict; ``dims``
    are the specs (``MSR3DNetwork.tp_dims`` or ``shard_dims``), a name
    absent from them replicated (rank 0's tensor)."""
    out = {}
    for name, value in shards[0].items():
        dim = dims.get(name)
        out[name] = value if dim is None else join_shards([s[name] for s in shards], dim)
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
                           dims: Mapping[str, Spec]) -> Dict[str, torch.Tensor]:
    """This rank's tensors → the full ones, gathered over the tp group (the
    replicated ones as they are); the identity at tp = 1. Every tp rank
    calls it, in one order."""
    if mesh.tp_size() == 1:
        return dict(local)

    def full(v, dim):
        if dim == PACKED_ROWS:
            from msr3d_tpu_torch.models.llm.convert import pack_int4, unpack_int4

            return pack_int4(gather_along(unpack_int4(v), 0))
        return gather_along(v, dim)

    return {n: (v if dims.get(n) is None else full(v, dims[n])) for n, v in local.items()}
