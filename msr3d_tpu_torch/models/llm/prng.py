"""JAX's threefry random stream in PyTorch, so that sampled tokens equal JAX's.

The JAX package samples with ``jax.random``: ``PRNGKey``, ``fold_in``,
``split`` and ``categorical`` (Gumbel-max). A ``torch.Generator`` would
draw other numbers, so this module carries the arithmetic of JAX 0.9.0's
default implementation itself (``jax/_src/prng.py``, ``jax/_src/random.py``):

  * a key is two uint32 words; ``PRNGKey(seed)`` of an int32 seed is
    ``[0, seed mod 2^32]`` (the high word is the seed shifted right by 32);
  * ``threefry2x32``: 20 rounds of Threefry-2x32, rotations (13, 15, 26,
    6) and (17, 29, 16, 24), the key schedule with ``0x1BD11BDA``;
  * the *partitionable* layouts (``jax_threefry_partitionable``, on by
    default in 0.9.0): an array of shape ``s`` hashes the 64-bit row-major
    index of each element as (high, low) counter words, ``split`` takes the
    two hashed words of the counters 0..n-1 as the n new keys, and 32-bit
    random bits are the two words XORed;
  * ``fold_in(key, d)`` hashes the counter pair (0, d);
  * a uniform in [tiny, 1) is ``bits >> 9 | 0x3F800000`` bit-cast to fp32,
    minus 1, scaled and floored at fp32's ``tiny``; Gumbel noise in JAX's
    default ``mode="low"`` is ``-log(-log(u))``; ``categorical`` is the
    argmax of logits plus Gumbel noise over the last axis (first maximum).

torch has no full uint32 arithmetic on CUDA, so every word is held in an
int64 tensor and masked to 32 bits after each addition and shift: the key
and bit arithmetic is exact integer arithmetic, bit-equal to JAX's on the
CPU and on the card. Only ``log`` is the platform's, a few ulp from XLA's.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words (x1, x2) under the key
    (k1, k2); int64 tensors holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` → (2,) int64 holding the uint32 words."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32, which PRNGKey takes")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in`` of (..., 2) keys and an int or (...) integer
    tensor (taken mod 2^32, as JAX's uint32 cast) → (..., 2)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (high, low) words of the row-major 64-bit index over ``shape``."""
    idx = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                       device=device).reshape(tuple(shape))
    return idx >> 32, idx & _MASK


def _hash(key: torch.Tensor, shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both hashed words of the counters over ``shape``, for (..., 2) keys
    → (..., *shape) each (the per-key layout of ``jax.vmap``)."""
    hi, lo = _counters(shape, key.device)
    extra = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + extra)
    k2 = key[..., 1].reshape(key.shape[:-1] + extra)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` in the partitionable layout: (..., 2) keys →
    (..., num, 2)."""
    y1, y2 = _hash(key, (num,))
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random bits of ``shape`` from (..., 2) keys → (..., *shape)
    int64 in [0, 2^32)."""
    y1, y2 = _hash(key, shape)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in fp32: [minval, maxval) from the top 23 bits."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (``mode="low"``) in fp32: -log(-log(u)), u
    uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis with one
    (2,) key: one Gumbel draw of the logits' whole shape → int64 indices."""
    return (gumbel(key, logits.shape) + logits.float()).argmax(dim=-1)


def categorical_rows(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)``: row b of the (B,
    V) logits drawn with its own key ``keys[b]`` over a (V,) counter."""
    return (gumbel(keys, logits.shape[-1:]) + logits.float()).argmax(dim=-1)
