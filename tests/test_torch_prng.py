"""The port's threefry stream (``msr3d_tpu_torch/models/llm/prng.py``) against
``jax.random`` (JAX 0.9.0, ``jax_threefry_partitionable`` on, its default).

Keys, ``fold_in``, ``split`` and 32-bit random bits are integer arithmetic
and must be bit-equal, over several seeds and shapes, one key over a whole
array and one key a row (``jax.vmap``); so must the uniforms built from
them. The Gumbel noise takes two logs, the platform's against XLA's: it is
held to |port - JAX| <= 1e-6 * max(1, |g|) (a few fp32 ulp of each log;
measured 4.8e-7 at most). ``categorical`` draws must pick the same
indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu_torch.models.llm import prng

SEEDS = [0, 1, 7, 42, -5, 2 ** 31 - 1]
SHAPES = [(37,), (3, 37), (2, 3, 5), (4, 1000)]
GUMBEL_RTOL = 1e-6
TINY = float(np.finfo(np.float32).tiny)

_bits = jax.jit(lambda k, shape: jax.random.bits(k, shape), static_argnums=1)
_uniform = jax.jit(lambda k, shape, lo: jax.random.uniform(k, shape, minval=lo, maxval=1.0),
                   static_argnums=(1, 2))
_gumbel = jax.jit(lambda k, shape: jax.random.gumbel(k, shape), static_argnums=1)
_categorical = jax.jit(jax.random.categorical)
_categorical_rows = jax.jit(jax.vmap(jax.random.categorical))
_fold_rows = jax.jit(jax.vmap(jax.random.fold_in))
_split_rows = jax.jit(jax.vmap(lambda k: jax.random.split(k, 3)))


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), _np(key))
    for data in (0, 3, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tkey, data).numpy(),
                                      _np(jax.random.fold_in(key, data)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                      _np(jax.random.split(key, num)))
    # a chain as the decode loops use it: split, then split the first half
    k, tk = key, tkey
    for _ in range(4):
        k, _ = jax.random.split(k)
        tk, _ = prng.split(tk)
    np.testing.assert_array_equal(tk.numpy(), _np(k))


def test_batched_keys_bit_equal():
    """Per-row keys, as the continuous engine folds them: fold_in of (B, 2)
    keys with (B,) data, and split of each row's key (``jax.vmap``)."""
    rids = np.array([0, 1, 5, 2 ** 31 + 7, 9], np.uint32)
    keys = jnp.broadcast_to(jax.random.PRNGKey(11), (5, 2))
    want = _fold_rows(keys, jnp.asarray(rids))
    got = prng.fold_in(prng.prng_key(11).expand(5, 2), torch.from_numpy(rids.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(prng.split(got, 3).numpy(), _np(_split_rows(want)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform_bit_equal(seed, shape):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    np.testing.assert_array_equal(prng.random_bits(tkey, shape).numpy(), _np(_bits(key, shape)))
    for lo in (0.0, TINY):
        np.testing.assert_array_equal(prng.uniform(tkey, shape, minval=lo).numpy(),
                                      np.asarray(_uniform(key, shape, lo)))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gumbel_within_bound(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(_gumbel(key, (8, 4096)))
    got = prng.gumbel(prng.prng_key(seed), (8, 4096)).numpy()
    assert got.dtype == np.float32
    err = np.abs(got - want)
    assert (err <= GUMBEL_RTOL * np.maximum(1.0, np.abs(want))).all(), err.max()


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_equal(seed):
    """One key over a (B, V) array (the fixed-batch sampling loop) and one
    key a row (the engine's ``vmap``), over logits with -inf entries, as
    top-k/top-p leave them."""
    r = np.random.default_rng(seed % 1000)
    logits = (r.normal(size=(6, 263)) * 2).astype(np.float32)
    logits[:, r.random(263) < 0.3] = -np.inf
    key = jax.random.PRNGKey(seed)
    got = prng.categorical(prng.prng_key(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_categorical(key, jnp.asarray(logits))))
    keys = jax.random.split(key, 6)
    got_rows = prng.categorical_rows(torch.from_numpy(_np(keys)), torch.from_numpy(logits))
    np.testing.assert_array_equal(got_rows.numpy(),
                                  np.asarray(_categorical_rows(keys, jnp.asarray(logits))))
    assert np.isfinite(logits[np.arange(6), got_rows.numpy()]).all()


def test_seed_outside_int32_raises():
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2 ** 31)
