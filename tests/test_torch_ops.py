"""Parity of the port's ops (``msr3d_tpu_torch.ops``) with the JAX package.

Same numpy inputs through both. FPS and ball-query indices must be equal;
float ops agree within 1e-5 in fp32 (the two frameworks sum in other
orders). The kernels themselves are held against these plain versions on
the card by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.ops import geometry as jgeo
from msr3d_tpu.ops import pointnet2 as jpn
from msr3d_tpu.ops.flash_attention import dense_attention_reference
from msr3d_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from msr3d_tpu.ops.pallas.fps import furthest_point_sample_pallas
from msr3d_tpu_torch.ops import geometry as tgeo
from msr3d_tpu_torch.ops import pointnet2 as tpn
from msr3d_tpu_torch.ops.flash_attention import flash_attention_reference
from msr3d_tpu_torch.ops.fps import furthest_point_sample_reference

ATOL = 1e-5


def _clouds(seed, b=6, n=64):
    r = np.random.default_rng(seed)
    xyz = (r.normal(size=(b, n, 3)) * 0.5).astype(np.float32)
    xyz[1, 40:] = 0.0  # trailing padding points
    xyz[2] = 0.0  # all padding: every index is 0
    xyz[3, ::3] *= 1e-3  # points inside the padding radius, interleaved
    return xyz


# ---------------------------------------------------------------------------
# FPS (kernel K1's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,npoint", [(64, 16), (32, 32), (50, 7)])
def test_fps_plain_matches_jax_xla_and_pallas(n, npoint):
    xyz = _clouds(0, n=n)
    want_xla = np.asarray(jpn.furthest_point_sample(jnp.asarray(xyz), npoint))
    want_pallas = np.asarray(
        furthest_point_sample_pallas(jnp.asarray(xyz), npoint, interpret=True)
    )
    got = furthest_point_sample_reference(torch.from_numpy(xyz), npoint).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got[2], 0)


# ---------------------------------------------------------------------------
# Ball query and grouping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius,nsample,n", [(0.4, 8, 64), (0.8, 16, 12), (0.05, 4, 64)])
def test_ball_query_matches_jax(radius, nsample, n):
    r = np.random.default_rng(2)
    xyz = (r.normal(size=(3, n, 3)) * 0.5).astype(np.float32)
    new_xyz = xyz[:, :5] + (r.normal(size=(3, 5, 3)) * 0.1).astype(np.float32)
    want = np.asarray(jpn.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    got = tpn.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    np.testing.assert_array_equal(got.numpy(), want)


def test_grouping_matches_jax():
    r = np.random.default_rng(3)
    xyz = (r.normal(size=(2, 40, 3)) * 0.5).astype(np.float32)
    feats = r.normal(size=(2, 40, 5)).astype(np.float32)
    idx = r.integers(0, 40, size=(2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tpn.gather_points(torch.from_numpy(xyz), torch.from_numpy(idx)).numpy(),
        np.asarray(jpn.gather_points(jnp.asarray(xyz), jnp.asarray(idx))),
    )
    new_xyz = xyz[:, :7]
    want = np.asarray(jpn.query_and_group(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats), 0.5, 8))
    got = tpn.query_and_group(torch.from_numpy(xyz), torch.from_numpy(new_xyz),
                              torch.from_numpy(feats), 0.5, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    want_all = np.asarray(jpn.group_all(jnp.asarray(xyz), jnp.asarray(feats)))
    got_all = tpn.group_all(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got_all.numpy(), want_all)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def test_geometry_matches_jax():
    r = np.random.default_rng(4)
    centers = r.normal(size=(2, 7, 3)).astype(np.float32)
    sizes = np.abs(r.normal(size=(2, 7, 3))).astype(np.float32)
    loc = r.normal(size=(2, 3)).astype(np.float32)
    quat = r.normal(size=(2, 4))
    quat = (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        tgeo.quaternion_to_matrix(t(quat)).numpy(),
        np.asarray(jgeo.quaternion_to_matrix(jnp.asarray(quat))), atol=ATOL)
    moved = tgeo.transform_to_agent_coor(t(centers), t(loc), t(quat))
    np.testing.assert_allclose(
        moved.numpy(),
        np.asarray(jgeo.transform_to_agent_coor(
            jnp.asarray(centers), jnp.asarray(loc), jnp.asarray(quat))), atol=ATOL)
    np.testing.assert_allclose(
        tgeo.calc_pairwise_locs(t(centers), t(sizes)).numpy(),
        np.asarray(jgeo.calc_pairwise_locs(jnp.asarray(centers), jnp.asarray(sizes))),
        atol=ATOL)
    # jnp.linspace and torch.linspace round some frequency bands one ulp
    # apart, so sin/cos see arguments (up to ~150 rad here) one ulp apart:
    # ~1.5e-5 at that magnitude
    np.testing.assert_allclose(
        tgeo.generate_fourier_features(moved).numpy(),
        np.asarray(jgeo.generate_fourier_features(jnp.asarray(moved.numpy()))), atol=3e-5)


# ---------------------------------------------------------------------------
# Flash attention (kernel K2f's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b,t,s,hq,hkv,d",
    [(2, 37, 37, 4, 4, 16), (2, 40, 40, 8, 2, 16), (1, 20, 45, 4, 1, 32)],
    ids=["mha", "gqa", "ragged"],
)
def test_flash_plain_matches_jax_flash_and_dense(b, t, s, hq, hkv, d):
    r = np.random.default_rng(5)
    q = r.normal(size=(b, t, hq, d)).astype(np.float32)
    k = r.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = r.normal(size=(b, s, hkv, d)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[0, :9] = False  # left padding: the first 9 query rows see no key
    out, lse = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_valid=torch.from_numpy(valid))
    jq, jk, jv, jvalid = map(jnp.asarray, (q, k, v, valid))
    want_flash = np.asarray(jax_flash_attention(jq, jk, jv, key_valid=jvalid, interpret=True))
    want_dense = np.asarray(dense_attention_reference(jq, jk, jv, key_valid=jvalid))
    has_key = (np.tril(np.ones((t, s), bool))[None] & valid[:, None, :]).any(-1)
    np.testing.assert_allclose(out.numpy()[has_key], want_flash[has_key], atol=ATOL)
    np.testing.assert_allclose(out.numpy()[has_key], want_dense[has_key], atol=ATOL)
    np.testing.assert_array_equal(out.numpy()[~has_key], 0.0)  # the kernel's contract
    # lse: log-sum-exp of the scaled, masked scores; 0 where no key is valid
    kr = np.repeat(k, hq // hkv, axis=2)
    logits = np.einsum("bthd,bshd->bhts", q, kr).astype(np.float64) / np.sqrt(d)
    mask = np.tril(np.ones((t, s), bool))[None, None] & valid[:, None, None, :]
    logits = np.where(mask, logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        want_lse = np.where(has_key.transpose(0, 1)[:, None, :],
                            (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0],
                            0.0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4)
