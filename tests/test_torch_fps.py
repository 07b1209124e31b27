"""K1's reduction (``msr3d_tpu_torch/csrc/fps.cu``), modelled in plain
PyTorch by ``tests/torch_fps_model.py``, against the JAX package's FPS: the
XLA version (``msr3d_tpu/ops/pointnet2.py``) and the Pallas TPU kernel in
interpret mode (``msr3d_tpu/ops/pallas/fps.py``). Indices must be equal, on
clouds built to make ties and the padding rules bite, at every N the kernel
sizes itself for (one warp a cloud up to 64 points, a lane holding 1 to 32
points, N not a multiple of 32, N = 4096) and with 1, 2, 4 and 8 warps a
cloud. The kernel itself is held against the plain version on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.ops import pointnet2 as jpn
from msr3d_tpu.ops.pallas.fps import furthest_point_sample_pallas
from msr3d_tpu_torch.ops.fps import furthest_point_sample_reference

from torch_fps_model import kernel_model_fps, launch_shape, tie_clouds

# N: the stage-2 input (32), one warp a cloud with two points a lane (33,
# 50, 64), ragged and full stage-1 inputs (1000, 1024), the largest N (4096)
SIZES = (32, 33, 50, 64, 1000, 1024, 4096)
WARPS = (1, 2, 4, 8)


def _npoint(n):
    return min(n, 40)  # past 32 rounds: the kernel stores its picks 32 at a time


@functools.lru_cache(maxsize=None)
def _jax_picks(n):
    xyz = tie_clouds(n, n)
    npoint = _npoint(n)
    xla = np.asarray(jpn.furthest_point_sample(jnp.asarray(xyz), npoint))
    pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint, interpret=True))
    return xyz, xla, pallas


@pytest.mark.parametrize("warps", WARPS)
@pytest.mark.parametrize("n", SIZES)
def test_fps_kernel_reduction_matches_jax(n, warps):
    xyz, xla, pallas = _jax_picks(n)
    np.testing.assert_array_equal(xla, pallas)
    got = kernel_model_fps(torch.from_numpy(xyz), _npoint(n), warps).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got[2], 0)  # all padding


@pytest.mark.parametrize("n", SIZES)
def test_fps_plain_version_matches_jax_on_ties(n):
    xyz, xla, _ = _jax_picks(n)
    got = furthest_point_sample_reference(torch.from_numpy(xyz), _npoint(n)).numpy()
    np.testing.assert_array_equal(got, xla)


def test_fps_tie_clouds_make_the_rules_bite():
    """The clouds hold what they are for: equal distances across lanes and
    warps, a valid point picked at distance 0, padding picked never, and
    points on both sides of the padding threshold."""
    n = 1024
    xyz, xla, _ = _jax_picks(n)
    assert launch_shape(n, 8) == (8, 4)
    sq = (xyz.astype(np.float64) ** 2).sum(-1)
    assert (sq[6] > 1e-3).any() and (sq[6] <= 1e-3).any()
    assert (xla[1, 2:] == 0).all()  # every valid point at distance 0: the first wins
    assert (sq[3, 0] <= 1e-3) and (xla[3, 0] == 0)  # the seed is index 0, padding or not
    for row in (0, 3, 4, 5):
        assert (sq[row][xla[row, 1:]] > 1e-3).all()  # later picks are never padding
    d = ((xyz[0] - xyz[0, 0]) ** 2).sum(-1)
    assert np.unique(d).size < n // 20  # many equal distances in one round
