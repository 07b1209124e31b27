"""The port's kernel wrappers, device rules and import boundary.

This file imports no JAX, so it also runs on the GPU host, where there is
none. There the ``cuda`` tests build the CUDA kernels and hold each against
its plain PyTorch version (the repository's ``tests/conftest.py`` imports
JAX, so run it there with ``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Without a GPU the ``cuda`` tests skip and the rest check that a CPU tensor
takes the plain version and that other devices are refused.
"""

import ast
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from msr3d_tpu_torch import resolve_device
from msr3d_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference,
    flash_attention_reference,
)
from msr3d_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_reference
from msr3d_tpu_torch.ops.pointnet2 import gather_points
from msr3d_tpu_torch.ops.w4_matmul import (
    matmul_w4,
    matmul_w4_config,
    matmul_w4_reference,
    pack_w4,
    plan_w4,
)
from msr3d_tpu_torch.ops.w8_matmul import (
    MAX_SPLIT,
    STAGES,
    TILES,
    matmul_w8,
    matmul_w8_config,
    matmul_w8_reference,
    plan_w8,
)

from torch_flash_bwd_model import (
    CASE_IDS,
    CASES,
    kernel_model_backward,
    make_case,
    split16,
    torch_inputs,
)
from torch_flash_fwd_model import forward_inputs, kernel_model_forward
from torch_fps_model import kernel_model_fps, tie_clouds
from torch_w4_model import W4_STAGE_BYTES, kernel_model_w4
from torch_w8_model import k_ranges, kernel_model_w8

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    """The GPU, for tests of the CUDA kernels; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only there)")
    return torch.device("cuda", 0)


def _clouds(seed, b=6, n=64):
    r = np.random.default_rng(seed)
    xyz = (r.normal(size=(b, n, 3)) * 0.5).astype(np.float32)
    xyz[1, 40:] = 0.0  # trailing padding points
    xyz[2] = 0.0  # all padding: every index is 0
    xyz[3, ::3] *= 1e-3  # points inside the padding radius, interleaved
    return xyz


def test_fps_wrapper_takes_plain_version_on_cpu():
    xyz = torch.from_numpy(_clouds(1))
    assert torch.equal(furthest_point_sample(xyz, 16), furthest_point_sample_reference(xyz, 16))


# N for K1's tie and padding cases (tests/torch_fps_model.py::tie_clouds): the
# stage-2 input, one warp a cloud with two points a lane, ragged and full
# stage-1 inputs, the largest N
FPS_SIZES = (32, 33, 50, 64, 1000, 1024, 4096)


def _fps_npoint(n):
    return min(n, 40)  # past 32 rounds: the kernel stores its picks 32 at a time


@pytest.mark.parametrize("warps", (1, 2, 4, 8))
def test_fps_kernel_reduction_matches_plain_version(warps):
    """K1's reduction (keys, each lane's first best, warp max then min index,
    the W-slot reduce), modelled in plain PyTorch, against the plain version
    K1 is held to on the card."""
    for n in FPS_SIZES:
        xyz = torch.from_numpy(tie_clouds(n, n))
        assert torch.equal(kernel_model_fps(xyz, _fps_npoint(n), warps),
                           furthest_point_sample_reference(xyz, _fps_npoint(n)))


def test_flash_wrapper_takes_plain_version_on_cpu():
    r = np.random.default_rng(6)
    q = torch.from_numpy(r.normal(size=(1, 9, 2, 16)).astype(np.float32))
    got = flash_attention(q, q, q)
    want = flash_attention_reference(q, q, q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# K2f against its plain version: |out - plain| <= FLASH_ATOL + FLASH_RTOL * |plain|.
# Both round to bf16/fp16 (p at another point, the output once); one bf16 ulp
# is up to 2^-7 of the value. lse is fp32 on both sides, summed in another order
FLASH_ATOL, FLASH_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3


def _assert_forward_matches(got, want, valid):
    """(out, lse) of K2f or its model against ``want`` (the plain version's or
    the model's) on query rows with a valid key; rows without one exactly 0,
    output and lse."""
    (out, lse), (ref, ref_lse) = got, want
    assert out.dtype == ref.dtype and bool(torch.isfinite(out.float()).all())
    has_key, _ = _live_rows_and_keys(valid, out.shape[1])
    torch.testing.assert_close(out.float()[has_key], ref.float()[has_key], atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)
    torch.testing.assert_close(lse.transpose(1, 2)[has_key], ref_lse.transpose(1, 2)[has_key],
                               atol=LSE_ATOL, rtol=0)
    assert bool((out[~has_key] == 0).all()) and bool((lse.transpose(1, 2)[~has_key] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_flash_forward_kernel_arithmetic_matches_plain_version(case):
    """K2f's arithmetic (64-key tiles, base-2 exponentials against the running
    max, p rounded to the value dtype tile by tile, o = acc / l), modelled in
    plain PyTorch, against the plain version K2f is held to on the card."""
    q, k, v, valid = forward_inputs(case, make_case(case))
    _assert_forward_matches(kernel_model_forward(q, k, v, valid),
                            flash_attention_reference(q, k, v, key_valid=valid), valid)


def _bwd_inputs(gen_or_seed, b, t, s, hq, hkv, d, dtype, device, pads=()):
    """q/do (B, T, Hq, D), k/v (B, S, Hkv, D), left-padded key_valid, and the
    forward's lse plus delta = rowsum(do·o) from the plain forward."""
    if isinstance(gen_or_seed, int):
        gen_or_seed = torch.Generator(device=device).manual_seed(gen_or_seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen_or_seed, device=device).to(dtype)

    q, k, v, do = randn(b, t, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d), randn(b, t, hq, d)
    valid = torch.ones((b, s), dtype=torch.bool, device=device)
    for row, p in enumerate(pads):
        valid[row, :p] = False
    out, lse = flash_attention_reference(q, k, v, key_valid=valid)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, valid


def test_flash_backward_wrappers_take_plain_version_on_cpu():
    q, k, v, do, lse, delta, valid = _bwd_inputs(8, 2, 9, 9, 4, 2, 16, torch.float32, "cpu",
                                                 pads=(0, 3))
    args = (q, k, v, do, lse, delta)
    assert torch.equal(flash_attention_bwd_dq(*args, key_valid=valid),
                       flash_attention_bwd_dq_reference(*args, key_valid=valid))
    got, want = (flash_attention_bwd_dkv(*args, key_valid=valid),
                 flash_attention_bwd_dkv_reference(*args, key_valid=valid))
    assert got[0].shape == (2, 9, 4, 16)  # per q head, group-summed by the caller
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _live_rows_and_keys(valid, t):
    """(B, T) query rows with a valid key at or before them, and (B, S) valid
    keys that some query row reaches; the backward leaves the others at 0."""
    s = valid.shape[1]
    causal = torch.ones((t, s), dtype=torch.bool, device=valid.device).tril()
    has_key = (causal[None] & valid[:, None, :]).any(-1)
    reached = valid & (torch.arange(s, device=valid.device) < t)
    return has_key, reached


def _assert_backward_matches_plain(got, inputs):
    """(dq, dk, dv) against the plain versions: 16-bit outputs of the same
    fp32 sums in another order, one ulp apart at most (2^-7 of the value in
    bf16), 1e-2 absolute near zero; rows without a valid key and keys no query
    reaches exactly 0."""
    q, k, v, do, lse, delta, valid = inputs
    args = (q, k, v, do, lse, delta)
    want_dq = flash_attention_bwd_dq_reference(*args, key_valid=valid)
    want_dk, want_dv = flash_attention_bwd_dkv_reference(*args, key_valid=valid)
    for g, want in zip(got, (want_dq, want_dk, want_dv)):
        assert g.dtype == want.dtype and bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), want.float(), atol=1e-2, rtol=1e-2)
    has_key, reached = _live_rows_and_keys(valid, q.shape[1])
    assert bool((got[0][~has_key] == 0).all())
    assert bool((got[1][~reached] == 0).all()) and bool((got[2][~reached] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_flash_backward_kernel_arithmetic_matches_plain_version(case):
    """The kernels' arithmetic (p and ds as hi + lo 16-bit parts, products
    accumulated in fp32, one rounding of each gradient), modelled in plain
    PyTorch, against the plain versions K2dq and K2dkv are held to."""
    inputs = torch_inputs(case, make_case(case))
    _assert_backward_matches_plain(kernel_model_backward(*inputs), inputs)
    if case[0].endswith("row-without-valid-key"):
        dq, dk, dv = kernel_model_backward(*inputs)
        assert bool((dq[1] == 0).all()) and bool((dk[1] == 0).all()) and bool((dv[1] == 0).all())


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2.0 ** -17), (torch.float16, 2.0 ** -23)],
                         ids=["bf16", "fp16"])
def test_hi_lo_split_carries_fp32(dtype, rel):
    """hi + lo reproduces an fp32 value to 2^-17 relative in bf16 (each part
    rounds to 8 bits: 2^-9 of 2^-9) and 2^-23 in fp16 (11 bits each), plus
    2^-25 absolute where fp16's lo part underflows; one rounding alone keeps
    2^-9 (bf16) or 2^-12 (fp16)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy((r.normal(size=4096) * 10.0 ** r.uniform(-4, 1, size=4096))
                         .astype(np.float32))
    hi, lo = split16(x, dtype)
    err = (x.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= rel * x.double().abs() + 2.0 ** -25).all())
    one = (x.double() - hi.double()).abs()
    assert bool((err <= one).all()) and float(one.max()) > 100 * float(err.max())


def _dequant_inputs(seed, b, k, n, bits, device):
    """x (B, K) bf16, the weight (int8, or int4 packed by ``pack_w4``) and a
    per-channel scale of the size quantization gives N(0, 0.02) weights."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(size=(b, k)).astype(np.float32)).to(torch.bfloat16)
    if bits == 8:
        wq = torch.from_numpy(r.integers(-127, 128, size=(k, n)).astype(np.int8))
        scale = r.uniform(0.5, 1.5, size=n) * 0.09 / 127
    else:
        wq = pack_w4(torch.from_numpy(r.integers(-8, 8, size=(k, n)).astype(np.int8)))
        scale = r.uniform(0.5, 1.5, size=n) * 0.09 / 7
    return x.to(device), wq.to(device), torch.from_numpy(scale.astype(np.float32)).to(device)


def test_dequant_matmul_wrappers_take_plain_version_on_cpu():
    x, wq, scale = _dequant_inputs(9, 3, 64, 40, 8, "cpu")
    assert torch.equal(matmul_w8(x, wq, scale), matmul_w8_reference(x, wq, scale))
    x, wq, scale = _dequant_inputs(9, 3, 64, 40, 4, "cpu")
    assert torch.equal(matmul_w4(x, wq, scale), matmul_w4_reference(x, wq, scale))


# K3's split-K model: (B, K, N, split, tile). B 1-37, N 640/1000/1001, K with
# and without a partial k tile (tiles of 64, 128 and 256 rows), 1-8 splits
W8_MODEL_CASES = [
    (1, 512, 640, 1, 128), (4, 520, 1000, 2, 128), (7, 512, 1001, 3, 64),
    (16, 520, 640, 4, 32), (37, 1032, 1000, 5, 64), (16, 1024, 1001, 8, 128),
    (4, 777, 640, 6, 32), (37, 512, 1001, 7, 128), (7, 1544, 1000, 8, 32),
    (1, 264, 1001, 2, 32),
]


@pytest.mark.parametrize("b,k,n,split,tile", W8_MODEL_CASES)
def test_w8_kernel_model_matches_plain_version(b, k, n, split, tile):
    x, wq, scale = _dequant_inputs(b + k + n + split, b, k, n, 8, "cpu")
    want = matmul_w8_reference(x, wq, scale)
    got = kernel_model_w8(x, wq, scale, split, tile)
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs() <= _dequant_tolerance(x, scale, want, 8)).all())


@pytest.mark.parametrize("k,split,tile", [(520, 3, 64), (4096, 16, 128), (11008, 9, 32)])
def test_w8_split_ranges_cover_k_once(k, split, tile):
    """The ranges are contiguous, tile-aligned, cover K (the last tile's pad
    included) and none is empty while there are tiles to spare."""
    ranges = k_ranges(k, split, tile)
    kt = 8192 // tile
    assert ranges[0][0] == 0 and ranges[-1][1] == -(-k // kt) * kt
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s % kt == 0 and e > s for s, e in ranges)


@pytest.mark.parametrize("b", [1, 4, 16, 37])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096), (520, 1001)])
def test_w8_plan_is_an_instance(b, k, n):
    split, tile, stages = plan_w8(b, k, n)
    assert 1 <= split <= MAX_SPLIT and tile in TILES and stages in STAGES
    assert split <= -(-k // (8192 // tile))  # every split has a k tile


# K4's split-K model: (B, K, N, split, tile). B 1-37, N 640/1000/1001, K/2
# with and without a partial k tile (tiles of 128, 256 and 512 packed rows),
# K/2 odd or not a multiple of 8, 1-8 splits
W4_MODEL_CASES = [
    (1, 2048, 640, 1, 128), (4, 2064, 1000, 2, 128), (7, 2048, 1001, 3, 64),
    (16, 2080, 640, 4, 32), (37, 4112, 1000, 5, 64), (16, 4096, 1001, 8, 128),
    (4, 3106, 640, 6, 32), (37, 2048, 1001, 7, 128), (7, 6160, 1000, 8, 32),
    (1, 1058, 1001, 2, 32),
]


@pytest.mark.parametrize("b,k,n,split,tile", W4_MODEL_CASES)
def test_w4_kernel_model_matches_plain_version(b, k, n, split, tile):
    x, wq, scale = _dequant_inputs(b + k + n + split, b, k, n, 4, "cpu")
    want = matmul_w4_reference(x, wq, scale)
    got = kernel_model_w4(x, wq, scale, split, tile)
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs() <= _dequant_tolerance(x, scale, want, 4)).all())


@pytest.mark.parametrize("k,split,tile", [(2080, 3, 64), (8192, 16, 128), (22016, 9, 32),
                                          (3106, 3, 32)])
def test_w4_split_ranges_cover_k_once(k, split, tile):
    """K4's ranges over the K/2 packed rows (16 KB stages) are contiguous,
    tile-aligned, cover K/2 (the last tile's pad included) and none is empty
    while there are tiles to spare."""
    ranges = k_ranges(k // 2, split, tile, W4_STAGE_BYTES)
    kt = W4_STAGE_BYTES // tile
    assert ranges[0][0] == 0 and ranges[-1][1] == -(-(k // 2) // kt) * kt
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s % kt == 0 and e > s for s, e in ranges)


@pytest.mark.parametrize("b", [1, 4, 16, 37])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096), (1040, 1001)])
def test_w4_plan_is_an_instance(b, k, n):
    split, tile, stages = plan_w4(b, k, n)
    assert 1 <= split <= MAX_SPLIT and tile in TILES and stages in STAGES
    assert split <= -(-(k // 2) // (W4_STAGE_BYTES // tile))  # every split has a k tile


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty((2, 8, 3), device="meta")
    with pytest.raises(ValueError):
        furthest_point_sample(meta, 4)
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    rows = torch.empty((1, 2, 4), device="meta")
    for bwd in (flash_attention_bwd_dq, flash_attention_bwd_dkv):
        with pytest.raises(ValueError):
            bwd(q, q, q, q, rows, rows)
    x = torch.empty((2, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        matmul_w8(x, torch.empty((8, 4), dtype=torch.int8, device="meta"),
                  torch.empty(4, device="meta"))
    with pytest.raises(ValueError):
        matmul_w4(x, torch.empty((4, 4), dtype=torch.int8, device="meta"),
                  torch.empty(4, device="meta"))


# ---------------------------------------------------------------------------
# The kernels on the card (skip without a GPU)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_fps_kernel_equals_plain_version(cuda_device):
    xyz = torch.from_numpy(_clouds(7, b=16, n=1024)).to(cuda_device)
    for npoint in (32, 16, 64):  # PointNet++'s SA stages, PointBERT's groups
        got = furthest_point_sample(xyz, npoint)
        torch.cuda.synchronize()
        assert torch.equal(got, furthest_point_sample_reference(xyz, npoint))


@pytest.mark.cuda
@pytest.mark.parametrize("n", FPS_SIZES)
def test_fps_kernel_equals_plain_version_on_ties(cuda_device, n):
    xyz = torch.from_numpy(tie_clouds(n, n)).to(cuda_device)
    got = furthest_point_sample(xyz, _fps_npoint(n))
    torch.cuda.synchronize()
    assert torch.equal(got, furthest_point_sample_reference(xyz, _fps_npoint(n)))


@pytest.mark.cuda
@pytest.mark.parametrize("clouds", (240, 960), ids=["batch-4", "batch-16"])
def test_fps_kernel_equals_plain_version_at_path_shapes(cuda_device, clouds):
    """Both SA stages of a scene encode: 60 clouds a scene, 1024 -> 32, then
    the 32 picked points -> 16."""
    gen = torch.Generator(device=cuda_device).manual_seed(clouds)
    xyz = torch.randn((clouds, 1024, 3), generator=gen, device=cuda_device) * 0.3
    for npoint in (32, 16):
        got = furthest_point_sample(xyz, npoint)
        torch.cuda.synchronize()
        assert torch.equal(got, furthest_point_sample_reference(xyz, npoint))
        xyz = gather_points(xyz, got).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("warps", (1, 2, 4, 8))
def test_fps_kernel_every_instance_equals_plain_version(cuda_device, warps):
    """``fps_launch_config`` at each number of warps a cloud (and, for one
    warp and N <= 64, each number of clouds a block), as
    ``scripts/fps_variants.py`` times them."""
    import ctypes

    from msr3d_tpu_torch.ops._build import load_library

    fn = load_library("fps").fps_launch_config
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for n in FPS_SIZES:
        xyz = torch.from_numpy(tie_clouds(n, n)).to(cuda_device)
        want = furthest_point_sample_reference(xyz, _fps_npoint(n))
        for per_block in ((1, 2, 4, 8) if warps == 1 and n <= 64 else (1,)):
            got = torch.empty_like(want)
            assert fn(xyz.data_ptr(), got.data_ptr(), xyz.shape[0], n, _fps_npoint(n), warps,
                      per_block, stream) == 0
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, warps, per_block)


@pytest.mark.cuda
def test_fps_kernel_refuses_what_it_does_not_take(cuda_device):
    xyz = torch.zeros((2, 64, 3), device=cuda_device)
    with pytest.raises(TypeError):
        furthest_point_sample(xyz.double(), 8)
    with pytest.raises(ValueError):
        furthest_point_sample(xyz.transpose(0, 1), 8)  # not contiguous
    with pytest.raises(ValueError):
        furthest_point_sample(torch.zeros((1, 4097, 3), device=cuda_device), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,b,t,s,hq,hkv,pads", [
    (torch.bfloat16, 128, 2, 150, 150, 4, 4, (0, 20)),  # T not a multiple of the 64-row tile
    (torch.float16, 64, 2, 150, 150, 16, 4, (0, 20)),  # GQA n_rep 4
    (torch.bfloat16, 128, 4, 225, 225, 32, 32, (17, 0, 5, 40)),  # the prefill's shape
    (torch.bfloat16, 64, 2, 150, 150, 2, 1, (70, 0)),  # a pad over a whole 64-key tile
    (torch.float16, 128, 2, 333, 100, 4, 2, (3, 70)),  # T > S: rows past the last key
    (torch.bfloat16, 128, 2, 100, 333, 8, 2, (3, 70)),  # S > T: keys no query reaches
    (torch.bfloat16, 64, 3, 70, 70, 4, 2, (0, 5, 70)),  # a batch row without any valid key
], ids=["bf16-D128", "fp16-D64-gqa", "path-4x225x32x128", "pad-over-a-tile", "T-over-S",
        "S-over-T", "row-without-valid-key"])
def test_flash_kernel_matches_plain_version(cuda_device, dtype, d, b, t, s, hq, hkv, pads):
    q, k, v, *_, valid = _bwd_inputs(0, b, t, s, hq, hkv, d, dtype, cuda_device, pads=pads)
    got = flash_attention(q, k, v, key_valid=valid)
    torch.cuda.synchronize()
    _assert_forward_matches(got, flash_attention_reference(q, k, v, key_valid=valid), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_flash_kernel_matches_its_model(cuda_device, case):
    """K2f on the card against the plain model of its arithmetic, on the CPU."""
    q, k, v, valid = forward_inputs(case, make_case(case))
    qc, kc, vc, valid_c = (x.to(cuda_device) for x in (q, k, v, valid))
    out, lse = flash_attention(qc, kc, vc, key_valid=valid_c)
    torch.cuda.synchronize()
    _assert_forward_matches((out.cpu(), lse.cpu()), kernel_model_forward(q, k, v, valid), valid)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)  # head dim 32
    q = torch.zeros((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)  # float32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,n_rep,t,s,pads", [
    (torch.bfloat16, 128, 1, 150, 150, (0, 20)),  # T not a multiple of the 64-row tile
    (torch.float16, 64, 4, 150, 150, (0, 20)),
    (torch.bfloat16, 128, 4, 100, 333, (3, 70)),  # S > T: key tiles no query reaches
    (torch.float16, 128, 2, 333, 100, (3, 70)),  # T > S: query tiles past the last key
    (torch.bfloat16, 64, 2, 70, 70, (0, 70)),  # a batch row without any valid key
], ids=["bf16-D128", "fp16-D64-gqa", "S-over-T", "T-over-S", "row-without-valid-key"])
def test_flash_backward_kernels_match_plain_version(cuda_device, dtype, d, n_rep, t, s, pads):
    b, hkv = 2, 4
    inputs = _bwd_inputs(0, b, t, s, hkv * n_rep, hkv, d, dtype, cuda_device, pads=pads)
    q, k, v, do, lse, delta, valid = inputs
    args = (q, k, v, do, lse, delta)
    dq = flash_attention_bwd_dq(*args, key_valid=valid)
    dk, dv = flash_attention_bwd_dkv(*args, key_valid=valid)
    torch.cuda.synchronize()
    assert dk.shape == (b, s, hkv * n_rep, d)  # per q head, group-summed by the caller
    _assert_backward_matches_plain((dq, dk, dv), inputs)


@pytest.mark.cuda
def test_flash_backward_kernels_refuse_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    rows = torch.zeros((1, 2, 8), device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention_bwd_dq(q, q, q, q.half(), rows, rows)  # do of another dtype
    with pytest.raises(ValueError):
        flash_attention_bwd_dkv(q, q, q, q, rows.double(), rows)  # lse not fp32
    q32 = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention_bwd_dq(q32, q32, q32, q32, rows, rows)  # head dim 32


def _dequant_tolerance(x, scale, want, bits):
    """|kernel - plain| allowed: both take the same exact fp32 products in
    other summation orders and round once to bf16, so one bf16 ulp (2^-7 of
    the value) plus 1e-2 near 0. K4's plain version sums the +8-biased low
    nibbles and subtracts 8·rowsum(x_lo) after, which the kernel does not:
    the rounding of that larger biased sum is allowed for as 2^-16 of its
    bound 16·Σ|x|, times the scale."""
    tol = 1e-2 + 2.0 ** -7 * want.float().abs()
    if bits == 4:
        tol = tol + 2.0 ** -12 * x.float().abs().sum(1, keepdim=True) * scale.float().abs()
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b,k,n", [
    (4, 4096, 4096),  # decode rows at a 7B shape
    (16, 4096, 1000),  # N not a multiple of the 32-column tile
    (1, 512, 1001),  # odd N: the byte-wise loads
    (37, 256, 640),  # more rows than one 16-row tile
])
def test_dequant_matmul_kernels_match_plain_version(cuda_device, bits, b, k, n):
    x, wq, scale = _dequant_inputs(b * n + bits, b, k, n, bits, cuda_device)
    fns = {8: (matmul_w8, matmul_w8_reference), 4: (matmul_w4, matmul_w4_reference)}[bits]
    got, want = fns[0](x, wq, scale), fns[1](x, wq, scale)
    torch.cuda.synchronize()
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs() <= _dequant_tolerance(x, scale, want, bits)).all())


def _w8_close(got, x, wq, scale):
    want = matmul_w8_reference(x, wq, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    return bool(((got.float() - want.float()).abs() <= _dequant_tolerance(x, scale, want, 8)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_w8_kernel_matches_plain_version_at_7b_shapes(cuda_device, b, k, n):
    x, wq, scale = _dequant_inputs(b * k + n, b, k, n, 8, cuda_device)
    got = matmul_w8(x, wq, scale)
    torch.cuda.synchronize()
    assert _w8_close(got, x, wq, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", [
    (1, 520, 1001),  # odd N: byte loads; a partial k tile
    (7, 4104, 1000),  # N % 16 == 8: 4-byte copies
    (37, 520, 640),  # three row tiles
    (16, 777, 1001),  # odd K: x loaded element by element
    (5, 24, 96),  # K shorter than one k tile
])
def test_w8_kernel_matches_plain_version_on_ragged_shapes(cuda_device, b, k, n):
    x, wq, scale = _dequant_inputs(b + k + n, b, k, n, 8, cuda_device)
    got = matmul_w8(x, wq, scale)
    torch.cuda.synchronize()
    assert _w8_close(got, x, wq, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", STAGES)
@pytest.mark.parametrize("tile", TILES)
def test_w8_kernel_every_instance_matches_plain_version(cuda_device, tile, stages):
    """Every split 1-16 of the instance, on an aligned and a ragged shape,
    against the plain version and the model of its sum order."""
    for b, k, n in ((16, 4096, 1024), (7, 2600, 1000)):
        x, wq, scale = _dequant_inputs(tile + stages + k, b, k, n, 8, cuda_device)
        for split in range(1, MAX_SPLIT + 1):
            got = matmul_w8_config(x, wq, scale, split, tile, stages)
            torch.cuda.synchronize()
            assert _w8_close(got, x, wq, scale), (b, k, n, split)
            model = kernel_model_w8(x.cpu(), wq.cpu(), scale.cpu(), split, tile)
            assert bool(((got.cpu().float() - model.float()).abs()
                         <= _dequant_tolerance(x.cpu(), scale.cpu(), model, 8)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", [(16, 11008, 4096), (7, 520, 1001)])
def test_w8_kernel_two_calls_bit_identical(cuda_device, b, k, n):
    x, wq, scale = _dequant_inputs(b + k, b, k, n, 8, cuda_device)
    first, second = matmul_w8(x, wq, scale), matmul_w8(x, wq, scale)
    split_8 = (matmul_w8_config(x, wq, scale, 8, 64, 3), matmul_w8_config(x, wq, scale, 8, 64, 3))
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(*split_8)


def _w4_close(got, x, wq, scale):
    want = matmul_w4_reference(x, wq, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    return bool(((got.float() - want.float()).abs() <= _dequant_tolerance(x, scale, want, 4)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_w4_kernel_matches_plain_version_at_7b_shapes(cuda_device, b, k, n):
    x, wq, scale = _dequant_inputs(b * k + n + 4, b, k, n, 4, cuda_device)
    got = matmul_w4(x, wq, scale)
    torch.cuda.synchronize()
    assert _w4_close(got, x, wq, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", [
    (1, 1040, 1001),  # odd N: byte loads; a partial k tile
    (7, 4112, 1000),  # N % 16 == 8: 4-byte copies
    (37, 1040, 640),  # three row tiles
    (16, 1554, 1001),  # K/2 = 777, not a multiple of 8: x loaded element by element
    (16, 1036, 1024),  # K/2 = 518, even but not a multiple of 8: x loaded element by element
    (5, 48, 96),  # K/2 shorter than one k tile
])
def test_w4_kernel_matches_plain_version_on_ragged_shapes(cuda_device, b, k, n):
    x, wq, scale = _dequant_inputs(b + k + n + 4, b, k, n, 4, cuda_device)
    got = matmul_w4(x, wq, scale)
    torch.cuda.synchronize()
    assert _w4_close(got, x, wq, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", STAGES)
@pytest.mark.parametrize("tile", TILES)
def test_w4_kernel_every_instance_matches_plain_version(cuda_device, tile, stages):
    """Every split 1-16 of the instance, on an aligned and a ragged shape,
    against the plain version and the model of its sum order."""
    for b, k, n in ((16, 8192, 1024), (7, 5200, 1000)):
        x, wq, scale = _dequant_inputs(tile + stages + k + 4, b, k, n, 4, cuda_device)
        for split in range(1, MAX_SPLIT + 1):
            got = matmul_w4_config(x, wq, scale, split, tile, stages)
            torch.cuda.synchronize()
            assert _w4_close(got, x, wq, scale), (b, k, n, split)
            model = kernel_model_w4(x.cpu(), wq.cpu(), scale.cpu(), split, tile)
            assert bool(((got.cpu().float() - model.float()).abs()
                         <= _dequant_tolerance(x.cpu(), scale.cpu(), model, 4)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", [(16, 11008, 4096), (7, 1040, 1001)])
def test_w4_kernel_two_calls_bit_identical(cuda_device, b, k, n):
    x, wq, scale = _dequant_inputs(b + k + 4, b, k, n, 4, cuda_device)
    first, second = matmul_w4(x, wq, scale), matmul_w4(x, wq, scale)
    split_8 = (matmul_w4_config(x, wq, scale, 8, 64, 3), matmul_w4_config(x, wq, scale, 8, 64, 3))
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(*split_8)


@pytest.mark.cuda
def test_dequant_matmul_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros((2, 64), dtype=torch.bfloat16, device=cuda_device)
    scale = torch.ones(32, device=cuda_device)
    with pytest.raises(TypeError):
        matmul_w8(x, torch.zeros((64, 32), device=cuda_device), scale)  # float weight
    with pytest.raises(ValueError):
        matmul_w8(x, torch.zeros((32, 64), dtype=torch.int8, device=cuda_device).t(), scale)
    with pytest.raises(ValueError):
        matmul_w4(x, torch.zeros((32, 32), dtype=torch.int8, device=cuda_device), scale.cpu())


# ---------------------------------------------------------------------------
# Device rules and the import boundary
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_continuous_engine_on_card_equals_generate(cuda_device):
    """The tiny model's greedy slot-refill engine on the card (prefill
    through K1 and K2f, bf16 decode) at generate's shapes: one refill group
    the size of the batch at generate's prompt bucket, so the arithmetic is
    generate's and the tokens must be equal; then 8 requests through 4
    slots at mixed budgets stop at EOS or their budget."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig, SpatialEncoderConfig
    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.serving import ContinuousBatchingServer

    prompter = OSE3DConfig(
        hidden_size=32, spatial_encoder=SpatialEncoderConfig(
            num_attention_heads=4, dim_feedforward=64, dropout=0.0, num_layers=1),
        sa_n_points=(8, 4, None), sa_n_samples=(8, 8, None), sa_radii=(0.4, 0.8, None),
        sa_mlps=((3, 8, 8, 16), (16, 16, 16, 32), (32, 32, 32, 64)))
    llm = LlamaConfig.tiny(vocab_size=263, hidden_size=256, intermediate_size=512,
                           flash_attention=True)  # head_dim 64, one of K2f's
    cfg = MSR3DNetworkConfig(prompter=prompter, llm=llm, backbone_name="convnext_test")
    model = MSR3D(cfg, scene_token_len=5, max_out_len=8, repetition_penalty=1.5,
                  device=cuda_device)
    model.init_params(seed=0)
    r = np.random.default_rng(0)
    reqs = [{"msr3d_prompt": f"Scene 景 here. What is object {i}?" + " Be brief." * (i % 3),
             "obj_fts": (r.normal(size=(6, 32, 6)) * 0.3).astype(np.float32),
             "obj_masks": np.ones(6, bool), "obj_locs": r.normal(size=(6, 6)).astype(np.float32),
             "anchor_locs": r.normal(size=3).astype(np.float32),
             "anchor_orientation": np.array([0, 0, 0, 1], np.float32)} for i in range(8)]
    keys = [k for k in reqs[0] if k != "msr3d_prompt"]

    def batch(qs):
        return {"msr3d_prompt": [q["msr3d_prompt"] for q in qs],
                **{k: np.stack([q[k] for q in qs]) for k in keys}}

    ids, _ = model._encode_prompts(model.build_text_prompt(batch(reqs[:4])))
    bucket = max(32, -(-ids.shape[1] // 32) * 32) + 1
    want = model.generate(batch(reqs[:4]), use_beam=False)["output_tokens"]
    engine = ContinuousBatchingServer(model, num_slots=4, refill_group=4, chunk_steps=3,
                                      prompt_len=bucket)
    FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
    got = engine.run(reqs[:4])
    assert FPS_KERNEL.launches == 2 and FLASH_FWD_KERNEL.launches == 2  # one refill group
    for res in got:
        np.testing.assert_array_equal(res.output_tokens, want[res.id])
    budgets = [1, 8, 3, 5, 2, 8, 4, 6]
    engine = ContinuousBatchingServer(model, num_slots=4, refill_group=2, chunk_steps=3,
                                      prompt_len=bucket)
    eos = model.tokenizer.eos_id
    for res in engine.run(reqs, budgets=budgets):
        toks = np.asarray(res.output_tokens)
        assert (toks[budgets[res.id]:] == eos).all()
        assert ((toks >= 0) & (toks < 263)).all()
    assert engine.steps_run > 0


@pytest.mark.cuda
def test_pool_engine_on_card_equals_generate(cuda_device):
    """The tiny model in fp32 (dense attention, TF32 off) on the card: the
    greedy prefix-pool engine over 2 scenes x 2 questions with 2 blocks and
    2 slots gives ``generate``'s tokens, one prefix prefill a scene (K1
    twice each); the beam pool engine gives batch-1 beam ``generate``'s."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig, SpatialEncoderConfig
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.serving import (
        PrefixPoolContinuousBatchingServer,
        PrefixPoolContinuousBeamBatchingServer,
    )

    prompter = OSE3DConfig(
        hidden_size=32, spatial_encoder=SpatialEncoderConfig(
            num_attention_heads=4, dim_feedforward=64, dropout=0.0, num_layers=1),
        sa_n_points=(8, 4, None), sa_n_samples=(8, 8, None), sa_radii=(0.4, 0.8, None),
        sa_mlps=((3, 8, 8, 16), (16, 16, 16, 32), (32, 32, 32, 64)))
    llm = LlamaConfig.tiny(vocab_size=263, dtype=torch.float32, param_dtype=torch.float32)
    cfg = MSR3DNetworkConfig(prompter=prompter, llm=llm, backbone_name="convnext_test")
    model = MSR3D(cfg, scene_token_len=5, max_out_len=8, num_beams=2, repetition_penalty=1.5,
                  device=cuda_device)
    model.init_params(seed=0)
    r = np.random.default_rng(1)
    reqs = []
    for s in range(2):
        scene = {"obj_fts": (r.normal(size=(6, 32, 6)) * 0.3).astype(np.float32),
                 "obj_masks": np.ones(6, bool), "obj_locs": r.normal(size=(6, 6)).astype(np.float32),
                 "anchor_locs": r.normal(size=3).astype(np.float32),
                 "anchor_orientation": np.array([0, 0, 0, 1], np.float32)}
        reqs += [dict(scene, msr3d_prompt=f"Scene {s}: 景. USER: what is object {q}?")
                 for q in range(2)]
    keys = [k for k in reqs[0] if k != "msr3d_prompt"]

    def batch(qs):
        return {"msr3d_prompt": [q["msr3d_prompt"] for q in qs],
                **{k: np.stack([q[k] for q in qs]) for k in keys}}

    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = model.generate(batch(reqs), use_beam=False)["output_tokens"]
        kw = dict(num_slots=2, num_prefixes=2, prefix_len=32, suffix_len=32, refill_group=1,
                  chunk_steps=3)
        engine = PrefixPoolContinuousBatchingServer(model, **kw)
        FPS_KERNEL.launches = 0
        got = engine.run(reqs)
        assert engine.prefix_prefills == 2 and FPS_KERNEL.launches == 2 * 2
        for res in got:
            np.testing.assert_array_equal(res.output_tokens, want[res.id])
        beam = PrefixPoolContinuousBeamBatchingServer(model, **kw)
        for res in beam.run(reqs):
            one = model.generate(batch([reqs[res.id]]), use_beam=True)["output_tokens"][0]
            np.testing.assert_array_equal(res.output_tokens, one)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


@pytest.mark.cuda
@pytest.mark.parametrize("situation_type", ["as_object", "as_cross_attention"])
def test_situation_modes_on_card_match_cpu(cuda_device, situation_type):
    """The LEO prompter (``as_object``: the anchor as a token) at a small
    width on the card, K1 inside, against the same module on the CPU (plain
    FPS): equal sampled points, so the fp32 tokens agree within 1e-4 (cuBLAS
    and the CPU sum in other orders; TF32 off)."""
    from msr3d_tpu_torch.models.ose3d_situation import (
        OSE3DConfig,
        OSE3DSituation,
        SpatialEncoderConfig,
    )
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    cfg = OSE3DConfig(
        hidden_size=64, situation_type=situation_type,
        spatial_encoder=SpatialEncoderConfig(num_attention_heads=4, dim_feedforward=128,
                                             num_layers=2),
        sa_n_points=(16, 8, None), sa_n_samples=(16, 16, None), sa_radii=(0.4, 0.8, None),
        sa_mlps=((3, 16, 16, 32), (32, 32, 32, 64), (64, 64, 64, 128)),
        obj_encoder_dtype="float32")
    torch.manual_seed(0)
    cpu = OSE3DSituation(cfg).eval()
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    card = OSE3DSituation(cfg, device=cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(1)
    masks = np.ones((2, 7), bool)
    masks[1, -3:] = False
    quat = r.normal(size=(2, 4))
    inputs = {"obj_fts": (r.normal(size=(2, 7, 128, 6)) * 0.3).astype(np.float32),
              "obj_masks": masks, "obj_locs": r.normal(size=(2, 7, 6)).astype(np.float32),
              "anchor_locs": r.normal(size=(2, 3)).astype(np.float32),
              "anchor_orientation": (quat / np.linalg.norm(quat, axis=1, keepdims=True))
              .astype(np.float32)}
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = cpu(**{k: torch.from_numpy(v) for k, v in inputs.items()})
            FPS_KERNEL.launches = 0
            got = card(**{k: torch.from_numpy(v).to(cuda_device) for k, v in inputs.items()})
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    assert FPS_KERNEL.launches == 2
    n = 8 if situation_type == "as_object" else 7
    assert got["obj_tokens"].shape == (2, n, 64)
    torch.testing.assert_close(got["obj_tokens"].cpu(), want["obj_tokens"], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got["obj_masks"].cpu(), want["obj_masks"])


def test_fixture_crops_decode_and_preprocess_to_their_manifest():
    """The committed object crops through the port's ``decode_jpeg`` and
    ``preprocess_2d`` give the digests of Pillow's decode and JAX's
    ``preprocess_2d`` in their manifest (``tests/test_torch_jpeg.py``
    wrote both and holds them to Pillow and JAX). No Pillow and no JAX
    here, so the GPU host runs it too."""
    from msr3d_tpu_torch.data.data_utils import preprocess_2d
    from msr3d_tpu_torch.data.jpeg import decode_jpeg

    crops = REPO / "msr3d_tpu_torch" / "data" / "fixtures" / "crops"
    manifest = json.loads((crops / "manifest.json").read_text())
    assert len(manifest["crops"]) >= 8

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for entry in manifest["crops"]:
        img = decode_jpeg(crops / entry["file"])
        assert list(img.shape) == entry["shape"], entry["file"]
        assert sha(img) == entry["decoded_sha256"], entry["file"]
        for w, h in ((224, 224), (32, 32)):
            assert sha(preprocess_2d(img, size=(w, h))) == entry[f"preprocess_{w}x{h}_sha256"], \
                (entry["file"], w, h)


def test_default_device_is_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "msr3d_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] \
        + sorted((REPO / "scripts").glob("*_variants.py"))
    assert len(files) > 10 and REPO / "scripts" / "fps_variants.py" in files
    assert REPO / "scripts" / "w8_variants.py" in files
    assert REPO / "scripts" / "w4_variants.py" in files
    for name in ("serving.py", "serving_http.py", "serve.py", "models/llm/llama.py",
                 "models/msr3d.py", "trainer/leo_trainer.py", "nn/grounding.py",
                 "nn/pointbert.py", "nn/pcd_tokenize.py", "optim/losses.py",
                 "data/datasets/scannet_legacy.py", "data/png.py", "data/datasets/nmr.py",
                 "nn/srt.py", "nn/swin3d.py", "ops/softgroup.py", "ops/host_geometry.py"):
        assert REPO / "msr3d_tpu_torch" / name in files
    bad = []
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "optax", "orbax", "msr3d_tpu", "PIL", "scipy",
                        "transformers", "yaml"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
