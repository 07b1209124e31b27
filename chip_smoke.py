"""Chip smoke test of the PyTorch/CUDA port (``msr3d_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``msr3d_tpu_torch/csrc`` with
``nvcc`` for ``sm_90a`` (one process per source, in parallel) and holds each
kernel against its plain PyTorch version at the shapes of the main paths
(phases 2, 3, 5 and 7; phase 2 times K1 a launch at both SA stages at 240
and 960 clouds, phases 3 and 5 time K2f, K2dq, K2dkv and the library's
forward and backward L2-warm and from HBM, and the whole body of
``FlashAttention.backward``).
Then it drives the port's paths at the flagship
width (OSE3D prompter: 60 objects x 1024 points; ConvNeXt-base image
encoder, 60 images of 224² a request; Vicuna-7B-geometry Llama, bf16, LoRA
r16 on all seven projections, flash attention) with random weights from a
seed: greedy ``MSR3D.generate`` (phase 4), beam-5 ``MSR3D.generate`` with
the ancestry map and with the reordered cache (phase 9), two optimizer
steps of ``LeoTrainer`` at the flagship's solver (phase 6), and greedy
generation with the LLM quantized on the card in four serving
configurations (phase 8, int8/int4 weights, int8 KV cache, s8xs8; beam-5
on the int8 KV cache), and the training entry (phase 10: ``python -m
msr3d_tpu_torch.run`` on ``configs/msr3d.yaml`` over a synthetic MSQA tree
that the phase writes, a Vicuna-7B ``config.json`` and a small BPE
``tokenizer.model``; 2 optimizer steps, nothing injected), and checks that
each path launched its kernels. Any failed check exits
non-zero. The last two lines of standard output are the per-kernel JSON
line and the result line ``{"ok": true, "device": {...}}``; without a GPU,
or without the package beside it, it exits non-zero and prints no result.
``--profile`` adds the device time by kernel of one more generate (bf16
greedy and beam, int8) and the device busy share of one more optimizer step
(``torch.profiler``).
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np

try:
    import torch
except ImportError:
    print("chip_smoke: PyTorch is not installed", file=sys.stderr)
    sys.exit(2)

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
# K2f vs its plain version: |out - plain| <= ATOL + RTOL * |plain|. Both round
# to bf16 (p at another point, the output once); one bf16 ulp is up to 2^-7
# of the value, and rows with few valid keys give outputs as large as |v| ~ 3
FLASH_ATOL, FLASH_RTOL = 1e-2, 1e-2
LSE_ATOL = 1e-3  # fp32 on both sides; only the summation order differs
# First-token logits of the whole prefill, K2f against its plain version
# (relative L2). With random weights, 32 bf16 layers amplify any change of
# rounding: on an H100 the JAX package's dense route (scores rounded to bf16)
# lands 5.2e-2 from the plain flash route, and K2f 4.9e-2. The kernel itself
# is held layer by layer at the kernel tolerance above; this gate catches a
# wiring fault (wrong head, layout or mask), which moves the logits by O(1)
E2E_RTOL = 0.1
# K2dq/K2dkv vs their plain version: |grad - plain| <= BWD_ATOL + BWD_RTOL *
# |plain|. Both sides take the same fp32 math (the 16-bit products are exact
# in fp32) in other summation orders and round dq, dk and dv to bf16/fp16
# once, so they land at most one ulp apart: 2^-7 of the value in bf16; the
# absolute term covers gradients near 0 (of order 1 here)
BWD_ATOL, BWD_RTOL = 1e-2, 1e-2
# All trainable gradients of one flagship micro-batch, the backward through
# K2dq/K2dkv against the backward through their plain version (relative L2).
# Each layer's attention gradients differ by at most one bf16 ulp (held layer
# by layer at the kernel tolerance above); the backward carries such changes
# through 32 bf16 layers, so they reach the gradients at the percent level
# at most. A wiring fault (head, layout, mask or a missing term) moves them
# by O(1); this gate catches that, not rounding
GRAD_RTOL = 0.1
# K3/K4 vs their plain version: |y - plain| <= DEQ_ATOL + DEQ_RTOL * |plain|. Both
# take the same exact fp32 products (bf16 x int8) in other summation orders and
# round once to bf16: one bf16 ulp (2^-7 of the value) apart, 1e-2 near 0. K4's
# plain version sums the +8-biased low nibbles and subtracts 8 * rowsum(x_lo)
# after, the kernel does not: the rounding of that larger biased sum is allowed
# for as DEQ_W4_BIAS * sum_k |x_k| * |scale_n| (2^-16 of its bound 16 sum|x|)
DEQ_ATOL, DEQ_RTOL, DEQ_W4_BIAS = 1e-2, 2.0 ** -7, 2.0 ** -12
# Each int4 projection of a decode step against the fp32 dequant oracle
# x @ (q * bf16(s)), relative L2: LoraDense rounds two half-products, their
# sum, the scale product (per channel) or each scaled weight (by group) to
# bf16, a few roundings of 2^-9 each. A wrong nibble, half or group moves it
# by O(1)
QUANT_ORACLE_RTOL = 1e-2
# s8xs8 adds the per-token int8 rounding of x (a step of amax/127, some 1e-2
# of the values' spread); the gate catches a wrong scale or layout, O(1)
ACT_ORACLE_RTOL = 0.1
SHAPES_7B = ((4096, 4096), (4096, 11008), (11008, 4096))  # (K, N): q/k/v/o, gate/up, down
# Phase 7 times each shape over copies of its weights that together span this
# many bytes, five times the H100's 50 MB L2, so each timed launch reads its
# weight from HBM as a decode step does
L2_SPAN_BYTES = 256 * 2**20
N_REQUESTS, NEW_TOKENS, REP_PENALTY = 4, 32, 3.0
# the reference's eval decode (msr3d_tpu/models/build.py:101-105): beam 5,
# repetition penalty 3.0, length penalty 1.0; cut from 256 to NEW_TOKENS tokens
BEAMS, LENGTH_PENALTY = 5, 1.0
# every MSQA sample carries msr3d_max_img_num images of img_size, padded with
# zeros and masked by the dataset wrapper (configs/msr3d.yaml:109,144)
MAX_IMAGES, IMAGE_SIZE = 60, 224
_SCENE_KEYS = ("obj_fts", "obj_masks", "obj_locs", "anchor_locs", "anchor_orientation")
# the flagship's solver (configs/msr3d.yaml:32-47): batch 4 x accumulation 5
TRAIN_ACCUM, TRAIN_STEPS = 5, 2
WIRING_LR, WIRING_STEPS = 1e-3, 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rows(prof):
    """(device ms, launches, name) of every kernel in a ``torch.profiler``
    profile; ops are left out, they would count their kernels twice."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key))
    return rows


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``: the summed durations of the
    kernels it launches, from ``torch.profiler``, over ``iters`` calls. Unlike
    an event loop it holds no host time, so it is right for a kernel shorter
    than its wrapper's Python (some tens of microseconds). Now and then a
    profile on the H100 comes back without device events (once, in phase 5,
    in this script's runs so far); it is then taken again, and after three
    empty ones the mean time by CUDA events stands in, with a note in the
    log."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(ms for ms, _, _ in kernel_rows(prof))
        if total > 0:
            return total / iters
        print("  torch.profiler recorded no device time; profiling again")
    print("  three empty profiles: this time is by CUDA events, which hold host time")
    return time_ms(fn, iters, warmup=0)


def rotating(fn, operands):
    """``fn`` on the next set of ``operands`` at each call, round and round."""
    it = itertools.cycle(operands)
    return lambda: fn(*next(it))


def past_l2(*tensors):
    """Copies of ``tensors`` (the first is kept) that together span
    L2_SPAN_BYTES, as argument tuples."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, -(-L2_SPAN_BYTES // nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` states them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def phase_card_and_build():
    print("== phase 1: card and kernel build")
    print(card_line())
    from msr3d_tpu_torch.ops import _build

    t0 = time.perf_counter()
    sources = ["fps", "flash_attn_fwd", "flash_attn_bwd", "w8_matmul", "w4_matmul"]
    # K3's and K4's earlier design, timed beside them in phases 7 and 8
    parents = {bits: start_parent_build(bits) for bits in PARENTS}
    paths = _build.build_all(sources)
    for bits, proc in parents.items():
        finish_parent_build(bits, proc)
    print(f"  built {[p.name for p in paths]} and {[lib.name for _, lib in PARENTS.values()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in sources:
        log = (_build.BUILD_DIR / f"{name}.log")
        if not log.exists():
            continue
        entry, spills = "", []
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip().replace('ptxas info    : ', '')}")
                if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    spills.append(entry)
        which = {"fps": "K1's instances", "flash_attn_fwd": "K2f",
                 "flash_attn_bwd": "K2dq and K2dkv", "w8_matmul": "K3's instances",
                 "w4_matmul": "K4's instances"}[name]
        check(not spills, f"no register spills in {which} {spills or ''}")


# K3's and K4's earlier design (the int8 and int4 instances of
# scripts/dequant_matmul.cuh, fp32 products on the CUDA cores), built from
# scripts/w8_parent.cu and scripts/w4_parent.cu to be timed beside them
_ROOT = Path(__file__).resolve().parent
PARENTS = {bits: (_ROOT / "scripts" / f"w{bits}_parent.cu",
                  _ROOT / "build" / "kernels" / f"libw{bits}_parent.so") for bits in (8, 4)}
_PARENT_FNS = {}


def start_parent_build(bits: int) -> subprocess.Popen:
    from msr3d_tpu_torch.ops import _build

    source, lib = PARENTS[bits]
    lib.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_parent_build(bits: int, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"K{3 if bits == 8 else 4}'s earlier design builds "
                                f"({PARENTS[bits][0].name})"
                                + ("" if proc.returncode == 0 else f":\n{log}"))


def parent_call(bits, x, wq, scale):
    """K3's (bits 8) or K4's (bits 4) earlier design on CUDA tensors (bf16 x,
    contiguous int8 wq, fp32 scale) -> y (B, N) bf16."""
    import ctypes

    fn = _PARENT_FNS.get(bits)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(PARENTS[bits][1])), f"w{bits}_parent_launch")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _PARENT_FNS[bits] = fn
    b, k, n = x.shape[0], x.shape[1], wq.shape[1]
    y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(), b, k, n,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise SmokeFailure(f"K{3 if bits == 8 else 4}'s earlier design failed to launch: CUDA "
                           f"error {err}")
    return y


def int8pack_call(x, scale):
    """``torch._weight_int8pack_mm`` (PyTorch's own int8 weight-only product,
    the weight as (N, K), scales in x's dtype) as fn(wq_t) -> y, or the
    reason it does not run on this card."""
    xb, sb = x.to(torch.bfloat16), scale.to(torch.bfloat16)
    try:
        probe = torch._weight_int8pack_mm(xb, torch.zeros((scale.shape[0], x.shape[1]),
                                                          dtype=torch.int8, device=x.device), sb)
        torch.cuda.synchronize()
        assert probe.shape == (x.shape[0], scale.shape[0])
    except (RuntimeError, NotImplementedError, AttributeError, AssertionError) as exc:
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    return (lambda wq_t: torch._weight_int8pack_mm(xb, wq_t, sb)), None


INT4PACK_GROUP = 256  # tinygemm's largest group; K 4096 and 11008 are multiples of it


def int4pack_operands(wq, scale):
    """K4's weight ((K/2, N) in ``pack_w4``'s layout) and scale as the
    operands of ``torch._weight_int4pack_mm`` (PyTorch's own int4 weight-only
    product, tinygemm, which computes x · ((u − 8) · s + z)): u = v + 8 of
    each of the K rows as (N, K), two a byte, converted by
    ``torch._convert_weight_to_int4pack`` (8 inner k tiles); the per-channel
    scale at bf16 repeated over K / INT4PACK_GROUP groups, z = 0."""
    half, n = wq.shape
    byte = wq.view(torch.uint8).to(torch.int32)
    u = torch.cat([byte & 0xF, ((byte >> 4) & 0xF) ^ 8]).t().contiguous()  # (N, K): v + 8
    w = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
    sz = torch.zeros((2 * half // INT4PACK_GROUP, n, 2), dtype=torch.bfloat16, device=wq.device)
    sz[..., 0] = scale.to(torch.bfloat16)
    return w, sz


def int4pack_call(x, wq, scale):
    """``torch._weight_int4pack_mm`` on x as fn(w, sz) -> y and the operands
    of (wq, scale) for it (:func:`int4pack_operands`), or the reason it does
    not run on this card."""
    xb = x.to(torch.bfloat16)
    try:
        if x.shape[1] % INT4PACK_GROUP:
            raise ValueError(f"K {x.shape[1]} is not a multiple of the group {INT4PACK_GROUP}")
        ops = int4pack_operands(wq, scale)
        probe = torch._weight_int4pack_mm(xb, ops[0], INT4PACK_GROUP, ops[1])
        torch.cuda.synchronize()
        assert probe.shape == (x.shape[0], wq.shape[1])
    except (RuntimeError, NotImplementedError, AttributeError, AssertionError, ValueError) as exc:
        return None, None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    return (lambda w, sz: torch._weight_int4pack_mm(xb, w, INT4PACK_GROUP, sz)), ops, None


def kernel_label(mangled: str) -> str:
    """A mangled template instantiation as 'kernel<type, ints>', enough to
    tell the ptxas lines apart."""
    name = None
    for i in range(len(mangled)):  # a length-prefixed source name: 16w8_matmul_kernel
        m = re.match(r"\d+", mangled[i:])
        ident = mangled[i + len(m.group(0)):i + len(m.group(0)) + int(m.group(0))] if m else ""
        if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
            name = ident
            break
    if name is None:
        m = re.search(r"[a-z_]+_kernel", mangled)
        name = m.group(0).lstrip("_") if m else mangled[:40]
    dtype = "bf16" if "bfloat16" in mangled else "fp16" if "6__half" in mangled else ""
    ints = re.findall(r"L[ib](\d+)E", mangled)
    return f"{name}<{', '.join(filter(None, [dtype, *ints]))}>"


FPS_OBJECTS = 60  # object clouds a scene, so 240 clouds at batch 4 and 960 at batch 16


def fps_path_inputs(dev, clouds: int, seed: int):
    """The two launches of one scene encode at ``clouds`` clouds: SA stage 1
    (1024 points -> 32) and stage 2 (the 32 picked points -> 16)."""
    from msr3d_tpu_torch.ops.fps import furthest_point_sample_reference
    from msr3d_tpu_torch.ops.pointnet2 import gather_points

    gen = torch.Generator(device=dev).manual_seed(seed)
    xyz1 = torch.randn((clouds, 1024, 3), generator=gen, device=dev) * 0.3
    xyz2 = gather_points(xyz1, furthest_point_sample_reference(xyz1, 32)).contiguous()
    return {f"{clouds}x1024->32": (xyz1, 32), f"{clouds}x32->16": (xyz2, 16)}


def fps_tie_cases(dev, seed: int):
    """Clouds that make K1's ties and padding rules bite, as (xyz, npoint)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def lattice(b, n):  # step 0.25: exact squares, many equal distances; the origin is padding
        return torch.randint(-3, 4, (b, n, 3), generator=gen, device=dev).float() * 0.25

    pair = torch.tensor([[0.5, -0.25, 0.75], [-1.0, 0.5, 0.25]], device=dev)
    padded = torch.randn((8, 1024, 3), generator=gen, device=dev) * 0.3
    padded[:, 700:] = 0.0  # trailing padding points
    padded[3] = 0.0  # a cloud of padding only
    padded[5, :, :] *= 1e-3  # every point inside the padding radius
    padded[6, ::3] *= 1e-3  # every third point inside it
    return {
        "lattice 240x1024 (equal distances across lanes and warps)": (lattice(240, 1024), 32),
        # every point at one of two positions: after two rounds every valid
        # point is at distance 0, and the first of them wins
        "two positions (valid points at distance 0)": (
            pair[torch.randint(0, 2, (16, 1024), generator=gen, device=dev)], 40),
        "padded": (padded, 32),
        "N=33": (lattice(60, 33), 33),
        "N=50": (lattice(60, 50), 40),
        "N=1000": (lattice(60, 1000), 40),
        "4096 points": (torch.randn((3, 4096, 3), generator=gen, device=dev), 64),
        "4096 lattice": (lattice(3, 4096), 64),
    }


def fps_bound(*launches):
    """(ms, 'bytes' or 'operations') for the (xyz, npoint) launches together:
    each xyz read once, the picks written once; nine fp32 operations per
    point and round."""
    nbytes = sum(x.numel() * 4 + x.shape[0] * m * 4 for x, m in launches)
    flops = sum(x.shape[0] * x.shape[1] * (m - 1) * 9 for x, m in launches)
    return bound(nbytes, flops, H100_FP32_FLOPS)


def phase_fps(dev):
    print("== phase 2: K1 (FPS) against its plain version")
    from msr3d_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_reference

    path = {**fps_path_inputs(dev, N_REQUESTS * FPS_OBJECTS, 1),
            **fps_path_inputs(dev, 16 * FPS_OBJECTS, 3)}
    cases = {**path, **fps_tie_cases(dev, 5)}
    worst = 0
    for name, (x, m) in cases.items():
        got, want = furthest_point_sample(x, m), furthest_point_sample_reference(x, m)
        torch.cuda.synchronize()
        worst = max(worst, (got - want).abs().max().item())
        check(torch.equal(got, want), f"K1 indices equal to the plain version ({name})")
    padded, m = cases["padded"]
    check(bool((furthest_point_sample(padded, m)[3] == 0).all()),
          "K1 gives all zeros for an all-padding cloud")
    # device time of each launch by torch.profiler (a wrapper's Python and
    # ctypes call outlast the kernel, so an event loop would time the host)
    per_launch = {name: device_ms(lambda x=x, m=m: furthest_point_sample(x, m), iters=50)
                  for name, (x, m) in path.items()}
    for name, ms in per_launch.items():
        print(f"  K1 {name}: {ms:.5f} ms of device time a launch (L2-warm), bound "
              f"{fps_bound(path[name])[0]:.6f} ms")
    encode = {}  # batch -> (device ms, (bound ms, by what)) of both launches
    for batch in (N_REQUESTS, 16):
        names = [f"{batch * FPS_OBJECTS}x1024->32", f"{batch * FPS_OBJECTS}x32->16"]
        encode[batch] = (sum(per_launch[n] for n in names), fps_bound(*(path[n] for n in names)))
    stages = [path[f"{N_REQUESTS * FPS_OBJECTS}x1024->32"], path[f"{N_REQUESTS * FPS_OBJECTS}x32->16"]]
    plain_ms = time_ms(lambda: [furthest_point_sample_reference(x, m) for x, m in stages], iters=5)
    ms, (b_ms, b_by) = encode[N_REQUESTS]
    print(f"  K1 per scene encode at batch {N_REQUESTS} (both launches): {ms:.5f} ms, plain "
          f"{plain_ms:.4f} ms (an event loop), bound {b_ms:.6f} ms ({b_by}); at batch 16 "
          f"{encode[16][0]:.5f} ms, bound {encode[16][1][0]:.6f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=float(worst), ms_per_launch=per_launch,
                ms_batch16=encode[16][0], bound_ms_batch16=encode[16][1][0])


def flash_against_plain(q, k, v, valid):
    """K2f and its plain version on the same causal problem: the output,
    its errors on query rows with a valid key, and whether the rows without
    one are exactly 0 (output and lse), as the TPU kernel leaves them."""
    from msr3d_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    out, lse = flash_attention(q, k, v, key_valid=valid)
    ref, ref_lse = flash_attention_reference(q, k, v, key_valid=valid)
    torch.cuda.synchronize()
    t, s = q.shape[1], k.shape[1]
    causal = torch.ones((t, s), dtype=torch.bool, device=q.device).tril()
    has_key = (causal[None] & valid.bool()[:, None, :]).any(-1)  # (B, T)
    delta = (out.float() - ref.float()).abs()[has_key]
    return dict(
        out=out, lse=lse,
        err=delta.max().item(),
        ratio=(delta / (FLASH_ATOL + FLASH_RTOL * ref.float().abs()[has_key])).max().item(),
        lse_err=(lse - ref_lse).abs().transpose(1, 2)[has_key].max().item(),
        finite=bool(torch.isfinite(out.float()).all()),
        zeros=bool((out[~has_key] == 0).all()) and bool((lse.transpose(1, 2)[~has_key] == 0).all()),
    )


def phase_flash(dev):
    print("== phase 3: K2f (flash-attention forward) against its plain version")
    import torch.nn.functional as F

    from msr3d_tpu_torch.ops import _build
    from msr3d_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    gen = torch.Generator(device=dev).manual_seed(2)

    def make(b, t, s, hq, hkv, d, dtype, pads):
        q = torch.randn((b, t, hq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        for row, p in enumerate(pads):
            valid[row, :p] = False  # left padding, as the prompt buckets have
        return q, k, v, valid

    path_pads = (17, 0, 5, 40)
    cases = {
        "path 4x225x32x128 bf16": make(4, 225, 225, 32, 32, 128, torch.bfloat16, path_pads),
        "GQA n_rep=4": make(2, 300, 300, 32, 8, 128, torch.bfloat16, (0, 33)),
        "ragged T=100 S=333 D=64 fp16": make(2, 100, 333, 8, 8, 64, torch.float16, (3, 70)),
        # a left pad over a whole 64-key tile: rows whose first key tile is all masked
        "pad 70 > 64, T=S=150 D=64": make(2, 150, 150, 8, 2, 64, torch.bfloat16, (70, 0)),
        # more query rows than keys, and a batch row without any valid key
        "T=333 S=100 D=128 fp16": make(2, 333, 100, 4, 4, 128, torch.float16, (3, 70)),
        "T=70 S=70, one batch row all invalid": make(3, 70, 70, 4, 2, 128, torch.bfloat16,
                                                     (0, 5, 70)),
    }
    worst = 0.0
    for name, (q, k, v, valid) in cases.items():
        res = flash_against_plain(q, k, v, valid)
        worst = max(worst, res["err"])
        print(f"  {name}: max |out - plain| {res['err']:.3e}, max |out - plain| / "
              f"({FLASH_ATOL} + {FLASH_RTOL}|plain|) {res['ratio']:.3f}, "
              f"max |lse - plain| {res['lse_err']:.3e} (tol {LSE_ATOL})")
        check(res["finite"], f"K2f output finite ({name})")
        check(res["ratio"] <= 1.0 and res["lse_err"] <= LSE_ATOL,
              f"K2f within tolerance ({name})")
        check(res["zeros"], f"K2f rows without a valid key are exactly 0 ({name})")

    blocks = _build.load_library("flash_attn_fwd").flash_attn_fwd_blocks_per_sm()
    print(f"  blocks of K2f an SM at D 128 bf16, by the runtime's occupancy calculation: {blocks}")
    check(blocks >= 2, "two blocks of K2f share an SM")

    q, k, v, valid = cases["path 4x225x32x128 bf16"]
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=dev).tril()[None, None] & valid[:, None, None, :]

    def k2f(q_, k_, v_):
        return flash_attention(q_, k_, v_, key_valid=valid)

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_.transpose(1, 2), k_.transpose(1, 2),
                                              v_.transpose(1, 2), attn_mask=mask)

    # three timings of each: a call in an event loop (it holds the wrapper's
    # Python, which outlasts the kernel), the kernels' own device time on one
    # L2-warm operand set, and on sets rotating past the L2
    sets = past_l2(q, k, v)
    loop_ms = time_ms(lambda: k2f(q, k, v), iters=50)
    warm_ms = device_ms(lambda: k2f(q, k, v), iters=50)
    ms = device_ms(rotating(k2f, sets), iters=6 * len(sets))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, key_valid=valid))
    library_loop = time_ms(lambda: sdpa(q, k, v), iters=50)
    library_warm = device_ms(lambda: sdpa(q, k, v), iters=50)
    library_ms = device_ms(rotating(sdpa, sets), iters=6 * len(sets))
    backend = sdpa_backend(lambda: sdpa(q, k, v))
    del sets
    b, _, hq, d = q.shape
    pairs = (mask[:, 0].sum().item()) * hq  # unmasked (row, key) pairs over batch and heads
    # q, k, v and key_valid read once; the output and lse written once
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + valid.numel() \
        + b * hq * t * 4
    flops = pairs * 4 * d  # q.k and p.v, 2 flops per multiply-add
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
    print(f"  K2f at the path shape: {ms:.4f} ms from HBM, {warm_ms:.4f} ms L2-warm (device time "
          f"of the kernel), {loop_ms:.4f} ms a call in an event loop; plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by})")
    print(f"  SDPA forward (boolean mask, backend: {backend}): {library_ms:.4f} ms from HBM, "
          f"{library_warm:.4f} ms L2-warm (device time of its kernels), {library_loop:.4f} ms a "
          f"call in an event loop")
    return dict(ms=ms, ms_warm=warm_ms, ms_warm_event_loop=loop_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                library_ms_warm=library_warm, max_abs_err=worst, blocks_per_sm=blocks)


def bwd_against_plain(q, k, v, do, lse, delta, valid, kernels):
    """K2dq and K2dkv (``kernels``: their two wrappers) and their plain
    version on the same inputs: the errors on query rows with a valid key
    (dq) and on keys some query reaches (dk, dv), and whether the others are
    exactly 0, as the TPU kernels leave them."""
    from msr3d_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq_reference,
    )

    args = (q, k, v, do, lse, delta)
    dq = kernels[0](*args, key_valid=valid)
    dk, dv = kernels[1](*args, key_valid=valid)
    want_dq = flash_attention_bwd_dq_reference(*args, key_valid=valid)
    want_dk, want_dv = flash_attention_bwd_dkv_reference(*args, key_valid=valid)
    torch.cuda.synchronize()
    t, s = q.shape[1], k.shape[1]
    causal = torch.ones((t, s), dtype=torch.bool, device=q.device).tril()
    has_key = (causal[None] & valid.bool()[:, None, :]).any(-1)  # (B, T)
    reached = valid.bool() & (torch.arange(s, device=q.device) < t)  # (B, S)
    err = ratio = 0.0
    zeros = finite = True
    for got, want, live in ((dq, want_dq, has_key), (dk, want_dk, reached),
                            (dv, want_dv, reached)):
        delta_abs = (got.float() - want.float()).abs()[live]
        err = max(err, delta_abs.max().item())
        ratio = max(ratio, (delta_abs / (BWD_ATOL + BWD_RTOL * want.float().abs()[live]))
                    .max().item())
        zeros = zeros and bool((got[~live] == 0).all())
        finite = finite and bool(torch.isfinite(got.float()).all())
    return dict(dq=dq, dk=dk, dv=dv, err=err, ratio=ratio, zeros=zeros, finite=finite)


def phase_flash_backward(dev):
    print("== phase 5: K2dq and K2dkv (flash-attention backward) against their plain version")
    import torch.nn.functional as F

    from msr3d_tpu_torch.ops import _build
    from msr3d_tpu_torch.ops.flash_attention import (
        FlashAttention,
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(5)

    def make(b, t, s, hq, hkv, d, dtype, pads):
        q, do = (torch.randn((b, t, hq, d), generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        for row, p in enumerate(pads):
            valid[row, :p] = False  # left padding, as the prompt buckets have
        out, lse = flash_attention(q, k, v, key_valid=valid)  # K2f, as the path has it
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, delta, valid

    cases = {
        "path 4x256x32x128 bf16": make(4, 256, 256, 32, 32, 128, torch.bfloat16,
                                       (17, 0, 5, 40)),
        "GQA n_rep=4": make(2, 300, 300, 32, 8, 128, torch.bfloat16, (0, 33)),
        "ragged T=100 S=333 D=64 fp16": make(2, 100, 333, 8, 8, 64, torch.float16, (3, 70)),
        # more query rows than keys, and a batch row without any valid key
        "T=333 S=100 D=128 fp16": make(2, 333, 100, 4, 4, 128, torch.float16, (3, 70)),
        "T=70 S=70, one batch row all invalid": make(3, 70, 70, 4, 2, 128, torch.bfloat16,
                                                     (0, 5, 70)),
    }
    worst = 0.0
    for name, inputs in cases.items():
        res = bwd_against_plain(*inputs, (flash_attention_bwd_dq, flash_attention_bwd_dkv))
        worst = max(worst, res["err"])
        print(f"  {name}: max |grad - plain| {res['err']:.3e} over dq/dk/dv, max |grad - plain|"
              f" / ({BWD_ATOL} + {BWD_RTOL}|plain|) {res['ratio']:.3f}")
        check(res["finite"], f"K2dq/K2dkv outputs finite ({name})")
        check(res["ratio"] <= 1.0, f"K2dq/K2dkv within tolerance ({name})")
        check(res["zeros"], f"dq of rows without a valid key and dk/dv of keys no query "
                            f"reaches are exactly 0 ({name})")

    occupancy = _build.load_library("flash_attn_bwd").flash_attn_bwd_blocks_per_sm
    blocks = {name: occupancy(which) for which, name in enumerate(("K2dq", "K2dkv"))}
    print(f"  blocks of 4 warps an SM at D 128 bf16, by the runtime's occupancy calculation: "
          f"{blocks}")
    check(min(blocks.values()) >= 2, "two blocks of K2dq and of K2dkv share an SM")

    q, k, v, do, lse, delta, valid = cases["path 4x256x32x128 bf16"]
    args = (q, k, v, do, lse, delta)

    def dq_fn(*a):
        return flash_attention_bwd_dq(*a, key_valid=valid)

    def dkv_fn(*a):
        return flash_attention_bwd_dkv(*a, key_valid=valid)

    # three timings of each kernel: the event loop as before (it holds the
    # wrapper's Python, which outlasts these kernels), the kernel's own device
    # time on one L2-warm operand set, and on sets rotating past the L2
    sets = past_l2(*args)
    dq_loop = time_ms(lambda: dq_fn(*args), iters=50)
    dkv_loop = time_ms(lambda: dkv_fn(*args), iters=50)
    dq_warm = device_ms(lambda: dq_fn(*args), iters=50)
    dkv_warm = device_ms(lambda: dkv_fn(*args), iters=50)
    dq_ms = device_ms(rotating(dq_fn, sets), iters=6 * len(sets))
    dkv_ms = device_ms(rotating(dkv_fn, sets), iters=6 * len(sets))
    dq_plain = time_ms(lambda: flash_attention_bwd_dq_reference(*args, key_valid=valid))
    dkv_plain = time_ms(lambda: flash_attention_bwd_dkv_reference(*args, key_valid=valid))

    b, t, hq, d = q.shape
    mask = torch.ones((t, t), dtype=torch.bool, device=dev).tril()[None, None] \
        & valid[:, None, None, :]

    def library_on(q_, k_, v_, do_, *_):
        """SDPA's backward on one operand set: the forward outside the timing."""
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q_, k_, v_))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dout = do_.transpose(1, 2)
        return lambda: torch.autograd.grad(out, (qt, kt, vt), dout, retain_graph=True)

    library = library_on(*args)
    library_loop = time_ms(library, iters=50)
    library_warm = device_ms(library, iters=50)
    library_sets = [library_on(*ops) for ops in sets]
    library_ms = device_ms(rotating(lambda fn: fn(), [(fn,) for fn in library_sets]),
                           iters=6 * len(sets))
    backend = sdpa_backend(library)
    del library_sets, sets

    pairs = mask[:, 0].sum().item() * hq  # unmasked (row, key) pairs over batch and heads
    elem = q.element_size()
    reads = (2 * q.numel() + k.numel() + v.numel()) * elem + 2 * b * hq * t * 4 + valid.numel()
    dq_bound = bound(reads + q.numel() * elem, pairs * 3 * 2 * d, H100_BF16_FLOPS)
    dkv_bound = bound(reads + 2 * b * t * hq * d * elem, pairs * 4 * 2 * d, H100_BF16_FLOPS)
    print(f"  K2dq at the path shape: {dq_ms:.4f} ms from HBM, {dq_warm:.4f} ms L2-warm (device "
          f"time of the kernel), {dq_loop:.4f} ms a call in an event loop; plain {dq_plain:.4f} "
          f"ms, bound {dq_bound[0]:.6f} ms ({dq_bound[1]})")
    print(f"  K2dkv at the path shape: {dkv_ms:.4f} ms from HBM, {dkv_warm:.4f} ms L2-warm, "
          f"{dkv_loop:.4f} ms a call in an event loop; plain {dkv_plain:.4f} ms, bound "
          f"{dkv_bound[0]:.6f} ms ({dkv_bound[1]})")
    print(f"  the pair {dq_ms + dkv_ms:.4f} ms from HBM, {dq_warm + dkv_warm:.4f} ms L2-warm; SDPA "
          f"backward (boolean mask, backend: {backend}) for dq, dk and dv together "
          f"{library_ms:.4f} ms from HBM, {library_warm:.4f} ms L2-warm (device time of its "
          f"kernels), {library_loop:.4f} ms a call in an event loop")

    # the whole body of FlashAttention.backward: delta, K2dq, K2dkv and the
    # GQA group-sum, on the saved tensors of a forward
    whole = {}
    for name in ("path 4x256x32x128 bf16", "GQA n_rep=4"):
        q, k, v, do, lse, _, valid = cases[name]
        ctx = SimpleNamespace(saved_tensors=(q, k, v, valid, flash_attention(
            q, k, v, key_valid=valid)[0], lse))
        whole[name] = (device_ms(lambda: FlashAttention.backward(ctx, do), iters=50),
                       time_ms(lambda: FlashAttention.backward(ctx, do), iters=50))
        print(f"  FlashAttention.backward, whole body ({name}): {whole[name][0]:.4f} ms of device "
              f"time L2-warm (delta, K2dq, K2dkv, group-sum), {whole[name][1]:.4f} ms a call in "
              f"an event loop")
    whole_ms = whole["path 4x256x32x128 bf16"][0]
    shared = dict(library_ms=library_ms, library_ms_warm=library_warm, max_abs_err=worst,
                  whole_backward_ms_warm=whole_ms, blocks_per_sm=min(blocks.values()))
    return (
        dict(ms=dq_ms, ms_warm=dq_warm, ms_warm_event_loop=dq_loop, plain_ms=dq_plain,
             bound_ms=dq_bound[0], bound_by=dq_bound[1], **shared),
        dict(ms=dkv_ms, ms_warm=dkv_warm, ms_warm_event_loop=dkv_loop, plain_ms=dkv_plain,
             bound_ms=dkv_bound[0], bound_by=dkv_bound[1], **shared),
    )


def sdpa_backend(fn) -> str:
    """Which of PyTorch's attention backends ``fn`` ran, from its kernels' names."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(name.lower() for _, _, name in kernel_rows(prof))
    for tag, label in (("cudnn", "cuDNN"), ("flash", "flash"),
                       ("fmha", "memory-efficient (CUTLASS fmha)"),
                       ("efficient", "memory-efficient")):
        if tag in names:
            return label
    return "math (plain ops)"


def make_requests(seed: int, b: int = N_REQUESTS, images: bool = False):
    """``b`` requests built like bench_qa.py's (60 objects x 1024 points).
    With ``images``, as the flagship serves them: request i shows 1 + i % 4
    images of 224², one 图 placeholder each in its prompt, padded with zeros
    to 60 and masked as the dataset wrapper pads them (the prompt stays
    inside the 224-token bucket)."""
    r = np.random.default_rng(seed)
    n_obj, n_pts = 60, 1024
    data = {
        "msr3d_prompt": [
            "You are an AI visual assistant situated in a 3D scene. "
            "Objects (including you) in the scene: 景 "
            f"USER: What is behind the chair number {i}? ASSISTANT:"
            for i in range(b)
        ],
        "obj_fts": (r.normal(size=(b, n_obj, n_pts, 6)) * 0.3).astype(np.float32),
        "obj_masks": np.ones((b, n_obj), bool),
        "obj_locs": r.normal(size=(b, n_obj, 6)).astype(np.float32),
        "anchor_locs": r.normal(size=(b, 3)).astype(np.float32),
        "anchor_orientation": np.tile(np.array([0, 0, 0, 1], np.float32), (b, 1)),
    }
    if images:
        shown = [1 + i % 4 for i in range(b)]
        data["msr3d_prompt"] = [
            f"You are an AI assistant in a 3D scene, seen in {'图' * n}. "
            "Objects (including you) in the scene: 景 "
            f"USER: What is behind the chair number {i}? ASSISTANT:"
            for i, n in enumerate(shown)
        ]
        imgs = np.zeros((b, MAX_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3), np.float32)
        for i, n in enumerate(shown):
            imgs[i, :n] = r.standard_normal((n, IMAGE_SIZE, IMAGE_SIZE, 3), np.float32)
        data["msr3d_imgs"] = imgs
        data["msr3d_img_masks"] = np.arange(MAX_IMAGES)[None, :] < np.array(shown)[:, None]
    return data


def build_flagship_model(dev, lora_rank: int = 16, what: str = "the flagship model of phases 4 and 6"):
    """OSE3DConfig() (spatial dropout 0.1) and the Vicuna-7B-geometry Llama
    (bf16 base, LoRA r16 on all seven projections, LoRA dropout 0.0 as
    configs/msr3d.yaml, flash attention), answer-window loss, random weights
    from seed 0."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig

    llm = LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, lora_rank=lora_rank,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, flash_attention=True,
    )
    cfg = MSR3DNetworkConfig(prompter=OSE3DConfig(), llm=llm, answer_window_loss=True)
    print(f"== {what}")
    t0 = time.perf_counter()
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=60, max_out_len=NEW_TOKENS,
                  repetition_penalty=REP_PENALTY, device=dev)
    model.init_params(seed=0)
    torch.cuda.synchronize()
    print(f"  built and initialised in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.network.parameters()) / 1e9:.3f} B parameters")
    return model


def phase_generate(model, dev, profile: bool):
    print(f"== phase 4: greedy MSR3D.generate at the flagship width, {MAX_IMAGES} images of "
          f"{IMAGE_SIZE}² a request ({model.cfg.backbone_name}, {model.cfg.image_pooling} "
          "pooling)")
    import msr3d_tpu_torch.models.llm.llama as llama
    import msr3d_tpu_torch.nn.pointnet as pointnet
    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL, flash_attention_reference
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL, furthest_point_sample_reference

    llm = model.cfg.llm
    data = make_requests(seed=0, images=True)
    model.generate(dict(data), use_beam=False)  # warm-up: cuBLAS handles, allocator

    FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    gen_ms = wall_ms(lambda: data.update(model.generate(dict(data), use_beam=False)))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = {"fps": FPS_KERNEL.launches, "flash_attn_fwd": FLASH_FWD_KERNEL.launches}
    print(f"  launches during generate: {launches}")
    check(launches["fps"] == 2, "K1 launched twice per scene encode (SA stages 1 and 2)")
    check(launches["flash_attn_fwd"] == llm.num_hidden_layers,
          "K2f launched once per layer in prefill (32)")
    tokens = data["output_tokens"]
    check(tokens.shape == (N_REQUESTS, NEW_TOKENS)
          and bool(((tokens >= 0) & (tokens < llm.vocab_size)).all()),
          f"generated tokens of shape {tokens.shape} inside the vocabulary")

    net = model.network
    prompts = model.build_text_prompt(data)
    ids, attn = model._pad_to_bucket(*model._encode_prompts(prompts), side="left")
    scene = model._scene_batch(data)
    points = {k: scene[k] for k in _SCENE_KEYS}
    ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    attn_t = torch.as_tensor(attn, dtype=torch.int32, device=dev)
    with torch.no_grad():
        def prefill(**images):
            return net.prefill(ids_t, attn_t, **dict(scene, **images),
                               bos_id=model.tokenizer.bos_id, max_cache_len=ids.shape[1] + 1)

        encode_ms = wall_ms(lambda: net.visual_prompter(**points))
        image_ms = wall_ms(lambda: net.encode_images(scene["images"]))
        image_device = device_ms(lambda: net.encode_images(scene["images"]), iters=3, warmup=1)
        prefill_ms = wall_ms(prefill)
        prefill_device = device_ms(prefill, iters=3, warmup=1)  # its kernels' summed time
        tokens_k = net.visual_prompter(**points)["obj_tokens"]
        with mock.patch.object(pointnet, "fps", lambda xyz, m: furthest_point_sample_reference(
                xyz.float().contiguous(), m)):
            tokens_plain = net.visual_prompter(**points)["obj_tokens"]
        check(torch.equal(tokens_k, tokens_plain),
              "scene tokens with K1 equal those with the plain FPS")
        layers = []

        def held(q, k, v, *, key_valid):
            # K2f on this layer's own q/k/v, held against its plain version
            res = flash_against_plain(q, k, v, key_valid)
            layers.append(res)
            return res["out"], res["lse"]

        with mock.patch.object(llama, "flash_attention", held):
            first_k2f = prefill()[0]
        with mock.patch.object(llama, "flash_attention", flash_attention_reference):
            first_plain = prefill()[0]
        net.llm.cfg = dataclasses.replace(llm, flash_attention=False)
        first_dense = prefill()[0]
        net.llm.cfg = llm
    print(f"  K2f on the prefill's own inputs, {len(layers)} layers: max |out - plain| "
          f"{max(r['err'] for r in layers):.3e}, max |out - plain| / ({FLASH_ATOL} + "
          f"{FLASH_RTOL}|plain|) {max(r['ratio'] for r in layers):.3f}, max |lse - plain| "
          f"{max(r['lse_err'] for r in layers):.3e}")
    check(len(layers) == llm.num_hidden_layers
          and all(r["finite"] and r["zeros"] and r["ratio"] <= 1.0 and r["lse_err"] <= LSE_ATOL
                  for r in layers),
          "K2f within tolerance of its plain version in every layer of the prefill, "
          "rows without a valid key exactly 0")
    check(bool(torch.isfinite(first_k2f).all()), "first-token logits finite")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    err_k2f, err_dense = rel(first_k2f, first_plain), rel(first_dense, first_plain)
    same_top1 = (first_k2f.argmax(-1) == first_plain.argmax(-1)).float().mean().item()
    print(f"  first-token logits, |K2f - plain| / |plain| {err_k2f:.4e}, "
          f"|dense - plain| / |plain| {err_dense:.4e} (the JAX package's dense route), "
          f"max |K2f - plain| {(first_k2f - first_plain).abs().max().item():.4e}, "
          f"max |plain| {first_plain.abs().max().item():.4e}, top-1 agreement {same_top1:.2f}")
    check(err_k2f <= E2E_RTOL, f"first-token logits with K2f within {E2E_RTOL} (relative "
          "L2) of the prefill with K2f's plain version")
    image_wiring_gate(prefill, scene)

    finished_at = [list(row).index(model.tokenizer.eos_id) if model.tokenizer.eos_id in row
                   else NEW_TOKENS for row in tokens]
    decode_steps = max(1, min(NEW_TOKENS, max(finished_at) + 1) - 1)
    decode_ms = (gen_ms - prefill_ms) / decode_steps
    print(f"  image encode ({N_REQUESTS * MAX_IMAGES} images, llm_proj_img included) "
          f"{image_ms:.2f} ms ({image_device:.3f} ms of device time; TF32 flags: "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}), "
          f"scene encode {encode_ms:.2f} ms, prefill (both encodes included) {prefill_ms:.2f} ms "
          f"({prefill_device:.3f} ms of device time), decode {decode_ms:.2f} ms/token over "
          f"{decode_steps} steps, generate {gen_ms:.2f} ms, {N_REQUESTS / gen_ms * 1e3:.3f} QA/s, "
          f"peak memory allocated {peak_gb:.2f} GiB")
    if profile:
        profile_device("generate", lambda: model.generate(dict(data), use_beam=False))
    return launches


def image_wiring_gate(prefill, scene) -> None:
    """The images reach the first-token logits through their placeholders
    only: other pixels in every masked (padding) image leave them equal bit
    for bit; other pixels in one shown image move them."""
    images, masks = scene["images"], scene["image_masks"]
    first = prefill()[0]
    padding = images.clone()
    padding[~masks] = torch.randn_like(padding[~masks])
    same = prefill(images=padding)[0]
    shown = images.clone()
    shown[0, 0] += 1.0
    moved = prefill(images=shown)[0]
    delta = (moved[0] - first[0]).abs().max().item()
    print(f"  image wiring: {int((~masks).sum())} masked images changed: max |Δ logits| "
          f"{(same - first).abs().max().item():.3e}; request 0's first image changed: "
          f"max |Δ logits| {delta:.3e}")
    check(torch.equal(same, first), "first-token logits bit-equal when the masked images change")
    check(delta > 0 and torch.equal(moved[1:], first[1:]),
          "first-token logits of request 0 move when its shown image changes, the others' not")


def beam_runs(model, data, label: str):
    """Beam generate of ``data`` (``num_beams`` BEAMS, length penalty 1.0, the
    model's repetition penalty) with the ancestry map and with the reordered
    generated cache, each timed once after a short warm-up, K1 and K2f
    counted from 0 around it, decode steps counted and the peak memory read.
    Gates: the tokens of the two runs are equal."""
    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    net = model.network
    model.num_beams, model.length_penalty = BEAMS, LENGTH_PENALTY
    runs = {}
    for ancestry in (True, False):
        model.beam_ancestry = ancestry
        model.generate(dict(data), use_beam=True, max_new_tokens=2)  # warm-up
        steps = []
        step_fns = {}
        for name in ("decode_step_shared", "decode_step_beam_anc"):
            def counted(*args, _fn=getattr(net, name), **kw):
                steps.append(1)
                return _fn(*args, **kw)
            step_fns[name] = counted
        out = {}
        FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.multiple(net, **step_fns):
            gen_ms = wall_ms(lambda: out.update(model.generate(dict(data), use_beam=True)))
        runs[ancestry] = dict(
            tokens=out["output_tokens"], gen_ms=gen_ms, steps=len(steps),
            peak_gb=torch.cuda.max_memory_allocated() / 2**30,
            launches={"fps": FPS_KERNEL.launches, "flash_attn_fwd": FLASH_FWD_KERNEL.launches})
        way = "ancestry" if ancestry else "reorder"
        r = runs[ancestry]
        print(f"  ({label}) beam {BEAMS}, {way}: generate {gen_ms:.2f} ms, {r['steps']} decode "
              f"steps, {len(data['msr3d_prompt']) / gen_ms * 1e3:.3f} QA/s, peak memory "
              f"allocated {r['peak_gb']:.2f} GiB, launches {r['launches']}")
    tokens = runs[True]["tokens"]
    check(tokens.shape == (len(data["msr3d_prompt"]), NEW_TOKENS)
          and bool(((tokens >= 0) & (tokens < net.llm.cfg.vocab_size)).all()),
          f"({label}) beam tokens of shape {tokens.shape} inside the vocabulary")
    check(np.array_equal(tokens, runs[False]["tokens"]),
          f"({label}) beam tokens with the ancestry map equal those with the reordered cache")
    return runs


def phase_beam(model, dev, profile: bool):
    print(f"== phase 9: beam-{BEAMS} MSR3D.generate at the flagship width (repetition penalty "
          f"{model.repetition_penalty}, length penalty {LENGTH_PENALTY}, {NEW_TOKENS} new tokens, "
          f"the requests of phase 4 with their images)")
    data = make_requests(seed=0, images=True)
    runs = beam_runs(model, data, "bf16 KV")
    for ancestry, r in runs.items():
        check(r["launches"]["fps"] == 2 and r["launches"]["flash_attn_fwd"] == 32,
              f"K1 launched twice and K2f 32 times per beam generate "
              f"({'ancestry' if ancestry else 'reorder'})")
    net = model.network
    ids, attn = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                     side="left")
    scene = model._scene_batch(data)
    with torch.no_grad():
        prefill_ms = wall_ms(lambda: net.prefill(
            torch.as_tensor(ids, dtype=torch.long, device=dev),
            torch.as_tensor(attn, dtype=torch.int32, device=dev), **scene,
            bos_id=model.tokenizer.bos_id, max_cache_len=ids.shape[1] + 1))
    for ancestry, r in runs.items():
        r["prefill_ms"] = prefill_ms
        r["decode_ms"] = (r["gen_ms"] - prefill_ms) / max(1, r["steps"])
        print(f"  {'ancestry' if ancestry else 'reorder'}: prefill (both encodes included) "
              f"{prefill_ms:.2f} ms, decode {r['decode_ms']:.2f} ms a step (beam bookkeeping "
              f"included) over {r['steps']} steps of {N_REQUESTS * BEAMS} rows")
    if profile:
        model.beam_ancestry = True
        profile_device("beam generate (ancestry)",
                       lambda: model.generate(dict(data), use_beam=True))
    return runs


def profile_device(what: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (``--profile``), and the
    device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(kernel_rows(prof), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  profile: {what} {wall:.2f} ms wall, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    # the twelve longest, and the port's own kernels wherever they rank
    for rank, (ms, count, key) in enumerate(rows):
        if rank < 12 or any(tag in key for tag in ("flash_", "fps_kernel", "matmul_kernel")):
            print(f"    {ms:9.3f} ms {count:6d}x  {key[:100]}")


def make_train_batches(n: int):
    """``n`` batches of four requests built like phase 4's, images included,
    each with answers of at most 30 characters: with bos and eos one 32-token
    bucket, so T = 224 + 32 = 256."""
    batches = []
    for i in range(n):
        data = make_requests(seed=100 + i, images=True)
        data["text_output"] = [f"the lamp left of chair {i}-{j}" for j in range(N_REQUESTS)]
        batches.append(data)
    return batches


def frozen_checksums(model):
    """fp64 sum of every frozen LLM tensor: base projections, norms,
    embeddings and lm_head."""
    return torch.stack([torch.sum(p, dtype=torch.float64)
                        for n, p in model.network.named_parameters()
                        if n.startswith("llm.") and "lora_" not in n])


def trainer_cfg(exp_dir: Path, *, accum: int, lr: float, warmup: int, epochs: int = 1):
    return {
        "exp_dir": str(exp_dir), "rng_seed": 0, "save_frequency": 0,
        "solver": {
            "gradient_accumulation_steps": accum, "grad_norm": 5.0, "epochs": epochs,
            "optim": {"name": "AdamW",
                      "args": {"lr": lr, "betas": [0.9, 0.999], "weight_decay": 0.05}},
            "sched": {"name": "warmup_cosine_instructblip", "args": {"warmup_steps": warmup}},
        },
    }


def phase_train(model, dev, exp_root: Path, profile: bool):
    print(f"== phase 6: LoRA training at the flagship width ({TRAIN_STEPS} optimizer steps of "
          f"batch {N_REQUESTS} x accumulation {TRAIN_ACCUM})")
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.models.llm.llama import LoraDense
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    net = model.network
    llm = model.cfg.llm
    loader = make_train_batches(TRAIN_STEPS * TRAIN_ACCUM)
    # the flagship's solver: AdamW 3e-5, betas (0.9, 0.999), wd 0.05, clip 5.0,
    # warmup_cosine_instructblip with 400 warm-up steps
    trainer = LeoTrainer(trainer_cfg(exp_root / "flagship", accum=TRAIN_ACCUM, lr=3e-5,
                                     warmup=400),
                         loaders={"msr3d_train": {"train": loader}}, model=model)
    frozen_before = frozen_checksums(model)
    encoder_before = {n: t.clone() for n, t in net.visual_prompter.obj_encoder.state_dict().items()}
    image_encoder_before = [t.clone() for t in net.image_encoder.state_dict().values()]
    proj_img_before = net.llm_proj_img.weight.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    micro_batches = TRAIN_STEPS * TRAIN_ACCUM

    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL)
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {kernel.symbol.replace("_launch", ""): kernel.launches for kernel in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches during {TRAIN_STEPS} optimizer steps ({micro_batches} micro-batches): "
          f"{launches}")
    layers = llm.num_hidden_layers
    check(launches["flash_attn_fwd"] == layers * micro_batches
          and launches["flash_attn_bwd_dq"] == layers * micro_batches
          and launches["flash_attn_bwd_dkv"] == layers * micro_batches,
          f"K2f, K2dq and K2dkv each launched {layers} times per micro-batch")
    check(launches["fps"] == 2 * micro_batches,
          "K1 launched twice per micro-batch (the frozen scene encode)")

    with open(exp_root / "flagship" / "metrics.jsonl") as fh:
        metrics = [json.loads(line) for line in fh]
    for m in metrics:
        print(f"  step {m['step']}: loss {m['train/loss']:.6f}, grad norm "
              f"{m['train/grad_norm']:.6f}, lr {m['train/lr']:.4e}, {m['train/step_time_s']:.3f} s")
    check(len(metrics) == TRAIN_STEPS and all(
        np.isfinite(m["train/loss"]) and np.isfinite(m["train/grad_norm"]) for m in metrics),
        "loss and grad norm finite at every step")
    loras = [m for m in net.modules() if isinstance(m, LoraDense) and m.scale]
    check(len(loras) == 7 * layers and all(bool((m.lora_b != 0).any()) for m in loras),
          f"every LoRA B tensor ({len(loras)}) moved from 0")
    check(torch.equal(frozen_checksums(model), frozen_before),
          "checksums of the frozen base weights, norms, embeddings and lm_head unchanged")
    check(all(torch.equal(t, encoder_before[n])
              for n, t in net.visual_prompter.obj_encoder.state_dict().items()),
          "the frozen obj_encoder weights and statistics unchanged")
    check(all(torch.equal(t, b) for t, b in zip(net.image_encoder.state_dict().values(),
                                                 image_encoder_before)),
          "the frozen image encoder (ConvNeXt and pooling) unchanged")
    check(not torch.equal(net.llm_proj_img.weight, proj_img_before), "llm_proj_img moved")
    check(trainer.ckpt.has_weights("latest") and trainer.ckpt.latest_step() == TRAIN_STEPS,
          "learnable 'latest' weights and the full state saved")
    step_s = trainer.timer.history
    print(f"  step time {' / '.join(f'{1e3 * t:.1f}' for t in step_s)} ms "
          f"({N_REQUESTS * TRAIN_ACCUM / step_s[-1]:.3f} samples/s at the last step), "
          f"run() {run_s:.1f} s, peak memory allocated {peak_gb:.2f} GiB")

    # one micro-batch, forward and backward timed apart (eval mode: no dropout)
    batch = trainer._device_batch([loader[0]])[0]
    params = trainer.params

    def loss_and_grads():
        for p in params.values():
            p.grad = None
        holder = {}
        fwd = wall_ms(lambda: holder.update(loss=net(**batch)["loss"].mean()))
        bwd = wall_ms(lambda: holder["loss"].backward())
        grads = torch.cat([p.grad.float().flatten() for p in params.values()])
        for p in params.values():
            p.grad = None
        return fwd, bwd, grads

    fwd_ms, bwd_ms, grads = loss_and_grads()
    with torch.no_grad():
        image_ms = wall_ms(lambda: net.encode_images(batch["images"]))
    print(f"  one micro-batch (4 x 256 positions, {N_REQUESTS * MAX_IMAGES} images): forward "
          f"{fwd_ms:.2f} ms (image encode {image_ms:.2f} ms of it), backward {bwd_ms:.2f} ms")

    # K2dq/K2dkv on each layer's own q, k, v, o, lse and do, held against the
    # plain backward
    held = []
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)

    def held_dq(q, k, v, do, lse, delta, *, key_valid):
        res = bwd_against_plain(q, k, v, do, lse, delta, key_valid, wrappers)
        held.append(res)
        return res["dq"]

    def held_dkv(q, k, v, do, lse, delta, *, key_valid):
        return held[-1]["dk"], held[-1]["dv"]

    with mock.patch.object(fa, "flash_attention_bwd_dq", held_dq), \
            mock.patch.object(fa, "flash_attention_bwd_dkv", held_dkv):
        loss_and_grads()
    print(f"  K2dq/K2dkv on the backward's own inputs, {len(held)} layers: max |grad - plain| "
          f"{max(r['err'] for r in held):.3e}, max |grad - plain| / ({BWD_ATOL} + "
          f"{BWD_RTOL}|plain|) {max(r['ratio'] for r in held):.3f}")
    check(len(held) == layers and all(r["finite"] and r["zeros"] and r["ratio"] <= 1.0
                                      for r in held),
          "K2dq/K2dkv within tolerance of their plain version in every layer of the backward, "
          "rows without a valid key and unreached keys exactly 0")

    with mock.patch.object(fa, "flash_attention_bwd_dq", fa.flash_attention_bwd_dq_reference), \
            mock.patch.object(fa, "flash_attention_bwd_dkv",
                              fa.flash_attention_bwd_dkv_reference):
        grads_plain = loss_and_grads()[2]
    net.llm.cfg = dataclasses.replace(llm, flash_attention=False)
    try:
        grads_dense = loss_and_grads()[2]
    finally:
        net.llm.cfg = llm

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    err_k, err_dense = rel(grads, grads_plain), rel(grads_dense, grads_plain)
    print(f"  trainable gradients ({grads.numel()} values), |kernels - plain| / |plain| "
          f"{err_k:.4e}, |dense - plain| / |plain| {err_dense:.4e} (the JAX package's dense "
          f"route)")
    check(bool(torch.isfinite(grads).all()) and err_k <= GRAD_RTOL,
          f"trainable gradients through K2dq/K2dkv within {GRAD_RTOL} (relative L2) of those "
          "through their plain version")

    # wiring: a few steps on one repeated group must lower the loss
    wiring = LeoTrainer(trainer_cfg(exp_root / "wiring", accum=1, lr=WIRING_LR, warmup=1,
                                    epochs=100),
                        loaders={"msr3d_train": {"train": [loader[0]] * WIRING_STEPS}},
                        model=model)
    with torch.no_grad():
        before = net(**batch)["loss"].mean().item()
    wiring.train_one_epoch(0)
    with torch.no_grad():
        after = net(**batch)["loss"].mean().item()
    print(f"  wiring: {WIRING_STEPS} AdamW steps at lr {WIRING_LR} (warm-up 1, cosine over 400) "
          f"on one repeated micro-batch: loss {before:.6f} -> {after:.6f}")
    check(after < before, "a few steps on one repeated group lower the loss")
    tokens = model.generate(make_requests(seed=0), use_beam=False,
                            max_new_tokens=4)["output_tokens"]
    check(tokens.shape == (N_REQUESTS, 4) and bool(((tokens >= 0) & (tokens < llm.vocab_size))
                                                   .all()),
          "greedy generate still runs on the trained model")
    if profile:
        group = trainer._device_batch(loader[:TRAIN_ACCUM])

        def one_step():
            net.train()
            try:
                trainer._train_step(group)
            finally:
                net.eval()

        profile_device(f"one optimizer step ({TRAIN_ACCUM} micro-batches)", one_step)
    return launches


# Phase 10: the training entry on configs/msr3d.yaml. The synthetic tree has
# scans of ENTRY_OBJECTS objects (over max_obj_len 60, so the relevant-objects
# crop runs) and 14 + 13 + 13 train annotations in the three MSQA domains: 40
# samples, 10 batches of 4, 2 optimizer steps at accumulation 5
ENTRY_OBJECTS = 64
ENTRY_ANNOTATIONS = (("scannet", ("scene0000_00", "scene0001_00"), 14),
                     ("rscan", ("rscan0001",), 13), ("arkitscenes", ("arkit0001",), 13))
# the public Vicuna-7B geometry, as its HF config.json states it
VICUNA_7B = {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
             "num_hidden_layers": 32, "num_attention_heads": 32, "rms_norm_eps": 1e-6,
             "max_position_embeddings": 2048, "tie_word_embeddings": False}


def write_entry_checkpoint(root: Path) -> Path:
    """``cfg_path`` for phase 10: the Vicuna-7B ``config.json`` and a BPE
    ``tokenizer.model`` (the port's ``serialize_model_proto``) with byte
    fallback, the 图/物/景 placeholders, single characters and the ▁-word
    prefixes of the MSQA template's words, so its prompts take about a
    token a word. No weights: the model takes seeded random ones."""
    from msr3d_tpu_torch.data.datasets.msr3d import MSR3DBase
    from msr3d_tpu_torch.models.llm.sentencepiece import (
        BYTE,
        CONTROL,
        NORMAL,
        UNKNOWN,
        serialize_model_proto,
    )

    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    chars = "▁abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,:;?!'-()[]图物景"
    pieces += [(ch, -1000.0, NORMAL) for ch in chars]
    text = " ".join(MSR3DBase.prompt_dict.values()) + (
        " What is the color of the chair number? To my left there is a chair near a table."
        " red the red one")
    seen = set(chars)
    for word in re.findall(r"[A-Za-z]+", text):
        for k in range(2, len(word) + 2):
            piece = ("▁" + word)[:k]
            if piece not in seen:
                seen.add(piece)
                pieces.append((piece, -float(k), NORMAL))
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(VICUNA_7B))
    (root / "tokenizer.model").write_bytes(serialize_model_proto(pieces))
    return root


def flagship_parameter_count(vocab_size: int) -> int:
    """The parameters of ``build_flagship_model``'s network, counted on the
    meta device, with ``vocab_size`` rows of embeddings and lm_head."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.msr3d import MSR3DNetwork, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig

    llm = LlamaConfig(vocab_size=vocab_size, hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=32, num_attention_heads=32, lora_rank=16,
                      dtype=torch.bfloat16, param_dtype=torch.bfloat16, flash_attention=True)
    net = MSR3DNetwork(MSR3DNetworkConfig(prompter=OSE3DConfig(), llm=llm), device="meta")
    return sum(p.numel() for p in net.parameters())


def phase_entry(exp_root: Path):
    print("== phase 10: the training entry at the flagship width (python -m "
          "msr3d_tpu_torch.run on configs/msr3d.yaml, 2 optimizer steps of batch "
          f"{N_REQUESTS} x accumulation {TRAIN_ACCUM}, nothing injected)")
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch import run as entry
    from msr3d_tpu_torch.data import synthetic
    from msr3d_tpu_torch.data.scan_loader import ScanCache
    from msr3d_tpu_torch.models.llm.llama import LoraDense
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    root = exp_root / "entry"
    data = root / "data"
    rng = np.random.default_rng(12)
    synthetic.build_scannet_tree(data, rng, n_objects=ENTRY_OBJECTS)
    synthetic.build_rscan_tree(data, rng, n_objects=ENTRY_OBJECTS)
    synthetic.build_arkit_tree(data, rng, n_objects=ENTRY_OBJECTS)
    for domain, scans, n in ENTRY_ANNOTATIONS:
        synthetic.build_msqa_annotations(data, list(scans), n=n, domain=domain)
    ckpt = write_entry_checkpoint(root / "vicuna7b")
    argv = ["--config", str(Path(__file__).resolve().parent / "configs" / "msr3d.yaml"),
            f"data.scan_family_base={data}/scan_family", f"data.rscan_base={data}/rscan",
            f"data.ARkit_base={data}/arkit", f"data.msr3d_base={data}/msr3d",
            f"model.llm.cfg_path={ckpt}", "model.llm.flash_attention=true",
            "task.msqa_scannet.mode=[]", "task.msqa_3rscan.mode=[]",
            "task.msqa_arkitscenes.mode=[]", "solver.epochs=1", f"exp_dir={root / 'exp'}"]
    print(f"  python -m msr3d_tpu_torch.run {' '.join(argv)}")

    micro_batches, frozen = [], {}
    loss_batch, init_params = MSR3D.loss_batch, MSR3D.init_params

    def recording_loss_batch(self, data_dict, *args):
        batch = loss_batch(self, data_dict, *args)
        micro_batches.append({k: (tuple(batch[k].shape), batch[k].device.type)
                              for k in ("obj_fts", "images", "input_ids")})
        return batch

    def recording_init(self, seed=None):
        init_params(self, seed)
        frozen["before"] = frozen_checksums(self)

    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL)
    ScanCache.clear()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(MSR3D, "loss_batch", recording_loss_batch), \
            mock.patch.object(MSR3D, "init_params", recording_init):
        for kernel in kernels:
            kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = entry.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {kernel.symbol.replace("_launch", ""): kernel.launches for kernel in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    model = trainer.model
    llm = model.cfg.llm
    n_micro = len(micro_batches)
    print(f"  launches during the run ({n_micro} micro-batches): {launches}")
    print(f"  built: {llm}")
    members = trainer.train_loader.dataset.dataset.datasets
    print(f"  {len(trainer.train_loader.dataset)} train samples from {[m.source for m in members]}"
          f", point-cloud preprocessing: {sorted({m.preprocess_path for m in members})}, "
          f"tokenizer {type(model.tokenizer).__name__} ({model.tokenizer.vocab_size} ids)")
    count = sum(p.numel() for p in model.network.parameters())
    want = flagship_parameter_count(llm.vocab_size)
    print(f"  {count} parameters; the flagship of phases 4 and 6 at vocab {llm.vocab_size}: "
          f"{want}")
    check(count == want and model.cfg.prompter == OSE3DConfig() and llm.hidden_size == 4096
          and llm.num_hidden_layers == 32 and llm.num_attention_heads == 32
          and llm.intermediate_size == 11008 and llm.lora_rank == 16 and len(llm.lora_targets)
          == 7 and llm.flash_attention and llm.param_dtype == torch.bfloat16
          and model.cfg.backbone_name == "convnext_base",
          "the model the YAML built has the flagship's geometry and parameter count")
    check(n_micro == TRAIN_STEPS * TRAIN_ACCUM and all(
        mb["obj_fts"] == ((N_REQUESTS, 60, 1024, 6), "cuda")
        and mb["images"] == ((N_REQUESTS, MAX_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3), "cuda")
        for mb in micro_batches),
        f"each of the {TRAIN_STEPS * TRAIN_ACCUM} micro-batches carries obj_fts (4, 60, 1024, 6) "
        "and msr3d_imgs (4, 60, 224, 224, 3) on the card")
    print(f"  micro-batch input_ids {sorted({mb['input_ids'][0] for mb in micro_batches})}")
    layers = llm.num_hidden_layers
    check(launches["fps"] == 2 * n_micro, "K1 launched twice per micro-batch")
    check(all(launches[k] == layers * n_micro
              for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")),
          f"K2f, K2dq and K2dkv each launched {layers} times per micro-batch")
    with open(trainer.exp_dir / "metrics.jsonl") as fh:
        metrics = [json.loads(line) for line in fh]
    for m in metrics:
        print(f"  step {m['step']}: loss {m['train/loss']:.6f}, grad norm "
              f"{m['train/grad_norm']:.6f}, {1e3 * m['train/step_time_s']:.1f} ms, data wait "
              f"{1e3 * m['train/data_wait_s']:.1f} ms")
    check(len(metrics) == TRAIN_STEPS and all(np.isfinite(m["train/loss"]) for m in metrics),
          "the loss is finite at every step")
    loras = [m for m in model.network.modules() if isinstance(m, LoraDense) and m.scale]
    check(len(loras) == 7 * layers and all(bool((m.lora_b != 0).any()) for m in loras),
          f"every LoRA B tensor ({len(loras)}) moved from 0")
    check(torch.equal(frozen_checksums(model), frozen["before"]),
          "checksums of the frozen base weights, norms, embeddings and lm_head unchanged")
    check(trainer.ckpt.has_weights("latest") and trainer.ckpt.latest_step() == TRAIN_STEPS
          and (trainer.exp_dir / "config.yaml").exists(),
          "the full state, 'latest' and the config snapshot written under the exp dir")
    step_s, wait_s = trainer.timer.history, trainer.data_wait_history
    print(f"  step time {' / '.join(f'{1e3 * t:.1f}' for t in step_s)} ms "
          f"({N_REQUESTS * TRAIN_ACCUM / step_s[-1]:.3f} samples/s at the last step), host data "
          f"wait {' / '.join(f'{1e3 * t:.1f}' for t in wait_s)} ms a step, main() {main_s:.1f} s "
          f"(build, init, data and training), peak memory allocated {peak_gb:.2f} GiB")
    # what the prefetch thread does for one micro-batch, alone on the host
    # (scans cached): the samples' preprocessing and the collate
    loader = trainer.train_loader
    chunks = list(itertools.islice(loader._batches(), 3))
    load_ms = [wall_ms(lambda c=c: loader._load(c)) for c in chunks]
    print(f"  one micro-batch from the loader alone: {' / '.join(f'{t:.1f}' for t in load_ms)} "
          f"ms ({len(chunks[0])} samples, preprocessing and collate)")
    ScanCache.clear()
    return launches


def dequant_against_plain(x, wq, scale, bits):
    """K3 (bits 8) or K4 (bits 4) and its plain version on the same inputs:
    max |Δ|, max |Δ| over the tolerance, whether the output is finite, and
    the plain output."""
    from msr3d_tpu_torch.ops.w4_matmul import matmul_w4, matmul_w4_reference
    from msr3d_tpu_torch.ops.w8_matmul import matmul_w8, matmul_w8_reference

    kernel, plain = (matmul_w8, matmul_w8_reference) if bits == 8 else (matmul_w4,
                                                                         matmul_w4_reference)
    got, want = kernel(x, wq, scale), plain(x, wq, scale)
    torch.cuda.synchronize()
    return dict(dequant_errors(got, want, x, scale, bits), want=want, got=got)


def dequant_errors(got, want, x, scale, bits):
    delta = (got.float() - want.float()).abs()
    tol = DEQ_ATOL + DEQ_RTOL * want.float().abs()
    if bits == 4:
        tol = tol + DEQ_W4_BIAS * x.float().abs().sum(1, keepdim=True) * scale.float().abs()
    return dict(err=delta.max().item(), ratio=(delta / tol).max().item(),
                finite=bool(torch.isfinite(got.float()).all()))


def dequant_bound(b, k, n, bits):
    """The weight (K·N bytes, half for int4), x and y in bf16 and the fp32
    scale, each crossing device memory once; 2·B·K·N products at the bf16
    tensor-core rate."""
    return bound(k * n * bits // 8 + 2 * b * k + 4 * n + 2 * b * n, 2 * b * k * n,
                 H100_BF16_FLOPS)


def phase_dequant(dev):
    print("== phase 7: K3 (int8) and K4 (int4) against their plain versions at the 7B shapes")
    from msr3d_tpu_torch.models.llm.convert import quantize_kernel
    from msr3d_tpu_torch.ops.w4_matmul import (
        matmul_w4,
        matmul_w4_reference,
        plan_w4,
        repack_from_splitnibble,
    )
    from msr3d_tpu_torch.ops.w8_matmul import matmul_w8, matmul_w8_reference, plan_w8

    gen = torch.Generator(device=dev).manual_seed(7)
    cases = [(b, k, n) for b in (4, 16) for k, n in SHAPES_7B] + [(7, 4096, 1000)]
    ok, rows = True, []
    for b, k, n in cases:
        x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
        kernel = torch.randn((k, n), generator=gen, device=dev) * 0.02  # flax layout (in, out)
        for bits in (8, 4):
            q, s = quantize_kernel(kernel, bits)  # the serving path's quantizer, on the card
            wq = q if bits == 8 else repack_from_splitnibble(q)
            res = dequant_against_plain(x, wq, s, bits)
            fn, plain = (matmul_w8, matmul_w8_reference) if bits == 8 else (matmul_w4,
                                                                             matmul_w4_reference)
            ok = ok and res["finite"] and res["ratio"] <= 1.0 and torch.equal(fn(x, wq, s),
                                                                               res["got"])
            w_deq = (dequant_oracle_weight(q, s, bits, None)).to(torch.bfloat16)
            # device time by torch.profiler; "from HBM": each launch reads its weight
            # from one of several copies spanning L2_SPAN_BYTES
            ops = past_l2(wq, s)
            hbm = lambda f, sets: device_ms(rotating(f, sets), iters=2 * len(sets))  # noqa: E731
            row = dict(bits=bits, b=b, k=k, n=n, err=res["err"], ratio=res["ratio"],
                       ms_warm=device_ms(lambda: fn(x, wq, s), iters=20),
                       ms=hbm(lambda w, sc: fn(x, w, sc), ops),
                       plain_ms=device_ms(rotating(lambda w, sc: plain(x, w, sc), ops),
                                          iters=len(ops)),
                       library_ms=hbm(lambda w: x @ w, past_l2(w_deq)))
            row["bound_ms"], row["bound_by"] = dequant_bound(b, k, n, bits)
            row["plan"] = (plan_w8 if bits == 8 else plan_w4)(b, k, n)
            row["parent_ms"] = hbm(lambda w, sc: parent_call(bits, x, w, sc), ops)
            if bits == 8:
                int8pack, why = int8pack_call(x, s)
                if int8pack is None:
                    row["int8pack_ms"] = None
                    extra = f", torch._weight_int8pack_mm does not run here ({why})"
                else:
                    got = int8pack(wq.t().contiguous())
                    row["int8pack_ms"] = hbm(int8pack, past_l2(wq.t().contiguous()))
                    extra = (f", torch._weight_int8pack_mm {row['int8pack_ms']:.4f} ms (max |Δ| "
                             f"{(got.float() - res['want'].float()).abs().max().item():.3e} "
                             f"from plain: bf16 scales)")
            else:
                int4pack, int4ops, why = int4pack_call(x, wq, s)
                if int4pack is None:
                    row["int4pack_ms"] = None
                    extra = f", torch._weight_int4pack_mm does not run here ({why})"
                else:
                    got = int4pack(*int4ops)
                    row["int4pack_ms"] = hbm(int4pack, past_l2(*int4ops))
                    extra = (f", torch._weight_int4pack_mm {row['int4pack_ms']:.4f} ms (max |Δ| "
                             f"{(got.float() - res['want'].float()).abs().max().item():.3e} "
                             f"from plain: bf16 scales; not gated)")
                    del int4ops
            extra = (f"; split {row['plan'][0]}, tile {row['plan'][1]}, {row['plan'][2]} "
                     f"stages; the earlier design {row['parent_ms']:.4f} ms "
                     f"({row['parent_ms'] / row['ms']:.2f}x)" + extra)
            print(f"  {'K3' if bits == 8 else 'K4'} B={b:2d} K={k:5d} N={n:5d}: max |Δ| "
                  f"{res['err']:.3e} ({res['ratio']:.3f} of the tolerance), device time "
                  f"{row['ms']:.4f} ms from HBM, {row['ms_warm']:.4f} ms L2-warm, plain "
                  f"{row['plain_ms']:.4f} ms, cuBLAS x @ w_bf16 {row['library_ms']:.4f} ms from "
                  f"HBM (reads {16 // bits}x the weight bytes), bound {row['bound_ms']:.6f} ms "
                  f"({row['bound_by']}){extra}")
            rows.append(row)
            del ops
        del kernel, q, wq, w_deq
    check(ok, "K3 and K4 within tolerance of their plain versions at every 7B shape and the "
              "ragged case (B 7, N 1000), and two calls bit-identical")
    return rows


def dequant_oracle_weight(q, s, bits, group):
    """The fp32 dequantized (in, out) weight of a LoraDense layout: int8, or
    int4 split-nibble with per-channel or group scales, the scale at bf16."""
    from msr3d_tpu_torch.models.llm.convert import unpack_int4

    s = s.to(torch.bfloat16).float()
    if bits == 8:
        return q.float() * s
    w = unpack_int4(q).float()
    if group:
        return (w.reshape(-1, group, w.shape[1]) * s[:, None, :]).reshape(w.shape)
    return w * s


QUANT_RUNS = (
    # (label, what, batch, LoRA rank, quantize_llm arguments)
    ("a", "int8 per channel, merged LoRA (rank 0), int8 KV cache: bench_qa.py's record "
          "configuration", 16, 0, dict(bits=8, kv_quantize=True)),
    ("b", "int4 per channel", 16, 16, dict(bits=4)),
    ("c", "int4 with group 128, int8 KV cache", 4, 16, dict(bits=4, group=128, kv_quantize=True)),
    ("d", "int8 with s8xs8 activations", 16, 16, dict(bits=8, act_quantize=True)),
)


def quantized_modules(net):
    from msr3d_tpu_torch.models.llm.llama import LoraDense

    return [m for m in net.llm.modules() if isinstance(m, LoraDense) and m.bits]


def capture_decode_inputs(model, data):
    """The input of every quantized projection in one decode step (forward
    pre-hooks; one generate with two new tokens), as (module, x (B, in))."""
    captured = []

    def hook(mod, args):
        if args[0].shape[1] == 1:  # decode, T = 1; the prefill has the prompt
            captured.append((mod, args[0].reshape(-1, mod.in_features)))

    handles = [m.register_forward_pre_hook(hook) for m in quantized_modules(model.network)]
    try:
        model.generate(dict(data), use_beam=False, max_new_tokens=2)
    finally:
        for h in handles:
            h.remove()
    return captured


def kernel_on_path(captured, bits, kernel, plain_fn, wrap):
    """Launch K3/K4 on each captured projection's own operands (``wrap``
    gives its weight in the kernel's layout), counted from 0; then hold each
    output against its plain version and print its distance to LoraDense's
    base output (the XLA-order product). The times are per launch, the mean
    over the decode step's 224 projections in order (6.5 GB of int8 weights,
    3.3 GB of int4, so each launch reads its weight from HBM)."""
    from msr3d_tpu_torch.ops.w4_matmul import matmul_w4, plan_w4
    from msr3d_tpu_torch.ops.w8_matmul import matmul_w8, plan_w8

    fn = matmul_w8 if bits == 8 else matmul_w4
    operands = [(x, wrap(m), m.weight_scale) for m, x in captured]
    kernel.launches = 0
    outs = [fn(*ops) for ops in operands]
    torch.cuda.synchronize()
    held = kernel.launches
    errs = [dequant_errors(out, plain_fn(*ops), ops[0], ops[2], bits)
            for out, ops in zip(outs, operands)]
    rel_base = max(((out.float() - m.base_forward(x).float()).norm()
                    / m.base_forward(x).float().norm()).item()
                   for out, (m, x) in zip(outs, captured))
    name = "K3" if bits == 8 else "K4"
    print(f"  {name} on the {len(operands)} projections' own decode inputs: {held} launches, "
          f"max |Δ| {max(e['err'] for e in errs):.3e}, max {max(e['ratio'] for e in errs):.3f} of "
          f"the tolerance; relative L2 to LoraDense's base output (the XLA order) at most "
          f"{rel_base:.3e} (not gated)")
    check(len(operands) == 224 and held == 224
          and all(e["finite"] and e["ratio"] <= 1.0 for e in errs),
          f"{name} within tolerance of its plain version on all 224 projections of a decode step")
    del outs
    n = len(operands)
    # device time by torch.profiler, a launch: the mean over the decode step's n
    # projections in order (each reads its weight from HBM), and L2-warm, the
    # mean over layer 0's seven projections each launched again and again
    ms = device_ms(lambda: [fn(*ops) for ops in operands], iters=3) / n
    ms_warm = statistics.mean(device_ms(lambda: fn(*ops), iters=20) for ops in operands[:7])
    plain_ms = device_ms(lambda: [plain_fn(*ops) for ops in operands], iters=1, warmup=1) / n
    w_deq = [dequant_oracle_weight(m.weight_q, m.weight_scale, m.bits, m.group).to(torch.bfloat16)
             for m, _ in captured]
    lib_ms = device_ms(lambda: [x @ w for (x, _, _), w in zip(operands, w_deq)], iters=3) / n
    del w_deq
    bounds = [dequant_bound(x.shape[0], x.shape[1], w.shape[1], bits) for x, w, _ in operands]
    b_ms = sum(t for t, _ in bounds) / n
    b_by = "bytes" if all(by == "bytes" for _, by in bounds) else "operations"
    out = dict(ms=ms, ms_warm=ms_warm, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, max_abs_err=max(e["err"] for e in errs))
    plan = plan_w8 if bits == 8 else plan_w4
    out["plan"] = {f"{x.shape[1]}x{w.shape[1]}": list(plan(*x.shape, w.shape[1]))
                   for x, w, _ in operands}
    args = [(x.to(torch.bfloat16).contiguous(), w, s.float().contiguous())
            for x, w, s in operands]
    out["parent_ms"] = device_ms(lambda: [parent_call(bits, *a) for a in args], iters=3) / n
    if bits == 8:
        int8pack, why = int8pack_call(operands[0][0], operands[0][2])
        if int8pack is None:
            out["library_ms_int8pack"] = None
            extra = f"; torch._weight_int8pack_mm does not run here ({why})"
        else:  # the weight as (N, K) and the scales in bf16, made outside the timed calls
            args = [(x, w.t().contiguous(), s.to(torch.bfloat16)) for x, w, s in args]
            out["library_ms_int8pack"] = device_ms(
                lambda: [torch._weight_int8pack_mm(*a) for a in args], iters=3) / n
            extra = f"; torch._weight_int8pack_mm {out['library_ms_int8pack']:.4f} ms"
    else:
        int4pack, _, why = int4pack_call(*operands[0])
        if int4pack is None:
            out["library_ms_int4pack"] = None
            extra = f"; torch._weight_int4pack_mm does not run here ({why})"
        else:  # tinygemm's operands, made outside the timed calls
            args = [(x, *int4pack_operands(w, s)) for x, w, s in args]
            errs4 = [(torch._weight_int4pack_mm(x, w, INT4PACK_GROUP, sz).float()
                      - plain_fn(*ops).float()).abs().max().item()
                     for (x, w, sz), ops in zip(args, operands)]
            out["library_ms_int4pack"] = device_ms(
                lambda: [torch._weight_int4pack_mm(x, w, INT4PACK_GROUP, sz)
                         for x, w, sz in args], iters=3) / n
            extra = (f"; torch._weight_int4pack_mm {out['library_ms_int4pack']:.4f} ms (max |Δ| "
                     f"{max(errs4):.3e} from plain: bf16 scales; not gated)")
    del args
    extra = (f"; the earlier design {out['parent_ms']:.4f} ms ({out['parent_ms'] / ms:.2f}x); "
             f"instances (split, tile, stages) {out['plan']}" + extra)
    print(f"  {name} device time a launch, mean over the {n} projections at "
          f"B={operands[0][0].shape[0]}: {ms:.4f} ms from HBM, {ms_warm:.4f} ms L2-warm (layer 0's "
          f"seven), plain {plain_ms:.4f} ms, cuBLAS x @ w_bf16 on the pre-dequantized weights "
          f"{lib_ms:.4f} ms (reads {16 // bits}x the weight bytes), bound {b_ms:.6f} ms ({b_by}); "
          f"the decode step's {n} launches take {ms * n:.3f} ms{extra}")
    return held, out


def oracle_gate(captured, rtol, what):
    """Each captured projection's base output against x @ (q · bf16(s)) in
    fp32, relative L2."""
    worst = 0.0
    for m, x in captured:
        want = x.float() @ dequant_oracle_weight(m.weight_q, m.weight_scale, m.bits, m.group)
        got = m.base_forward(x).float()
        worst = max(worst, ((got - want).norm() / want.norm()).item())
    print(f"  {len(captured)} projections of a decode step against the fp32 dequant oracle: "
          f"relative L2 at most {worst:.4e}")
    check(len(captured) == 224 and worst <= rtol,
          f"every quantized projection ({what}) within {rtol} (relative L2) of the oracle")


def kv_roundtrip_gate(prefill):
    """Every layer's prefill k/v against the int8 cache they quantize to:
    |q · s − k| <= amax / 127 (+1e-5), per (position, head)."""
    import msr3d_tpu_torch.models.llm.llama as llama

    recorded = []
    orig = llama.quantize_kv_cache

    def record(cache):
        out = orig(cache)
        recorded.append((cache, out))
        return out

    with mock.patch.object(llama, "quantize_kv_cache", record):
        prefill()
    ok = len(recorded) == 32
    worst = 0.0
    for cache, out in recorded:
        for key in ("k", "v"):
            ref = cache[key].float()
            deq = out[key].float() * out[f"{key}_scale"].float()[..., None]
            amax = ref.abs().amax(dim=-1, keepdim=True)
            worst = max(worst, ((deq - ref).abs() / (amax / 127.0 + 1e-5)).max().item())
    print(f"  int8 KV cache: {len(recorded)} layers' prefill k/v round-trip within "
          f"{worst:.3f} of amax/127")
    check(ok and worst <= 1.0, "every layer's prefill k/v round-trips within amax/127")


def generate_stages(model, data, gen_ms, tokens, dev):
    """Scene-encode and prefill ms (host clock around one call each) and
    decode ms/token = (generate - prefill) / decode steps."""
    net = model.network
    ids, attn = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                     side="left")
    scene = model._scene_batch(data)
    ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    attn_t = torch.as_tensor(attn, dtype=torch.int32, device=dev)

    def prefill():
        with torch.no_grad():
            return net.prefill(ids_t, attn_t, **scene, bos_id=model.tokenizer.bos_id,
                               max_cache_len=ids.shape[1] + 1)

    with torch.no_grad():
        encode_ms = wall_ms(lambda: net.visual_prompter(**scene))
    prefill_ms = wall_ms(prefill)
    finished_at = [list(row).index(model.tokenizer.eos_id) if model.tokenizer.eos_id in row
                   else NEW_TOKENS for row in tokens]
    steps = max(1, min(NEW_TOKENS, max(finished_at) + 1) - 1)
    return prefill, dict(encode_ms=encode_ms, prefill_ms=prefill_ms,
                         decode_ms=(gen_ms - prefill_ms) / steps, steps=steps)


def phase_quantized(dev, profile: bool):
    print("== phase 8: quantized greedy serving at the flagship width")
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.ops.w4_matmul import (
        W4_MATMUL_KERNEL,
        matmul_w4_reference,
        repack_from_splitnibble,
    )
    from msr3d_tpu_torch.ops.w8_matmul import W8_MATMUL_KERNEL, matmul_w8_reference

    counted = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, W8_MATMUL_KERNEL, W4_MATMUL_KERNEL)
    out = {}
    for label, what, batch, rank, quant in QUANT_RUNS:
        print(f"-- ({label}) {what}, batch {batch}")
        model = build_flagship_model(dev, lora_rank=rank, what=f"({label}): the flagship, LoRA "
                                                              f"rank {rank}, bf16 from seed 0")
        t0 = time.perf_counter()
        model.quantize_llm(**quant)
        torch.cuda.synchronize()
        print(f"  quantized on the card in {time.perf_counter() - t0:.2f} s: "
              f"{model.network.llm.cfg}")
        net = model.network
        data = make_requests(seed=0, b=batch)
        model.generate(dict(data), use_beam=False)  # warm-up: cuBLAS handles, allocator
        for kernel in counted:
            kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        gen_ms = wall_ms(lambda: data.update(model.generate(dict(data), use_beam=False)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches = {k.symbol.replace("_launch", ""): k.launches for k in counted}
        print(f"  launches during generate: {launches} (K3/K4: 0 on generate, as in the JAX "
              f"package, whose serving path computes LoraDense in XLA)")
        check(launches["fps"] == 2 and launches["flash_attn_fwd"] == 32,
              "K1 launched twice and K2f 32 times per generate")
        tokens = data["output_tokens"]
        check(tokens.shape == (batch, NEW_TOKENS)
              and bool(((tokens >= 0) & (tokens < net.llm.cfg.vocab_size)).all()),
              f"generated tokens of shape {tokens.shape} inside the vocabulary")
        prefill, st = generate_stages(model, data, gen_ms, tokens, dev)
        row = dict(st, gen_ms=gen_ms, qa_s=batch / gen_ms * 1e3, peak_gb=peak_gb,
                   launches=launches)
        print(f"  ({label}) scene encode {st['encode_ms']:.2f} ms, prefill (encode included) "
              f"{st['prefill_ms']:.2f} ms, decode {st['decode_ms']:.2f} ms/token over "
              f"{st['steps']} steps, generate {gen_ms:.2f} ms, {row['qa_s']:.3f} QA/s, peak "
              f"memory allocated {peak_gb:.2f} GiB")
        if profile and label == "a":
            profile_device("quantized generate (a)",
                           lambda: model.generate(dict(data), use_beam=False))
        with torch.no_grad():
            first = prefill()[0]
        check(bool(torch.isfinite(first).all()), "first-token logits finite")
        if quant.get("kv_quantize"):
            kv_roundtrip_gate(prefill)
            llm = net.llm.cfg
            net.llm.cfg = dataclasses.replace(llm, kv_quantize=False)
            try:
                bf16_cache = model.generate(dict(data), use_beam=False)["output_tokens"]
            finally:
                net.llm.cfg = llm
            row["same_as_bf16_cache"] = float((bf16_cache == tokens).mean())
            print(f"  tokens equal to a bf16-cache run: {row['same_as_bf16_cache']:.3f} "
                  f"(not gated)")
        with torch.no_grad():
            captured = capture_decode_inputs(model, data)
            if label in ("b", "c"):
                oracle_gate(captured, QUANT_ORACLE_RTOL, what)
            if label == "d":
                oracle_gate(captured, ACT_ORACLE_RTOL, what)
            if label == "a":
                out["w8"] = kernel_on_path(captured, 8, W8_MATMUL_KERNEL, matmul_w8_reference,
                                           lambda m: m.weight_q)
            if label == "b":
                out["w4"] = kernel_on_path(captured, 4, W4_MATMUL_KERNEL, matmul_w4_reference,
                                           lambda m: repack_from_splitnibble(m.weight_q))
            if label == "a":
                row["beam"] = beam_runs(model, make_requests(seed=0), "a, int8 KV, batch 4")
                bf16_twin_gate(model, prefill, first)
        out[label] = row
        del model, net, captured, prefill, first
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bf16_twin_gate(model, prefill, first):
    """Wiring check of the int8 LoraDense: give every projection the bf16
    weight bf16(q) · bf16(s) it computes with (stored as the transpose of that
    (in, out) product, so the product runs as the same cuBLAS call) and run
    the model's own bf16 path: the first-token logits must be equal bit for
    bit. This ends the int8 model."""
    for m in quantized_modules(model.network):
        w = m.weight_q.to(m.dtype) * m.weight_scale.to(m.dtype)
        del m.weight_q, m.weight_scale
        m.bits = 0
        m.weight = torch.nn.Parameter(w.t(), requires_grad=False)
    bf16 = prefill()[0]
    print(f"  first-token logits of the int8 model against its bf16 twin: max |Δ| "
          f"{(first - bf16).abs().max().item():.3e}")
    check(torch.equal(first, bf16), "first-token logits of (a) equal, bit for bit, those of the "
                                    "bf16 model with the weights bf16(q)·bf16(s)")


def phase7_rows(rows, bits):
    """Phase 7's device times of K3 or K4 for the kernels line, one entry a
    shape."""
    keys = ("b", "k", "n", "ms", "ms_warm", "plain_ms", "library_ms", "bound_ms", "parent_ms",
            "int8pack_ms", "int4pack_ms", "plan")
    return [{key: r[key] for key in keys if key in r} for r in rows if r["bits"] == bits]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU host", file=sys.stderr)
        return 2
    try:
        import msr3d_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    profile = "--profile" in sys.argv[1:]
    exp_root = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    t0 = time.perf_counter()
    def timed(phase, *args):
        """Run one phase and print the seconds it took, so a growing script
        shows where its time limit goes."""
        start = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        print(f"  {phase.__name__} took {time.perf_counter() - start:.1f} s")
        return out

    try:
        timed(phase_card_and_build)
        fps_row = timed(phase_fps, dev)
        flash_row = timed(phase_flash, dev)
        dq_row, dkv_row = timed(phase_flash_backward, dev)
        dequant_rows = timed(phase_dequant, dev)
        model = build_flagship_model(dev)
        launches = timed(phase_generate, model, dev, profile)
        beam = timed(phase_beam, model, dev, profile)
        shutil.rmtree(exp_root, ignore_errors=True)
        train_launches = timed(phase_train, model, dev, exp_root, profile)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        quantized = timed(phase_quantized, dev, profile)
        gc.collect()
        torch.cuda.empty_cache()
        # last, so that phases 1-9 run as they ran before it existed
        entry_launches = timed(phase_entry, exp_root)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    source = "msr3d_tpu_torch/csrc/flash_attn_bwd.cu"
    rows = [
        # launches: greedy generate (phase 4); launches_beam: the beam-5
        # generate with the ancestry map (phase 9); launches_entry: the
        # training entry's run (phase 10)
        dict(name="fps", route="cuda", source="msr3d_tpu_torch/csrc/fps.cu",
             replaces="msr3d_tpu/ops/pallas/fps.py:28", launches=launches["fps"],
             launches_beam=beam[True]["launches"]["fps"],
             launches_entry=entry_launches["fps"], **fps_row),
        dict(name="flash_attn_fwd", route="cuda", source="msr3d_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="msr3d_tpu/ops/flash_attention.py:97",
             launches=launches["flash_attn_fwd"],
             launches_beam=beam[True]["launches"]["flash_attn_fwd"],
             launches_entry=entry_launches["flash_attn_fwd"], **flash_row),
        dict(name="flash_attn_bwd_dq", route="cuda", source=source,
             replaces="msr3d_tpu/ops/flash_attention.py:152",
             launches=train_launches["flash_attn_bwd_dq"],
             launches_entry=entry_launches["flash_attn_bwd_dq"], **dq_row),
        dict(name="flash_attn_bwd_dkv", route="cuda", source=source,
             replaces="msr3d_tpu/ops/flash_attention.py:193",
             launches=train_launches["flash_attn_bwd_dkv"],
             launches_entry=entry_launches["flash_attn_bwd_dkv"], **dkv_row),
        # K3/K4: no serving path calls them, in either package, so their
        # launches over generate (a) and (b) are 0; held_on_path_operands
        # counts the launches on the 224 projections' own decode operands
        dict(name="w8_matmul", route="cuda", source="msr3d_tpu_torch/csrc/w8_matmul.cu",
             replaces="msr3d_tpu/ops/pallas/w8_matmul.py:36",
             launches=quantized["a"]["launches"]["w8_matmul"],
             held_on_path_operands=quantized["w8"][0], **quantized["w8"][1],
             phase7=phase7_rows(dequant_rows, 8)),
        dict(name="w4_matmul", route="cuda", source="msr3d_tpu_torch/csrc/w4_matmul.cu",
             replaces="msr3d_tpu/ops/pallas/w4_matmul.py:94",
             launches=quantized["b"]["launches"]["w4_matmul"],
             held_on_path_operands=quantized["w4"][0], **quantized["w4"][1],
             phase7=phase7_rows(dequant_rows, 4)),
    ]
    print(f"total {time.perf_counter() - t0:.1f} s on {card_line()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
