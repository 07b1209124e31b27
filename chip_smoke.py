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
``tokenizer.model``; 2 optimizer steps, nothing injected), and evaluation
from the YAML on that tree (phase 11: the same entry with the three MSQA
eval tasks on, one optimizer step, then val and test of a batch of 4 each
with beam 5 at 32 new tokens; the ``mode=test`` rerun from ``best``, which
must give the same test texts; retrieval over the SQA3D answer vocabulary
with ``predict_answers``), and serving (phase 12: the serve entry's
``create_frontend`` on the same YAML; (a) the greedy and beam-5 slot-refill
engines against ``generate`` at matched shapes, tokens equal; (b) 12
requests with images over HTTP from 4 client threads at budgets of 4-16
tokens, one over SSE; (c) ``python -m msr3d_tpu_torch.serve`` on the debug
config as a subprocess, SIGTERM, a drain, exit 0), and the LEO configs'
situation mode (phase 13: (a) the prompter in each of its six situation
modes, four other fusions, ``vertical_bottom``, the plain encoder stack and
``diff_all`` at the flagship width, on the card against the CPU; (b) the
entry on ``configs/leo_3_dataset.yaml`` over phase 10's tree: 61 scene
tokens a request, one step, val and test of a batch of 4, ``anchor_size``
moved by AdamW's decay alone; (c) the greedy and beam-5 engines against
``generate``), and object crops (phase 14: (a) the committed fixture crops
through the port's JPEG decoder and resample on the host's CPU against
their manifest of Pillow's and JAX's digests, with the ms a crop; (b) the
entry on ``configs/msr3d.yaml`` with ``data.obj_img_base`` set, two or
three crops a situation, one missing: one optimizer step of 4 x 5 and a
val batch, every shown image bit-equal to its CPU preprocessing), and the
serving engines' second part (phase 15, the flagship from configs/msr3d.yaml
built by the serve entry with ``--engine grouped``, penalty 1.0, 16 new
tokens: (a)
speculative greedy, ``generate`` and the continuous engine, against plain
greedy, with ms an emitted token and ``spec_stats``; (b) sampled
``generate`` and engine, each twice at one seed, their threefry keys and
bits on the card against the CPU's; (c) grouped ``generate``, greedy and
beam 5, of 2 scenes x 4 questions against the 8 questions as rows (K1 2
and K2f 32 launches: one scene encode, the prefix prefill), and the grouped
engine over HTTP; (d) ``compact_transfer``'s bytes and its unpack on the
card against the CPU's; then the exact token gates in fp32 at the
flagship's width and 2 layers), and the prefix-pool engines (phase 16, the
same YAML built by the serve entry with ``--engine pool`` and ``pool-beam``,
16 new tokens: 3 scenes x 4 questions interleaved over 2 blocks of
scene-prefix KV, so
eviction, a scene's return and head-of-line blocking occur; (a) the greedy
pool against the continuous engine, K1 2 and K2f 32 launches a prefix
prefill; (b) the speculative pool against the pool at T = 1; (c) the beam
pool against the continuous beam engine; (d) the pool over HTTP with a
400 for an overflowing question; then fp32 token gates at 2 layers against
batch-1 ``generate``), and the training-memory options (phase 17: (a)
one step of 4 x 2 from one LoRA state without remat and under each
``remat_policy`` (full, dots, residuals), with its peak memory, K2f launching
twice a layer and micro-batch under remat and the loss and grad norm those
of the step without it, then the same without images; (b) the entry on configs/msr3d.yaml with
``model.llm.remat=true model.llm.remat_policy=dots``, one step, then
``generate`` with and without remat; (c) QLoRA, a step over int8 and int4
bases without remat and with ``full``, the buffers bit-unchanged, and one
micro-batch's peak through ``_QuantizedBase`` against autograd over the
plain weight rebuild; (d) the unfrozen point encoder's training BatchNorm on
the card against the CPU; (e) the ``MSR3D_NAN_CHECKS`` guard's cost and an
injected NaN; (f) ``train_metrics_lag`` 0 against 1), and data parallelism
(phase 18, ``python -m msr3d_tpu_torch.launch --mode accelerate`` over phase
10's tree: (a) one rank at the card count, NCCL; (b) two ranks sharing the
card over gloo, 2 samples a rank a micro-batch; each one step of 4 x 5 and
val of an odd-length split, each sample scored once, the ranks' parameters
bit-equal, checked by the trainer; TrainStep's flat gradient all-reduce
through NCCL at world 1, bit-unchanged; (c) two ranks against one process in
fp32 at the flagship's width and 2 layers: the loss and the averaged
gradients within 1e-5 relative, each parameter within the step AdamW
computes from the two gradients, the same eval texts), tensor parallelism
(phase 19, at tp = 2 on the one card, two ranks over gloo: (a) the launcher
with ``parallel.tp=2``, one step of 4 x 5 and val, each rank holding half of
each split LLM tensor, its peak memory and its launches, the replicated
parameters bit-equal across the ranks; (b) the bf16 flagship's greedy and
beam-5 ``generate`` on phase 4's requests, ms a token against phase 4's; (c)
fp32 at the flagship's width and 2 layers: greedy and beam generate, the
continuous and the prefix-pool engine equal to one process's tokens, one
micro-batch's loss and gathered gradients within 1e-5 relative), pipeline
parallelism and quantized bases under tp (phase 20, two ranks over gloo on
the one card: (a) the launcher with ``parallel.pp=2``, one step and val,
each rank holding its stage's 16 blocks beside the embedding and head, its
peak, its step's share in the host-routed pp transfers and its launches,
the stages' replicated parameters bit-equal; (b) greedy generate of the
int8 and the int4-grouped flagship at tp = 2, ms a token and peak beside
phase 8's; (c) fp32 at the flagship's width and 2 layers: pp = 2's loss and
LoRA gradients within 1e-5 and 1e-4 relative of one process's, the tp = 2
greedy tokens of int8, int4, int4 by group and s8xs8 equal to tp = 1's),
sequence parallelism (phase 21, two ranks over gloo on the one card: (a) the
launcher with ``parallel.sp=2``, one step through ring attention (no flash
kernel launched in it) and a val batch generated on both ranks and scored
once, each rank's peak, its step's share in the host-routed ring hops, the
ranks' parameters bit-equal; (b) the flagship's LLM at 8 layers, T = 4096,
batch 1, forward and backward at sp = 1 (K2f, K2dq, K2dkv) and at sp = 2
(the ring), each rank's peak and ms; (c) fp32 at the flagship's width and 2
layers: sp = 2's loss and gradients within 1e-5 and 1e-4 relative of one
process's), the legacy ScanNet grounding and QA stack (phase 22: (a) a
synthetic tree of 8 scans x 64 objects with predicted masks written as CSR
arrays, one micro-batch of 8 from ScanRefer (train, and val over the
predicted masks), ScanQA, SGQA, the pretraining captions through
``MaskDatasetWrapper`` and the multi-view Referit3D; (b)
PointTokenizeEncoder, BERT, UnifiedSpatialCrossEncoderV2, GroundHeadV1 and
QAHeadV1 at the JAX modules' widths, 8 x 60 objects x 1024 points, text 80,
three AdamW steps, the eval forward on the val batch scored at IoU 0.25 and
0.5, PointBERT forward and backward, K1 at npoint 32, 16 and 64 and its picks
there equal to the plain version's; (c) fp32 at 1 layer a stack, batch 2,
three draws, on the card against the CPU: K1's picks and the kNN equal, the losses and every gradient within their tolerances),
multi-view reconstruction and the sparse-voxel stack (phase 23: (a) an NMR
tree of 32 scenes x 24 views of 64² written with the port's PNG encoder, a
batch of 32 ``NMRMVRecon`` items of 8192 rays, ``SRTEncoder`` and
``SRTDecoder`` at 768, forward and the MSE's backward, peak against the
reckoned activations; (b) Swin3D-S through ``PCDSwin3DEncoder`` over two
~100 000-voxel rooms of ``build_room_scene``: host plans (the repo's
``native/geometry.cc``), each stage's windows W and K, eval forward, then
one room forward and backward with training BatchNorm and its kernels by
device time; (c) SoftGroup's voxelization, ball query and BFS clusters on
the host and its device ops over the clusters; (d) small widths on the card
against the CPU: SRT's pixels and gradients, the ray encodings by octave,
Swin3D's outputs, gradients and running statistics, the cRSE indices equal
and the restructured cRSE against its literal formula, SoftGroup's results;
none of K1-K4 launched, as in JAX), and
checks that each path launched its kernels. Any failed
check exits non-zero. The last two lines of standard output are the per-kernel JSON
line and the result line ``{"ok": true, "device": {...}}``; without a GPU,
or without the package beside it, it exits non-zero and prints no result.
``--profile`` adds the device time by kernel of one more generate (bf16
greedy and beam, int8) and the device busy share of one more optimizer step
(``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
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
# phases 15, 16, 19 (b) and 20 (b) decode ENGINE_TOKENS tokens a request
# (their exact gates in fp32 too, phase 15's NEW_TOKENS): their engines'
# decode steps, bound by the host's dispatch, were a third of the script's
# time (32, cut to 16 for phase 18, to 8 for phase 21). Their engines decode
# in chunks of ENGINE_CHUNK steps (POOL_CHUNK for the pool engines), fewer
# than ENGINE_TOKENS, so that live slots cross a chunk boundary
ENGINE_TOKENS, ENGINE_CHUNK = 8, 4
# phases 11 and 13's eval answers (the entry's model.llm.max_out_len), cut
# from NEW_TOKENS for phase 21 (16), and to 8 for phase 22
EVAL_TOKENS = 8
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


FIGURES: dict = {}  # what an earlier phase hands a later one (phase 4's figures to phase 19)


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
    model.generate(dict(data), use_beam=False, max_new_tokens=2)  # warm-up

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
    FIGURES.update(phase4_decode_ms=decode_ms, phase4_gen_ms=gen_ms, phase4_peak_gib=peak_gb,
                   phase4_tokens=tokens)
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


def make_train_batches(n: int, images: bool = True):
    """``n`` batches of four requests built like phase 4's, images included
    unless ``images`` is False, each with answers of at most 30 characters:
    with bos and eos one 32-token bucket, so T = 224 + 32 = 256."""
    batches = []
    for i in range(n):
        data = make_requests(seed=100 + i, images=images)
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


def write_entry_tree(exp_root: Path) -> Path:
    """Phase 10's synthetic tree under ``exp_root/entry/data`` and its
    ``cfg_path``; returns the ``cfg_path``."""
    from msr3d_tpu_torch.data import synthetic

    data = exp_root / "entry" / "data"
    rng = np.random.default_rng(12)
    synthetic.build_scannet_tree(data, rng, n_objects=ENTRY_OBJECTS)
    synthetic.build_rscan_tree(data, rng, n_objects=ENTRY_OBJECTS)
    synthetic.build_arkit_tree(data, rng, n_objects=ENTRY_OBJECTS)
    for domain, scans, n in ENTRY_ANNOTATIONS:
        synthetic.build_msqa_annotations(data, list(scans), n=n, domain=domain)
    return write_entry_checkpoint(exp_root / "entry" / "vicuna7b")


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
    from msr3d_tpu_torch.data.scan_loader import ScanCache
    from msr3d_tpu_torch.models.llm.llama import LoraDense
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    root = exp_root / "entry"
    data = root / "data"
    ckpt = write_entry_tree(exp_root)
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
    return dict(launches=launches, step_ms=[1e3 * t for t in step_s],
                wait_ms=[1e3 * t for t in wait_s], load_ms=load_ms)


# Phase 11: evaluation from the YAML, on phase 10's tree and checkpoint
# directory. The three MSQA eval tasks of configs/msr3d.yaml stay on; the
# train set is cut to one batch of 4 (debug size 4, the ScanNet member of
# the mix) for one optimizer step, and each eval split to one batch of 4
EVAL_TASKS = ("msqa_scannet", "msqa_3rscan", "msqa_arkitscenes")


def eval_argv(exp_root: Path, exp: Path, *extra: str):
    """The entry's arguments of phase 11: configs/msr3d.yaml over phase 10's
    tree and ``cfg_path``, nothing else injected."""
    root = exp_root / "entry"
    data = root / "data"
    return ["--config", str(Path(__file__).resolve().parent / "configs" / "msr3d.yaml"),
            f"data.scan_family_base={data}/scan_family", f"data.rscan_base={data}/rscan",
            f"data.ARkit_base={data}/arkit", f"data.msr3d_base={data}/msr3d",
            f"model.llm.cfg_path={root / 'vicuna7b'}", "model.llm.flash_attention=true",
            "debug.flag=true", "debug.debug_size=4", "data.msr3dmix.args.mix=[msqa_scannet]",
            "solver.gradient_accumulation_steps=1", "solver.epochs=1",
            "solver.num_batch_eval=1", f"model.llm.max_out_len={EVAL_TOKENS}", f"exp_dir={exp}",
            *extra]


class EvalRecorder:
    """Instruments one entry run: each ``MSR3D.generate_async`` (its wall ms, the
    prefill's, the K1/K2f launches inside it, its texts, the task and split
    being evaluated), the evaluators' host time, ``load_learnable``'s names
    and the optimizer steps taken. The global generators are seeded before
    each test evaluation, so two runs evaluate the same test batches (neither
    package's entry seeds them, and the point resampling draws from them)."""

    def __init__(self):
        self.calls, self.evaluator_ms, self.loaded, self.steps = [], [], [], 0
        self.current = None

    def patches(self):
        from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
        from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetwork
        from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL
        from msr3d_tpu_torch.ops.fps import FPS_KERNEL
        from msr3d_tpu_torch.trainer import leo_trainer, train_state

        rec = self
        generate_async, prefill = MSR3D.generate_async, MSR3DNetwork.prefill
        update, record = MSQAEval.update, MSQAEval.record
        eval_task, load = leo_trainer.LeoTrainer.eval_task, leo_trainer.LeoTrainer.load_learnable
        step = train_state.TrainStep.__call__

        def timed_generate(model, data_dict, **kw):
            # the trainer's eval loop calls generate_async and finalizes later
            # (eval_pipeline_depth); finalized here, inside the timed call
            k1, k2 = FPS_KERNEL.launches, FLASH_FWD_KERNEL.launches
            rec.prefill_ms = 0.0
            ms = wall_ms(lambda: data_dict.update(generate_async(model, data_dict, **kw)()))
            eos = model.tokenizer.eos_id
            ends = [list(row).index(eos) if eos in row else EVAL_TOKENS
                    for row in data_dict["output_tokens"]]
            rec.calls.append(dict(task=rec.current, ms=ms, prefill_ms=rec.prefill_ms,
                                  steps=max(1, min(EVAL_TOKENS, max(ends) + 1) - 1),
                                  fps=FPS_KERNEL.launches - k1,
                                  flash=FLASH_FWD_KERNEL.launches - k2,
                                  text=list(data_dict["output_text"])))
            return lambda: data_dict

        def timed_prefill(net, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prefill(net, *args, **kw)
            torch.cuda.synchronize()
            rec.prefill_ms += (time.perf_counter() - t0) * 1e3
            return out

        def host_timed(fn):
            def wrapper(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                rec.evaluator_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return wrapper

        def tracked_eval(trainer, task, split):
            rec.current = (task, split)
            if split == "test":
                random.seed(0)
                np.random.seed(0)
            return eval_task(trainer, task, split)

        def tracked_load(trainer, name):
            rec.loaded.append(name)
            return load(trainer, name)

        def counted_step(ts, batches):
            rec.steps += 1
            return step(ts, batches)

        return [mock.patch.object(MSR3D, "generate_async", timed_generate),
                mock.patch.object(MSR3DNetwork, "prefill", timed_prefill),
                mock.patch.object(MSQAEval, "update", host_timed(update)),
                mock.patch.object(MSQAEval, "record", host_timed(record)),
                mock.patch.object(leo_trainer.LeoTrainer, "eval_task", tracked_eval),
                mock.patch.object(leo_trainer.LeoTrainer, "load_learnable", tracked_load),
                mock.patch.object(train_state.TrainStep, "__call__", counted_step)]

    def run(self, argv):
        from msr3d_tpu_torch import run as entry
        from msr3d_tpu_torch.data.scan_loader import ScanCache

        ScanCache.clear()
        with contextlib.ExitStack() as stack:
            for patch in self.patches():
                stack.enter_context(patch)
            trainer = entry.main(argv)
        torch.cuda.synchronize()
        return trainer

    def texts(self, split: str):
        return {c["task"][0]: c["text"] for c in self.calls if c["task"][1] == split}


def eval_batch_line(calls) -> str:
    """Seconds per eval batch: prefill, decode ms a step, QA/s."""
    parts = []
    for c in calls:
        decode = (c["ms"] - c["prefill_ms"]) / c["steps"]
        parts.append(f"{c['task'][0]}/{c['task'][1]} {c['ms'] / 1e3:.3f} s (prefill "
                     f"{c['prefill_ms']:.1f} ms, decode {decode:.2f} ms/step over "
                     f"{c['steps']}, {len(c['text']) / c['ms'] * 1e3:.3f} QA/s)")
    return "; ".join(parts)


def phase_eval(exp_root: Path):
    print(f"== phase 11: evaluation at the flagship width (python -m msr3d_tpu_torch.run on "
          f"configs/msr3d.yaml with its three MSQA eval tasks on: one optimizer step of "
          f"{N_REQUESTS}, then val and test over one batch of {N_REQUESTS} each, beam "
          f"{BEAMS}, repetition penalty {REP_PENALTY}; cut: {EVAL_TOKENS} new tokens, not 256 "
          f"(model.llm.max_out_len={EVAL_TOKENS}), on {card_line()})")
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    exp = exp_root / "entry" / "eval_exp"
    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL)
    layers = 32

    # (a) train one step, then val and test of the three tasks
    first = EvalRecorder()
    argv = eval_argv(exp_root, exp)
    print(f"  python -m msr3d_tpu_torch.run {' '.join(argv[:2])} ... (phase 10's data and "
          f"cfg_path) {' '.join(argv[-7:])}")
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    trainer = first.run(argv)
    main_s = time.perf_counter() - t0
    launches = {kernel.symbol.replace("_launch", ""): kernel.launches for kernel in kernels}
    print(f"  launches during the run: {launches}; main() {main_s:.1f} s (build, init, one "
          f"step, six eval batches)")
    check(first.steps == 1 and trainer.step == 1, "one optimizer step trained")
    order = [c["task"] for c in first.calls]
    want_order = [(t, "val") for t in EVAL_TASKS] + [(t, "test") for t in EVAL_TASKS]
    print(f"  eval batches: {order}")
    check(order == want_order and all(len(c["text"]) == N_REQUESTS for c in first.calls),
          f"each of the three tasks ran val and test over one batch of {N_REQUESTS}")
    check(all(c["fps"] == 2 and c["flash"] == layers for c in first.calls),
          f"K1 launched 2 and K2f {layers} times in each eval batch's generate")
    n_eval = len(first.calls)
    check(launches["fps"] == 2 * (1 + n_eval)
          and launches["flash_attn_fwd"] == layers * (1 + n_eval)
          and launches["flash_attn_bwd_dq"] == launches["flash_attn_bwd_dkv"] == layers,
          f"over the run: K1 2 and K2f {layers} a micro-batch and an eval batch, K2dq and K2dkv "
          f"{layers} for the one micro-batch")
    with open(exp / "metrics.jsonl") as fh:
        metrics = [json.loads(line) for line in fh]
    logged = {k: v for m in metrics for k, v in m.items() if "/" in k and not
              k.startswith("train/")}
    targets = {f"{s}/{t}/target_metric": logged.get(f"{s}/{t}/target_metric")
               for s in ("val", "test") for t in EVAL_TASKS}
    print(f"  target metrics: {targets}")
    check(all(v is not None and math.isfinite(v) and 0.0 <= v <= 1.0
              for v in targets.values()),
          "metrics.jsonl holds val/ and test/<task>/target_metric for each task, finite in "
          "[0, 1]")
    check(all(isinstance(v, (int, float)) and math.isfinite(v) for v in logged.values()),
          f"every eval metric finite ({len(logged)} values)")
    saved = {t: json.loads((exp / "eval" / t / "results.json").read_text())
             for t in EVAL_TASKS if (exp / "eval" / t / "results.json").exists()}
    check(sorted(saved) == sorted(EVAL_TASKS) and all(len(r) == N_REQUESTS
                                                      for r in saved.values()),
          f"results.json written for each task under exp_dir/eval/<task>, {N_REQUESTS} records")
    ev_ms = first.evaluator_ms
    print(f"  seconds per eval batch: {eval_batch_line(first.calls)}; on {card_line()}")
    print(f"  evaluators' host time: {statistics.mean(ev_ms):.3f} ms a call over {len(ev_ms)} "
          f"update/record calls, {sum(ev_ms) / n_eval:.3f} ms a batch; on {card_line()}")
    for c in first.calls[-len(EVAL_TASKS):]:
        print(f"  {c['task'][0]} test output_text[0]: {c['text'][0]!r}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # (b) mode=test on the same exp_dir, from `best`. A val target above the
    # tracker's 0.0 saves `best` (EM-R counts a prediction contained in an
    # answer, so even random weights may score); without one the phase
    # copies `latest`, the same step's weights, to `best` itself
    best_val = max(targets[f"val/{t}/target_metric"] for t in EVAL_TASKS)
    if (exp / "ckpt" / "best.pt").exists():
        print(f"  the run saved 'best' itself (best val target {best_val} > 0.0)")
    else:
        shutil.copyfile(exp / "ckpt" / "latest.pt", exp / "ckpt" / "best.pt")
        print(f"  no val target above 0.0 ({best_val}), so no 'best' was saved: the phase "
              "copies 'latest' to 'best' itself")
    second = EvalRecorder()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    trainer = second.run(eval_argv(exp_root, exp, "mode=test"))
    test_s = time.perf_counter() - t0
    launches_test = {kernel.symbol.replace("_launch", ""): kernel.launches for kernel in kernels}
    print(f"  mode=test: launches {launches_test}, main() {test_s:.1f} s; seconds per eval "
          f"batch: {eval_batch_line(second.calls)}; on {card_line()}")
    check(second.loaded == ["best"], "the mode=test run loaded 'best'")
    check(second.steps == 0 and trainer.step == 0 and launches_test["flash_attn_bwd_dq"] == 0,
          "the mode=test run trained no step")
    got, want = second.texts("test"), first.texts("test")
    for task in EVAL_TASKS:
        same = got.get(task) == want.get(task)
        print(f"  {task}: test output_text {'equal' if same else 'DIFFERENT'} to the first "
              f"run's")
    check(sorted(got) == sorted(EVAL_TASKS) and got == want,
          "each task's test output_text equals the first run's, string for string")

    # (c) retrieval over the SQA3D answer vocabulary with the same model
    retrieval = phase_retrieval(trainer, exp)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, launches_test=launches_test, retrieval=retrieval,
                eval_batches=n_eval)


def phase_retrieval(trainer, exp: Path):
    print(f"  (c) retrieval: SQA3DScanNet (a ScanNetSQA3D) val at data.sqa3d.args of "
          f"configs/msr3d.yaml, SQA3DEval, inference_mode retrieval; on {card_line()}")
    import msr3d_tpu_torch.models.llm.llama as llama
    import msr3d_tpu_torch.nn.pointnet as pointnet
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.config import config_from_dict
    from msr3d_tpu_torch.data.build import build_dataloader_leo
    from msr3d_tpu_torch.evaluator.sqa3d_eval import SQA3DEval
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL, furthest_point_sample_reference

    cfg = config_from_dict(trainer.cfg)
    task = cfg.task.msqa_scannet
    loader = build_dataloader_leo(cfg, "SQA3DScanNet", task.dataset_wrapper,
                                  task.dataset_wrapper_args, task.eval_dataloader_args, "val")
    cands = loader.dataset.dataset.answer_cands

    class Labelled:
        """The loader's batches with the multi-hot ``answer_label`` over the
        answer vocabulary that SQA3DEval reads."""
        dataset = loader

        def __len__(self):
            return len(loader)

        def __iter__(self):
            for batch in loader:
                label = np.zeros((len(batch["answer_list"]), len(cands)), np.int64)
                for i, answers in enumerate(batch["answer_list"]):
                    for a in answers.split("[answer_seq]"):
                        label[i, cands.index(a)] = 1
                yield dict(batch, answer_label=label)

    trainer.loaders["sqa3d"] = {"val": Labelled()}
    trainer.evaluators["sqa3d"] = SQA3DEval(None, "sqa3d", save_dir=exp / "eval" / "sqa3d")
    trainer.inference_mode = "retrieval"
    seen, ms = [], []
    predict = MSR3D.predict_answers

    def recorded(model, data_dict, answer_list, **kw):
        seen.append(data_dict)  # predict_answers adds its outputs to it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict(model, data_dict, answer_list, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    random.seed(0)
    np.random.seed(0)
    FPS_KERNEL.launches = fa.FLASH_FWD_KERNEL.launches = 0
    with mock.patch.object(MSR3D, "predict_answers", recorded):
        results = trainer.eval_task("sqa3d", "val")
    launches = {"fps": FPS_KERNEL.launches, "flash_attn_fwd": fa.FLASH_FWD_KERNEL.launches}
    batch = seen[0]
    ids, scores = batch["answers_id"], batch["answer_scores"]
    b, k = len(batch["answer_list"]), min(128, len(cands))
    chunks = -(-k // 16)
    print(f"  {b} questions, {len(cands)} candidates {cands}, {k} scored in {chunks} loss "
          f"chunk(s); launches {launches}; {ms[0]:.1f} ms a batch; answers "
          f"{[cands[int(i)] for i in ids]}; EM@1 {results['ans1_acc']}, EM@10 "
          f"{results['ans10_acc']}; on {card_line()}")
    check(bool(((ids >= 0) & (ids < len(cands))).all()), "answers_id inside the answer "
                                                          "vocabulary")
    check(launches["flash_attn_fwd"] == 32 * (1 + chunks) and launches["fps"] == 2 * (1 + chunks),
          "K2f launched 32 times in the prefill and 32 times per loss chunk, K1 twice in each")
    check(math.isfinite(results["ans1_acc"]) and math.isfinite(results["ans10_acc"]),
          "EM@1 and EM@10 finite")
    # the same candidates' losses through the plain path (K1's and K2f's
    # plain versions)
    keys = [key for key in batch if key not in ("answers_id", "answers", "answer_scores")]
    with mock.patch.object(fa, "flash_attention", fa.flash_attention_reference), \
            mock.patch.object(llama, "flash_attention", fa.flash_attention_reference), \
            mock.patch.object(pointnet, "fps", lambda xyz, m: furthest_point_sample_reference(
                xyz.float().contiguous(), m)):
        plain = trainer.model.predict_answers({key: batch[key] for key in keys}, cands)
    plain_scores = plain["answer_scores"]
    scored = scores > -1e9
    gap = np.sort(-plain_scores, axis=1)
    print(f"  losses through K1/K2f against the plain path: max |Δ| "
          f"{np.abs(scores - plain_scores)[scored].max():.4e}; plain margin of the best "
          f"candidate over the next {(gap[:, 1] - gap[:, 0]).min():.4e}")
    check(bool((plain_scores[np.arange(b), ids] == plain_scores.max(axis=1)).all()),
          "each answers_id is the argmin of the candidates' losses recomputed through the "
          "plain path")
    trainer.inference_mode = "generation"
    del trainer.loaders["sqa3d"], trainer.evaluators["sqa3d"]
    return dict(launches=launches, ms=ms[0], chunks=chunks)


# Phase 12: serving at the flagship width through the serve entry's
# create_frontend on configs/msr3d.yaml, over phase 10's cfg_path. (b) sends
# SERVE_REQUESTS requests from SERVE_CLIENTS client threads, budgets cycling
# over SERVE_BUDGETS (the reference's 256 tokens cut to SERVE_TOKENS: 32, 16
# since phase 21); request SERVE_STREAMED (budget 16, so that a chunk of 8
# ends before it does) streams over SSE
SERVE_TOKENS = 16
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_BUDGETS, SERVE_STREAMED = 12, 4, (4, 8, 12, 16), 3
SERVE_BATCH1 = 1  # (b)'s answers held (not gated) to a batch-1 generate


def serve_argv(exp_root: Path, *extra: str, tokens: int = SERVE_TOKENS):
    """The serve entry's arguments of phase 12: configs/msr3d.yaml with
    phase 10's ``cfg_path``, random weights, an ephemeral port, ``tokens``
    new tokens."""
    return ["--config", str(_ROOT / "configs" / "msr3d.yaml"), "--random-init", "--port", "0",
            "--max-new-tokens", str(tokens), *extra,
            f"model.llm.cfg_path={exp_root / 'entry' / 'vicuna7b'}",
            "model.llm.flash_attention=true"]


def timed_decode(model, fn):
    """Run ``fn`` with the network's prefill timed (synchronized) and its
    decode steps counted: (result, total ms, prefill ms, decode steps)."""
    net = model.network
    prefill = net.prefill
    rec = dict(prefill_ms=0.0, steps=0)

    def timed_prefill(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*args, **kw)
        torch.cuda.synchronize()
        rec["prefill_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def counted(fn_step):
        def step(*args, **kw):
            rec["steps"] += 1
            return fn_step(*args, **kw)
        return step

    out = {}
    with mock.patch.multiple(net, prefill=timed_prefill,
                             decode_step_shared=counted(net.decode_step_shared),
                             decode_step_beam_anc=counted(net.decode_step_beam_anc)):
        ms = wall_ms(lambda: out.update(result=fn()))
    return out["result"], ms, rec["prefill_ms"], rec["steps"]


def serve_matched(model):
    """(a) Both engines at generate's shapes: phase 4's four requests in one
    refill group of 4 slots, prompt_len generate's bucket + 1, SERVE_TOKENS tokens.
    Gates: the greedy engine's tokens equal greedy generate's, the beam-5
    engine's equal beam-5 generate's (ancestry map on), request by request."""
    from msr3d_tpu_torch.serving import (
        ContinuousBatchingServer,
        ContinuousBeamBatchingServer,
        uncollate_batch,
    )

    data = make_requests(seed=0, images=True)
    samples = uncollate_batch(data)
    ids, _ = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                  side="left")
    prompt_len = ids.shape[1] + 1
    model.generate(dict(data), use_beam=False, max_new_tokens=2)  # warm-up
    rows = {}
    for label, use_beam, cls in (("greedy", False, ContinuousBatchingServer),
                                 (f"beam {BEAMS}", True, ContinuousBeamBatchingServer)):
        gen, gen_ms, gen_prefill, gen_steps = timed_decode(
            model, lambda: model.generate(dict(data), use_beam=use_beam,
                                          max_new_tokens=SERVE_TOKENS))
        engine = cls(model, num_slots=N_REQUESTS, refill_group=N_REQUESTS, chunk_steps=8,
                     max_new_tokens=SERVE_TOKENS, prompt_len=prompt_len)
        res, eng_ms, eng_prefill, eng_steps = timed_decode(model, lambda: engine.run(samples))
        want = gen["output_tokens"]
        same = [bool(np.array_equal(r.output_tokens, want[r.id])) for r in res]
        row = dict(gen_ms=gen_ms, gen_decode_ms=(gen_ms - gen_prefill) / max(1, gen_steps),
                   gen_steps=gen_steps, engine_ms=eng_ms,
                   engine_decode_ms=(eng_ms - eng_prefill) / max(1, eng_steps),
                   engine_steps=eng_steps, steps_run=engine.steps_run, equal=sum(same))
        print(f"  (a) {label}, prompt_len {prompt_len}: generate {gen_ms:.2f} ms (prefill "
              f"{gen_prefill:.2f} ms, decode {row['gen_decode_ms']:.2f} ms a step over "
              f"{gen_steps}), engine run {eng_ms:.2f} ms (prefill {eng_prefill:.2f} ms, decode "
              f"{row['engine_decode_ms']:.2f} ms a step over {eng_steps}, steps_run "
              f"{engine.steps_run}); tokens equal for {sum(same)} of {len(same)} requests")
        check(len(res) == N_REQUESTS and all(same) and eng_steps == engine.steps_run,
              f"the {label} engine's tokens equal {label} generate's at matched shapes, request "
              "by request")
        rows[label] = row
    return rows


def sse_events(resp):
    """The ``data:`` events of an open SSE answer, up to the final one."""
    events = []
    for raw in resp:
        line = raw.decode().strip()
        if line.startswith("data: "):
            events.append(json.loads(line[len("data: "):]))
            if events[-1].get("done"):
                break
    return events


def serve_http(fe, model):
    """(b) The HTTP front end (greedy, 8 slots, refill group 4, chunk 8,
    lookahead 1) under SERVE_REQUESTS requests with images from
    SERVE_CLIENTS client threads in a closed loop at mixed budgets, one over
    SSE. K1 and K2f are counted from 0 around the traffic."""
    import urllib.request

    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.serving import _collate, uncollate_batch
    from msr3d_tpu_torch.serving_http import encode_scene_b64

    n = SERVE_REQUESTS
    samples = uncollate_batch(make_requests(seed=1, b=n, images=True))
    budgets = [SERVE_BUDGETS[i % len(SERVE_BUDGETS)] for i in range(n)]
    bodies = [json.dumps(dict({"prompt": s["msr3d_prompt"], "scene_b64": encode_scene_b64(s),
                               "max_new_tokens": b}, **({"stream": True}
                                                        if i == SERVE_STREAMED else {})))
              .encode() for i, (s, b) in enumerate(zip(samples, budgets))]
    url = f"http://127.0.0.1:{fe.port}"
    answers, errors = {}, []

    def post(i):
        req = urllib.request.Request(f"{url}/v1/generate", data=bodies[i],
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            if i == SERVE_STREAMED:
                events = sse_events(resp)
                return resp.status, dict(events[-1], snapshots=[e for e in events[:-1]])
            return resp.status, json.loads(resp.read())

    order = iter(range(n))
    lock = threading.Lock()

    def client(k):
        # a closed loop: each client sends the next request of the list once
        # its previous answer is in, so at most SERVE_CLIENTS are in flight
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            try:
                answers[i] = post(i)
            except Exception as exc:  # reported and gated below
                errors.append(f"request {i}: {exc!r}")

    fe.start()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    launches = {"fps": FPS_KERNEL.launches, "flash_attn_fwd": FLASH_FWD_KERNEL.launches}
    with urllib.request.urlopen(f"{url}/v1/health", timeout=60) as resp:
        health = json.loads(resp.read())
    fe.close(timeout=None)
    check(not errors and sorted(answers) == list(range(n))
          and all(status == 200 for status, _ in answers.values()),
          f"every one of the {n} answers is 200 ({errors[:2]})")
    eos = model.tokenizer.eos_id
    emitted, bad = [], []
    for i, (_, payload) in sorted(answers.items()):
        toks = np.asarray(payload["tokens"])
        first = int(np.argmax(toks == eos)) if (toks == eos).any() else len(toks)
        emitted.append(min(first + 1, budgets[i]))
        if not (first <= budgets[i] and bool((toks[first:] == eos).all())
                and payload["text"] == model.batch_detokenize(toks[None])[0]):
            bad.append(i)
    print(f"  (b) tokens emitted a request (an EOS counted): {emitted} at budgets {budgets}")
    check(not bad, "each answer's tokens within its budget, nothing but EOS after an early end, "
                   f"its text the detokenized tokens (failing: {bad})")
    snaps = answers[SERVE_STREAMED][1]["snapshots"]
    final = answers[SERVE_STREAMED][1]["text"]
    check(len(snaps) > 0 and all(final.startswith(e["text"]) for e in snaps),
          f"the SSE request's {len(snaps)} snapshots are prefixes of its final text")
    check(health["served"] == n and health["status"] == "ok",
          f"/v1/health: served {health['served']}, {health}")
    check(not fe._engine_thread.is_alive() and not fe._http_thread.is_alive(),
          "close() drained: the engine and HTTP threads ended")
    # not gated: a batch-1 generate runs its GEMMs at another batch, and bf16
    # may round otherwise there; the first SERVE_BATCH1 requests only, for
    # the script's time
    same = 0
    for i, s in enumerate(samples[:SERVE_BATCH1]):
        want = model.generate(_collate([s]), use_beam=False,
                              max_new_tokens=budgets[i])["output_tokens"][0]
        same += int(np.array_equal(np.asarray(answers[i][1]["tokens"])[:budgets[i]], want))
    row = dict(elapsed_s=elapsed, requests_s=n / elapsed, tokens_s=sum(emitted) / elapsed,
               answer_tokens=sum(emitted), steps_run=fe.engine.steps_run,
               decode_steps_health=health["decode_steps"], launches=launches,
               equal_to_batch1_generate=same)
    print(f"  (b) {n} requests in {elapsed:.3f} s: {row['requests_s']:.3f} requests/s, "
          f"{row['tokens_s']:.2f} answer tokens/s ({sum(emitted)} tokens), steps_run "
          f"{fe.engine.steps_run}, launches {launches}; {same} of the first {SERVE_BATCH1} "
          f"answers equal a batch-1 generate (not gated); on {card_line()}")
    check(launches["fps"] > 0 and launches["flash_attn_fwd"] > 0,
          "K1 and K2f launched during the HTTP traffic (the refill groups' prefills)")
    return row


def serve_entry():
    """(c) ``python -m msr3d_tpu_torch.serve`` on the debug config as a
    subprocess: the listening line, one answer, SIGTERM, a drain, exit 0."""
    import signal
    import urllib.request

    from msr3d_tpu_torch.serving_http import encode_scene_b64

    r = np.random.default_rng(5)
    scene = {"obj_fts": (r.normal(size=(6, 64, 6)) * 0.3).astype(np.float32),
             "obj_masks": np.ones(6, bool), "obj_locs": r.normal(size=(6, 6)).astype(np.float32),
             "anchor_locs": np.zeros(3, np.float32),
             "anchor_orientation": np.array([0, 0, 0, 1], np.float32)}
    cmd = [sys.executable, "-m", "msr3d_tpu_torch.serve", "--config",
           "configs/debug_synthetic.yaml", "--random-init", "--port", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines, out = [], ""
    try:
        for line in proc.stdout:
            lines.append(line)
            if "listening on http://" in line:
                break
        check("listening on http://" in "".join(lines[-1:]),
              f"the entry printed its listening line ({''.join(lines[-5:])!r})")
        port = int(lines[-1].split("http://")[1].split()[0].rsplit(":", 1)[1])
        body = json.dumps({"prompt": "scene: 景 USER: what is here? ASSISTANT:",
                           "scene_b64": encode_scene_b64(scene)}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, payload = resp.status, json.loads(resp.read())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    print(f"  (c) {' '.join(cmd[1:])}: answered {status} with {len(payload['tokens'])} tokens, "
          f"exit code {proc.returncode} after SIGTERM, {seconds:.1f} s in all")
    check(status == 200 and proc.returncode == 0 and "drained, bye" in out,
          "the serve entry answered, drained on SIGTERM and exited 0")
    return dict(seconds=seconds)


def phase_serve(exp_root: Path):
    print("== phase 12: serving at the flagship width (the serve entry's create_frontend on "
          "configs/msr3d.yaml with phase 10's cfg_path, random weights)")
    from msr3d_tpu_torch import serve

    t0 = time.perf_counter()
    fe = serve.create_frontend(serve.parse_args(serve_argv(
        exp_root, "--slots", "8", "--refill-group", "4", "--chunk-steps", "8",
        "--lookahead", "1")))
    model = fe.engine.model
    torch.cuda.synchronize()
    print(f"  built and initialised in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.network.parameters()) / 1e9:.3f} B parameters, "
          f"{model.cfg.llm}")
    out = dict(a=serve_matched(model), b=serve_http(fe, model))
    del fe, model
    gc.collect()
    torch.cuda.empty_cache()
    out["c"] = serve_entry()
    return out


# Phase 13: the LEO configs' situation mode (as_object: the anchor as a
# scene token) and the other modes. (a) holds every situation mode, fusion
# and geometry option of the prompter at the flagship width on the card (K1
# inside) against the same module on the CPU (plain FPS, fp32, TF32 off):
# equal sampled points, fp32 sums in other orders through 3 layers of width
# 256, so |card - cpu| <= LEO_ATOL + LEO_RTOL * |cpu|
LEO_ATOL, LEO_RTOL = 1e-4, 1e-4
LEO_ROWS = {
    "as_object": {}, "as_object_add_loc": {}, "as_embedding": {},
    "as_transform_for_objects": {}, "as_cross_attention": {}, "as_dit_attention": {},
    **{f"fusion {f}": {"spatial_attn_fusion": f} for f in ("mul", "bias", "add", "ctx")},
    "vertical_bottom": {"pairwise_rel_type": "vertical_bottom"},
    "use_spatial_attn off": {"use_spatial_attn": False},
    "diff_all": {"obj_loc_encoding": "diff_all"},
}


# Phase 14: the entry with object crops. Phase 10's scans and cfg_path; new
# MSQA ScanNet annotations whose situations hold two or three object-image
# placeholders (synthetic.IMAGE_SITUATIONS), and the committed fixture crops
# copied to the names they ask for, one left out. 20 train samples: one
# optimizer step of 4 x 5, then one val batch of msqa_scannet
CROP_SCANS = ("scene0000_00", "scene0001_00")
CROP_SAMPLES = N_REQUESTS * TRAIN_ACCUM


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def host_ms(fn, iters: int = 20) -> float:
    """Median wall ms of ``fn`` on the host's CPU (no device work)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def crops_on_host():
    """(a) Each fixture crop through ``decode_jpeg`` and ``preprocess_2d`` on
    this host's CPU against the manifest's digests (Pillow's decode and the
    JAX package's ``preprocess_2d``, written where Pillow runs), and the
    decode, resize and ``preprocess_2d`` ms a crop."""
    from msr3d_tpu_torch.data.data_utils import preprocess_2d, resize_bilinear
    from msr3d_tpu_torch.data.jpeg import decode_jpeg
    from msr3d_tpu_torch.data.synthetic import CROP_FIXTURES

    manifest = json.loads((CROP_FIXTURES / "manifest.json").read_text())
    rows = []
    for entry in manifest["crops"]:
        path = CROP_FIXTURES / entry["file"]
        img = decode_jpeg(path)
        digests = {f"preprocess_{w}x{h}_sha256": sha256(preprocess_2d(img, size=(w, h)))
                   for w, h in ((224, 224), (32, 32))}
        check(list(img.shape) == entry["shape"] and sha256(img) == entry["decoded_sha256"]
              and all(entry[k] == v for k, v in digests.items()),
              f"{entry['file']}: the decode and preprocess_2d at 224² and 32² equal the "
              "manifest's digests")
        data = path.read_bytes()
        row = dict(file=entry["file"], height=img.shape[0], width=img.shape[1],
                   bytes=len(data), decode_ms=host_ms(lambda: decode_jpeg(data)),
                   resize_ms=host_ms(lambda: resize_bilinear(img, (IMAGE_SIZE, IMAGE_SIZE))),
                   preprocess_ms=host_ms(lambda: preprocess_2d(img)))
        rows.append(row)
        print(f"  {row['file']} ({row['width']}x{row['height']}, {row['bytes']} bytes): decode "
              f"{row['decode_ms']:.4f} ms, resize to {IMAGE_SIZE}² {row['resize_ms']:.4f} ms, "
              f"preprocess_2d {row['preprocess_ms']:.4f} ms (host CPU)")
    check(len(rows) == len(manifest["crops"]) >= 8, "every fixture crop held to the manifest")
    return rows


def expected_crops(img_base: Path, scan_id: str, index: int):
    """The crop files of sample ``index``'s placeholders, in prompt order,
    that exist (the missing one falls back to text)."""
    from msr3d_tpu_torch.data.synthetic import IMAGE_SITUATIONS

    situation = IMAGE_SITUATIONS[index % len(IMAGE_SITUATIONS)]
    paths = [img_base / "ScanNet" / f"{scan_id}_inst{inst}_{label}_0.jpg"
             for label, inst in re.findall(r"<([^<>-]+)-(\d+)-IMG>", situation)]
    return [path for path in paths if path.exists()]


def phase_crops(exp_root: Path, entry: dict):
    print("== phase 14: object crops at the flagship width ((a) the fixture crops through the "
          "port's JPEG decoder and resample on the host's CPU against their manifest; (b) python "
          "-m msr3d_tpu_torch.run on configs/msr3d.yaml with data.obj_img_base set over phase "
          f"10's scans and cfg_path: one optimizer step of {N_REQUESTS} x {TRAIN_ACCUM}, then one "
          f"val batch of msqa_scannet, beam {BEAMS}, {NEW_TOKENS} new tokens), on {card_line()}")
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.data import synthetic
    from msr3d_tpu_torch.data.data_utils import pad_tensors, preprocess_2d
    from msr3d_tpu_torch.data.jpeg import decode_jpeg
    from msr3d_tpu_torch.data.scan_loader import ScanCache, ScanDataLoader
    from msr3d_tpu_torch.models.llm.llama import LoraDense
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    t_phase = time.perf_counter()
    host = crops_on_host()

    # (b) the entry with crops
    root = exp_root / "entry"
    tree = root / "crops_tree"
    synthetic.build_msqa_annotations(tree, list(CROP_SCANS), n=CROP_SAMPLES, domain="scannet")
    img_base = synthetic.build_msqa_crops(tree, list(CROP_SCANS))
    data = root / "data"
    argv = ["--config", str(_ROOT / "configs" / "msr3d.yaml"),
            f"data.scan_family_base={data}/scan_family", f"data.rscan_base={data}/rscan",
            f"data.ARkit_base={data}/arkit", f"data.msr3d_base={tree}/msr3d",
            f"data.obj_img_base={img_base}", f"model.llm.cfg_path={root / 'vicuna7b'}",
            "model.llm.flash_attention=true", "debug.flag=true",
            f"debug.debug_size={CROP_SAMPLES}", "data.msr3dmix.args.mix=[msqa_scannet]",
            "task.msqa_scannet.mode=[val]", "task.msqa_3rscan.mode=[]",
            "task.msqa_arkitscenes.mode=[]", "solver.epochs=1", "solver.num_batch_eval=1",
            f"model.llm.max_out_len={NEW_TOKENS}", f"exp_dir={root / 'crops_exp'}"]
    print(f"  python -m msr3d_tpu_torch.run {' '.join(argv[:2])} ... {' '.join(argv[6:7])} "
          f"{' '.join(argv[-9:])}")
    rec = EvalRecorder()
    seen, frozen = [], {}
    scene_batch, init_params = MSR3D._scene_batch, MSR3D.init_params

    def recording_scene_batch(self, data_dict):
        batch = scene_batch(self, data_dict)
        masks = batch["image_masks"]
        seen.append(dict(stage=rec.current, shape=tuple(batch["images"].shape),
                         device=batch["images"].device.type,
                         scans=list(data_dict["scan_id"]),
                         index=[int(i) for i in data_dict["index"]],
                         prompts=list(data_dict["msr3d_prompt"]), masks=masks.cpu(),
                         shown=batch["images"][masks].clone()))
        return batch

    def recording_init(self, seed=None):
        init_params(self, seed)
        frozen["before"] = frozen_checksums(self)

    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL)
    with mock.patch.object(MSR3D, "_scene_batch", recording_scene_batch), \
            mock.patch.object(MSR3D, "init_params", recording_init):
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        trainer = rec.run(argv)
        main_s = time.perf_counter() - t0
        launches = {kernel.symbol.replace("_launch", ""): kernel.launches for kernel in kernels}
    model = trainer.model
    train = [b for b in seen if b["stage"] is None]
    print(f"  launches during the run: {launches}; main() {main_s:.1f} s (build, init, one step "
          f"of {len(train)} micro-batches, {len(rec.calls)} eval batch)")
    check(rec.steps == 1 and trainer.step == 1 and len(train) == TRAIN_ACCUM,
          f"one optimizer step of {TRAIN_ACCUM} micro-batches trained")
    check(all(b["shape"] == (N_REQUESTS, MAX_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3)
              and b["device"] == "cuda" for b in seen),
          f"each micro-batch and eval batch carries images ({N_REQUESTS}, {MAX_IMAGES}, "
          f"{IMAGE_SIZE}, {IMAGE_SIZE}, 3) on the card")
    cpu_images, counts, first = {}, [], None
    for b in seen:
        k = 0
        for j, (scan, index, prompt) in enumerate(zip(b["scans"], b["index"], b["prompts"])):
            mask = b["masks"][j]
            n = int(mask.sum())
            crops = expected_crops(img_base, scan, index)
            counts.append((n, prompt.count("图"), len(crops)))
            check(n == prompt.count("图") and bool(mask[:n].all()) and n in (0, len(crops)),
                  f"sample {index} ({scan}): its {n} shown images come first and equal its 图 "
                  f"placeholders ({prompt.count('图')}) and its crops ({len(crops)}) or none")
            for path in crops[:n]:
                if path not in cpu_images:
                    size = (b["shape"][3], b["shape"][2])
                    cpu_images[path] = torch.from_numpy(preprocess_2d(decode_jpeg(path), size))
                got = b["shown"][k].cpu()
                first = first or (path.name, b["stage"])
                check(torch.equal(got, cpu_images[path]),
                      f"the image of {path.name} on the card is bit-equal to its CPU "
                      "preprocess_2d")
                k += 1
    shown = [n for n, _, _ in counts]
    check(any(n == 0 < c for n, _, c in counts) and any(n == c == 3 for n, _, c in counts)
          and any(n == c == 2 for n, _, c in counts) and sum(shown) > 0,
          "samples with 2 and 3 crops shown, and a count mismatch falling back to text, ran")
    check(any("A lamp is behind me" in p for b in seen for p in b["prompts"]),
          "the missing crop fell back to its label in the text")
    print(f"  shown images a sample (图 placeholders): {sorted(set(shown))}, {sum(shown)} images "
          f"over {len(counts)} samples, each bit-equal to its CPU preprocess_2d (first: "
          f"{first[0]})")
    check(launches["fps"] == 2 * (TRAIN_ACCUM + len(rec.calls))
          and launches["flash_attn_fwd"] == 32 * (TRAIN_ACCUM + len(rec.calls))
          and launches["flash_attn_bwd_dq"] == launches["flash_attn_bwd_dkv"] == 32 * TRAIN_ACCUM,
          "K1 2 and K2f 32 launches a micro-batch and an eval batch, K2dq and K2dkv 32 a "
          "micro-batch")
    with open(trainer.exp_dir / "metrics.jsonl") as fh:
        metrics = [json.loads(line) for line in fh]
    losses = [m["train/loss"] for m in metrics if "train/loss" in m]
    logged = {k: v for m in metrics for k, v in m.items() if k.startswith("val/")}
    check(len(losses) == 1 and all(math.isfinite(v) for v in losses), "the loss is finite")
    loras = [m for m in model.network.modules() if isinstance(m, LoraDense) and m.scale]
    check(len(loras) == 7 * 32 and all(bool((m.lora_b != 0).any()) for m in loras),
          f"every LoRA B tensor ({len(loras)}) moved from 0")
    check(torch.equal(frozen_checksums(model), frozen["before"]),
          "checksums of the frozen base weights, norms, embeddings and lm_head unchanged")
    check([c["task"] for c in rec.calls] == [("msqa_scannet", "val")]
          and all(len(c["text"]) == N_REQUESTS and c["fps"] == 2 and c["flash"] == 32
                  for c in rec.calls)
          and logged and all(isinstance(v, (int, float)) and math.isfinite(v)
                             for v in logged.values()),
          f"one val batch of msqa_scannet: {N_REQUESTS} texts, K1 2 and K2f 32 launches, every "
          f"metric finite ({len(logged)} values)")
    step_ms = [1e3 * t for t in trainer.timer.history]
    wait_ms = [1e3 * t for t in trainer.data_wait_history]
    # the loader alone, and what of it is the crops' reading (decode and
    # preprocess_2d) and what one sample's image padding costs beside the
    # zeros of a sample without crops (the dataset wrapper's two branches)
    loader = trainer.train_loader
    chunks = list(itertools.islice(loader._batches(), 3))
    read_ms, read_one = [], ScanDataLoader.get_one_certain_img

    def timed_read(self, *args):
        t0 = time.perf_counter()
        out = read_one(self, *args)
        read_ms[-1] += (time.perf_counter() - t0) * 1e3
        return out

    load_ms = []
    with mock.patch.object(ScanDataLoader, "get_one_certain_img", timed_read):
        for c in chunks:
            read_ms.append(0.0)
            load_ms.append(wall_ms(lambda c=c: loader._load(c)))
    shown_two = np.stack([next(iter(cpu_images.values())).numpy()] * 2)
    pad_ms = host_ms(lambda: pad_tensors(shown_two, MAX_IMAGES), iters=5)
    zeros_ms = host_ms(lambda: np.zeros((MAX_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3), np.float32),
                       iters=5)
    print(f"  the loader alone with crops: {' / '.join(f'{t:.1f}' for t in load_ms)} ms a "
          f"micro-batch, of which reading its crops {' / '.join(f'{t:.1f}' for t in read_ms)} "
          f"ms; one sample's 2 images padded to {MAX_IMAGES} {pad_ms:.2f} ms, the zeros of a "
          f"sample without crops {zeros_ms:.3f} ms (host CPU)")
    print(f"  with crops: step {' / '.join(f'{t:.1f}' for t in step_ms)} ms, host data wait "
          f"{' / '.join(f'{t:.1f}' for t in wait_ms)} ms a step, one micro-batch from the "
          f"loader alone {' / '.join(f'{t:.1f}' for t in load_ms)} ms; phase 10 (no crops): "
          f"step {' / '.join(f'{t:.1f}' for t in entry['step_ms'])} ms, wait "
          f"{' / '.join(f'{t:.1f}' for t in entry['wait_ms'])} ms, loader alone "
          f"{' / '.join(f'{t:.1f}' for t in entry['load_ms'])} ms; val batch "
          f"{eval_batch_line(rec.calls)}; on {card_line()}")
    print(f"  msqa_scannet val output_text[0]: {rec.calls[0]['text'][0]!r}")
    ScanCache.clear()
    del trainer, model, seen
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  phase 14 wall time {wall:.1f} s")
    return dict(launches=launches, host=host, step_ms=step_ms, wait_ms=wait_ms, load_ms=load_ms,
                eval_batches=len(rec.calls), wall_s=wall)


def leo_prompter_cfg(name: str):
    """The flagship prompter (hidden 256, 3 layers, 8 heads, FFN 2048) with a
    fp32 point encoder, in the row's mode (the fusions, geometry and the
    plain stack under the flagship's as_transform_for_objects)."""
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig

    base = OSE3DConfig(obj_encoder_dtype="float32")
    kw = dict(LEO_ROWS[name])
    situation = "as_transform_for_objects" if kw else name
    se = {k: kw.pop(k) for k in list(kw) if hasattr(base.spatial_encoder, k)}
    return dataclasses.replace(base, situation_type=situation, **kw,
                               spatial_encoder=dataclasses.replace(base.spatial_encoder, **se))


def leo_modes(dev):
    """(a): each row's prompter from seed 13, its point encoder one shared
    weight set; the CPU side runs on the shared encoder's CPU embeddings."""
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DSituation
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    data = make_requests(seed=13, b=2)
    data["obj_masks"][1, 50:] = False  # ten padded objects in the second scene
    quat = np.random.default_rng(13).normal(size=(2, 4))
    data["anchor_orientation"] = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).astype(
        np.float32)
    cpu_in = {k: torch.from_numpy(np.asarray(data[k])) for k in _SCENE_KEYS}
    card_in = {k: v.to(dev) for k, v in cpu_in.items()}
    encoder = None
    rows = {}
    for name in LEO_ROWS:
        torch.manual_seed(13)
        cpu = OSE3DSituation(leo_prompter_cfg(name)).eval()
        with torch.no_grad():
            for p in cpu.parameters():  # off PyTorch's init: biases and norms not trivial
                p.add_(torch.randn_like(p) * 0.02)
        if encoder is None:
            encoder = cpu.obj_encoder.state_dict()
            t0 = time.perf_counter()
            with torch.no_grad():
                embeds = cpu.obj_encoder(cpu_in["obj_fts"])
            print(f"  the shared point encoder on the CPU (plain FPS): "
                  f"{time.perf_counter() - t0:.1f} s for {2 * 60} clouds of 1024 points")
        cpu.obj_encoder.load_state_dict(encoder)
        card = OSE3DSituation(cpu.cfg, device=dev).eval()
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            want = cpu(**cpu_in, precomputed_obj_embeds=embeds)
            FPS_KERNEL.launches = 0
            got = card(**card_in)
            torch.cuda.synchronize()
        launches = FPS_KERNEL.launches
        tokens = got["obj_tokens"].cpu()
        err = (tokens - want["obj_tokens"]).abs()
        excess = float((err - LEO_RTOL * want["obj_tokens"].abs()).max())
        n = 61 if card.prepend_anchor else 60
        rows[name] = dict(max_abs_err=float(err.max()), launches=launches)
        print(f"  (a) {name}: obj_tokens {tuple(tokens.shape)}, max |card - cpu| "
              f"{float(err.max()):.3e}, K1 launches {launches}")
        check(tuple(tokens.shape) == (2, n, 256) and launches == 2
              and excess <= LEO_ATOL and bool(torch.isfinite(tokens).all())
              and torch.equal(got["obj_masks"].cpu(), want["obj_masks"]),
              f"{name}: {n} tokens of 256, K1 launched twice, |card - cpu| <= {LEO_ATOL} + "
              f"{LEO_RTOL}|cpu|, masks equal")
    return rows


def phase_leo(exp_root: Path):
    print("== phase 13: the LEO configs' as_object at the flagship width ((a) every situation "
          "mode, fusion and geometry option of the prompter on the card against the CPU; (b) "
          "python -m msr3d_tpu_torch.run on configs/leo_3_dataset.yaml over phase 10's tree "
          "and cfg_path: one optimizer step, val and test of msqa_scannet at a batch of "
          f"{N_REQUESTS}; (c) the greedy and beam-{BEAMS} engines against generate), on "
          f"{card_line()}")
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.models.llm.llama import LoraDense
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetwork
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    modes = leo_modes(dev)

    # (b) the entry on the LEO YAML
    root = exp_root / "entry"
    exp = root / "leo_exp"
    argv = ["--config", str(_ROOT / "configs" / "leo_3_dataset.yaml"), *eval_argv(
        exp_root, exp, "task.msqa_3rscan.mode=[]", "task.msqa_arkitscenes.mode=[]")[2:]]
    print(f"  python -m msr3d_tpu_torch.run {' '.join(argv[:2])} ... (phase 10's data and "
          f"cfg_path) {' '.join(argv[-9:])}")
    before, scenes = {}, []
    init_params, build_embeds = MSR3D.init_params, MSR3DNetwork.build_embeds

    def recording_init(self, seed=None):
        init_params(self, seed)
        vp = self.network.visual_prompter
        before.update(frozen=frozen_checksums(self), anchor_size=vp.anchor_size.detach().clone(),
                      anchor_feat=vp.anchor_feat.detach().clone())

    def recording_embeds(net, input_ids, *args, **kw):
        out = build_embeds(net, input_ids, *args, **kw)
        scenes.append([int(n) for n in (input_ids == net.cfg.scene_token_id).sum(dim=1)])
        return out

    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL)
    rec = EvalRecorder()
    with mock.patch.object(MSR3D, "init_params", recording_init), \
            mock.patch.object(MSR3DNetwork, "build_embeds", recording_embeds):
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        trainer = rec.run(argv)
        main_s = time.perf_counter() - t0
        launches = {kernel.symbol.replace("_launch", ""): kernel.launches for kernel in kernels}
    model = trainer.model
    vp = model.network.visual_prompter
    print(f"  launches during the run: {launches}; main() {main_s:.1f} s (build, init, one "
          f"step, {len(rec.calls)} eval batches)")
    check(model.cfg.prompter == dataclasses.replace(OSE3DConfig(), situation_type="as_object")
          and vp.prepend_anchor and model.scene_token_len == 61
          and model.cfg.llm.hidden_size == 4096 and model.cfg.llm.num_hidden_layers == 32
          and model.cfg.llm.flash_attention,
          "the YAML built the flagship with the as_object prompter and 61 scene tokens")
    print(f"  scene placeholders a request: {sorted({n for row in scenes for n in row})}")
    check(scenes and all(n == 61 for row in scenes for n in row),
          "61 scene tokens a request (60 objects and the anchor), in training and generation")
    check(rec.steps == 1 and trainer.step == 1, "one optimizer step trained")
    order = [c["task"] for c in rec.calls]
    check(order == [("msqa_scannet", "val"), ("msqa_scannet", "test")]
          and all(len(c["text"]) == N_REQUESTS and c["fps"] == 2 and c["flash"] == 32
                  for c in rec.calls),
          f"val and test of msqa_scannet over one batch of {N_REQUESTS}, K1 2 and K2f 32 "
          "launches in each generate")
    n_eval = len(rec.calls)
    check(launches["fps"] == 2 * (1 + n_eval) and launches["flash_attn_fwd"] == 32 * (1 + n_eval)
          and launches["flash_attn_bwd_dq"] == launches["flash_attn_bwd_dkv"] == 32,
          "over the run: K1 2 and K2f 32 a micro-batch and an eval batch, K2dq and K2dkv 32 "
          "for the one micro-batch")
    opt = trainer.optimizer
    lr = opt.schedule(0)
    size0 = before["anchor_size"]
    decayed = size0 + (opt.weight_decay * size0) * -lr
    print(f"  anchor_size {vp.anchor_size.detach().flatten().tolist()} (before "
          f"{size0.flatten().tolist()}, lr {lr!r}, weight decay {opt.weight_decay})")
    check(torch.equal(vp.anchor_size.detach(), decayed),
          "anchor_size equals what AdamW's decay alone makes of it (no gradient reaches it), "
          "bit for bit in fp32")
    check(not torch.equal(vp.anchor_feat.detach(), before["anchor_feat"]),
          "anchor_feat moved")
    loras = [m for m in model.network.modules() if isinstance(m, LoraDense) and m.scale]
    check(len(loras) == 7 * 32 and all(bool((m.lora_b != 0).any()) for m in loras),
          f"every LoRA B tensor ({len(loras)}) moved from 0")
    check(torch.equal(frozen_checksums(model), before["frozen"]),
          "checksums of the frozen base weights, norms, embeddings and lm_head unchanged")
    saved = exp / "eval" / "msqa_scannet" / "results.json"
    check(saved.exists() and len(json.loads(saved.read_text())) == N_REQUESTS,
          f"results.json written for msqa_scannet, {N_REQUESTS} records")
    step_ms = [1e3 * t for t in trainer.timer.history]
    print(f"  LEO training step {' / '.join(f'{t:.1f}' for t in step_ms)} ms (batch "
          f"{N_REQUESTS}, accumulation 1); seconds per eval batch: {eval_batch_line(rec.calls)}"
          f"; on {card_line()}")
    for c in rec.calls:
        print(f"  {c['task'][0]} {c['task'][1]} output_text[0]: {c['text'][0]!r}")

    # (c) the engines on the same model, LEO requests (60 objects: 61 tokens)
    serving = serve_matched(model)
    del trainer, model, vp
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  phase 13 wall time {wall:.1f} s; LEO greedy generate "
          f"{serving['greedy']['gen_decode_ms']:.2f} ms a token; on {card_line()}")
    return dict(modes=modes, launches=launches, eval_batches=n_eval, step_ms=step_ms,
                serving=serving, wall_s=wall)


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
        model.generate(dict(data), use_beam=False, max_new_tokens=2)  # warm-up
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


# Phase 15: the serving engines, part 2, on the flagship from configs/msr3d.yaml
# over phase 10's cfg_path (bf16, flash attention, random weights), built by
# the serve entry with --engine grouped and the repetition penalty at 1.0 that
# speculative decoding needs: (a) speculative greedy (SPEC_K drafts of
# SPEC_NGRAM-grams), generate and the continuous engine, against plain
# greedy; (b) sampled generate and engine; (c) grouped generate, greedy and
# beam 5, of GROUP_SCENES scenes x GROUP_QUESTIONS questions against G·Q
# separate rows, and the grouped engine over HTTP; (d) compact_transfer. The
# exact token gates run in fp32 at the flagship's width and EXACT_LAYERS
# layers (dense attention): tokens equal, or, where a row parts, the plain
# pick there was a tie within fp32 rounding (top-2 margin below EXACT_MARGIN).
# In bf16 a window of SPEC_K + 1 tokens rounds otherwise than SPEC_K + 1 single
# steps, so the bf16 run reports the share of equal tokens, and a row may part
# only where plain greedy's top-2 margin is below BF16_MARGIN: ten times the
# 5e-2 by which bf16 rounding moves the prefill's logits (phase 4)
SPEC_K, SPEC_NGRAM = 4, 3
GROUP_SCENES, GROUP_QUESTIONS = 2, 4
GROUP_ASKS = ("What is behind the chair?", "Where is the table relative to me?",
              "What color is the chair on my left?", "How many chairs are there in the room?")
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, sample_seed=7)
EXACT_LAYERS, EXACT_MARGIN, BF16_MARGIN = 2, 1e-4, 0.5


def counted(fn):
    """``fn()`` with K1 and K2f counted from 0: (result, launches)."""
    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
    out = fn()
    return out, {"fps": FPS_KERNEL.launches, "flash_attn_fwd": FLASH_FWD_KERNEL.launches}


def recorded_generate(model, data, **kw):
    """Greedy ``generate`` with the (B, V) logits of every pick recorded: the
    prefill's, then each one-token step's. (result, picks)."""
    net = model.network
    prefill, decode = net.prefill, net.decode_step_shared
    picks = []

    def rec_prefill(*args, **kwargs):
        out = prefill(*args, **kwargs)
        picks.append(out[0].float())
        return out

    def rec_decode(*args, **kwargs):
        out = decode(*args, **kwargs)
        if out.shape[1] == 1:
            picks.append(out[:, -1].float())
        return out

    with mock.patch.multiple(net, prefill=rec_prefill, decode_step_shared=rec_decode):
        out = model.generate(dict(data), use_beam=False, **kw)
    return out, picks


def emitted(tokens, eos) -> int:
    """Tokens produced, each row up to and with its first EOS."""
    tokens = np.asarray(tokens)
    first = np.where((tokens == eos).any(1), (tokens == eos).argmax(1) + 1, tokens.shape[1])
    return int(first.sum())


def partings(want, got, picks):
    """For each row where ``got`` parts from greedy ``want``: (row, step,
    top-2 margin of the greedy pick there, from its recorded logits)."""
    out = []
    for r in range(want.shape[0]):
        diff = np.nonzero(np.asarray(want[r]) != np.asarray(got[r]))[0]
        if len(diff):
            s = int(diff[0])
            top2 = picks[s][r].topk(2).values
            out.append((r, s, float(top2[0] - top2[1])))
    return out


def top_k_boundaries(fn):
    """``fn()`` with each top-k decision of a beam search recorded: (result,
    the smallest gap between the k-th and the (k+1)-th live candidate)."""
    from msr3d_tpu_torch import serving
    from msr3d_tpu_torch.models.llm import sampling

    top_k, gaps = sampling._top_k, []

    def recording(x, k):
        values, indices = top_k(x, k)
        if x.shape[-1] > k:
            nxt = torch.sort(x, dim=-1, descending=True, stable=True)[0][..., k]
            live = values[..., -1] > -1e8
            if bool(live.any()):
                gaps.append(float((values[..., -1] - nxt)[live].min()))
        return values, indices

    # the serving engines' per-slot search holds its own reference
    with mock.patch.object(sampling, "_top_k", recording), \
            mock.patch.object(serving, "_top_k", recording):
        out = fn()
    return out, min(gaps, default=float("inf"))


@contextlib.contextmanager
def beam_request_gaps(engine, gaps: dict):
    """Within the block, record each request's smallest top-k gap in the
    beam engine ``engine``: the k-th against the (k+1)-th live candidate,
    over the decisions of the request's own rows (step 0 at its refill, then
    each re-rank while its slot runs). On exit ``gaps`` maps request id to
    gap. The gaps stay on the card until then: no host read a step."""
    from msr3d_tpu_torch import serving

    top_k, refill, rerank = serving._top_k, engine._engine_refill, engine._rerank
    slot_rid, ctx, calls = {}, {}, []

    def recording(x, k):
        values, indices = top_k(x, k)
        if ctx and x.shape[-1] > k:
            nxt = torch.topk(x, k + 1, dim=-1).values[..., k]
            live = (values[..., -1] > -1e8) & ctx["run"]
            calls.append((ctx["rids"], torch.where(live, values[..., -1] - nxt, math.inf)))
        return values, indices

    def refill_recorded(prompt_ctx, state, group, slots):
        rids = [rid for rid, _, _ in group]
        slot_rid.update(zip(slots, rids))
        ctx.update(rids=rids + [None] * (len(slots) - len(rids)),
                   run=torch.arange(len(slots), device=engine.model.device) < len(rids))
        try:
            return refill(prompt_ctx, state, group, slots)
        finally:
            ctx.clear()

    def rerank_recorded(st, logits, run, cnt):
        ctx.update(rids=[slot_rid.get(s) for s in range(run.shape[0])], run=run)
        try:
            return rerank(st, logits, run, cnt)
        finally:
            ctx.clear()

    with mock.patch.object(serving, "_top_k", recording), \
            mock.patch.object(engine, "_engine_refill", refill_recorded), \
            mock.patch.object(engine, "_rerank", rerank_recorded):
        yield
    for rids, gap in calls:
        for rid, g in zip(rids, gap.tolist()):
            if rid is not None:
                gaps[rid] = min(gaps.get(rid, math.inf), g)


def group_data(seed: int, images: bool):
    """GROUP_SCENES scenes of ``make_requests``, each with GROUP_QUESTIONS
    questions after its own scene prompt (nested), and the same questions
    as G·Q independent rows."""
    scenes = make_requests(seed, b=GROUP_SCENES, images=images)
    heads = [p.split("USER:")[0] for p in scenes["msr3d_prompt"]]
    nested = [[f"{h}USER: {q} ASSISTANT:" for q in GROUP_ASKS[:GROUP_QUESTIONS]] for h in heads]
    arrays = {k: v for k, v in scenes.items() if k != "msr3d_prompt"}
    group = dict(arrays, msr3d_prompt=nested)
    rows = dict({k: np.repeat(v, GROUP_QUESTIONS, axis=0) for k, v in arrays.items()},
                msr3d_prompt=[p for qs in nested for p in qs])
    return group, rows


def spec_runs(model):
    """(a) on the bf16 flagship: plain greedy and speculative ``generate`` on
    phase 4's requests, then the continuous engine both ways at generate's
    shapes."""
    from msr3d_tpu_torch.serving import ContinuousBatchingServer, uncollate_batch

    data = make_requests(seed=0, images=True)
    eos = model.tokenizer.eos_id
    model.generate(dict(data), use_beam=False, max_new_tokens=2)  # warm-up
    (plain, picks), plain_ms, plain_pre, plain_steps = timed_decode(
        model, lambda: recorded_generate(model, data, max_new_tokens=ENGINE_TOKENS))
    model.spec_k, model.spec_ngram = SPEC_K, SPEC_NGRAM
    try:
        (spec, spec_ms, spec_pre, spec_calls), launches = counted(lambda: timed_decode(
            model, lambda: model.generate(dict(data), use_beam=False,
                                          max_new_tokens=ENGINE_TOKENS)))
    finally:
        model.spec_k = 0
    want, got = plain["output_tokens"], spec["output_tokens"]
    parted = partings(want, got, picks)
    n_plain, n_spec = emitted(want, eos), emitted(got, eos)
    row = dict(plain_decode_ms=plain_ms - plain_pre, plain_steps=plain_steps,
               plain_emitted=n_plain, spec_decode_ms=spec_ms - spec_pre, verify_calls=spec_calls,
               spec_stats=spec["spec_stats"], launches=launches,
               equal_tokens=int((want == got).sum()), tokens=int(want.size), parted=parted)
    row["plain_ms_per_token"] = row["plain_decode_ms"] / n_plain
    row["spec_ms_per_token"] = row["spec_decode_ms"] / n_spec
    print(f"  (a) bf16 generate, {N_REQUESTS} requests x {ENGINE_TOKENS} tokens: plain greedy "
          f"decode {row['plain_decode_ms']:.2f} ms over {plain_steps} steps, "
          f"{row['plain_ms_per_token']:.3f} ms an emitted token ({n_plain}); speculative "
          f"(spec_k {SPEC_K}, {SPEC_NGRAM}-grams) {row['spec_decode_ms']:.2f} ms over "
          f"{spec_calls} verify calls, {row['spec_ms_per_token']:.3f} ms an emitted token "
          f"({n_spec}); spec_stats {spec['spec_stats']}; launches {launches}; equal tokens "
          f"{row['equal_tokens']} of {row['tokens']}; rows parted at (row, step, top-2 "
          f"margin) {parted}; on {card_line()}")
    check(spec["spec_stats"]["verify_calls"] == spec_calls
          and spec["spec_stats"]["emitted"] == n_spec,
          "spec_stats count the verify calls and the emitted tokens")
    check(all(m < BF16_MARGIN for _, _, m in parted),
          f"bf16: where speculative tokens part from greedy, greedy's top-2 margin is below "
          f"{BF16_MARGIN}")
    check(launches == {"fps": 2, "flash_attn_fwd": 32},
          "K1 2 and K2f 32 launches in the speculative generate (its prefill)")

    samples = uncollate_batch(data)
    prompt_len = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                      side="left")[0].shape[1] + 1
    engines = {}
    for spec_k in (0, SPEC_K):
        engine = ContinuousBatchingServer(model, num_slots=N_REQUESTS, refill_group=N_REQUESTS,
                                          chunk_steps=ENGINE_CHUNK, max_new_tokens=ENGINE_TOKENS,
                                          prompt_len=prompt_len, spec_k=spec_k,
                                          spec_ngram=SPEC_NGRAM)
        res, ms, pre, calls = timed_decode(model, lambda: engine.run(samples))
        toks = np.stack([r.output_tokens for r in res])
        engines[spec_k] = dict(decode_ms=ms - pre, steps_run=engine.steps_run,
                               emitted=emitted(toks, eos), tokens=toks)
        check(calls == engine.steps_run, f"the engine (spec_k {spec_k}) counts its model calls")
    same = int((engines[0]["tokens"] == engines[SPEC_K]["tokens"]).sum())
    parted = partings(want, engines[SPEC_K]["tokens"], picks)
    print(f"  (a) bf16 engine: spec_k 0 decode {engines[0]['decode_ms']:.2f} ms over "
          f"{engines[0]['steps_run']} steps, {engines[0]['decode_ms'] / engines[0]['emitted']:.3f}"
          f" ms an emitted token; spec_k {SPEC_K} {engines[SPEC_K]['decode_ms']:.2f} ms over "
          f"{engines[SPEC_K]['steps_run']} verify calls, "
          f"{engines[SPEC_K]['decode_ms'] / engines[SPEC_K]['emitted']:.3f} ms an emitted "
          f"token; equal tokens {same} of {want.size}; parted from greedy generate at {parted}")
    check(all(m < BF16_MARGIN for _, _, m in parted),
          f"bf16: where the speculative engine parts from greedy, the margin is below "
          f"{BF16_MARGIN}")
    row["engine"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                     for k, v in engines.items()}
    return row


def keys_match_cpu(key_dev, key_cpu, v: int, rows: int) -> dict:
    """The keys, random bits and uniforms of a key on the card against the
    same arithmetic on the CPU; the Gumbel noise's largest difference (the
    platforms' logs)."""
    from msr3d_tpu_torch.models.llm import prng

    same_keys = torch.equal(key_dev.cpu(), key_cpu)
    bits = torch.equal(prng.random_bits(key_dev, (rows, v)).cpu(),
                       prng.random_bits(key_cpu, (rows, v)))
    unif = torch.equal(prng.uniform(key_dev, (rows, v), minval=1e-38).cpu(),
                       prng.uniform(key_cpu, (rows, v), minval=1e-38))
    gumbel = float((prng.gumbel(key_dev, (rows, v)).cpu() - prng.gumbel(key_cpu, (rows, v)))
                   .abs().max())
    return dict(keys=same_keys, bits=bits, uniform=unif, gumbel_max_abs_diff=gumbel)


def sampled_runs(model, greedy_decode_ms: float, greedy_steps: int):
    """(b) sampled generate and engine on the bf16 flagship: each twice at one
    seed (equal tokens), the keys and bits of their draws on the card against
    the CPU's."""
    from msr3d_tpu_torch.models.llm import prng
    from msr3d_tpu_torch.serving import ContinuousBatchingServer, uncollate_batch

    data = make_requests(seed=0, images=True)
    dev, v = model.device, model.cfg.llm.vocab_size
    for key, val in dict(SAMPLING, do_sample=True).items():
        setattr(model, key, val)
    runs = []
    try:
        for _ in range(2):
            model._sample_calls = 0
            (out, ms, pre, steps), launches = counted(lambda: timed_decode(
                model, lambda: model.generate(dict(data), use_beam=False,
                                              max_new_tokens=ENGINE_TOKENS)))
            runs.append((out["output_tokens"], ms - pre, steps, launches))
        check(np.array_equal(runs[0][0], runs[1][0]),
              "sampled generate: equal tokens in two runs at one seed")
        seed = SAMPLING["sample_seed"]
        key_dev, key_cpu = (prng.fold_in(prng.prng_key(seed, d), 0) for d in (dev, "cpu"))
        chain = []
        for _ in range(steps + 1):  # one split a pick, as the loop does
            key_dev, sub_dev = prng.split(key_dev)
            key_cpu, sub_cpu = prng.split(key_cpu)
            chain.append(torch.equal(sub_dev.cpu(), sub_cpu))
        gen_keys = keys_match_cpu(sub_dev, sub_cpu, v, N_REQUESTS)
        check(all(chain) and gen_keys["keys"] and gen_keys["bits"] and gen_keys["uniform"],
              f"sampled generate: its {len(chain)} step keys, a step's (B, V) random bits and "
              "uniforms on the card bit-equal to the CPU's")

        samples = uncollate_batch(data)
        engine_runs = []
        for _ in range(2):
            engine = ContinuousBatchingServer(model, num_slots=N_REQUESTS, refill_group=2,
                                              chunk_steps=ENGINE_CHUNK,
                                              max_new_tokens=ENGINE_TOKENS)
            res, ms, pre, calls = timed_decode(model, lambda: engine.run(samples))
            engine_runs.append((np.stack([r.output_tokens for r in res]), ms - pre, calls))
        check(np.array_equal(engine_runs[0][0], engine_runs[1][0]),
              "sampled engine: equal tokens in two runs at one seed")
        rids = torch.arange(N_REQUESTS)
        row_dev = prng.fold_in(prng.fold_in(prng.prng_key(seed, dev).expand(N_REQUESTS, 2),
                                            rids.to(dev)), 5)
        row_cpu = prng.fold_in(prng.fold_in(prng.prng_key(seed).expand(N_REQUESTS, 2), rids), 5)
        eng_keys = keys_match_cpu(row_dev, row_cpu, v, 1)
        rows_bits = torch.equal(prng.random_bits(row_dev, (v,)).cpu(),
                                prng.random_bits(row_cpu, (v,)))
        check(eng_keys["keys"] and rows_bits,
              "sampled engine: each request's row key (request id, then step 5) and its (V,) "
              "random bits on the card bit-equal to the CPU's")
    finally:
        model.do_sample = False
    eos = model.tokenizer.eos_id
    row = dict(decode_ms=runs[0][1], steps=runs[0][2], launches=runs[0][3],
               greedy_decode_ms=greedy_decode_ms, greedy_steps=greedy_steps,
               emitted=emitted(runs[0][0], eos), generate_keys=gen_keys, engine_keys=eng_keys,
               engine_decode_ms=engine_runs[0][1], engine_steps=engine_runs[0][2],
               engine_emitted=emitted(engine_runs[0][0], eos))
    print(f"  (b) bf16 sampled generate ({SAMPLING}): decode {row['decode_ms']:.2f} ms over "
          f"{row['steps']} steps, {row['decode_ms'] / max(1, row['steps']):.3f} ms a step "
          f"against greedy's {greedy_decode_ms / max(1, greedy_steps):.3f}; launches "
          f"{row['launches']}; gumbel noise card - CPU at most "
          f"{gen_keys['gumbel_max_abs_diff']:.3e}; engine decode {row['engine_decode_ms']:.2f} "
          f"ms over {row['engine_steps']} steps ({row['engine_emitted']} tokens); on "
          f"{card_line()}")
    check(row["launches"] == {"fps": 2, "flash_attn_fwd": 32},
          "K1 2 and K2f 32 launches in the sampled generate")
    return row


def grouped_runs(fe, model):
    """(c) grouped generate on the bf16 flagship, greedy and beam 5, against
    the same G·Q questions as separate rows; then the grouped engine behind
    the HTTP front end."""
    import urllib.request

    from msr3d_tpu_torch.serving import uncollate_batch
    from msr3d_tpu_torch.serving_http import encode_scene_b64

    group, rows = group_data(seed=2, images=True)
    n = GROUP_SCENES * GROUP_QUESTIONS
    out = {}
    for label, use_beam in (("greedy", False), (f"beam {BEAMS}", True)):
        (g_out, g_ms, g_pre, g_steps), g_launch = counted(lambda: timed_decode(
            model, lambda: model.generate_scene_group(dict(group), use_beam=use_beam,
                                                      max_new_tokens=ENGINE_TOKENS)))
        if use_beam:
            (p_out, p_ms, p_pre, p_steps), p_launch = counted(lambda: timed_decode(
                model, lambda: model.generate(dict(rows), use_beam=True,
                                              max_new_tokens=ENGINE_TOKENS)))
            parted = None
        else:
            ((p_out, picks), p_ms, p_pre, p_steps), p_launch = counted(lambda: timed_decode(
                model, lambda: recorded_generate(model, rows, max_new_tokens=ENGINE_TOKENS)))
            parted = partings(p_out["output_tokens"], g_out["output_tokens"], picks)
        same = int((g_out["output_tokens"] == p_out["output_tokens"]).all(axis=1).sum())
        out[label] = dict(grouped_ms=g_ms, grouped_prefix_prefill_ms=g_pre,
                          grouped_steps=g_steps, grouped_launches=g_launch, rows_ms=p_ms,
                          rows_prefill_ms=p_pre, rows_steps=p_steps, rows_launches=p_launch,
                          equal_answers=same, parted=parted)
        print(f"  (c) bf16 {label}, {GROUP_SCENES} scenes x {GROUP_QUESTIONS} questions: grouped "
              f"{g_ms:.2f} ms (prefix prefill {g_pre:.2f} ms of {GROUP_SCENES} scenes, "
              f"{g_steps} decode calls with the window pass; K1 {g_launch['fps']} launches over "
              f"{GROUP_SCENES * 60} clouds, K2f {g_launch['flash_attn_fwd']}) against {n} rows "
              f"{p_ms:.2f} ms (prefill {p_pre:.2f} ms; K1 {p_launch['fps']} over {n * 60} "
              f"clouds, K2f {p_launch['flash_attn_fwd']}); {same} of {n} answers equal the "
              f"rows' (bf16, not gated; greedy rows parted at (row, step, top-2 margin) "
              f"{parted}); on {card_line()}")
        check(g_launch == {"fps": 2, "flash_attn_fwd": 32},
              f"grouped {label}: K1 2 launches (one scene encode of the {GROUP_SCENES} prefixes, "
              "both SA stages) and K2f 32 (the prefix prefill)")

    samples = []
    for g, qs in enumerate(group["msr3d_prompt"]):
        scene = {k: group[k][g] for k in group if k != "msr3d_prompt"}
        samples += [dict(scene, msr3d_prompt=q) for q in qs]
    bodies = [json.dumps({"prompt": s["msr3d_prompt"], "scene_b64": encode_scene_b64(s)}).encode()
              for s in samples]
    url = f"http://127.0.0.1:{fe.port}"
    answers, errors = {}, []

    def post(i):
        try:
            req = urllib.request.Request(f"{url}/v1/generate", data=bodies[i],
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                answers[i] = (resp.status, json.loads(resp.read()))
        except Exception as exc:  # reported and gated below
            errors.append(f"request {i}: {exc!r}")

    def drive():
        threads = [threading.Thread(target=post, args=(i,)) for i in range(n)]
        start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - start

    fe.start()
    elapsed, launches = counted(drive)
    with urllib.request.urlopen(f"{url}/v1/health", timeout=60) as resp:
        health = json.loads(resp.read())
    fe.close(timeout=None)
    check(not errors and sorted(answers) == list(range(n))
          and all(status == 200 for status, _ in answers.values()),
          f"serve --engine grouped: every one of the {n} answers is 200 ({errors[:2]})")
    # the engine serves with the config's num_beams, 5: the grouped beam's answers
    beam = model.generate_scene_group(dict(group), max_new_tokens=ENGINE_TOKENS)["output_tokens"]
    same = sum(int(np.array_equal(answers[i][1]["tokens"], beam[i])) for i in range(n))
    out["http"] = dict(elapsed_s=elapsed, qa_s=n / elapsed, launches=launches,
                       served=health["served"], equal_to_grouped_beam=same)
    print(f"  (c) serve --engine grouped over HTTP: {n} requests from {n} threads in "
          f"{elapsed:.3f} s, {n / elapsed:.3f} QA/s, launches {launches}; {same} of {n} "
          f"answers equal grouped beam {BEAMS} generate's; on {card_line()}")
    check(health["served"] == n and launches["fps"] > 0 and launches["flash_attn_fwd"] > 0,
          "the grouped engine served every request, with K1 and K2f launched")
    return out


def compact_runs(model):
    """(d) compact_transfer on phase 4's requests: the bytes sent, the
    device's unpack against the CPU's, and a greedy generate through it."""
    from msr3d_tpu_torch.models.msr3d import MSR3D

    data = make_requests(seed=0)
    host = model._host_scene_batch(data)
    model.compact_transfer = True
    try:
        packed = model._maybe_pack(host)
        plain_bytes = host["obj_fts"].nbytes
        packed_bytes = packed["obj_fts_xyz_q"].nbytes + packed["obj_fts_rgb_q"].nbytes
        points = host["obj_fts"].size // 6
        dev_ms = statistics.median(wall_ms(lambda: torch.as_tensor(host["obj_fts"]).to(
            model.device)) for _ in range(5))
        packed_ms = statistics.median(wall_ms(lambda: model._to_device(
            {k: packed[k] for k in ("obj_fts_xyz_q", "obj_fts_rgb_q")})) for _ in range(5))
        on_card = MSR3D._unpack_batch(model._to_device(packed))["obj_fts"].cpu()
        on_cpu = MSR3D._unpack_batch({k: torch.as_tensor(v) for k, v in packed.items()})
        same = torch.equal(on_card, on_cpu["obj_fts"])
        out, launches = counted(lambda: model.generate(dict(data), use_beam=False,
                                                       max_new_tokens=8))
    finally:
        model.compact_transfer = False
    row = dict(points=points, bytes_fp32=plain_bytes, bytes_packed=packed_bytes,
               fp32_copy_ms=dev_ms, packed_copy_ms=packed_ms, launches=launches)
    print(f"  (d) compact_transfer: {points} points, {plain_bytes} bytes fp32 "
          f"({plain_bytes / points:.0f} a point) against {packed_bytes} packed "
          f"({packed_bytes / points:.0f} a point); host-to-card copy {dev_ms:.3f} / "
          f"{packed_ms:.3f} ms; unpack on the card bit-equal to the CPU's: {same}; a greedy "
          f"generate through it: launches {launches}; on {card_line()}")
    check(same and packed_bytes * 24 == plain_bytes * 9,
          "compact_transfer: 9 bytes a point against 24, unpacked on the card bit-equal to the "
          "CPU's")
    check(np.isfinite(out["output_tokens"]).all() and launches["fps"] == 2,
          "a generate through compact_transfer runs (K1 2 launches)")
    return row


def build_exact_model(dev, tokenizer, prompter=None):
    """The flagship's width in fp32 at EXACT_LAYERS layers (dense attention,
    LoRA r16, TF32 off), random weights from seed 1, penalty 1.0; the
    prompter ``OSE3DConfig()`` unless given."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig

    llm = LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=EXACT_LAYERS, num_attention_heads=32, lora_rank=16,
                      dtype=torch.float32, param_dtype=torch.float32)
    model = MSR3D(MSR3DNetworkConfig(prompter=prompter or OSE3DConfig(), llm=llm), tokenizer,
                  scene_token_len=60, max_out_len=NEW_TOKENS, num_beams=BEAMS,
                  repetition_penalty=1.0, device=dev)
    model.init_params(seed=1)
    return model


def exact_gates(dev, tokenizer):
    """The fp32 token gates: speculative generate and engine against greedy
    generate, grouped greedy and beam 5 against the questions' own
    ``generate``."""
    from msr3d_tpu_torch.serving import ContinuousBatchingServer, uncollate_batch

    model = build_exact_model(dev, tokenizer)
    data = make_requests(seed=3)
    plain, picks = recorded_generate(model, data, max_new_tokens=NEW_TOKENS)
    want = plain["output_tokens"]
    model.spec_k, model.spec_ngram = SPEC_K, SPEC_NGRAM
    spec = model.generate(dict(data), use_beam=False, max_new_tokens=NEW_TOKENS)
    model.spec_k = 0
    prompt_len = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                      side="left")[0].shape[1] + 1
    engine = ContinuousBatchingServer(model, num_slots=N_REQUESTS, refill_group=N_REQUESTS,
                                      chunk_steps=8, max_new_tokens=NEW_TOKENS,
                                      prompt_len=prompt_len, spec_k=SPEC_K,
                                      spec_ngram=SPEC_NGRAM)
    eng = np.stack([r.output_tokens for r in engine.run(uncollate_batch(data))])
    group, rows = group_data(seed=4, images=False)
    (rows_out, rows_picks) = recorded_generate(model, rows, max_new_tokens=NEW_TOKENS)
    grouped = model.generate_scene_group(dict(group), use_beam=False, max_new_tokens=NEW_TOKENS)
    beam_rows, rows_gap = top_k_boundaries(lambda: model.generate(
        dict(rows), use_beam=True, max_new_tokens=NEW_TOKENS))
    beam_grouped, grouped_gap = top_k_boundaries(lambda: model.generate_scene_group(
        dict(group), use_beam=True, max_new_tokens=NEW_TOKENS))
    out = dict(spec=partings(want, spec["output_tokens"], picks),
               engine=partings(want, eng, picks),
               grouped=partings(rows_out["output_tokens"], grouped["output_tokens"], rows_picks),
               spec_stats=spec["spec_stats"], engine_steps_run=engine.steps_run,
               beam_equal=bool(np.array_equal(beam_rows["output_tokens"],
                                              beam_grouped["output_tokens"])),
               beam_min_gap=min(rows_gap, grouped_gap))
    print(f"  fp32, {EXACT_LAYERS} layers at the flagship width: speculative generate "
          f"{spec['spec_stats']}, engine steps_run {engine.steps_run}; rows parted from greedy "
          f"(row, step, margin): generate {out['spec']}, engine {out['engine']}, grouped "
          f"{out['grouped']}; grouped beam {BEAMS} equal to the rows' beam {BEAMS}: "
          f"{out['beam_equal']} (smallest top-k gap {out['beam_min_gap']:.3e})")
    for what in ("spec", "engine", "grouped"):
        check(all(m < EXACT_MARGIN for _, _, m in out[what]),
              f"fp32 {what}: tokens equal greedy's, or part only at a tie within {EXACT_MARGIN}")
    check(out["beam_equal"] or out["beam_min_gap"] < EXACT_MARGIN,
          f"fp32 grouped beam {BEAMS}: tokens equal the rows' beam search, or a top-k decision "
          f"was a tie within {EXACT_MARGIN}")
    del model
    return out


def phase_serving2(exp_root: Path):
    print("== phase 15: the serving engines, part 2 (speculative, sampled and scene-grouped "
          "decoding, compact_transfer) at the flagship width (configs/msr3d.yaml over phase "
          "10's cfg_path, random weights, repetition penalty 1.0)")
    from msr3d_tpu_torch import serve

    t0 = time.perf_counter()
    fe = serve.create_frontend(serve.parse_args(serve_argv(
        exp_root, "--engine", "grouped", "--group-scenes", str(GROUP_SCENES),
        "--group-questions", str(GROUP_QUESTIONS), "eval_repetition_penalty=1.0",
        tokens=ENGINE_TOKENS)))
    model = fe.engine.model
    torch.cuda.synchronize()
    print(f"  built and initialised in {time.perf_counter() - t0:.1f} s")
    out = dict(a=spec_runs(model))
    out["b"] = sampled_runs(model, out["a"]["plain_decode_ms"], out["a"]["plain_steps"])
    out["c"] = grouped_runs(fe, model)
    out["d"] = compact_runs(model)
    tokenizer = model.tokenizer
    del fe, model
    gc.collect()
    torch.cuda.empty_cache()
    out["exact"] = exact_gates(torch.device("cuda", 0), tokenizer)
    return out


# Phase 16: the prefix-pool engines on the flagship from configs/msr3d.yaml over
# phase 10's cfg_path (bf16, flash attention, random weights, the config's
# penalty 3.0), built by the serve entry with --engine pool and --engine
# pool-beam. The stream is POOL_SCENES scenes x POOL_QUESTIONS questions,
# interleaved (question q of every scene before question q + 1), each scene
# made like phase 4's request s (60 images of 224², 1 + s % 4 shown; the
# bench_qa.py prompt with its own question after USER:), over POOL_BLOCKS
# blocks, so LRU eviction, an evicted scene's return and head-of-line
# blocking all occur: POOL_SLOTS slots, refill group POOL_GROUP, question
# bucket POOL_SUFFIX, the prefix bucket the model's prompt_pad_to, ENGINE_TOKENS
# tokens. (b) runs the first POOL_SPEC_REQUESTS requests at penalty 1.0; (d)
# sends the first POOL_HTTP requests and
# one whose question overflows the bucket over HTTP. The exact gates run in
# fp32 at the flagship's width and EXACT_LAYERS layers, as phase 15's; in
# bf16 a request may part from its own greedy generate only where the
# generate's top-2 margin is below BF16_MARGIN (the pool's batch-1 segment
# sums over G·S_pre keys, a row's prompt over its own), and the beam pool's
# answer from the continuous beam engine's only where either search made a
# top-k decision of that request within BF16_MARGIN
POOL_SCENES, POOL_QUESTIONS, POOL_BLOCKS = 3, 4, 2
POOL_SLOTS, POOL_GROUP, POOL_SUFFIX, POOL_CHUNK = 8, 4, 64, 4
POOL_SPEC_REQUESTS, POOL_HTTP = 6, 8


def pool_stream(seed: int, images: bool, scenes: int = POOL_SCENES,
                questions: int = POOL_QUESTIONS):
    """``scenes`` scenes made like ``make_requests``' rows, each asked
    ``questions`` of GROUP_ASKS after its own scene prompt, interleaved: a
    list of single-sample requests (request i is of scene i % scenes)."""
    data = make_requests(seed, b=scenes, images=images)
    heads = [p.split("USER:")[0] for p in data["msr3d_prompt"]]
    arrays = {k: v for k, v in data.items() if k != "msr3d_prompt"}
    return [dict({k: v[s] for k, v in arrays.items()},
                 msr3d_prompt=f"{heads[s]}USER: {GROUP_ASKS[q]} ASSISTANT:")
            for q in range(questions) for s in range(scenes)]


def pool_kw(**kw):
    return dict(dict(num_slots=POOL_SLOTS, num_prefixes=POOL_BLOCKS, suffix_len=POOL_SUFFIX,
                     refill_group=POOL_GROUP, chunk_steps=POOL_CHUNK,
                     max_new_tokens=ENGINE_TOKENS), **kw)


def engine_run(model, engine, reqs, **kw):
    """``engine.run(reqs)`` with K1/K2f counted, the prefills timed and the
    peak memory: a dict of the numbers and the tokens (request order)."""
    torch.cuda.reset_peak_memory_stats()
    net, calls = model.network, [0]
    prefill = net.prefill

    def counting(*args, **kwargs):
        calls[0] += 1
        return prefill(*args, **kwargs)

    with mock.patch.object(net, "prefill", counting):
        (res, ms, pre, _), launches = counted(lambda: timed_decode(
            model, lambda: engine.run(reqs, **kw)))
    check([r.id for r in res] == list(range(len(reqs))),
          f"{type(engine).__name__}: one result a request, in request order")
    tokens = np.stack([np.asarray(r.output_tokens) for r in res])
    return dict(ms=ms, prefill_ms=pre, decode_ms=(ms - pre) / max(1, engine.steps_run),
                steps_run=engine.steps_run, prefills=calls[0],
                prefix_prefills=getattr(engine, "prefix_prefills", None), launches=launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                tokens=tokens)


def pool_launch_gate(row, what: str) -> None:
    """K1 2 and K2f 32 launches a prefill; a pool engine's prefills are its
    prefix prefills."""
    prefills = row["prefills"]
    check(row.get("prefix_prefills") in (None, prefills),
          f"{what}: every prefill is a prefix prefill ({row.get('prefix_prefills')} of "
          f"{prefills})")
    check(row["launches"] == {"fps": 2 * prefills, "flash_attn_fwd": 32 * prefills},
          f"{what}: K1 2 and K2f 32 launches a prefill ({prefills} prefills), got "
          f"{row['launches']}")


def public(row) -> dict:
    return {k: v for k, v in row.items() if k != "tokens"}


def pool_greedy_runs(model, pool, reqs):
    """(a) The greedy pool engine and the continuous engine on the same
    requests; both held by the bf16 margin rule to one greedy generate of
    the requests as rows."""
    from msr3d_tpu_torch.serving import ContinuousBatchingServer, _collate

    model.generate(_collate(reqs[:1]), use_beam=False, max_new_tokens=2)  # warm-up
    rows, picks = recorded_generate(model, _collate(reqs), max_new_tokens=ENGINE_TOKENS)
    want = rows["output_tokens"]
    out = dict(pool=engine_run(model, pool, reqs))
    cont = ContinuousBatchingServer(model, num_slots=POOL_SLOTS, refill_group=POOL_GROUP,
                                    chunk_steps=POOL_CHUNK, max_new_tokens=ENGINE_TOKENS)
    out["continuous"] = engine_run(model, cont, reqs)
    n = len(reqs)
    for name, row in out.items():
        row["parted"] = partings(want, row["tokens"], picks)
        row["equal_answers"] = int((row["tokens"] == want).all(axis=1).sum())
    p, c = out["pool"], out["continuous"]
    print(f"  (a) bf16 greedy, {POOL_SCENES} scenes x {POOL_QUESTIONS} questions interleaved, "
          f"{POOL_BLOCKS} blocks, {POOL_SLOTS} slots: pool {p['ms']:.2f} ms against "
          f"continuous {c['ms']:.2f} ms, "
          f"{p['prefix_prefills']} prefix prefills against {n} per-request prefills, prefill "
          f"{p['prefill_ms'] / n:.2f} ms a request against {c['prefill_ms'] / n:.2f}; decode "
          f"{p['decode_ms']:.2f} ms a step over steps_run {p['steps_run']} against "
          f"{c['decode_ms']:.2f} over {c['steps_run']}; launches {p['launches']} against "
          f"{c['launches']}; answers equal to generate's rows: pool {p['equal_answers']}, "
          f"continuous {c['equal_answers']} of {n}; parted (request, step, top-2 margin): pool "
          f"{p['parted']}, continuous {c['parted']}; on {card_line()}")
    check(POOL_SCENES <= p["prefix_prefills"] < n,
          f"the pool prefills each of the {POOL_SCENES} scenes, fewer times than {n} requests")
    pool_launch_gate(p, "the pool engine")
    pool_launch_gate(c, "the continuous engine")
    for name, row in out.items():
        check(all(m < BF16_MARGIN for _, _, m in row["parted"]),
              f"bf16 {name}: where a request parts from greedy generate, the margin is below "
              f"{BF16_MARGIN}")
    return {k: public(v) for k, v in out.items()}


def pool_spec_runs(model, pool, reqs):
    """(b) The pool engine with SPEC_K drafts of SPEC_NGRAM-grams against
    the pool at T = 1, at penalty 1.0; both held by the bf16 margin rule to
    greedy generate at penalty 1.0."""
    from msr3d_tpu_torch import serving as serving_mod
    from msr3d_tpu_torch.serving import PrefixPoolContinuousBatchingServer, _collate

    eos = model.tokenizer.eos_id
    saved = model.repetition_penalty
    model.repetition_penalty = 1.0
    accepted = [0]
    spec_accept = serving_mod.spec_accept

    def counting(*args, **kw):
        emit, acc, is_eos = spec_accept(*args, **kw)
        accepted[0] += int(emit[:, 1:].sum())  # drafts emitted (the pick after them is not)
        return emit, acc, is_eos

    try:
        rows, picks = recorded_generate(model, _collate(reqs), max_new_tokens=ENGINE_TOKENS)
        out = dict(t1=engine_run(model, PrefixPoolContinuousBatchingServer(model, **pool_kw()),
                                 reqs))
        spec = PrefixPoolContinuousBatchingServer(model, **pool_kw(spec_k=SPEC_K,
                                                                   spec_ngram=SPEC_NGRAM))
        with mock.patch.object(serving_mod, "spec_accept", counting):
            out["spec"] = engine_run(model, spec, reqs)
    finally:
        model.repetition_penalty = saved
    for row in out.values():
        row["emitted"] = emitted(row["tokens"], eos)
        row["ms_per_token"] = (row["ms"] - row["prefill_ms"]) / row["emitted"]
        row["parted"] = partings(rows["output_tokens"], row["tokens"], picks)
    t1, sp = out["t1"], out["spec"]
    sp["accepted_drafts"] = accepted[0]
    same = int((t1["tokens"] == sp["tokens"]).sum())
    print(f"  (b) bf16 pool, penalty 1.0, {len(reqs)} requests: T = 1 "
          f"{t1['ms_per_token']:.3f} ms an emitted token ({t1['emitted']} over "
          f"{t1['steps_run']} steps); spec_k {SPEC_K} ({SPEC_NGRAM}-grams) "
          f"{sp['ms_per_token']:.3f} ms an emitted token ({sp['emitted']} over "
          f"{sp['steps_run']} verify calls, {sp['accepted_drafts']} accepted drafts); "
          f"prefix prefills {t1['prefix_prefills']} / {sp['prefix_prefills']}; equal tokens "
          f"{same} of {t1['tokens'].size}; parted from generate: T = 1 {t1['parted']}, spec "
          f"{sp['parted']}; on {card_line()}")
    for name, row in out.items():
        pool_launch_gate(row, f"the {name} pool")
        check(all(m < BF16_MARGIN for _, _, m in row["parted"]),
              f"bf16 {name} pool: where a request parts from greedy generate, the margin is "
              f"below {BF16_MARGIN}")
    return {k: public(v) for k, v in out.items()}


def pool_beam_runs(model, pool_beam, reqs):
    """(c) The beam pool engine against the continuous beam engine on the
    same requests (beam 5, penalty 3.0)."""
    from msr3d_tpu_torch.serving import ContinuousBeamBatchingServer

    beam_kw = dict(num_slots=POOL_SLOTS, refill_group=POOL_GROUP, chunk_steps=POOL_CHUNK)
    cont = ContinuousBeamBatchingServer(model, max_new_tokens=ENGINE_TOKENS, **beam_kw)
    out, gaps = {}, dict(pool={}, continuous={})
    for name, engine in (("pool", pool_beam), ("continuous", cont)):
        with beam_request_gaps(engine, gaps[name]):
            out[name] = engine_run(model, engine, reqs)
    p, c = out["pool"], out["continuous"]
    same = int((p["tokens"] == c["tokens"]).all(axis=1).sum())
    # a request may part only where one engine's search made a top-k
    # decision within BF16_MARGIN
    parted = [(i, min(gaps["pool"].get(i, math.inf), gaps["continuous"].get(i, math.inf)))
              for i in range(len(reqs)) if not np.array_equal(p["tokens"][i], c["tokens"][i])]
    p["parted_gaps"] = parted
    print(f"  (c) bf16 beam {model.num_beams}, {len(reqs)} requests: pool {p['ms']:.2f} ms, "
          f"{p['prefix_prefills']} prefix prefills, decode {p['decode_ms']:.2f} ms a step over "
          f"{p['steps_run']}, peak {p['peak_gib']:.2f} GiB; continuous {c['ms']:.2f} ms, "
          f"decode {c['decode_ms']:.2f} ms a step over {c['steps_run']}, peak "
          f"{c['peak_gib']:.2f} GiB; {same} of {len(reqs)} answers equal; parted at (request, "
          f"smallest top-k gap of either search) {[(i, round(g, 5)) for i, g in parted]}; on "
          f"{card_line()}")
    pool_launch_gate(p, "the beam pool engine")
    pool_launch_gate(c, "the continuous beam engine")
    check(len(gaps["pool"]) == len(gaps["continuous"]) == len(reqs),
          "every request's top-k decisions are recorded in both beam engines")
    check(all(g < BF16_MARGIN for _, g in parted),
          f"bf16 beam: where the pool and continuous beam answers part, a top-k decision of the "
          f"request was within {BF16_MARGIN}")
    return {k: public(v) for k, v in out.items()}


def pool_http(fe, reqs):
    """(d) The pool front end: POOL_HTTP requests from as many threads and
    one whose question overflows the suffix bucket, all at once."""
    import urllib.error
    import urllib.request

    from msr3d_tpu_torch.serving_http import encode_scene_b64

    bad = dict(reqs[0], msr3d_prompt=reqs[0]["msr3d_prompt"] + " pad" * (2 * POOL_SUFFIX))
    samples = list(reqs[:POOL_HTTP]) + [bad]
    bodies = [json.dumps({"prompt": s["msr3d_prompt"], "scene_b64": encode_scene_b64(s)}).encode()
              for s in samples]
    url = f"http://127.0.0.1:{fe.port}"
    answers, errors = {}, []

    def post(i):
        req = urllib.request.Request(f"{url}/v1/generate", data=bodies[i],
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                answers[i] = (resp.status, json.loads(resp.read()))
        except urllib.error.HTTPError as err:
            answers[i] = (err.code, json.loads(err.read()))
        except Exception as exc:  # reported and gated below
            errors.append(f"request {i}: {exc!r}")

    def drive():
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(samples))]
        start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - start

    fe.start()
    elapsed, launches = counted(drive)
    with urllib.request.urlopen(f"{url}/v1/health", timeout=60) as resp:
        health = json.loads(resp.read())
    fe.close(timeout=None)
    engine = fe.engine
    row = dict(elapsed_s=elapsed, qa_s=POOL_HTTP / elapsed, launches=launches,
               served=health["served"], prefix_prefills=engine.prefix_prefills,
               steps_run=engine.steps_run, bad_status=answers.get(POOL_HTTP, (None,))[0])
    print(f"  (d) serve --engine pool over HTTP: {POOL_HTTP} requests and one overflowing the "
          f"{POOL_SUFFIX}-token suffix bucket from {len(samples)} threads in {elapsed:.3f} s, "
          f"{row['qa_s']:.3f} QA/s; the overflow answered {row['bad_status']} "
          f"({answers.get(POOL_HTTP, (None, {}))[1].get('error')}); served {health['served']}, "
          f"prefix prefills {engine.prefix_prefills}, steps_run {engine.steps_run}, launches "
          f"{launches}; on {card_line()}")
    check(not errors and all(answers[i][0] == 200 for i in range(POOL_HTTP)),
          f"serve --engine pool: the {POOL_HTTP} requests are answered 200 ({errors[:2]})")
    check(row["bad_status"] == 400 and "suffix" in answers[POOL_HTTP][1]["error"],
          "the request whose question overflows the suffix bucket is a 400 on its own")
    check(health["served"] == POOL_HTTP, f"health counts {POOL_HTTP} served")
    check(launches == {"fps": 2 * engine.prefix_prefills,
                       "flash_attn_fwd": 32 * engine.prefix_prefills},
          f"the pool front end: K1 2 and K2f 32 launches a prefix prefill, got {launches}")
    return row


def pool_exact_gates(dev, tokenizer):
    """The fp32 gates at the flagship's width and EXACT_LAYERS layers, on
    POOL_SCENES scenes x 2 questions without images over POOL_BLOCKS blocks
    and 4 slots: the pool's tokens against each request's own batch-1
    generate (penalty 3.0), the beam pool's against a batch-1 beam generate,
    the speculative pool's and the T = 1 pool's at penalty 1.0 against
    batch-1 generate (each equal, or parting only at a tie within
    EXACT_MARGIN)."""
    from msr3d_tpu_torch.serving import (
        PrefixPoolContinuousBatchingServer,
        PrefixPoolContinuousBeamBatchingServer,
        _collate,
    )

    model = build_exact_model(dev, tokenizer)
    reqs = pool_stream(seed=5, images=False, questions=2)
    kw = pool_kw(num_slots=4, refill_group=2)
    out = {}

    def against_rows(tokens):
        parted = []
        for i, req in enumerate(reqs):
            one, picks = recorded_generate(model, _collate([req]), max_new_tokens=ENGINE_TOKENS)
            parted += [(i, s, m) for _, s, m in partings(one["output_tokens"],
                                                         tokens[i:i + 1], picks)]
        return parted

    model.repetition_penalty = REP_PENALTY
    pool = PrefixPoolContinuousBatchingServer(model, **kw)
    toks = np.stack([r.output_tokens for r in pool.run(reqs)])
    out["pool"] = dict(parted=against_rows(toks), prefix_prefills=pool.prefix_prefills)
    beam = PrefixPoolContinuousBeamBatchingServer(model, **kw)
    beam_toks, gap = top_k_boundaries(lambda: np.stack([r.output_tokens for r in beam.run(reqs)]))
    rows_beam, rows_gap = top_k_boundaries(lambda: np.stack([model.generate(
        _collate([req]), use_beam=True, max_new_tokens=ENGINE_TOKENS)["output_tokens"][0]
        for req in reqs]))
    out["beam"] = dict(equal=bool(np.array_equal(beam_toks, rows_beam)),
                       min_gap=min(gap, rows_gap), prefix_prefills=beam.prefix_prefills)
    model.repetition_penalty = 1.0
    t1 = PrefixPoolContinuousBatchingServer(model, **kw)
    t1_toks = np.stack([r.output_tokens for r in t1.run(reqs)])
    spec = PrefixPoolContinuousBatchingServer(model, **kw, spec_k=SPEC_K, spec_ngram=SPEC_NGRAM)
    spec_toks = np.stack([r.output_tokens for r in spec.run(reqs)])
    out["t1"] = dict(parted=against_rows(t1_toks), steps_run=t1.steps_run)
    out["spec"] = dict(parted=against_rows(spec_toks), steps_run=spec.steps_run,
                       equal_to_t1=bool(np.array_equal(spec_toks, t1_toks)))
    print(f"  fp32, {EXACT_LAYERS} layers at the flagship width, {len(reqs)} requests over "
          f"{POOL_BLOCKS} blocks: pool parted from batch-1 generate at (request, step, margin) "
          f"{out['pool']['parted']} ({pool.prefix_prefills} prefix prefills); beam pool equal "
          f"to batch-1 beam {BEAMS}: {out['beam']['equal']} (smallest top-k gap "
          f"{out['beam']['min_gap']:.3e}); penalty 1.0: T = 1 pool parted at "
          f"{out['t1']['parted']}, spec pool at {out['spec']['parted']}, spec equal to T = 1: "
          f"{out['spec']['equal_to_t1']} (verify calls {spec.steps_run} against steps "
          f"{t1.steps_run})")
    for what in ("pool", "t1", "spec"):
        check(all(m < EXACT_MARGIN for _, _, m in out[what]["parted"]),
              f"fp32 {what} pool: tokens equal batch-1 generate's, or part only at a tie within "
              f"{EXACT_MARGIN}")
    check(out["beam"]["equal"] or out["beam"]["min_gap"] < EXACT_MARGIN,
          f"fp32 beam pool: tokens equal batch-1 beam {BEAMS} generate's, or a top-k decision "
          f"was a tie within {EXACT_MARGIN}")
    del model
    return out


def phase_pool(exp_root: Path):
    print("== phase 16: the prefix-pool engines (greedy, speculative and beam over a shared "
          "scene-prefix KV pool) at the flagship width (configs/msr3d.yaml over phase 10's "
          "cfg_path, random weights)")
    from msr3d_tpu_torch import serve
    from msr3d_tpu_torch.models import build as build_mod

    t0 = time.perf_counter()
    pool_args = ["--slots", str(POOL_SLOTS), "--refill-group", str(POOL_GROUP),
                 "--chunk-steps", str(POOL_CHUNK), "--num-prefixes", str(POOL_BLOCKS),
                 "--suffix-len", str(POOL_SUFFIX)]
    fe = serve.create_frontend(serve.parse_args(serve_argv(exp_root, "--engine", "pool",
                                                           *pool_args, tokens=ENGINE_TOKENS)))
    model = fe.engine.model
    # the pool-beam entry on the same model: its init redraws the same seeded weights
    with mock.patch.object(build_mod, "build_model", lambda cfg, device=None: model):
        fe_beam = serve.create_frontend(serve.parse_args(serve_argv(
            exp_root, "--engine", "pool-beam", *pool_args, tokens=ENGINE_TOKENS)))
    fe_beam.httpd.server_close()  # built for its engine; never started
    torch.cuda.synchronize()
    print(f"  built and initialised in {time.perf_counter() - t0:.1f} s; prefix bucket "
          f"{fe.engine.prefix_len}, beams {fe_beam.engine.num_beams}, penalty "
          f"{model.repetition_penalty}")
    check(model.repetition_penalty == REP_PENALTY and fe_beam.engine.num_beams == BEAMS,
          f"the config's eval decode: penalty {REP_PENALTY}, beam {BEAMS}")
    reqs = pool_stream(seed=6, images=True)
    out = dict(a=pool_greedy_runs(model, fe.engine, reqs))
    out["b"] = pool_spec_runs(model, fe.engine, reqs[:POOL_SPEC_REQUESTS])
    out["c"] = pool_beam_runs(model, fe_beam.engine, reqs)
    out["d"] = pool_http(fe, reqs)
    tokenizer = model.tokenizer
    del fe, fe_beam, model
    gc.collect()
    torch.cuda.empty_cache()
    out["exact"] = pool_exact_gates(torch.device("cuda", 0), tokenizer)
    return out


# Phase 17: the training-memory options and the trainer's last knobs. One
# optimizer step of (a) and (c) is one group of OPTIONS_ACCUM micro-batches of
# N_REQUESTS requests with images (phase 6's; a step's peak is one
# micro-batch's, so 2 of TRAIN_ACCUM's 5 show it, for the script's time);
# every policy's step starts from the same LoRA state
OPTIONS_ACCUM = 2
REMAT_POLICIES = (None, "full", "dots", "residuals")
QLORA_BITS = (8, 4)
LAG_STEPS_ACCUM = 2  # (f): 2 steps of 2 micro-batches a run
NAN_GUARD_ITERS = 3
# (a), (f): steps from one state and one group, remat or not, lag or not. The
# forward is the same ops on the same inputs, and the recompute reruns them,
# so bit-equal is expected; the gates allow fp32 rounding of the loss (1e-6)
# and of the grad norm (1e-4), in case a library op sums in another order
# from one call to the next, and the log says whether the bits were equal
STEP_LOSS_RTOL, STEP_NORM_RTOL = 1e-6, 1e-4
# (d) the unfrozen point encoder in fp32 on the card against the CPU: the
# same arithmetic in other summation orders; the batch variance E[x²] - E[x]²
# cancels, so each stage grows the rounding by E[x²] / Var (the CPU tests
# hold the port to flax within 1e-4 on tiny clouds). A wrong axis, a biased
# or unbiased slip, or a missed update moves values by O(1e-1) or more
BN_EMBED_ATOL, BN_STATS_ATOL = 1e-3, 1e-4


def kernel_launches(kernels) -> dict:
    return {kernel.symbol.replace("_launch", ""): kernel.launches for kernel in kernels}


def lora_state(net):
    return {n: p.detach().clone() for n, p in net.named_parameters() if p.requires_grad}


@torch.no_grad()
def load_state(net, state) -> None:
    params = dict(net.named_parameters())
    for n, t in state.items():
        params[n].copy_(t)


def one_step(trainer, group, kernels):
    """One optimizer step over ``group`` from a fresh optimizer and dropout
    generator: (loss, grad norm, ms, peak GiB, kept GiB, launches). The peak
    holds the frozen image encode's transient; ``kept_gb`` is what the
    autograd graph holds at the end of a micro-batch's forward (the most
    over the group), the activations the policy keeps for the backward."""
    net, step = trainer.model.network, trainer._train_step
    trainer.optimizer.state, trainer.optimizer.count = {}, 0
    trainer.generator.manual_seed(0)
    for kernel in kernels:
        kernel.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    held = []
    loss_fn = step.loss_fn

    def measured(mb):
        loss = loss_fn(mb)
        held.append(torch.cuda.memory_allocated())  # host-side allocator count: no sync
        return loss

    t0 = time.perf_counter()
    net.train()
    step.loss_fn = measured
    try:
        metrics = step(group)
    finally:
        step.loss_fn = loss_fn
        net.eval()
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(loss=loss, grad_norm=norm, ms=ms, peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                kept_gb=(max(held) - before) / 2**30, launches=kernel_launches(kernels))


def remat_steps(model, trainer, group, kernels, label: str = "(a)"):
    """(a): one step with each remat policy and without, from one state."""
    net, llm = model.network, model.cfg.llm
    saved = lora_state(net)
    layers, n_micro = llm.num_hidden_layers, len(group)
    rows = {}
    try:
        for policy in REMAT_POLICIES:
            load_state(net, saved)
            net.llm.cfg = dataclasses.replace(llm, remat=policy is not None,
                                              remat_policy=policy or "full")
            row = rows[policy or "none"] = one_step(trainer, group, kernels)
            print(f"  {label} remat {policy or 'off'}: loss {row['loss']!r}, grad norm "
                  f"{row['grad_norm']!r}, step {row['ms']:.1f} ms, peak {row['peak_gb']:.2f} GiB, "
                  f"kept after a forward {row['kept_gb']:.3f} GiB, launches {row['launches']}")
    finally:
        net.llm.cfg = llm
        load_state(net, saved)
    base = rows["none"]
    for policy in REMAT_POLICIES[1:]:
        row = rows[policy]
        check(row["launches"] == {"fps": 2 * n_micro, "flash_attn_fwd": 2 * layers * n_micro,
                                  "flash_attn_bwd_dq": layers * n_micro,
                                  "flash_attn_bwd_dkv": layers * n_micro},
              f"remat {policy}: K1 {2 * n_micro}, K2f {2 * layers * n_micro} (the forward and its "
              f"recompute), K2dq and K2dkv {layers * n_micro} launches a step")
        same = row["loss"] == base["loss"] and row["grad_norm"] == base["grad_norm"]
        check(abs(row["loss"] - base["loss"]) <= STEP_LOSS_RTOL * abs(base["loss"])
              and abs(row["grad_norm"] - base["grad_norm"]) <= STEP_NORM_RTOL * base["grad_norm"],
              f"remat {policy}: loss and grad norm those of the step without remat "
              f"({'bit-equal' if same else 'not bit-equal'})")
    check(base["launches"]["flash_attn_fwd"] == layers * n_micro,
          f"without remat K2f launches {layers} times a micro-batch")
    check(rows["full"]["peak_gb"] < base["peak_gb"],
          f"remat full peaks below the step without remat ({rows['full']['peak_gb']:.2f} < "
          f"{base['peak_gb']:.2f} GiB)")
    check(rows["full"]["kept_gb"] < rows["residuals"]["kept_gb"] < base["kept_gb"],
          "a micro-batch's forward keeps least under full, then residuals, most without remat")
    return rows


def lag_runs(model, exp_root: Path, loader):
    """(f): train_metrics_lag 0 against 1 over the same steps, in turns."""
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    net = model.network
    saved = lora_state(net)
    out = {0: [], 1: []}
    first = None
    try:
        for i, lag in enumerate((0, 1, 1, 0)):
            load_state(net, saved)
            cfg = dict(trainer_cfg(exp_root / f"lag{i}", accum=LAG_STEPS_ACCUM, lr=3e-5,
                                   warmup=400), train_metrics_lag=lag)
            trainer = LeoTrainer(cfg, loaders={"t": {"train": loader}}, model=model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_one_epoch(0)
            torch.cuda.synchronize()
            steps = trainer.step
            out[lag].append((time.perf_counter() - t0) * 1e3 / steps)
            with open(exp_root / f"lag{i}" / "metrics.jsonl") as fh:
                losses = [json.loads(line)["train/loss"] for line in fh]
            first = losses if first is None else first
            check(steps == 2 and np.allclose(losses, first, rtol=STEP_LOSS_RTOL, atol=0),
                  f"run {i} at lag {lag}: {steps} steps, the losses of the first run "
                  f"({'bit-equal' if losses == first else 'not bit-equal'})")
    finally:
        load_state(net, saved)
    print(f"  (f) train_metrics_lag 0 / 1: {' / '.join(f'{t:.1f}' for t in out[0])} against "
          f"{' / '.join(f'{t:.1f}' for t in out[1])} ms a step (wall, {LAG_STEPS_ACCUM} "
          f"micro-batches a step, runs in the order 0, 1, 1, 0)")
    return {"lag0_ms": out[0], "lag1_ms": out[1]}


def nan_guard_runs(model, batch):
    """(e): one micro-batch's forward with the NaN guard off and on, and a
    NaN injected into the object locations with the guard on."""
    import msr3d_tpu_torch.utils.debug as debug

    net = model.network
    times = {False: [], True: []}
    saved = debug._ENABLED
    try:
        with torch.no_grad():
            for on in (False, True) * NAN_GUARD_ITERS:
                debug._ENABLED = on
                times[on].append(wall_ms(lambda: net(**batch)["loss"]))
            bad = dict(batch, obj_locs=batch["obj_locs"].clone())
            bad["obj_locs"][0, 0, 0] = float("nan")
            debug._ENABLED = False
            unguarded = net(**bad)["loss"]
            debug._ENABLED = True
            try:
                net(**bad)
                raised = None
            except FloatingPointError as exc:
                raised = str(exc)
    finally:
        debug._ENABLED = saved
    print(f"  (e) one micro-batch's forward, NaN guard off / on: "
          f"{' / '.join(f'{t:.1f}' for t in times[False])} against "
          f"{' / '.join(f'{t:.1f}' for t in times[True])} ms; a NaN in obj_locs with the guard "
          f"on: {raised!r}")
    check(raised is not None and raised.startswith("spatial fused_attn: ")
          and not bool(torch.isfinite(unguarded).all()),
          "an injected NaN raises FloatingPointError with the guard on and flows through with it "
          "off")
    return {"off_ms": times[False], "on_ms": times[True]}


def quantized_buffers(net):
    return {n: b for n, b in net.named_buffers() if n.endswith((".weight_q", ".weight_scale"))}


def qlora_steps(model, trainer, group, kernels, bits: int):
    """(c): one step over the quantized base without remat and with full
    remat; then one micro-batch's forward and backward through
    ``_QuantizedBase`` and through autograd over the plain rebuild, whose
    kept bf16 weights are the memory trap."""
    import msr3d_tpu_torch.models.llm.llama as llama_mod
    import msr3d_tpu_torch.ops.w4_matmul as w4
    import msr3d_tpu_torch.ops.w8_matmul as w8

    net, llm = model.network, model.cfg.llm
    buffers = quantized_buffers(net)
    host = {n: b.cpu() for n, b in buffers.items()}
    saved = lora_state(net)
    quant_kernels = (w8.W8_MATMUL_KERNEL, w4.W4_MATMUL_KERNEL)
    rows = {}
    try:
        for policy in (None, "full"):
            load_state(net, saved)
            net.llm.cfg = dataclasses.replace(llm, remat=policy is not None)
            for kernel in quant_kernels:
                kernel.launches = 0
            row = rows[policy or "none"] = one_step(trainer, group, kernels)
            row["quant_launches"] = sum(kernel.launches for kernel in quant_kernels)
            moved = sum(not torch.equal(p, saved[n]) for n, p in net.named_parameters()
                        if "lora_b" in n)
            print(f"  (c) int{bits}, remat {policy or 'off'}: loss {row['loss']!r}, grad norm "
                  f"{row['grad_norm']!r}, step {row['ms']:.1f} ms, peak {row['peak_gb']:.2f} GiB, "
                  f"kept after a forward {row['kept_gb']:.3f} GiB, launches {row['launches']}, K3/K4 {row['quant_launches']}, LoRA B moved "
                  f"{moved}")
            check(np.isfinite(row["loss"]) and moved == 7 * llm.num_hidden_layers
                  and row["quant_launches"] == 0,
                  f"int{bits}, remat {policy or 'off'}: loss finite, every LoRA B moved, K3/K4 not "
                  "launched (the base product is the JAX-order rebuild)")
        net.llm.cfg = llm
        load_state(net, saved)
        peaks = {}
        batch = group[0]
        for label, apply in (("function", None), ("plain", lambda x, mod: mod._dequant_product(x))):
            patch = (mock.patch.object(llama_mod._QuantizedBase, "apply", apply) if apply
                     else contextlib.nullcontext())
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with patch:
                net(**batch)["loss"].mean().backward()
            peaks[label] = torch.cuda.max_memory_allocated() / 2**30
            for p in net.parameters():
                p.grad = None
        print(f"  (c) int{bits}: one micro-batch's forward and backward peaks at "
              f"{peaks['function']:.2f} GiB through _QuantizedBase and at {peaks['plain']:.2f} "
              f"GiB through autograd over the plain rebuild (+{peaks['plain'] - peaks['function']:.2f}"
              " GiB of kept bf16 weights)")
        check(peaks["plain"] - peaks["function"] > 8.0,
              "the rebuilt bf16 weights (some 12 GiB over the 224 projections) are kept by "
              "autograd over the plain rebuild and not by _QuantizedBase")
    finally:
        net.llm.cfg = llm
        load_state(net, saved)
    check(all(torch.equal(b.cpu(), host[n]) for n, b in buffers.items()),
          f"int{bits}: weight_q and weight_scale bit-unchanged ({len(buffers)} buffers)")
    rows["peaks"] = peaks
    return rows


def batchnorm_runs(dev):
    """(d): the unfrozen point encoder in train() on the card against its CPU
    plain route, fp32, at the flagship's encoder widths."""
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.nn.pointnet import PcdObjEncoder
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    cfg = OSE3DConfig()
    g = torch.Generator().manual_seed(17)
    cpu = PcdObjEncoder(cfg.sa_n_points, cfg.sa_n_samples, cfg.sa_radii, cfg.sa_mlps,
                        compute_dtype=torch.float32, freeze=False)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1]))
            elif ".bn." in name:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g) if name.endswith("weight")
                        else 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.zero_()
    card = copy.deepcopy(cpu).to(dev)
    pcds = torch.from_numpy(make_requests(seed=21)["obj_fts"])
    FPS_KERNEL.launches = 0
    card.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = card(pcds.to(dev))
    weights = torch.randn(out.shape, generator=g)
    (out * weights.to(dev)).sum().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = FPS_KERNEL.launches
    with torch.no_grad():
        want = cpu.train()(pcds)
    err = (out.detach().cpu() - want).abs().max().item()
    stats_err = max((b.cpu() - w).abs().max().item()
                    for b, w in zip(card.buffers(), cpu.buffers()))
    moved = sum(not torch.equal(b, torch.zeros_like(b)) and not torch.equal(b, torch.ones_like(b))
                for b in cpu.buffers())
    finite = all(bool(torch.isfinite(p.grad).all()) for p in card.parameters()
                 if p.grad is not None)
    n_grads = sum(p.grad is not None for p in card.parameters())
    print(f"  (d) PcdObjEncoder(freeze=False).train() on {tuple(pcds.shape)}: forward and "
          f"backward {ms:.1f} ms, K1 {launches}; max |card - cpu| embeddings {err:.3e}, running "
          f"statistics {stats_err:.3e} ({moved} buffers moved); {n_grads} gradients")
    check(launches == 2, "K1 launched twice (SA stages 1 and 2)")
    check(err <= BN_EMBED_ATOL and stats_err <= BN_STATS_ATOL and moved == len(list(cpu.buffers())),
          f"embeddings within {BN_EMBED_ATOL} and new running statistics within {BN_STATS_ATOL} of "
          "the CPU's, every statistic updated")
    check(finite and n_grads > 0, "the encoder's gradients are finite")
    return dict(ms=ms, err=err, stats_err=stats_err, launches=launches)


def remat_entry(exp_root: Path, kernels):
    """(b): the entry on configs/msr3d.yaml with remat dots, one step; then
    generate on its model with and without remat."""
    from msr3d_tpu_torch import run as entry
    from msr3d_tpu_torch.data import synthetic
    from msr3d_tpu_torch.data.scan_loader import ScanCache

    root = exp_root / "remat"
    data = root / "data"
    rng = np.random.default_rng(12)
    synthetic.build_scannet_tree(data, rng, n_objects=ENTRY_OBJECTS)
    synthetic.build_rscan_tree(data, rng, n_objects=ENTRY_OBJECTS)
    synthetic.build_arkit_tree(data, rng, n_objects=ENTRY_OBJECTS)
    synthetic.build_msqa_annotations(data, ["scene0000_00", "scene0001_00"],
                                     n=N_REQUESTS * TRAIN_ACCUM, domain="scannet")
    ckpt = root / "vicuna7b"
    if not (ckpt / "config.json").exists():
        write_entry_checkpoint(ckpt)
    argv = ["--config", str(_ROOT / "configs" / "msr3d.yaml"),
            f"data.scan_family_base={data}/scan_family", f"data.rscan_base={data}/rscan",
            f"data.ARkit_base={data}/arkit", f"data.msr3d_base={data}/msr3d",
            f"model.llm.cfg_path={ckpt}", "model.llm.flash_attention=true",
            "model.llm.remat=true", "model.llm.remat_policy=dots", "debug.flag=true",
            f"debug.debug_size={N_REQUESTS * TRAIN_ACCUM}", "data.msr3dmix.args.mix=[msqa_scannet]",
            "task.msqa_scannet.mode=[]", "task.msqa_3rscan.mode=[]",
            "task.msqa_arkitscenes.mode=[]", "solver.epochs=1", f"exp_dir={root / 'exp'}"]
    print(f"  (b) python -m msr3d_tpu_torch.run ... {' '.join(argv[12:16])} ...")
    ScanCache.clear()
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = entry.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = kernel_launches(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    model = trainer.model
    llm = model.cfg.llm
    with open(trainer.exp_dir / "metrics.jsonl") as fh:
        metrics = [json.loads(line) for line in fh]
    print(f"  (b) main() {main_s:.1f} s, {trainer.step} step(s), loss "
          f"{[m['train/loss'] for m in metrics]}, step "
          f"{[round(1e3 * m['train/step_time_s'], 1) for m in metrics]} ms, peak "
          f"{peak_gb:.2f} GiB, launches {launches}")
    layers, n_micro = llm.num_hidden_layers, TRAIN_ACCUM
    check(llm.remat and llm.remat_policy == "dots" and trainer.step == 1
          and np.isfinite(metrics[0]["train/loss"]),
          "the YAML's model.llm.remat=true remat_policy=dots trained one step, loss finite")
    check(launches == {"fps": 2 * n_micro, "flash_attn_fwd": 2 * layers * n_micro,
                       "flash_attn_bwd_dq": layers * n_micro, "flash_attn_bwd_dkv": layers * n_micro},
          f"the entry's step: K1 {2 * n_micro}, K2f {2 * layers * n_micro}, K2dq and K2dkv "
          f"{layers * n_micro} launches")
    data_req = make_requests(seed=4)
    tokens = {}
    for remat in (True, False):
        model.network.llm.cfg = dataclasses.replace(llm, remat=remat)
        for kernel in kernels:
            kernel.launches = 0
        tokens[remat] = model.generate(dict(data_req), use_beam=False,
                                       max_new_tokens=8)["output_tokens"]
        check(kernel_launches(kernels)["flash_attn_fwd"] == layers,
              f"generate with remat {remat}: K2f {layers} launches (the prefill, no recompute)")
    model.network.llm.cfg = llm
    check(np.array_equal(tokens[True], tokens[False]),
          "generate on the remat model gives the tokens of its remat-free twin")
    ScanCache.clear()
    return dict(launches=launches, main_s=main_s, peak_gb=peak_gb,
                step_ms=[1e3 * m["train/step_time_s"] for m in metrics])


def build_quantized_model(dev, bits: int):
    """The flagship of phases 4 and 6 with its base quantized (int4: by
    init on the card, each projection quantized as it is drawn)."""
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig

    llm = LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, lora_rank=16, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, flash_attention=True, quantize=True, quantize_bits=bits)
    cfg = MSR3DNetworkConfig(prompter=OSE3DConfig(), llm=llm, answer_window_loss=True)
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=60, max_out_len=NEW_TOKENS,
                  repetition_penalty=REP_PENALTY, device=dev)
    model.init_params(seed=0)
    return model


def phase_train_options(exp_root: Path, dev=None):
    print("== phase 17: the training-memory options at the flagship width ((a) remat off / "
          f"full / dots / residuals, one step of {N_REQUESTS} x {OPTIONS_ACCUM} each from one "
          "LoRA state; (b) the entry "
          "on configs/msr3d.yaml with model.llm.remat=true remat_policy=dots, one step, then "
          "generate; (c) QLoRA over int8 and int4 bases; (d) the unfrozen point encoder's "
          "training BatchNorm; (e) the NaN guard; (f) train_metrics_lag 0 against 1), on "
          f"{card_line()}")
    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    dev = dev or torch.device("cuda", 0)
    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL)
    out = {"b": remat_entry(exp_root, kernels)}
    gc.collect()
    torch.cuda.empty_cache()

    model = build_flagship_model(dev, what="the flagship model of phase 17")
    net = model.network
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():  # a LoRA state with every adapter in play
        for name, p in net.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(1e-3 * torch.randn(p.shape, generator=g, device=dev))
    loader = make_train_batches(max(OPTIONS_ACCUM, 2 * LAG_STEPS_ACCUM))
    trainer = LeoTrainer(trainer_cfg(exp_root / "phase17", accum=OPTIONS_ACCUM, lr=3e-5,
                                     warmup=400),
                         loaders={"t": {"train": loader}}, model=model)
    group = trainer._device_batch(loader[:OPTIONS_ACCUM])
    out["a"] = remat_steps(model, trainer, group, kernels)
    # the same without images: no image encode, so the step's peak is the LLM's
    out["a_text"] = remat_steps(model, trainer,
                                trainer._device_batch(make_train_batches(OPTIONS_ACCUM,
                                                                         images=False)),
                                kernels, "(a) without images:")
    out["f"] = lag_runs(model, exp_root, loader[:2 * LAG_STEPS_ACCUM])
    out["e"] = nan_guard_runs(model, group[0])
    model.quantize_llm(8)
    out["c8"] = qlora_steps(model, trainer, group, kernels, 8)
    del model, trainer, net
    gc.collect()
    torch.cuda.empty_cache()
    model = build_quantized_model(dev, 4)
    trainer = LeoTrainer(trainer_cfg(exp_root / "phase17q4", accum=OPTIONS_ACCUM, lr=3e-5,
                                     warmup=400),
                         loaders={"t": {"train": loader}}, model=model)
    with torch.no_grad():
        for name, p in model.network.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(1e-3 * torch.randn(p.shape, generator=g, device=dev))
    out["c4"] = qlora_steps(model, trainer, trainer._device_batch(loader[:OPTIONS_ACCUM]),
                            kernels, 4)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    out["d"] = batchnorm_runs(dev)
    return out


# Phase 18: data parallelism through the port's launcher, over phase 10's tree
# and cfg_path. The train mix takes DP_DEBUG_SIZE samples of each MSQA domain
# (21: one step of 4 x 5, at one rank or two); msqa_scannet's val split takes
# DP_DEBUG_SIZE too, an odd length, so two ranks at batch 2 take 4 samples
# each and rank 1's last is a wrap-around duplicate
DP_DEBUG_SIZE = 7
DP_TIMEOUT_S = 420
DP_KERNELS = ("fps", "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
DP_EXACT_ACCUM, DP_EXACT_EVAL = 2, 5
# the flagship's trainable gradient values (phase 6 prints the count), in as
# many tensors as a LoRA set of some size
DP_FLAT_VALUES, DP_FLAT_TENSORS = 49427856, 256
DP_NEW_TOKENS = 8  # (a), (b): val's answers, cut from NEW_TOKENS (16, then 8 for phase 22)


def dp_argv(exp_root: Path, exp: Path, *extra: str):
    """The entry's arguments of phase 18 (a) and (b): configs/msr3d.yaml over
    phase 10's tree and ``cfg_path``, the msqa_scannet val task alone."""
    root = exp_root / "entry"
    data = root / "data"
    return ["--config", str(Path(__file__).resolve().parent / "configs" / "msr3d.yaml"),
            f"data.scan_family_base={data}/scan_family", f"data.rscan_base={data}/rscan",
            f"data.ARkit_base={data}/arkit", f"data.msr3d_base={data}/msr3d",
            f"model.llm.cfg_path={root / 'vicuna7b'}", "model.llm.flash_attention=true",
            "debug.flag=true", f"debug.debug_size={DP_DEBUG_SIZE}", "task.msqa_scannet.mode=[val]",
            "task.msqa_3rscan.mode=[]", "task.msqa_arkitscenes.mode=[]", "solver.epochs=1",
            "solver.num_batch_eval=0", f"model.llm.max_out_len={DP_NEW_TOKENS}", f"exp_dir={exp}",
            *extra]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_launcher(args, what: str):
    """``python -m msr3d_tpu_torch.launch args`` from the repository root; its
    ranks' ``run summary`` lines, by rank, the digests of the trainable
    parameters that the trainer of a multi-rank run logs after training (it
    raises when the ranks' differ), and the seconds it took. The launcher
    and its ranks share a session that a timeout kills whole."""
    import os
    import signal

    cmd = [sys.executable, "-m", "msr3d_tpu_torch.launch", *args]
    print(f"  ({what}) {' '.join(cmd[1:5])} ... {' '.join(args[-4:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out[-6000:])
        raise SmokeFailure(f"({what}) the launcher ran past {DP_TIMEOUT_S} s")
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        print(out[-6000:])
        raise SmokeFailure(f"({what}) the launcher exited with {proc.returncode}")
    summaries = sorted((json.loads(m) for m in re.findall(r"run summary (\{.*\})", out)),
                       key=lambda m: m["rank"])
    digests = re.findall(r"agree across \d+ ranks after training \(sha256 (\w+)\)", out)
    run_launcher.last_out = out
    return summaries, digests, took


def dp_gates(exp: Path, summaries, digests, world: int, backend: str, eval_batches: int,
             what: str, tp: int = 1, n_val: int = DP_DEBUG_SIZE):
    """The gates (a) and (b) share: the world, the backend, one step, each
    val sample scored once in one results.json, the files written once (one
    metrics line a logged step), every rank's kernels on the path and, with
    more than one rank, its parameters bit-equal to the others' (the
    trainer's own check after training, one digest a rank)."""
    check([(m["rank"], m["world"], m["backend"]) for m in summaries]
          == [(r, world, backend) for r in range(world)],
          f"({what}) {world} rank(s) over {backend}")
    check(all(m["steps"] == 1 for m in summaries), f"({what}) one optimizer step on each rank")
    results = json.loads((exp / "eval" / "msqa_scannet" / "results.json").read_text())
    indices = sorted(str(r["index"]) for r in results)
    print(f"  ({what}) results.json: {len(results)} records, indices {indices}")
    check(len(results) == n_val and len(set(indices)) == n_val,
          f"({what}) results.json scores each of the {n_val} val samples once")
    metrics = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    check([m["step"] for m in metrics if "train/loss" in m] == [1]
          and sum(any(k.startswith("val/") for k in m) for m in metrics) == 1
          and sorted(q.name for q in (exp / "ckpt" / "state").iterdir()) == ["1.pt"]
          and (exp / "ckpt" / "latest.pt").exists() and (exp / "config.yaml").exists(),
          f"({what}) metrics.jsonl, the checkpoint and the snapshot written once")
    micro = TRAIN_ACCUM
    want = {"fps": 2 * (micro + eval_batches), "flash_attn_fwd": 32 * (micro + eval_batches),
            "flash_attn_bwd_dq": 32 * micro, "flash_attn_bwd_dkv": 32 * micro}
    for m in summaries:
        print(f"  ({what}) rank {m['rank']} on {m['device']}: launches {m['launches']}, step "
              f"{' / '.join(f'{t:.1f}' for t in m['step_ms'])} ms, peak {m['peak_gib']:.2f} GiB")
    check(all(m["launches"] == want for m in summaries),
          f"({what}) each rank launched K1, K2f, K2dq, K2dkv {want} ({micro} micro-batches, "
          f"{eval_batches} eval batches)")
    if world > 1 and tp == 1:  # under tp each rank holds its own shards
        check(len(digests) == world and len(set(digests)) == 1,
              f"({what}) the trainable parameters bit-equal across ranks after the step "
              f"(the trainer's check, {world} equal digests)")


def dp_nccl_reduce() -> dict:
    """(a)'s collective: ``TrainStep``'s flat gradient reduction (an fp32 cat
    of the gradients and the loss, one ``all_reduce`` through
    ``mesh.all_reduce_sum_``, a divide, a split) on the card, under the
    world-1 NCCL group that ``initialize_distributed_from_env`` joins from
    the env contract, as a rank of a card a rank does. The gradients are
    DP_FLAT_VALUES random fp32 values (the flagship's trainable count) in
    DP_FLAT_TENSORS tensors. At world 1 the sum is the buffer itself, so
    they and the loss come back bit-unchanged. Its device time is printed;
    at world 1 NCCL moves nothing between cards."""
    import os

    import torch.distributed as dist

    from msr3d_tpu_torch.optim.build import SGD
    from msr3d_tpu_torch.parallel import mesh
    from msr3d_tpu_torch.trainer.train_state import TrainStep

    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), MSR3D_DIST_TIMEOUT_S="120")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(mesh.initialize_distributed_from_env("cuda") and dist.get_backend() == "nccl"
              and mesh.world_size() == 1,
              "(a) initialize_distributed_from_env joins a world of 1 over nccl in this process")
        gen = torch.Generator(device="cuda").manual_seed(18)
        sizes = [DP_FLAT_VALUES // DP_FLAT_TENSORS] * DP_FLAT_TENSORS
        sizes[-1] += DP_FLAT_VALUES - sum(sizes)
        grads = [torch.randn(n, device="cuda", generator=gen) for n in sizes]
        loss = torch.randn((), device="cuda", generator=gen)
        step = TrainStep(None, {}, SGD({}, lambda count: 0.0), None, data_parallel=1)
        out, out_loss = step._average_over_ranks(grads, loss)
        same = all(torch.equal(a, b) for a, b in zip(out, grads)) and torch.equal(out_loss, loss)
        ms = time_ms(lambda: step._average_over_ranks(grads, loss), iters=5, warmup=1)
        buf = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        reduce_ms = time_ms(lambda: mesh.all_reduce_sum_(buf), iters=5, warmup=1)
        print(f"  (a) TrainStep's flat reduction of {DP_FLAT_VALUES} fp32 values in "
              f"{DP_FLAT_TENSORS} tensors and the loss over nccl at world 1: "
              f"{'bit-unchanged' if same else 'CHANGED'}; {ms:.3f} ms (cat, all_reduce, "
              f"divide, split), the all_reduce alone {reduce_ms:.3f} ms")
        check(same, "(a) the flat NCCL all-reduce at world 1 gives the gradients and the "
                    "loss back bit-unchanged")
    finally:
        mesh.destroy()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(values=DP_FLAT_VALUES, ms=ms, all_reduce_ms=reduce_ms)


def dp_collate(items):
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else list(vals)
    return out


class DpRows:
    """Rows ``lo:hi`` of each global batch, one batch a loader step."""

    def __init__(self, batches, lo: int, hi: int):
        self.batches, self.lo, self.hi = batches, lo, hi

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            yield {k: v[self.lo:self.hi] for k, v in b.items()}


class DpTexts:
    """An evaluator that keeps each sample's text by its index."""

    def __init__(self):
        self.texts = {}

    def reset(self):
        self.texts = {}

    def update(self, record):
        self.texts.update(zip((int(i) for i in record["index"]), record["output_text"]))

    def record(self, split):
        return False, {"n": len(self.texts)}


def dp_exact_job(out: Path, dev=None) -> dict:
    """(c) at one rank or each of two: the fp32 model at the flagship width
    and EXACT_LAYERS layers with the spatial encoder's dropout at 0 (each
    rank draws its own masks, so with dropout the runs differ by design, as
    the CPU parity tests say), ``eval_task`` over DP_EXACT_EVAL samples at batch
    1 (this rank's shard), then one ``LeoTrainer`` step over this rank's rows
    of DP_EXACT_ACCUM global batches of 4; the loss, the gradients the
    optimizer took and the trainable parameters are written to ``out``."""
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig, SpatialEncoderConfig
    from msr3d_tpu_torch.parallel import mesh
    from msr3d_tpu_torch.serving import uncollate_batch
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, w = mesh.rank(), mesh.world_size()
    dev = dev or torch.device("cuda", torch.cuda.current_device())
    model = build_exact_model(dev, ByteTokenizer(), OSE3DConfig(
        spatial_encoder=SpatialEncoderConfig(dropout=0.0)))
    samples = uncollate_batch(make_requests(seed=21, b=DP_EXACT_EVAL))
    for i, sample in enumerate(samples):
        sample["index"] = i
    rows = N_REQUESTS // w
    trainer = LeoTrainer(
        dict(trainer_cfg(out / f"exp{w}", accum=DP_EXACT_ACCUM, lr=0.1, warmup=1),
             fixed_text_buckets=True),
        loaders={"train": {"train": DpRows(make_train_batches(DP_EXACT_ACCUM, images=False),
                                           r * rows, (r + 1) * rows)},
                 "eval": {"val": DataLoader(samples, batch_size=1, collate_fn=dp_collate,
                                            prefetch=0, num_shards=w, shard_id=r)}},
        evaluators={"eval": DpTexts()}, model=model)
    trainer.eval_task("eval", "val")
    texts = trainer.evaluators["eval"].texts
    grads, step = {}, trainer.optimizer.step

    def recording(g):
        grads.update({n: t.detach().cpu().clone() for n, t in g.items()})
        return step(g)

    trainer.optimizer.step = recording
    loss = trainer.train_one_epoch(0)["loss"]  # the one step's, all-reduced
    trainer.logger.close()
    torch.save({"grads": grads, "params": {n: p.detach().cpu().clone()
                                           for n, p in trainer.params.items()}},
               out / f"exact_w{w}_r{r}.pt")
    return dict(rank=r, world=w, loss=loss, steps=trainer.step,
                texts={str(k): v for k, v in texts.items()},
                digest=mesh.tensors_digest(trainer.params), lr=float(trainer.schedule(0)),
                eps=trainer.optimizer.eps)


def dp_exact_rank(out: str) -> None:
    """One rank of (c), under the env contract the phase sets."""
    from msr3d_tpu_torch.parallel import mesh

    assert mesh.initialize_distributed_from_env("cuda"), "no env contract"
    try:
        result = dp_exact_job(Path(out))
        (Path(out) / f"exact_rank{mesh.rank()}.json").write_text(json.dumps(result))
    finally:
        mesh.destroy()


def dp_exact(out: Path):
    """(c): two ranks on the card's one device over gloo against one process."""
    import os

    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   MSR3D_DIST_TIMEOUT_S="300")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as cs; cs.dp_exact_rank({str(out)!r})"],
            cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    one = dp_exact_job(out)  # the one process, while the ranks run
    logs, failed = [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
        failed |= p.returncode != 0
    if failed:
        for r, log in enumerate(logs):
            print(f"  (c) rank {r}:\n{log[-4000:]}")
        raise SmokeFailure("(c) a rank failed")
    ranks = [json.loads((out / f"exact_rank{r}.json").read_text()) for r in range(2)]
    return one, ranks


def dp_exact_gates(out: Path, one, ranks) -> dict:
    """(c)'s gates: one step on each side; the ranks' loss and the averaged
    gradients the optimizer took (each tensor, in norm) within 1e-5 relative
    of the one process's (the spatial attention's key bias, whose true
    gradient is 0 and whose computed one is rounding noise, within 1e-5 of
    the global gradient norm); the ranks' parameters bit-equal to each
    other's; the same eval texts. The parameters are not held to 1e-5
    relative: AdamW's first step moves an element by lr·u, u = g/(|g| +
    eps) (the decay lr·wd·p is the same in both runs), which maps a gradient
    of rounding noise about 0 to about ±lr, so two runs whose gradients part
    by 1e-6 may step apart by up to 2·lr. Each element is held instead to
    the step AdamW computes from the two captured gradients, |p₂ − p₁| <=
    lr·|u₂ − u₁| + 1e-5·|p₁| + 2e-5·lr (fp32 rounding of the step): the
    parameters must have moved as the two gradients say, where those share
    a sign and where they do not."""
    rel = 1e-5
    check(ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["digest"] == ranks[1]["digest"],
          "(c) both ranks report the same loss and hold bit-equal parameters")
    check(one["steps"] == ranks[0]["steps"] == ranks[1]["steps"] == 1,
          "(c) one optimizer step at one rank and at two")
    loss_err = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    want = torch.load(out / "exact_w1_r0.pt")
    got = torch.load(out / "exact_w2_r0.pt")
    total = float(torch.sqrt(sum(g.double().square().sum() for g in want["grads"].values())))
    grad_err = max(float((got["grads"][n] - g).norm()) / (
        total if n.endswith("self_attn.w_ks.bias") else float(g.norm()))
        for n, g in want["grads"].items() if bool(g.any()))
    lr, eps = one["lr"], one["eps"]
    param_err, flip_err, flips, elements = 0.0, 0.0, 0, 0
    for n, p1 in want["params"].items():
        g1, g2 = want["grads"][n].double(), got["grads"][n].double()
        same = torch.sign(g1) == torch.sign(g2)
        step = (g2 / (g2.abs() + eps) - g1 / (g1.abs() + eps)).abs()
        allowed = rel * p1.double().abs() + lr * (step + 2 * rel)
        ratio = (got["params"][n].double() - p1.double()).abs() / allowed
        param_err = max(param_err, float(ratio[same].max()) if bool(same.any()) else 0.0)
        if not bool(same.all()):
            flip_err = max(flip_err, float(ratio[~same].max()))
        flips += int((~same).sum())
        elements += p1.numel()
    texts_equal = one["texts"] == ranks[0]["texts"] == ranks[1]["texts"]
    print(f"  (c) fp32, {EXACT_LAYERS} layers at the flagship width, one step of "
          f"{N_REQUESTS} x {DP_EXACT_ACCUM}: loss {one['loss']!r} (one process) against "
          f"{ranks[0]['loss']!r} (two ranks), relative {loss_err:.3e}; the gradients the "
          f"optimizer took, max relative (a tensor, in norm) {grad_err:.3e}; parameters, max "
          f"|diff| / (lr·|u₂ − u₁|, AdamW's step from the two gradients, + 1e-5·|p| + "
          f"2e-5·lr) over {elements} elements: {param_err:.6f} where the gradients share a "
          f"sign, {flip_err:.6f} at the {flips} where they do not (lr {lr:.1e})")
    print(f"  (c) eval_task texts ({DP_EXACT_EVAL} samples at batch 1, beam {BEAMS}): "
          f"{'equal' if texts_equal else 'DIFFERENT'}; indices {sorted(ranks[0]['texts'])}")
    check(loss_err <= rel and grad_err <= rel and max(param_err, flip_err) <= 1.0,
          f"(c) the two ranks' loss and averaged gradients within {rel} relative of the one "
          "process's on the global batch, and every parameter within the step AdamW computes "
          "from the two gradients")
    check(texts_equal and sorted(ranks[0]["texts"]) == [str(i) for i in range(DP_EXACT_EVAL)],
          "(c) the two-rank eval_task gives the one process's texts, each sample once")
    return dict(loss_err=loss_err, grad_err=grad_err, param_err=param_err, flip_err=flip_err,
                flips=flips)


def phase_dp(exp_root: Path):
    print(f"== phase 18: data parallelism (python -m msr3d_tpu_torch.launch --mode accelerate "
          f"on configs/msr3d.yaml over phase 10's tree: one step of {N_REQUESTS} x "
          f"{TRAIN_ACCUM}, then val of {DP_DEBUG_SIZE} samples; on {card_line()})")
    root = exp_root / "dp"
    # (a) the launcher at the card count (one rank): NCCL, a world of 1
    exp_a = root / "a"
    one, _, took_a = run_launcher(["--mode", "accelerate", "--port", str(free_port()),
                                   *dp_argv(exp_root, exp_a)], "a")
    print(f"  (a) {took_a:.1f} s (start, build, init, data, one step, val)")
    dp_gates(exp_a, one, [], 1, "nccl", eval_batches=-(-DP_DEBUG_SIZE // N_REQUESTS), what="a")
    flat = dp_nccl_reduce()
    # (b) two ranks sharing the one card over gloo, 2 samples a rank a micro-batch
    exp_b = root / "b"
    two, digests, took_b = run_launcher(["--mode", "accelerate", "--num_processes", "2", "--port",
                                str(free_port()), *dp_argv(exp_root, exp_b,
                                "dataloader.train.batchsize=2", "dataloader.eval.batchsize=2")],
                               "b")
    print(f"  (b) {took_b:.1f} s; two ranks share one card, so each is slower than (a)'s "
          f"one: step {two[0]['step_ms'][0]:.1f} / {two[1]['step_ms'][0]:.1f} ms against "
          f"{one[0]['step_ms'][0]:.1f}, peak {two[0]['peak_gib']:.2f} / {two[1]['peak_gib']:.2f} "
          f"GiB against {one[0]['peak_gib']:.2f}")
    dp_gates(exp_b, two, digests, 2, "gloo", eval_batches=-(-DP_DEBUG_SIZE // N_REQUESTS),
             what="b")
    # (c) the exact gate
    t0 = time.perf_counter()
    exact_one, exact_ranks = dp_exact(root / "c")
    exact = dp_exact_gates(root / "c", exact_one, exact_ranks)
    print(f"  (c) {time.perf_counter() - t0:.1f} s")
    return dict(a=one, b=two, c=exact, flat=flat, seconds=dict(a=took_a, b=took_b))


# Phase 19: tensor parallelism on the one card. (a) the launcher with
# parallel.tp=2 over phase 18's arguments: two ranks over gloo, one step of
# 4 x 5 and val; (b) the bf16 flagship at tp = 2 in two processes, greedy
# and beam-5 generate on phase 4's requests; (c) the fp32 gates at the
# flagship's width and EXACT_LAYERS layers: tp = 2 against one process
TP = 2
TP_TIMEOUT_S = 420


def llm_params_at_tp(tp: int) -> int:
    """The flagship LLM's parameters one rank holds at ``tp``: half of each
    tensor ``shard_dims`` splits, all of each replicated one (the shapes from
    a model on the meta device)."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel
    from msr3d_tpu_torch.parallel.sharding import shard_dims

    llm = LlamaModel(LlamaConfig(lora_rank=16, param_dtype=torch.bfloat16), device="meta")
    shapes = {f"llm.{n}": tuple(p.shape) for n, p in llm.named_parameters()}
    dims = shard_dims(shapes, tp)
    return sum(int(np.prod(sh)) // (tp if dims[n] is not None else 1) for n, sh in shapes.items())


def spawn_ranks(fn: str, out: Path, world: int = TP) -> list:
    """``chip_smoke.fn(out)`` in ``world`` rank processes under the env
    contract, sharing the card; each rank's JSON (``out/<fn>_rank<r>.json``).
    A rank that fails or outlives TP_TIMEOUT_S fails the phase, its log
    printed."""
    import os

    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   MSR3D_DIST_TIMEOUT_S="300")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as cs; cs.{fn}({str(out)!r})"],
            cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    return procs


def wait_ranks(procs, out: Path, fn: str, what: str) -> list:
    import os
    import signal

    logs, failed = [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            logs.append(p.communicate()[0])
        failed |= p.returncode != 0
    if failed:
        for r, log in enumerate(logs):
            print(f"  ({what}) rank {r}:\n{log[-4000:]}")
        raise SmokeFailure(f"({what}) a rank failed")
    return [json.loads((out / f"{fn}_rank{r}.json").read_text()) for r in range(len(procs))]


def _rank_main(fn, out: str, parallel: "dict | None" = None) -> None:
    """One rank of a multi-rank part: join the group, build the mesh
    (``parallel``, tp = TP by default), run ``fn``, write its JSON."""
    from msr3d_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert mesh.initialize_distributed_from_env("cuda"), "no env contract"
    try:
        mesh.init_mesh(parallel or {"tp": TP})
        result = fn(Path(out))
        (Path(out) / f"{fn.__name__}_rank{mesh.rank()}.json").write_text(json.dumps(result))
    finally:
        mesh.destroy()


def tp_generate(out: Path) -> dict:
    """(b) on one rank: the flagship (bf16, 32 layers, 32 heads, 16 a rank)
    at tp = 2 from phase 4's seed, greedy and beam-5 generate on phase 4's
    requests, each timed after a warm-up with K1 and K2f counted from 0."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.parallel import mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    llm = LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=32, num_attention_heads=32, lora_rank=16,
                      dtype=torch.bfloat16, param_dtype=torch.bfloat16, flash_attention=True,
                      tp_size=TP, tp_rank=mesh.tp_rank())
    model = MSR3D(MSR3DNetworkConfig(prompter=OSE3DConfig(), llm=llm, answer_window_loss=True),
                  ByteTokenizer(), scene_token_len=60, max_out_len=ENGINE_TOKENS,
                  repetition_penalty=REP_PENALTY, device=dev)
    model.init_params(seed=0)  # phase 4's weights, this rank's shards
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    llm_params = sum(p.numel() for p in model.network.llm.parameters())
    data = make_requests(seed=0, images=True)
    net = model.network
    ids, attn = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                     side="left")
    scene = model._scene_batch(data)
    ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    attn_t = torch.as_tensor(attn, dtype=torch.int32, device=dev)
    out_row = dict(rank=mesh.rank(), tp_rank=mesh.tp_rank(), llm_params=llm_params,
                   build_s=build_s)
    for beam in (False, True):
        model.num_beams, model.length_penalty = (BEAMS, LENGTH_PENALTY) if beam else (1, 1.0)
        model.generate(dict(data), use_beam=beam, max_new_tokens=2)  # warm-up
        FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
        torch.cuda.reset_peak_memory_stats()
        got = {}
        gen_ms = wall_ms(lambda: got.update(model.generate(dict(data), use_beam=beam)))
        launches = {"fps": FPS_KERNEL.launches, "flash_attn_fwd": FLASH_FWD_KERNEL.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        tokens = got["output_tokens"]
        with torch.no_grad():
            prefill_ms = wall_ms(lambda: net.prefill(
                ids_t, attn_t, **scene, bos_id=model.tokenizer.bos_id,
                max_cache_len=ids.shape[1] + 1))
        finished_at = [list(row).index(model.tokenizer.eos_id) if model.tokenizer.eos_id in row
                       else ENGINE_TOKENS for row in tokens]
        steps = max(1, min(ENGINE_TOKENS, max(finished_at) + 1) - 1)
        out_row["beam" if beam else "greedy"] = dict(
            tokens=np.asarray(tokens).tolist(), gen_ms=gen_ms, prefill_ms=prefill_ms,
            decode_ms=(gen_ms - prefill_ms) / steps, steps=steps, launches=launches,
            peak_gib=peak)
    return out_row


TP_CLIP = 1e-2  # (c)'s clip: the step's norm is far above it, so it scales
TP_LR = 1e5  # (c)'s SGD rate: 100 at the first step (1e-3 of it in warm-up),
# so the clipped update's norm is 1


def tp_exact(out: Path) -> dict:
    """(c) at tp = 1 (the parent process) or on one of two tp ranks: the fp32
    model of ``build_exact_model`` with random LoRA B (so every LoRA factor
    has a gradient), split by ``shard_for_serving`` on a rank; greedy and
    beam-5 generate, the continuous greedy engine and the prefix-pool engine
    (ENGINE_TOKENS tokens); one ``TrainStep`` of one micro-batch in eval
    mode through ``LeoTrainer`` (SGD, the clip at TP_CLIP): its loss and
    grad norm, the gradients the optimizer took and the updated trainable
    parameters, gathered whole (rank 0 writes them, and the one process the
    parameters before the step)."""
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.parallel import mesh
    from msr3d_tpu_torch.parallel.sharding import gather_full_state_dict
    from msr3d_tpu_torch.serving import (
        ContinuousBatchingServer,
        PrefixPoolContinuousBatchingServer,
        uncollate_batch,
    )
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    dev = torch.device("cuda", torch.cuda.current_device())
    tp = mesh.tp_size()
    model = build_exact_model(dev, ByteTokenizer())
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for name, p in model.network.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 1e-2)
    model.shard_for_serving(tensor_parallel=True)
    data = make_requests(seed=3)
    res = dict(rank=mesh.rank(), tp=tp)
    for beam in (False, True):
        res["beam" if beam else "greedy"] = np.asarray(model.generate(
            dict(data), use_beam=beam, max_new_tokens=ENGINE_TOKENS)["output_tokens"]).tolist()
    prompt_len = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                      side="left")[0].shape[1] + 1
    engine = ContinuousBatchingServer(model, num_slots=N_REQUESTS, refill_group=N_REQUESTS,
                                      chunk_steps=ENGINE_CHUNK, max_new_tokens=ENGINE_TOKENS,
                                      prompt_len=prompt_len)
    res["engine"] = [np.asarray(r.output_tokens).tolist()
                     for r in engine.run(uncollate_batch(data))]
    pool = PrefixPoolContinuousBatchingServer(model, **pool_kw(num_slots=4, refill_group=2))
    res["pool"] = [np.asarray(r.output_tokens).tolist()
                   for r in pool.run(pool_stream(seed=5, images=False, questions=2))]
    res["digests"] = dict(engine=engine.tokens_digest, pool=pool.tokens_digest)

    cfg = trainer_cfg(out / f"exp_tp{tp}", accum=1, lr=TP_LR, warmup=1)
    cfg["solver"].update(grad_norm=TP_CLIP, optim={"name": "SGD", "args": {"lr": TP_LR}})
    batches = make_train_batches(1, images=False)
    trainer = LeoTrainer(dict(cfg, parallel={"tp": tp}),
                         loaders={"msr3d_train": {"train": batches}}, evaluators={}, model=model)
    before = trainer._learnable()
    dims, taken, step = model.network.tp_dims(), [], trainer.optimizer.step

    def record(grads):
        taken.append({n: g.cpu() for n, g in gather_full_state_dict(
            {n: g.detach().clone() for n, g in grads.items()}, dims).items()})
        return step(grads)

    trainer.optimizer.step = record
    metrics = trainer._train_step(trainer._device_batch(batches))
    after = trainer._learnable()
    if mesh.rank() == 0:
        torch.save(dict(grads=taken[0], params=after, before=before),
                   out / f"exact_step_tp{tp}.pt")
    res.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               lr=float(trainer.schedule(0)))
    return res


def tp_generate_rank(out: str) -> None:
    _rank_main(tp_generate, out)


def tp_exact_rank(out: str) -> None:
    _rank_main(tp_exact, out)


def phase_tp(exp_root: Path, dp: "dict | None" = None):
    print(f"== phase 19: tensor parallelism at tp = {TP} on one card (two ranks over gloo: "
          f"(a) python -m msr3d_tpu_torch.launch --mode accelerate parallel.tp={TP} on "
          f"configs/msr3d.yaml over phase 10's tree, one step of {N_REQUESTS} x {TRAIN_ACCUM} "
          f"and a val batch of {N_REQUESTS}; (b) the bf16 flagship's generate, {ENGINE_TOKENS} "
          f"tokens; (c) fp32 gates; on "
          f"{card_line()})")
    root = exp_root / "tp"
    want_params = llm_params_at_tp(TP)
    full_params = llm_params_at_tp(1)
    exp_a = root / "a"
    summaries, digests, took_a = run_launcher(
        ["--mode", "accelerate", "--port", str(free_port()),
         *dp_argv(exp_root, exp_a, f"parallel.tp={TP}", "solver.num_batch_eval=1")], "a")
    print(f"  (a) {took_a:.1f} s (start, build, init, data, one step, val)")
    dp_gates(exp_a, summaries, digests, TP, "gloo", eval_batches=1, what="a", tp=TP,
             n_val=N_REQUESTS)
    check([(m["dp"], m["tp"], m["tp_rank"]) for m in summaries] == [(1, TP, r) for r in range(TP)],
          f"(a) the launcher started dp 1 x tp {TP} ranks from parallel.tp={TP}")
    tp_digests = re.findall(r"agree across \d+ tp ranks after training \(sha256 (\w+)\)",
                            run_launcher.last_out)
    b18 = dp["b"][0] if dp else dict(peak_gib=float("nan"), step_ms=[float("nan")])
    for m in summaries:
        print(f"  (a) rank {m['rank']}: {m['llm_params']} LLM parameters (of {full_params} "
              f"whole), peak {m['peak_gib']:.2f} GiB against phase 18 (b)'s "
              f"{b18['peak_gib']:.2f} (two dp ranks, each the whole LLM), data wait "
              f"{m['data_wait_ms'][0]:.1f} ms before the step (tp rank 0 loads, then "
              f"broadcasts the batch), step "
              f"{m['step_ms'][0]:.1f} ms against {b18['step_ms'][0]:.1f}, of it "
              f"{1e3 * m['step_tp_comm_s'][0]:.1f} ms ({m['step_tp_comm_s'][0] / m['step_ms'][0] * 1e3:.1%}) "
              f"in the host-routed tp collectives; {m['tp_comm']['calls']} collectives over the "
              f"run, {m['tp_comm']['seconds']:.2f} s")
    check(all(m["llm_params"] == want_params for m in summaries),
          f"(a) each rank holds {want_params} LLM parameters: half of every split tensor")
    check(len(tp_digests) == TP and len(set(tp_digests)) == 1,
          f"(a) the ranks' replicated trainable parameters bit-equal after the step "
          f"({len(tp_digests)} digests, {len(set(tp_digests))} distinct)")

    # (b) the bf16 flagship at tp = 2
    t0 = time.perf_counter()
    gen = wait_ranks(spawn_ranks("tp_generate_rank", root / "b"), root / "b", "tp_generate",
                     "b")
    took_b = time.perf_counter() - t0
    p4_tokens = FIGURES.get("phase4_tokens")
    for way in ("greedy", "beam"):
        rows = [g[way] for g in gen]
        for g in gen:
            r = g[way]
            print(f"  (b) rank {g['rank']} {way}{f' {BEAMS}' if way == 'beam' else ''}: "
                  f"generate {r['gen_ms']:.2f} ms, prefill {r['prefill_ms']:.2f} ms, decode "
                  f"{r['decode_ms']:.2f} ms a token over {r['steps']} steps, peak "
                  f"{r['peak_gib']:.2f} GiB, launches {r['launches']}")
        check(rows[0]["tokens"] == rows[1]["tokens"],
              f"(b) {way}: both tp ranks emit the same tokens")
        check(all(r["launches"] == {"fps": 2, "flash_attn_fwd": 32} for r in rows),
              f"(b) {way}: each rank launches K1 2 and K2f 32 (its 16 heads) a generate")
    if p4_tokens is not None:
        same = float(np.mean(np.asarray(gen[0]["greedy"]["tokens"])
                             == np.asarray(p4_tokens)[:, :ENGINE_TOKENS]))
        print(f"  (b) greedy at tp = {TP} against phase 4's one process (bf16, the partial sums "
              f"add in another order): {same:.3f} of the tokens equal; decode "
              f"{gen[0]['greedy']['decode_ms']:.2f} ms a token against phase 4's "
              f"{FIGURES['phase4_decode_ms']:.2f}, peak {gen[0]['greedy']['peak_gib']:.2f} GiB "
              f"against {FIGURES['phase4_peak_gib']:.2f}; built in {gen[0]['build_s']:.1f} s")
    print(f"  (b) {took_b:.1f} s")

    # (c) fp32 gates: two tp ranks against one process, the one process
    # running while the ranks do
    t0 = time.perf_counter()
    out_c = root / "c"
    procs = spawn_ranks("tp_exact_rank", out_c)
    try:
        one = tp_exact(out_c)
    finally:  # the ranks end, whatever happened here
        ranks = wait_ranks(procs, out_c, "tp_exact", "c")
    for what in ("greedy", "beam", "engine", "pool"):
        check(ranks[0][what] == ranks[1][what] == one[what],
              f"(c) fp32 {what}: the tp = {TP} tokens equal the one process's on both ranks")
    check(all(ranks[0]["digests"][k] == ranks[1]["digests"][k] for k in ("engine", "pool")),
          "(c) the engines' token digests agree across the tp ranks")
    want = torch.load(out_c / "exact_step_tp1.pt")
    got = torch.load(out_c / f"exact_step_tp{TP}.pt")

    def max_rel(got_d, want_d, size, total, allow=lambda n: 0.0):
        """The largest of each tensor's (‖got − want‖ − ``allow``) over its
        ``size``; the key bias's over ``total`` (its true gradient is 0,
        ROADMAP §3)."""
        return max((float((got_d[n] - w).double().norm()) - allow(n)) / (
            total if n.endswith("self_attn.w_ks.bias") else size(n))
            for n, w in want_d.items() if size(n))

    grads = want["grads"]
    grad_total = float(torch.sqrt(sum(g.double().square().sum() for g in grads.values())))
    grad_err = max_rel(got["grads"], grads, lambda n: float(grads[n].double().norm()),
                       grad_total)
    update = {n: want["params"][n].double() - want["before"][n].double() for n in grads}
    update_total = float(torch.sqrt(sum(u.square().sum() for u in update.values())))
    # each side stores its parameters in fp32: up to one spacing apart an
    # element for the rounding alone
    update_err = max_rel(got["params"], want["params"], lambda n: float(update[n].norm()),
                         update_total, allow=lambda n: float(np.linalg.norm(
                             np.spacing(np.abs(want["params"][n].numpy())))))
    loss_err = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    norm_err = abs(ranks[0]["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
    print(f"  (c) fp32, {EXACT_LAYERS} layers at the flagship width: greedy, beam {BEAMS}, the "
          f"continuous and the pool engine's tokens equal at tp = {TP} and tp = 1; one "
          f"TrainStep of a micro-batch of {N_REQUESTS} (SGD at {one['lr']!r}, clip "
          f"{TP_CLIP}): loss {one['loss']!r} against {ranks[0]['loss']!r}, relative "
          f"{loss_err:.3e}; grad norm {one['grad_norm']!r} against {ranks[0]['grad_norm']!r}, "
          f"relative {norm_err:.3e}; the {len(grads)} clipped gradients the optimizer took, "
          f"gathered, max relative (a tensor, in norm) {grad_err:.3e}; the updated parameters, "
          f"gathered, max relative to the update (a tensor, in norm, less fp32 storage) "
          f"{update_err:.3e} (update norm {update_total:.4f}); "
          f"{time.perf_counter() - t0:.1f} s")
    check(ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["grad_norm"] == ranks[1]["grad_norm"],
          "(c) both tp ranks report the same loss and grad norm")
    check(one["grad_norm"] > TP_CLIP, f"(c) the clip at {TP_CLIP} engaged")
    check(loss_err <= 1e-5 and norm_err <= 1e-5 and grad_err <= 1e-5 and update_err <= 1e-5,
          f"(c) the tp = {TP} TrainStep's loss, grad norm, clipped gradients and updated "
          f"parameters (gathered) within 1e-5 relative of one process's")
    return dict(a=summaries, b=gen, c=dict(loss_err=loss_err, norm_err=norm_err,
                                           grad_err=grad_err, update_err=update_err),
                seconds=dict(a=took_a, b=took_b))


# phase 20: pipeline parallelism at pp = PP and quantized bases at tp = TP,
# two ranks sharing the card over gloo: (a) the launcher with parallel.pp=PP
# over phase 18's arguments (one step, one val batch); (b) greedy generate of
# the int8 and the int4-grouped flagship at tp = TP (phase 8's (a) and (c));
# (c) the fp32 gates at the flagship's width and EXACT_LAYERS layers
PP = 2
PP_QUANT_RUNS = (
    # (label of phase 8, what, batch, LoRA rank, quantization of the LlamaConfig)
    ("a", "int8 per channel, merged LoRA, int8 KV cache", 16, 0,
     dict(quantize_bits=8, kv_quantize=True)),
    ("c", "int4 with group 128, int8 KV cache", 4, 16,
     dict(quantize_bits=4, quantize_group=128, kv_quantize=True)),
)
# (c): a one-process gradient whose norm is below this share of the whole
# gradient's is rounding noise (fp32 spacing is 1.2e-7 of a value; the
# spatial key biases' gradients, zero in exact arithmetic, sit far below it)
PP_GRAD_FLOOR = 1e-6
PP_EXACT_QUANT = {  # (c)'s quantize_llm arguments
    "int8": dict(bits=8), "int4": dict(bits=4), "int4-g128": dict(bits=4, group=128),
    "s8s8": dict(bits=8, act_quantize=True)}


def llm_params_at_pp(pp: int, pp_rank: int) -> int:
    """The flagship LLM's parameters stage ``pp_rank`` of ``pp`` holds: its
    blocks beside the embedding, the final norm and the head (a model on
    the meta device)."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel

    llm = LlamaModel(LlamaConfig(lora_rank=16, param_dtype=torch.bfloat16, pp_size=pp,
                                 pp_rank=pp_rank), device="meta")
    return sum(p.numel() for p in llm.parameters())


def tpq_generate(out: Path) -> dict:
    """(b) on one rank: each of PP_QUANT_RUNS's flagships at tp = TP from
    phase 8's seed (each projection drawn whole, quantized whole on the
    card and this rank's shards kept), greedy generate of ENGINE_TOKENS
    tokens on phase 8's requests, timed after a warm-up with K1 and K2f
    counted from 0."""
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.parallel import mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    res = dict(rank=mesh.rank(), tp_rank=mesh.tp_rank())
    for label, _, batch, rank, quant in PP_QUANT_RUNS:
        t0 = time.perf_counter()
        llm = LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                          num_hidden_layers=32, num_attention_heads=32, lora_rank=rank,
                          dtype=torch.bfloat16, param_dtype=torch.bfloat16, flash_attention=True,
                          quantize=True, tp_size=TP, tp_rank=mesh.tp_rank(), **quant)
        model = MSR3D(MSR3DNetworkConfig(prompter=OSE3DConfig(), llm=llm, answer_window_loss=True),
                      ByteTokenizer(), scene_token_len=60, max_out_len=ENGINE_TOKENS,
                      repetition_penalty=REP_PENALTY, device=dev)
        model.init_params(seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        data = make_requests(seed=0, b=batch)
        model.generate(dict(data), use_beam=False, max_new_tokens=2)  # warm-up
        FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
        torch.cuda.reset_peak_memory_stats()
        got = {}
        gen_ms = wall_ms(lambda: got.update(model.generate(dict(data), use_beam=False)))
        launches = {"fps": FPS_KERNEL.launches, "flash_attn_fwd": FLASH_FWD_KERNEL.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        net = model.network
        ids, attn = model._pad_to_bucket(*model._encode_prompts(model.build_text_prompt(data)),
                                         side="left")
        scene = model._scene_batch(data)
        with torch.no_grad():
            prefill_ms = wall_ms(lambda: net.prefill(
                torch.as_tensor(ids, dtype=torch.long, device=dev),
                torch.as_tensor(attn, dtype=torch.int32, device=dev), **scene,
                bos_id=model.tokenizer.bos_id, max_cache_len=ids.shape[1] + 1))
        tokens = np.asarray(got["output_tokens"])
        finished_at = [list(row).index(model.tokenizer.eos_id) if model.tokenizer.eos_id in row
                       else ENGINE_TOKENS for row in tokens]
        steps = max(1, min(ENGINE_TOKENS, max(finished_at) + 1) - 1)
        res[label] = dict(tokens=tokens.tolist(), gen_ms=gen_ms, prefill_ms=prefill_ms,
                          decode_ms=(gen_ms - prefill_ms) / steps, steps=steps,
                          launches=launches, peak_gib=peak, build_s=build_s,
                          llm_bytes=sum(t.numel() * t.element_size()
                                        for t in net.llm.state_dict().values()))
        del model, net, scene
        gc.collect()
        torch.cuda.empty_cache()
    return res


PP_LR = 1e-3  # (c)'s SGD rate: its updates are not gated, its gradients are


def exact_step(out: Path, axis: str) -> dict:
    """(c)'s training half of phases 20 (``axis`` pp) and 21 (sp), at one
    process (the parent) or on one of two ranks of ``axis``:
    ``build_exact_model`` with random LoRA B, one ``TrainStep`` of one
    micro-batch of N_REQUESTS (PP micro-batches under pp) in eval mode
    through ``LeoTrainer`` (SGD, no clip): its loss and the gradients the
    optimizer took, gathered whole over the stages (rank 0 writes them)."""
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.parallel import mesh
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    dev = torch.device("cuda", torch.cuda.current_device())
    size = {"pp": mesh.pp_size, "sp": mesh.sp_size}[axis]()
    model = build_exact_model(dev, ByteTokenizer())
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for name, p in model.network.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 1e-2)
    cfg = trainer_cfg(out / f"exp_{axis}{size}", accum=1, lr=PP_LR, warmup=1)
    cfg["solver"].update(grad_norm=None, optim={"name": "SGD", "args": {"lr": PP_LR}})
    batches = make_train_batches(1, images=False)
    trainer = LeoTrainer(dict(cfg, parallel={axis: size}),
                         loaders={"msr3d_train": {"train": batches}}, evaluators={}, model=model)
    taken, step = [], trainer.optimizer.step

    def record(grads):
        taken.append(trainer._gather_stages({n: g.detach().cpu() for n, g in grads.items()}))
        return step(grads)

    trainer.optimizer.step = record
    metrics = trainer._train_step(trainer._device_batch(batches))
    if mesh.rank() == 0:
        torch.save(taken[0], out / f"exact_grads_{axis}{size}.pt")
    return dict(rank=mesh.rank(), size=size, loss=float(metrics["loss"]),
                blocks=sorted({n.split(".")[2] for n, _ in model.network.named_parameters()
                               if n.startswith("llm.layer.")}))


def pp_exact(out: Path) -> dict:
    return exact_step(out, "pp")


def exact_grad_errors(want: dict, got: dict) -> dict:
    """(c)'s gradients of one process (``want``) against the ranks'
    (``got``), by name. A gradient that the model's invariance makes zero is
    rounding noise on both sides (the spatial attention's key biases:
    softmax over the keys is blind to a shift); such a one, below
    PP_GRAD_FLOOR of the whole gradient's norm in one process, is held to
    that floor (``noise``: |diff| / whole), every other to its own norm:
    the max relative error (a tensor, in norm) over all (``all``), the LoRA
    ones (``lora``) and those outside the blocks (``outside``)."""
    whole = math.sqrt(sum(float(g.double().square().sum()) for g in want.values()))
    norms = {n: float(g.double().norm()) for n, g in want.items()}
    errs = {n: float((got[n] - want[n]).double().norm()) for n in want}
    noise = sorted(n for n in want if norms[n] <= PP_GRAD_FLOOR * whole)

    def rel(names):
        return max((errs[n] / norms[n] for n in names if n not in noise), default=0.0)

    worst = sorted((n for n in want if n not in noise), key=lambda n: -errs[n] / norms[n])[:3]
    return dict(
        whole=whole, all=rel(want), lora=rel([n for n in want if "lora_" in n]),
        outside=rel([n for n in want if not n.startswith("llm.layer.")]),
        noise=max((errs[n] / whole for n in noise), default=0.0),
        worst=[(n, f"{errs[n] / norms[n]:.3e}") for n in worst],
        noise_names=[(n, f"{norms[n]:.3e}") for n in noise],
        n_lora=sum("lora_" in n for n in want),
        n_outside=sum(not n.startswith("llm.layer.") for n in want))


def tpq_exact(out: Path) -> dict:
    """(c)'s quantized half, at tp = 1 (the parent) or on one of two tp
    ranks: ``build_exact_model`` quantized whole by each of PP_EXACT_QUANT's
    settings, split by ``shard_for_serving`` on a rank, greedy generate of
    ENGINE_TOKENS tokens on phase 4's requests."""
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.parallel import mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    res = dict(rank=mesh.rank(), tp=mesh.tp_size())
    for name, quant in PP_EXACT_QUANT.items():
        model = build_exact_model(dev, ByteTokenizer())
        model.quantize_llm(**quant)
        model.shard_for_serving(tensor_parallel=True)
        got = model.generate(make_requests(seed=3), use_beam=False, max_new_tokens=ENGINE_TOKENS)
        res[name] = np.asarray(got["output_tokens"]).tolist()
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return res


def tpq_generate_rank(out: str) -> None:
    _rank_main(tpq_generate, out)


def pp_exact_rank(out: str) -> None:
    _rank_main(pp_exact, out, {"pp": PP})


def tpq_exact_rank(out: str) -> None:
    _rank_main(tpq_exact, out)


def phase_pp(exp_root: Path, tp: "dict | None" = None, quantized: "dict | None" = None):
    print(f"== phase 20: pipeline parallelism at pp = {PP} and quantized bases at tp = {TP}, "
          f"on one card (two ranks over gloo: (a) python -m msr3d_tpu_torch.launch --mode "
          f"accelerate parallel.pp={PP} on configs/msr3d.yaml over phase 10's tree, one step of "
          f"{N_REQUESTS} x {TRAIN_ACCUM} and a val batch of {N_REQUESTS}; (b) greedy generate of "
          f"the int8 and the int4-grouped flagship at tp = {TP}, {ENGINE_TOKENS} tokens; (c) fp32 "
          f"gates; on {card_line()})")
    root = exp_root / "pp"
    exp_a = root / "a"
    summaries, _, took_a = run_launcher(
        ["--mode", "accelerate", "--port", str(free_port()),
         *dp_argv(exp_root, exp_a, f"parallel.pp={PP}", "solver.num_batch_eval=1")], "a")
    print(f"  (a) {took_a:.1f} s (start, build, init, data, one step, val)")
    check([(m["rank"], m["world"], m["backend"], m["dp"], m["tp"], m["pp"], m["pp_rank"])
           for m in summaries] == [(r, PP, "gloo", 1, 1, PP, r) for r in range(PP)],
          f"(a) the launcher started dp 1 x pp {PP} ranks over gloo from parallel.pp={PP}")
    check(all(m["steps"] == 1 for m in summaries), "(a) one optimizer step on each rank")
    results = json.loads((exp_a / "eval" / "msqa_scannet" / "results.json").read_text())
    indices = sorted(str(r["index"]) for r in results)
    check(len(results) == N_REQUESTS and len(set(indices)) == N_REQUESTS,
          f"(a) results.json scores each of the {N_REQUESTS} val samples once (pp rank 0 "
          f"evaluates with the whole LLM, pp rank 1 waits)")
    metrics = [json.loads(line) for line in (exp_a / "metrics.jsonl").read_text().splitlines()]
    check([m["step"] for m in metrics if "train/loss" in m] == [1]
          and sorted(q.name for q in (exp_a / "ckpt" / "state").iterdir()) == ["1.pt"]
          and (exp_a / "ckpt" / "latest.pt").exists(),
          "(a) metrics.jsonl and the checkpoint written once, by rank 0")
    pp_digests = re.findall(r"agree across \d+ pp ranks after training \(sha256 (\w+)\)",
                            run_launcher.last_out)
    check(len(pp_digests) == PP and len(set(pp_digests)) == 1,
          f"(a) the ranks' trainable parameters outside the blocks bit-equal after the step "
          f"({len(pp_digests)} digests, {len(set(pp_digests))} distinct)")
    micro, layers = TRAIN_ACCUM * PP, 32 // PP  # PP pipeline micro-batches a loader batch
    b19 = tp["a"][0] if tp else dict(peak_gib=float("nan"), step_ms=[float("nan")],
                                     launches={k: -1 for k in DP_KERNELS})
    for m in summaries:
        r = m["rank"]
        want = {"fps": 2 * (TRAIN_ACCUM + 1) if r == 0 else 0,
                "flash_attn_fwd": layers * micro + (32 if r == 0 else 0),
                "flash_attn_bwd_dq": layers * micro, "flash_attn_bwd_dkv": layers * micro}
        share = m["step_pp_comm_s"][0] / m["step_ms"][0] * 1e3
        print(f"  (a) rank {r} (stage {m['pp_rank']}): {m['llm_params']} LLM parameters "
              f"(blocks {layers * r}..{layers * (r + 1) - 1} of 32, the embedding, norm and head), "
              f"peak {m['peak_gib']:.2f} GiB against phase 19 (a)'s {b19['peak_gib']:.2f}, step "
              f"{m['step_ms'][0]:.1f} ms against {b19['step_ms'][0]:.1f}, of it "
              f"{1e3 * m['step_pp_comm_s'][0]:.1f} ms ({share:.1%}) in the host-routed pp "
              f"transfers ({m['pp_comm']['calls']} over the run, "
              f"{m['pp_comm']['bytes'] / 2**30:.2f} GiB, {m['pp_comm']['seconds']:.2f} s, the "
              f"eval's gather of the blocks included); "
              f"data wait {m['data_wait_ms'][0]:.1f} ms; launches {m['launches']} (phase 19 (a) "
              f"a rank: {b19['launches']})")
        check(m["llm_params"] == llm_params_at_pp(PP, r),
              f"(a) rank {r} holds its stage's {layers} blocks beside the embedding and head")
        check(m["launches"] == want,
              f"(a) rank {r} launched K1, K2f, K2dq, K2dkv {want} ({layers} layers x {micro} "
              f"pipeline micro-batches{'; K1 and the eval batch on stage 0' if r == 0 else ''})")

    # (b) the quantized flagships at tp = TP
    t0 = time.perf_counter()
    gen = wait_ranks(spawn_ranks("tpq_generate_rank", root / "b"), root / "b", "tpq_generate",
                     "b")
    took_b = time.perf_counter() - t0
    for label, what, batch, _, _ in PP_QUANT_RUNS:
        rows = [g[label] for g in gen]
        p8 = (quantized or {}).get(label, {})
        for g in gen:
            r = g[label]
            print(f"  (b) {label} ({what}, batch {batch}) rank {g['rank']}: generate "
                  f"{r['gen_ms']:.2f} ms, prefill {r['prefill_ms']:.2f} ms, decode "
                  f"{r['decode_ms']:.2f} ms a token over {r['steps']} steps against phase 8 "
                  f"({label})'s {p8.get('decode_ms', float('nan')):.2f} at tp = 1, peak "
                  f"{r['peak_gib']:.2f} GiB against {p8.get('peak_gb', float('nan')):.2f}, LLM "
                  f"{r['llm_bytes'] / 2**30:.2f} GiB a rank, built in {r['build_s']:.1f} s, "
                  f"launches {r['launches']}")
        check(rows[0]["tokens"] == rows[1]["tokens"],
              f"(b) {label}: both tp ranks emit the same tokens")
        check(all(r["launches"] == {"fps": 2, "flash_attn_fwd": 32} for r in rows),
              f"(b) {label}: each rank launches K1 2 and K2f 32 a generate")
        toks = np.asarray(rows[0]["tokens"])
        check(toks.shape == (batch, ENGINE_TOKENS) and bool(((toks >= 0) & (toks < 32000)).all()),
              f"(b) {label}: tokens of shape {toks.shape} inside the vocabulary")
    print(f"  (b) {took_b:.1f} s")

    # (c) fp32 gates: two pp ranks and two tp ranks against one process, the
    # one process running while the ranks do
    t0 = time.perf_counter()
    out_c = root / "c"
    procs_pp = spawn_ranks("pp_exact_rank", out_c / "pp")
    procs_tp = spawn_ranks("tpq_exact_rank", out_c / "tp")
    try:
        one_pp = pp_exact(out_c / "pp")
        one_tp = tpq_exact(out_c / "tp")
    finally:  # the ranks end, whatever happened here
        ranks_pp = wait_ranks(procs_pp, out_c / "pp", "pp_exact", "c")
        ranks_tp = wait_ranks(procs_tp, out_c / "tp", "tpq_exact", "c")
    want = torch.load(out_c / "pp" / "exact_grads_pp1.pt")
    got = torch.load(out_c / "pp" / f"exact_grads_pp{PP}.pt")
    check(sorted(got) == sorted(want), "(c) the gathered gradients name every trainable tensor")
    e = exact_grad_errors(want, got)
    grad_err, outside_err, all_err, noise_err = e["lora"], e["outside"], e["all"], e["noise"]
    loss_err = abs(ranks_pp[0]["loss"] - one_pp["loss"]) / abs(one_pp["loss"])
    print(f"  (c) fp32, {EXACT_LAYERS} layers at the flagship width, pp = {PP} (stages hold blocks "
          f"{[r['blocks'] for r in ranks_pp]}) against one process: loss {one_pp['loss']!r} "
          f"against {ranks_pp[0]['loss']!r}, relative {loss_err:.3e}; the {len(want)} trainable "
          f"gradients, gathered (whole norm {e['whole']:.6g}), max relative (a tensor, in norm) "
          f"{all_err:.3e}: the {e['n_lora']} LoRA ones' {grad_err:.3e}, the {e['n_outside']} "
          f"outside the blocks' (stage 0's backward from the pipe's input gradients, broadcast "
          f"over pp) {outside_err:.3e}; the largest {e['worst']}; {len(e['noise_names'])} at "
          f"rounding noise {e['noise_names']}, their |diff| / whole norm at most "
          f"{noise_err:.3e}")
    check(ranks_pp[0]["loss"] == ranks_pp[1]["loss"], "(c) both pp ranks report the same loss")
    check(loss_err <= 1e-5 and all_err <= 1e-4 and noise_err <= PP_GRAD_FLOOR,
          f"(c) the pp = {PP} loss within 1e-5 and every trainable gradient within 1e-4 "
          f"relative of one process's (those at rounding noise within {PP_GRAD_FLOOR:g} of the "
          "whole gradient's norm)")
    for name in PP_EXACT_QUANT:
        check(ranks_tp[0][name] == ranks_tp[1][name] == one_tp[name],
              f"(c) fp32 {name}: the tp = {TP} greedy tokens equal the one process's on both "
              "ranks")
    print(f"  (c) fp32 greedy tokens at tp = {TP} equal tp = 1's for {list(PP_EXACT_QUANT)}; "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(a=summaries, b=gen, c=dict(loss_err=loss_err, grad_err=all_err,
                                           lora_grad_err=grad_err, outside_grad_err=outside_err,
                                           noise_grad_err=noise_err),
                seconds=dict(a=took_a, b=took_b))


# phase 21: sequence parallelism at sp = SP, two ranks sharing the card over
# gloo: (a) the launcher with parallel.sp=SP over phase 18's arguments (one
# step, one val batch); (b) the long context sp exists for, at sp = 1 (one
# process, K2f/K2dq/K2dkv) and sp = SP (the ring); (c) fp32 gates
SP = 2
# (b): JAX's long-context test length, batch 1, the flagship LLM's width at
# a depth that fits the script's time
SP_LONG_T, SP_LONG_LAYERS = 4096, 8
SP_LONG_STEPS = 1  # timed steps after a warm-up
# (b)'s gates in bf16 (the ring rounds q·k to bf16, K2f keeps fp32 scores):
# the loss at sp = SP relative to sp = 1's; each LoRA gradient relative to
# its own norm at sp = 1, the largest within SP_LONG_SPREAD times the largest
# of the dense route's (two routes without the ring: bf16's spread)
SP_LONG_RTOL, SP_LONG_SPREAD = 1e-3, 2.0


def sp_long(out: Path) -> dict:
    """(b) at sp = 1 (the parent) or on one of SP ranks: the flagship's LLM
    (4096, 32 heads, bf16, LoRA r16 on the seven projections, flash
    attention) at SP_LONG_LAYERS layers, random weights and LoRA B from one
    seed; forward and backward of a mean token CE over SP_LONG_T tokens of
    batch 1 (the rank's block under sp, the LoRA gradients summed over sp),
    a warm-up and SP_LONG_STEPS timed steps: ms, peak, launches and the
    ring's hops a step. The last step's LoRA gradients (summed over sp) go
    to ``out/long_grads_sp<sp>.pt`` (rank 0 writes them); at sp = 1 one
    more step through the dense route (the same weights, flash off; the
    scores rounded to bf16 as the ring rounds them) gives
    ``out/long_grads_dense.pt``, the spread of two routes without the ring
    and its loss."""
    import torch.nn.functional as F

    from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel
    from msr3d_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV_KERNEL,
        FLASH_BWD_DQ_KERNEL,
        FLASH_FWD_KERNEL,
    )
    from msr3d_tpu_torch.parallel import mesh, ring_attention

    dev = torch.device("cuda", torch.cuda.current_device())
    out.mkdir(parents=True, exist_ok=True)
    sp, t = mesh.sp_size(), SP_LONG_T
    kernels = (FLASH_FWD_KERNEL, FLASH_BWD_DQ_KERNEL, FLASH_BWD_DKV_KERNEL)
    t0 = time.perf_counter()
    llm = LlamaModel(LlamaConfig(num_hidden_layers=SP_LONG_LAYERS, lora_rank=16,
                                 param_dtype=torch.bfloat16, flash_attention=True, sp_size=sp,
                                 sp_rank=mesh.sp_rank()), device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.no_grad():
        for name, p in llm.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    build_s = time.perf_counter() - t0
    names, lora = zip(*((n, p) for n, p in llm.named_parameters() if p.requires_grad))
    embeds = torch.randn((1, t, 4096), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.ones((1, t), dtype=torch.int32, device=dev)
    targets = torch.randint(0, 32000, (1, t), generator=gen, device=dev)
    lo, hi = llm.sp_window(t)

    def step(model=llm, params=lora) -> tuple:
        for p in params:
            p.grad = None
        logits = model(embeds, mask)
        loss = F.cross_entropy(logits.float().flatten(0, 1), targets[0, lo:hi],
                               reduction="sum") / t
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        if sp > 1:  # as TrainStep sums every gradient over sp
            mesh.all_reduce_sum_(flat, group=mesh.sp_group())
            loss = mesh.all_reduce_sum_(loss.detach().reshape(1), group=mesh.sp_group())[0]
        return float(loss.detach()), flat

    step()  # warm-up
    ms, hops = [], []
    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels:
        kernel.launches = 0
    for _ in range(SP_LONG_STEPS):
        calls, nbytes, secs = (ring_attention.COMM[k] for k in ("calls", "bytes", "seconds"))
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss, flat = step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - start))
        hops.append(dict(calls=ring_attention.COMM["calls"] - calls,
                         bytes=ring_attention.COMM["bytes"] - nbytes,
                         seconds=ring_attention.COMM["seconds"] - secs))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    def save(flat, name: str) -> None:
        grads = flat.float().cpu().split([p.numel() for p in lora])
        torch.save({n: g.view(p.shape) for n, g, p in zip(names, grads, lora)},
                   out / f"long_grads_{name}.pt")

    if mesh.rank() == 0:
        save(flat, f"sp{sp}")
    norm, dense_loss = float(flat.float().norm()), None
    if sp == 1:
        del flat
        dense = LlamaModel(dataclasses.replace(llm.cfg, flash_attention=False), device=dev)
        dense.load_state_dict(llm.state_dict())
        dense_loss, flat = step(dense, [p for p in dense.parameters() if p.requires_grad])
        save(flat, "dense")
    return dict(rank=mesh.rank(), sp=sp, window=[lo, hi], ms=ms, hops=hops, loss=loss,
                dense_loss=dense_loss, grad_norm=norm, peak_gib=peak_gib,
                build_s=build_s, launches={k.symbol.replace("_launch", ""): k.launches
                                           for k in kernels})


def sp_exact(out: Path) -> dict:
    return exact_step(out, "sp")


def sp_long_rank(out: str) -> None:
    _rank_main(sp_long, out, {"sp": SP})


def sp_exact_rank(out: str) -> None:
    _rank_main(sp_exact, out, {"sp": SP})


def sp_long_gates(out: Path) -> dict:
    """Phase 21 (b): the long context, one process (flash), then SP ranks
    (the ring); the launches, the loss and every LoRA gradient of sp = SP
    held against sp = 1's."""
    t0 = time.perf_counter()
    one = sp_long(out)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = wait_ranks(spawn_ranks("sp_long_rank", out), out, "sp_long", "b")
    took_b = time.perf_counter() - t0
    for r in [one] + ranks:
        hop = r["hops"][-1]
        print(f"  (b) sp = {r['sp']} rank {r['rank']} (positions {r['window'][0]}.."
              f"{r['window'][1] - 1}): step {' / '.join(f'{x:.1f}' for x in r['ms'])} ms, peak "
              f"{r['peak_gib']:.2f} GiB, loss {r['loss']!r}, LoRA grad norm "
              f"{r['grad_norm']:.6g}, ring hops a step {hop['calls']} "
              f"({hop['bytes'] / 2**20:.1f} MiB, {1e3 * hop['seconds']:.1f} ms), launches over "
              f"the {SP_LONG_STEPS} steps {r['launches']}, built in {r['build_s']:.1f} s")
    layers = SP_LONG_LAYERS * SP_LONG_STEPS
    check(one["launches"] == {"flash_attn_fwd": layers, "flash_attn_bwd_dq": layers,
                              "flash_attn_bwd_dkv": layers},
          "(b) sp = 1 runs K2f, K2dq and K2dkv once a layer and step")
    check(all(r["launches"] == dict.fromkeys(one["launches"], 0) for r in ranks),
          f"(b) sp = {SP} launches no flash kernel (the ring)")
    check(ranks[0]["loss"] == ranks[1]["loss"], "(b) both sp ranks hold the whole loss")
    loss_err = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    print(f"  (b) loss at sp = {SP} against sp = 1, relative {loss_err:.3e} (bf16; the ring "
          f"rounds q·k to bf16 as JAX's ring does, K2f keeps fp32 scores); {took_b:.1f} s")
    check(loss_err <= SP_LONG_RTOL, f"(b) the sp = {SP} loss within {SP_LONG_RTOL} of sp = 1's")
    flash, dense, ring = (torch.load(out / f"long_grads_{name}.pt")
                          for name in ("sp1", "dense", f"sp{SP}"))
    check(sorted(ring) == sorted(flash) == sorted(dense),
          "(b) the gradients name every LoRA tensor")

    def errors(got: dict, want: dict) -> dict:
        """Each LoRA gradient's relative error in norm, and the whole's."""
        rel = {n: float((got[n] - g).double().norm() / g.double().norm()) for n, g in want.items()}
        worst = sorted(rel, key=rel.get, reverse=True)
        whole = math.sqrt(sum(float((got[n] - g).double().square().sum()) for n, g in want.items())
                          / sum(float(g.double().square().sum()) for g in want.values()))
        return dict(max=rel[worst[0]], median=rel[worst[len(rel) // 2]], whole=whole,
                    worst=[(n, f"{rel[n]:.3e}") for n in worst[:3]])

    errs = {"ring against flash": errors(ring, flash), "dense against flash": errors(dense, flash),
            "ring against dense": errors(ring, dense)}
    dense_err = abs(one["dense_loss"] - one["loss"]) / abs(one["loss"])
    print(f"  (b) the {len(flash)} LoRA gradients, relative in norm (a tensor: max, median; "
          f"the whole): " + "; ".join(f"{k} {e['max']:.3e}, {e['median']:.3e}; {e['whole']:.3e}"
                                      for k, e in errs.items())
          + f"; the largest of the ring's {errs['ring against flash']['worst']}; the dense "
          f"route's loss {dense_err:.3e} from flash's")
    grad_err, spread = errs["ring against flash"]["max"], errs["dense against flash"]["max"]
    check(grad_err <= SP_LONG_SPREAD * spread,
          f"(b) every LoRA gradient at sp = {SP} within {SP_LONG_SPREAD:g} x {spread:.3e} (the "
          f"dense route's largest, bf16's spread) relative of sp = 1's")
    return dict(one=one, ranks=ranks, loss_err=loss_err, grad_err=grad_err, spread=spread,
                seconds=took_b)


def phase_sp(exp_root: Path, dp: "dict | None" = None):
    print(f"== phase 21: sequence parallelism at sp = {SP} on one card (two ranks over gloo: (a) "
          f"python -m msr3d_tpu_torch.launch --mode accelerate parallel.sp={SP} on "
          f"configs/msr3d.yaml over phase 10's tree, one step of {N_REQUESTS} x {TRAIN_ACCUM} "
          f"and a val batch of {N_REQUESTS}; (b) the flagship's LLM at {SP_LONG_LAYERS} layers, "
          f"T = {SP_LONG_T}, batch 1, forward and backward at sp = 1 and {SP}; (c) fp32 gates; "
          f"on {card_line()})")
    root = exp_root / "sp"
    exp_a = root / "a"
    summaries, _, took_a = run_launcher(
        ["--mode", "accelerate", "--port", str(free_port()),
         *dp_argv(exp_root, exp_a, f"parallel.sp={SP}", "solver.num_batch_eval=1")], "a")
    print(f"  (a) {took_a:.1f} s (start, build, init, data, one step, val)")
    check([(m["rank"], m["world"], m["backend"], m["dp"], m["tp"], m["pp"], m["sp"],
            m["sp_rank"]) for m in summaries]
          == [(r, SP, "gloo", 1, 1, 1, SP, r) for r in range(SP)],
          f"(a) the launcher started dp 1 x sp {SP} ranks over gloo from parallel.sp={SP}")
    check(all(m["steps"] == 1 for m in summaries), "(a) one optimizer step on each rank")
    results = json.loads((exp_a / "eval" / "msqa_scannet" / "results.json").read_text())
    indices = sorted(str(r["index"]) for r in results)
    check(len(results) == N_REQUESTS and len(set(indices)) == N_REQUESTS,
          f"(a) results.json scores each of the {N_REQUESTS} val samples once (both sp ranks "
          f"generate the batch rank 0 broadcasts; the records gather over dp)")
    metrics = [json.loads(line) for line in (exp_a / "metrics.jsonl").read_text().splitlines()]
    check([m["step"] for m in metrics if "train/loss" in m] == [1]
          and sorted(q.name for q in (exp_a / "ckpt" / "state").iterdir()) == ["1.pt"]
          and (exp_a / "ckpt" / "latest.pt").exists(),
          "(a) metrics.jsonl and the checkpoint written once, by rank 0")
    sp_digests = re.findall(r"agree across \d+ sp ranks after training \(sha256 (\w+)\)",
                            run_launcher.last_out)
    print(f"  (a) the sp replicas' digests after the step: {sp_digests}")
    check(len(sp_digests) == SP and len(set(sp_digests)) == 1,
          f"(a) the ranks' trainable parameters bit-equal after the step ({len(sp_digests)} "
          f"digests, {len(set(sp_digests))} distinct)")
    b18 = dp["b"][0] if dp else dict(peak_gib=float("nan"), step_ms=[float("nan")])
    # K1 in each micro-batch's scene encode and the eval's; K2f in the eval's
    # prefill only: the step's attention is the ring, as in JAX
    want = {"fps": 2 * (TRAIN_ACCUM + 1), "flash_attn_fwd": 32, "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0}
    for m in summaries:
        share = m["step_sp_comm_s"][0] / m["step_ms"][0] * 1e3
        print(f"  (a) rank {m['rank']} (sp rank {m['sp_rank']}): peak {m['peak_gib']:.2f} GiB "
              f"against phase 18 (b)'s {b18['peak_gib']:.2f}, step {m['step_ms'][0]:.1f} ms "
              f"against {b18['step_ms'][0]:.1f}, of it {1e3 * m['step_sp_comm_s'][0]:.1f} ms "
              f"({share:.1%}) in the ring's host-routed hops ({m['sp_comm']['calls']} over the "
              f"run, {m['sp_comm']['bytes'] / 2**30:.3f} GiB, {m['sp_comm']['seconds']:.2f} s); "
              f"data wait {m['data_wait_ms'][0]:.1f} ms; launches {m['launches']}")
        check(m["launches"] == want,
              f"(a) rank {m['rank']} launched K1, K2f, K2dq, K2dkv {want} (no flash kernel in "
              f"the step: {TRAIN_ACCUM} micro-batches through the ring; K2f in the eval's prefill)")

    b = sp_long_gates(root / "b")

    # (c) fp32 gates: two sp ranks against one process, the one process
    # running while the ranks do
    t0 = time.perf_counter()
    out_c = root / "c"
    procs = spawn_ranks("sp_exact_rank", out_c)
    try:
        one_c = sp_exact(out_c)
    finally:  # the ranks end, whatever happened here
        ranks_c = wait_ranks(procs, out_c, "sp_exact", "c")
    want = torch.load(out_c / "exact_grads_sp1.pt")
    got = torch.load(out_c / f"exact_grads_sp{SP}.pt")
    check(sorted(got) == sorted(want), "(c) the gradients name every trainable tensor")
    e = exact_grad_errors(want, got)
    loss_err_c = abs(ranks_c[0]["loss"] - one_c["loss"]) / abs(one_c["loss"])
    print(f"  (c) fp32, {EXACT_LAYERS} layers at the flagship width, sp = {SP} against one "
          f"process: loss {one_c['loss']!r} against {ranks_c[0]['loss']!r}, relative "
          f"{loss_err_c:.3e}; the {len(want)} trainable gradients (whole norm "
          f"{e['whole']:.6g}, summed over sp), max relative (a tensor, in norm) {e['all']:.3e}: "
          f"the {e['n_lora']} LoRA ones' {e['lora']:.3e}, the {e['n_outside']} outside the "
          f"LLM's blocks' (the prompter's, each sp rank's part through its block) "
          f"{e['outside']:.3e}; the largest {e['worst']}; {len(e['noise_names'])} at rounding "
          f"noise {e['noise_names']}, their |diff| / whole norm at most {e['noise']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(ranks_c[0]["loss"] == ranks_c[1]["loss"], "(c) both sp ranks report the same loss")
    check(loss_err_c <= 1e-5 and e["all"] <= 1e-4 and e["noise"] <= PP_GRAD_FLOOR,
          f"(c) the sp = {SP} loss within 1e-5 and every trainable gradient within 1e-4 "
          f"relative of one process's (those at rounding noise within {PP_GRAD_FLOOR:g} of the "
          "whole gradient's norm)")
    return dict(a=summaries, b=b,
                c=dict(loss_err=loss_err_c, grad_err=e["all"], lora_grad_err=e["lora"],
                       noise_grad_err=e["noise"]),
                seconds=dict(a=took_a, b=b["seconds"]))


# ---------------------------------------------------------------------------
# phase 22: the legacy ScanNet grounding, QA and pretraining stack

# 8 scenes of 64 objects, cropped to the wrapper's 60 (dataset_wrapper.py's
# max_obj_len default) x 1024 points x 6, text 80 (scannet_legacy.py's
# num_points, the wrapper's max_seq_len); QAHeadV1's 8864 ScanQA answers
LEGACY_SCANS, LEGACY_OBJECTS, LEGACY_OBJ_LEN, LEGACY_POINTS = 8, 64, 60, 1024
LEGACY_TEXT, LEGACY_ANSWERS, LEGACY_STEPS, N_LEGACY_BATCH = 80, 8864, 3, 8
LEGACY_LOSSES = ["og3d_loss", "txt_cls_loss", "obj_cls_pre_loss", "obj_cls_post_loss",
                 "answer_loss"]
# (c): one fp32 stack on the card and on the CPU, 1 layer a stack at the
# full widths. Both sides take the same fp32 arithmetic (TF32 off) in other
# reduction orders: the losses agree to some 1e-7 relative. Some gradients
# magnify that rounding: q's and k's pass through softmax's Jacobian, a
# difference of nearly equal terms, and a max-pool's backward sends a
# group's gradient to one point, so a near-tie decided the other way moves
# it whole (the card's scatter-adds also sum in a varying order). Each
# tensor is held to LEGACY_GRAD_RTOL of its own norm: over four draws on an
# H100 the worst stood at 9.0e-5 to 6.5e-4 (PointBERT's MiniPointNet conv1a,
# then its q and k), the stack's at 1.3e-6 to 1.0e-4, so the gate is about
# 3x the worst. A fault stands far above it: on the CPU, the fusion's
# padding mask dropped, its token types swapped, the locations one slot off,
# PointBERT's groups not centred, MiniPointNet's max over the wrong axis, or
# a gradient halved (block 0's k path, conv1a) with the forward bit-equal,
# each put a tensor at 0.5 to 2.0. The tensors of
# LEGACY_ZERO_GRADS have a true gradient of 0 by a softmax's shift
# invariance: an attention key bias (q·b_k is the same for every key),
# og3d's last bias and the LayerNorm bias before it (one shift of every
# object's logit), AttFlat's single-glimpse bias (one shift over the
# tokens). Their computed gradient is rounding alone, so each is held, on
# the card and on the CPU, to LEGACY_GRAD_ATOL of its module's whole
# gradient norm (the stack's or PointBERT's), as is a tensor whose CPU
# gradient is exactly 0. A wrong K1 pick is caught by the bit-equality gates
# of (b) and (c).
LEGACY_LOSS_RTOL, LEGACY_GRAD_RTOL, LEGACY_GRAD_ATOL = 1e-5, 2e-3, 1e-6
# (c)'s draws: the weights' seed and the batch's two scenes
LEGACY_DRAWS = ((23, slice(0, 2)), (25, slice(2, 4)), (26, slice(4, 6)))
LEGACY_ZERO_GRADS = re.compile(
    r"\.(k_proj|w_ks)\.bias$|og3d_head\.(norm|fc2)\.bias$|attflat_\w+\.mlp\.linear\.bias$")


def legacy_names(n: int):
    """Instance names of a phase-22 scan: 0 a chair (ScanRefer's target), 1
    a table (Nr3D's and ScanQA's), two background objects that the datasets
    drop, the rest mixed, so that the grounding datasets crop 62 objects to
    59."""
    cycle = ["lamp", "sofa", "chair", "table", "sofa", "lamp", "table", "chair"]
    names = ["chair", "table"] + [cycle[i % len(cycle)] for i in range(n - 2)]
    names[10], names[20] = "wall", "floor"
    return names


def write_pred_csr(base: Path, scan_id: str, inst: np.ndarray, rng) -> int:
    """The predicted masks of one scan as ``scipy.sparse.save_npz`` writes a
    CSR matrix, but written with numpy: each of the first 50 instances with a
    random 80% of its points, then its label. Returns the mask count."""
    n_inst = min(50, int(inst.max()) + 1)
    rows = [np.flatnonzero((inst == i) & (rng.random(inst.shape[0]) < 0.8))
            for i in range(n_inst)]
    indptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int32)
    (base / "mask").mkdir(exist_ok=True)
    np.savez_compressed(base / "mask" / f"{scan_id}.mask.npz", format=np.bytes_(b"csr"),
                        shape=np.array([n_inst, inst.shape[0]]),
                        data=np.ones(int(indptr[-1]), np.int8),
                        indices=np.concatenate(rows).astype(np.int32), indptr=indptr)
    np.save(base / "mask" / f"{scan_id}.label.npy", rng.integers(0, 7, n_inst))
    return n_inst


def legacy_tree(root: Path):
    """The synthetic legacy tree of phase 22 (scans, legacy annotations,
    multi-view info, predicted masks) and its port config."""
    from msr3d_tpu_torch.config import config_from_dict
    from msr3d_tpu_torch.data import synthetic

    shutil.rmtree(root, ignore_errors=True)
    scans = [f"scene{i:04d}_00" for i in range(LEGACY_SCANS)]
    rng = np.random.default_rng(22)
    base = synthetic.build_scannet_tree(root, rng, scan_ids=scans, n_objects=LEGACY_OBJECTS)
    synthetic.build_legacy_annotations(base, scans)
    synthetic.build_multiview_tree(base, scans)
    for scan_id in scans:
        (base / "scan_data" / "instance_id_to_name" / f"{scan_id}.json").write_text(
            json.dumps(legacy_names(LEGACY_OBJECTS)))
        inst = torch.load(base / "scan_data" / "pcd_with_global_alignment" / f"{scan_id}.pth",
                          weights_only=False)[-1].numpy()
        write_pred_csr(base, scan_id, inst, rng)
    d = synthetic.mv_config_dict(base)
    # the grounding datasets keep max_obj_len - 1 objects: the last of the
    # wrapper's slots is the "no target" index
    common = dict(max_obj_len=LEGACY_OBJ_LEN, num_points=LEGACY_POINTS,
                  max_seq_len=LEGACY_TEXT)
    for task in ("scanrefer", "referit3d", "spatialrefer", "scanqa"):
        d["data"][task]["args"].update(common)
    d["data"]["scanrefer"]["args"]["pc_type"] = "pred"  # its val split
    d["data"]["pretrain"]["args"].update(max_obj_len=LEGACY_OBJ_LEN, num_points=LEGACY_POINTS)
    d["data"]["scannet_sgqa"]["args"].update(max_obj_len=LEGACY_OBJ_LEN,
                                             num_points=LEGACY_POINTS)
    d["data"]["mvreferit3d"]["args"]["max_obj_len"] = LEGACY_OBJ_LEN
    return base, config_from_dict(d)


def legacy_batches(cfg):
    """(a): one micro-batch of 8 from each dataset through its wrapper, and
    the ms each took on the host (items and collate)."""
    from msr3d_tpu_torch.data.datasets import dataset_wrapper as dw
    from msr3d_tpu_torch.data.datasets import scannet_legacy as sl
    from msr3d_tpu_torch.data.datasets import scannet_mv as mv

    args = {"max_seq_len": LEGACY_TEXT, "max_obj_len": LEGACY_OBJ_LEN}
    plan = {
        "scanrefer_train_gt": (sl.ScanNetScanRefer, "train", dw.ScanFamilyDatasetWrapper),
        "scanrefer_val_pred": (sl.ScanNetScanRefer, "val", dw.ScanFamilyDatasetWrapper),
        "scanqa_train": (sl.ScanNetScanQA, "train", dw.ScanFamilyDatasetWrapper),
        "sgqa_train": (sl.ScanNetSGQA, "train", dw.LeoScanFamilyDatasetWrapper),
        "pretrain_mask": (sl.ScanNetPretrain, "train", dw.MaskDatasetWrapper),
        "mv_referit3d": (mv.ScanNetMVReferit3D, "train", dw.ScanFamilyDatasetWrapper),
    }
    random.seed(22)
    np.random.seed(22)
    batches, ms, datasets = {}, {}, {}
    for name, (cls, split, wrapper) in plan.items():
        ds = cls(cfg, split)
        w = wrapper(cfg, ds, args)
        t0 = time.perf_counter()
        batches[name] = w.collate_fn([w[i] for i in range(N_LEGACY_BATCH)])
        ms[name] = (time.perf_counter() - t0) * 1e3
        datasets[name] = ds
    return batches, ms, datasets



def legacy_modules(dev, layers: "int | None" = None, seed: int = 22):
    """The stack at the JAX modules' own widths (``layers`` cuts each stack's
    depth for (c)): PointTokenizeEncoder, BERTLanguageEncoder,
    UnifiedSpatialCrossEncoderV2, GroundHeadV1, QAHeadV1; then PointBERT."""
    from msr3d_tpu_torch.nn.grounding import (BERTLanguageEncoder, GroundHeadV1, QAHeadV1,
                                              UnifiedSpatialCrossEncoderV2)
    from msr3d_tpu_torch.nn.pcd_tokenize import PointTokenizeEncoder
    from msr3d_tpu_torch.nn.pointbert import PointBERTPcdObjEncoder

    torch.manual_seed(seed)
    deep = {} if layers is None else {"num_layers": layers}
    stack = torch.nn.ModuleDict(dict(
        enc=PointTokenizeEncoder(**deep),
        bert=BERTLanguageEncoder(**({} if layers is None else {"num_hidden_layers": layers})),
        fusion=UnifiedSpatialCrossEncoderV2(**deep),
        ground=GroundHeadV1(sem_cls_size=607),
        qa=QAHeadV1(num_answers=LEGACY_ANSWERS)))
    pointbert = PointBERTPcdObjEncoder(**({} if layers is None else {"depth": layers}))
    return stack.to(dev), pointbert.to(dev)


def legacy_inputs(batch, answers, dev, rows=None):
    """The step's tensors from a ScanRefer batch and a ScanQA answer
    multi-hot padded to LEGACY_ANSWERS."""
    keys = ["obj_fts", "obj_locs", "obj_masks", "obj_sem_masks", "obj_labels", "obj_boxes",
            "txt_ids", "txt_masks", "tgt_object_id", "tgt_object_label"]
    rows = slice(None) if rows is None else rows
    out = {k: torch.from_numpy(np.ascontiguousarray(batch[k][rows])).to(dev) for k in keys}
    ans = np.zeros((len(batch["txt_ids"][rows]), LEGACY_ANSWERS), np.int64)
    a = answers[rows]
    ans[:, :a.shape[1]] = a
    out["answer_label"] = torch.from_numpy(ans).to(dev)
    out["obj_labels_ce"] = out["obj_labels"].clamp_min(0)
    return out


def legacy_forward(stack, b, generator=None):
    """encoder → BERT → fusion → heads: the loss dict of ``get_losses``."""
    obj, obj_pre, _ = stack["enc"](b["obj_fts"], b["obj_locs"], b["obj_masks"],
                                   b["obj_sem_masks"], b["obj_labels"], generator=generator)
    txt = stack["bert"](b["txt_ids"], b["txt_masks"], generator=generator)
    txt, obj = stack["fusion"](txt, b["txt_masks"], obj, b["obj_locs"], b["obj_masks"],
                               generator=generator)
    txt_cls, obj_cls, obj_cls_pre, og3d = stack["ground"](txt, obj, obj_pre, b["obj_masks"],
                                                          generator=generator)
    scores = stack["qa"](obj, b["obj_masks"], txt, b["txt_masks"], generator=generator)
    return {"og3d_logits": og3d, "txt_cls_logits": txt_cls, "obj_cls_post_logits": obj_cls,
            "obj_cls_pre_logits": obj_cls_pre, "answer_scores": scores,
            "tgt_object_id": b["tgt_object_id"], "tgt_object_label": b["tgt_object_label"],
            "obj_labels": b["obj_labels_ce"], "obj_masks": b["obj_masks"],
            "answer_label": b["answer_label"]}


def legacy_optimizers(stack):
    """AdamW over the stack with the legacy no-decay mask: two groups."""
    from msr3d_tpu_torch.optim.build import AdamW
    from msr3d_tpu_torch.optim.losses import no_decay_mask

    named = dict(stack.named_parameters())
    mask = no_decay_mask(stack)
    return [AdamW({k: p for k, p in named.items() if mask[k] == decays}, lambda step: 1e-4,
                  weight_decay=0.05 if decays else 0.0) for decays in (True, False)]


def legacy_eval(stack, batch, ds):
    """The eval forward on the ``pred`` val batch: og3d's pick scored by
    ``eval_ref_one_sample`` against the target's gt box."""
    from msr3d_tpu_torch.data.box_utils import (construct_bbox_corners, convert_pc_to_box,
                                                eval_ref_one_sample)

    dev = next(stack.parameters()).device
    b = legacy_inputs(batch, np.zeros((len(batch["txt_ids"]), 1), np.int64), dev)
    stack.eval()
    with torch.no_grad():
        og3d = legacy_forward(stack, b)["og3d_logits"]
    picks = og3d.argmax(dim=1).cpu().numpy()
    ious = []
    for i, pick in enumerate(picks):
        item = ds.lang_data[i]
        gt = convert_pc_to_box(ds._scan(item["scan_id"])["obj_pcds"][int(item["target_id"])])
        box = batch["obj_boxes"][i, pick]
        ious.append(eval_ref_one_sample(construct_bbox_corners(box[:3], box[3:]),
                                        construct_bbox_corners(*gt)))
    ious = np.asarray(ious)
    finite = bool(torch.isfinite(og3d[b["obj_masks"]]).all())
    return dict(acc25=float((ious >= 0.25).mean()), acc50=float((ious >= 0.5).mean()),
                finite=finite, picks=picks.tolist())


def legacy_picks(clouds):
    """The main path's K1 calls over the batch's object clouds (B·O, P, 3):
    npoint 32, then 16 over those 32 (PointTokenizeEncoder's PointNet++
    stages), 64 (PointBERT's GroupDivider), and the kNN of those 64 centers
    (PointBERT's groups of 32). A CUDA tensor launches K1, a CPU one runs
    the plain version. Returned on the CPU."""
    from msr3d_tpu_torch.nn.pointbert import knn_point
    from msr3d_tpu_torch.ops.pointnet2 import fps, gather_points

    p32 = fps(clouds, 32)
    p64 = fps(clouds, 64)
    out = {32: p32, 16: fps(gather_points(clouds, p32), 16), 64: p64,
           "knn": knn_point(32, clouds, gather_points(clouds, p64))}
    return {k: v.cpu() for k, v in out.items()}


def legacy_grad_errors(want: dict, got: dict) -> dict:
    """(c)'s gate over one module's gradients by name (``want`` the CPU's,
    ``got`` the card's): each tensor's ‖got − want‖ / ‖want‖, held to
    LEGACY_GRAD_RTOL; a tensor of LEGACY_ZERO_GRADS, or one whose CPU
    gradient is exactly 0, is held instead on both sides to LEGACY_GRAD_ATOL
    of the module's whole gradient norm (``noise``: the larger share)."""
    whole = math.sqrt(sum(float(w.double().square().sum()) for w in want.values()))
    zero = sorted(n for n, w in want.items() if LEGACY_ZERO_GRADS.search(n) or not w.any())
    rel = {n: float((got[n] - w).norm() / w.norm()) for n, w in want.items() if n not in zero}
    noise = max((max(float(want[n].norm()), float(got[n].norm())) / whole for n in zero),
                default=0.0)
    worst = sorted(rel, key=rel.get, reverse=True)[:3]
    return dict(whole=whole, rel=rel, worst={n: rel[n] for n in worst}, max=rel[worst[0]],
                zero=zero, noise=noise,
                ok=rel[worst[0]] <= LEGACY_GRAD_RTOL and noise <= LEGACY_GRAD_ATOL)


def legacy_exact(stack_cpu, pointbert_cpu, b_cpu, dev):
    """(c): the same fp32 stack (1 layer a stack) and batch of 2 on the card
    and on the CPU: K1's picks and the kNN over the batch's clouds on the
    card against the CPU's plain versions, the losses and every gradient."""
    from msr3d_tpu_torch.ops.pointnet2 import gather_points
    from msr3d_tpu_torch.optim.losses import get_losses

    clouds = b_cpu["obj_fts"].reshape(-1, LEGACY_POINTS, 6)[..., :3].contiguous()
    want, got = legacy_picks(clouds), legacy_picks(clouds.to(dev))
    k1_equal = all(torch.equal(got[m], want[m]) for m in (32, 16, 64))
    differ = got["knn"] != want["knn"]
    d2 = ((gather_points(clouds, want[64])[:, :, None, :] - clouds[:, None, :, :]) ** 2).sum(-1)
    tie = d2.gather(2, got["knn"].long()) == d2.gather(2, want["knn"].long())
    runs = {}
    for where, (stack, pointbert) in {
            "cpu": (stack_cpu, pointbert_cpu),
            "card": (copy.deepcopy(stack_cpu).to(dev), copy.deepcopy(pointbert_cpu).to(dev))
    }.items():
        b = {k: v.to(next(stack.parameters()).device) for k, v in b_cpu.items()}
        stack.eval()
        pointbert.eval()
        loss, losses = get_losses(legacy_forward(stack, b), LEGACY_LOSSES, LEGACY_LOSSES)
        emb = pointbert(b["obj_fts"])[0]
        (loss + (emb * torch.linspace(-1, 1, emb.shape[-1], device=emb.device)).mean()
         ).backward()
        runs[where] = dict(losses={k: v.item() for k, v in losses.items()}, emb=emb.detach().cpu(),
                           grads={name: {n: p.grad.detach().cpu()
                                         for n, p in module.named_parameters()
                                         if p.grad is not None}
                                  for name, module in (("stack", stack),
                                                       ("pointbert", pointbert))})
    cpu, card = runs["cpu"], runs["card"]
    same_grads = all(set(cpu["grads"][m]) == set(card["grads"][m]) for m in cpu["grads"])
    check(same_grads, "(c) the card's gradients name the CPU's tensors")
    loss_err = max(abs(card["losses"][k] - v) / max(abs(v), 1e-30)
                   for k, v in cpu["losses"].items())
    grads = {m: legacy_grad_errors(cpu["grads"][m], card["grads"][m]) for m in cpu["grads"]}
    emb_err = ((card["emb"] - cpu["emb"]).norm() / cpu["emb"].norm()).item()
    return dict(k1_equal=k1_equal, k1_clouds=int(clouds.shape[0]), knn_diff=int(differ.sum()),
                knn_ties=int((differ & tie).sum()), loss_rel_err=loss_err, grads=grads,
                pointbert_rel_err=emb_err, losses=cpu["losses"])


def phase_legacy(exp_root: Path, dev=None):
    dev = dev or torch.device("cuda", 0)
    print(f"== phase 22: the legacy ScanNet grounding/QA stack ((a) {LEGACY_SCANS} synthetic "
          f"scans of {LEGACY_OBJECTS} objects, predicted masks, a micro-batch of "
          f"{N_LEGACY_BATCH} from six datasets; (b) PointTokenizeEncoder + BERT + "
          f"UnifiedSpatialCrossEncoderV2 + GroundHeadV1 + QAHeadV1 at 768, {N_LEGACY_BATCH} x "
          f"{LEGACY_OBJ_LEN} x {LEGACY_POINTS} x 6, text {LEGACY_TEXT}, {LEGACY_STEPS} AdamW "
          f"steps, the pred val batch scored, PointBERT forward and backward; (c) fp32 gates; "
          f"on {card_line()})")
    from msr3d_tpu_torch.data.scan_loader import ScanCache
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL, furthest_point_sample
    from msr3d_tpu_torch.optim.losses import get_losses

    t0 = time.perf_counter()
    base, cfg = legacy_tree(exp_root / "legacy")
    ScanCache.clear()
    batches, batch_ms, datasets = legacy_batches(cfg)
    print(f"  (a) tree written in {time.perf_counter() - t0:.1f} s; a batch of "
          f"{N_LEGACY_BATCH} (items + collate, host ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in batch_ms.items()))
    train, val = batches["scanrefer_train_gt"], batches["scanrefer_val_pred"]
    check(train["obj_fts"].shape == (N_LEGACY_BATCH, LEGACY_OBJ_LEN, LEGACY_POINTS, 6)
          and train["txt_ids"].shape == (N_LEGACY_BATCH, LEGACY_TEXT)
          and bool((train["obj_masks"].sum(1) == LEGACY_OBJ_LEN - 1).all()),
          f"(a) ScanRefer train: {LEGACY_OBJ_LEN} object slots a scene ({LEGACY_OBJECTS} "
          f"objects, 62 not background, cropped to {LEGACY_OBJ_LEN - 1}) x {LEGACY_POINTS} x 6, "
          f"text {LEGACY_TEXT}")
    n_pred = val["obj_masks"].sum(1)
    check(bool(((n_pred > 0) & (n_pred <= 50)).all())
          and bool((val["tgt_object_id_iou25"].sum(1) >= 1).all()),
          f"(a) ScanRefer val over the predicted masks: {int(n_pred.min())}-{int(n_pred.max())} "
          "objects a scene, each target matched at IoU >= 0.25")
    pre = batches["pretrain_mask"]
    check(bool((pre["masked_lm_labels"] != -1).any()) and not bool(pre["obj_sem_masks"].all())
          and batches["scanqa_train"]["answer_label"].sum() > 0
          and batches["sgqa_train"]["obj_fts"].shape[1] == LEGACY_OBJ_LEN
          and batches["mv_referit3d"]["obj_fts"].shape[-1] == 16,
          "(a) MaskDatasetWrapper masked words and objects; ScanQA answers; SGQA and the "
          "multi-view Referit3D batches padded")

    # (b) the stack at the JAX modules' widths
    stack, pointbert = legacy_modules(dev)
    b = legacy_inputs(train, batches["scanqa_train"]["answer_label"], dev)
    opts = legacy_optimizers(stack)
    gen = torch.Generator(device=dev).manual_seed(22)
    torch.cuda.reset_peak_memory_stats(dev)
    stack.train()
    FPS_KERNEL.launches = 0
    step_ms, step_losses = [], []
    for _ in range(LEGACY_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, losses = get_losses(legacy_forward(stack, b, gen), LEGACY_LOSSES, LEGACY_LOSSES)
        stack.zero_grad(set_to_none=True)
        loss.backward()
        named = dict(stack.named_parameters())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        for opt in opts:
            opt.step({k: grads[k] for k in opt.params})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        step_losses.append({k: v.item() for k, v in losses.items()})
    tokenize_launches = FPS_KERNEL.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = statistics.median(step_ms[1:])
    print(f"  (b) {LEGACY_STEPS} AdamW steps: {', '.join(f'{t:.1f}' for t in step_ms)} ms "
          f"(median of 2-3 {ms:.1f} ms), peak {peak:.2f} GiB, K1 {tokenize_launches}; losses "
          + ", ".join(f"{k} {step_losses[0][k]:.4f} -> {step_losses[-1][k]:.4f}"
                      for k in LEGACY_LOSSES + ["total_loss"]))
    check(tokenize_launches == 2 * LEGACY_STEPS,
          "(b) K1 launched by PointTokenizeEncoder's two SA stages in each step")
    check(all(math.isfinite(v) for s in step_losses for v in s.values()),
          "(b) every loss finite")
    FPS_KERNEL.launches = 0
    scores = legacy_eval(stack, val, datasets["scanrefer_val_pred"])
    eval_launches = FPS_KERNEL.launches
    print(f"  (b) eval on the pred val batch: acc@0.25 {scores['acc25']:.3f}, acc@0.5 "
          f"{scores['acc50']:.3f} (random weights), K1 {eval_launches}")
    check(scores["finite"] and eval_launches == 2 and 0 <= scores["acc25"] <= 1,
          "(b) the eval forward's og3d logits finite over the real objects, K1 twice")
    del opts, grads, named, stack
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    FPS_KERNEL.launches = 0
    pointbert.train()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    emb = pointbert(b["obj_fts"])[0]
    (emb * torch.linspace(-1, 1, emb.shape[-1], device=dev)).mean().backward()
    torch.cuda.synchronize()
    pb_ms = (time.perf_counter() - t1) * 1e3
    pb_launches = FPS_KERNEL.launches
    pb_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"  (b) PointBERT (384, depth 12, 64 groups x 32) forward and backward over "
          f"{tuple(b['obj_fts'].shape)}: {pb_ms:.1f} ms, peak {pb_peak:.2f} GiB, K1 {pb_launches}")
    check(pb_launches == 1 and emb.shape == (N_LEGACY_BATCH, LEGACY_OBJ_LEN, 768)
          and bool(torch.isfinite(emb).all())
          and all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  for p in pointbert.parameters()),
          "(b) PointBERT's GroupDivider launched K1 once; embeddings and gradients finite")
    clouds = b["obj_fts"].reshape(-1, LEGACY_POINTS, 6)[..., :3].contiguous()
    got, want = legacy_picks(clouds), legacy_picks(clouds.cpu())
    check(all(torch.equal(got[m], want[m]) for m in (32, 16, 64)),
          f"(b) K1's picks over the main path's {clouds.shape[0]} clouds of {LEGACY_POINTS} "
          "(npoint 32, 16 over those 32, 64) bit-equal to the plain version's")
    k1_ms = device_ms(lambda: furthest_point_sample(clouds, 64), iters=20)
    k1_bound, k1_by = fps_bound((clouds, 64))
    print(f"  K1 at PointBERT's shape, {clouds.shape[0]}x{LEGACY_POINTS}->64: {k1_ms:.5f} ms of "
          f"device time a launch, bound {k1_bound:.6f} ms ({k1_by})")
    del pointbert, emb, b
    torch.cuda.empty_cache()

    print(f"  (a) and (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # (c) exactness: 1 layer a stack, batch 2, on the card and on the CPU
    exact = []
    for seed, rows in LEGACY_DRAWS:
        t1 = time.perf_counter()
        stack_c, pointbert_c = legacy_modules(torch.device("cpu"), layers=1, seed=seed)
        b_cpu = legacy_inputs(train, batches["scanqa_train"]["answer_label"], "cpu", rows=rows)
        ex = legacy_exact(stack_c, pointbert_c, b_cpu, dev)
        exact.append(ex)
        print(f"  (c) seed {seed}, scenes {rows.start}-{rows.stop - 1}: K1 over {ex['k1_clouds']} "
              f"clouds (npoint 32, 16, 64) bit-equal to the CPU's: {ex['k1_equal']}; kNN "
              f"entries that differ {ex['knn_diff']}, of them distance ties {ex['knn_ties']}; "
              f"losses within {ex['loss_rel_err']:.3e} relative; PointBERT embeddings "
              f"{ex['pointbert_rel_err']:.3e}; "
              + "; ".join(f"{m}: {len(e['rel'])} gradients, the worst relative in norm "
                          + ", ".join(f"{n} {v:.3e}" for n, v in e["worst"].items())
                          + f", the median {statistics.median(e['rel'].values()):.3e}; "
                          f"{len(e['zero'])} at rounding noise {e['zero']}, at most "
                          f"{e['noise']:.3e} of the whole norm {e['whole']:.6g}"
                          for m, e in ex["grads"].items())
              + f" ({time.perf_counter() - t1:.1f} s)")
    print(f"  (c) took {time.perf_counter() - t0:.1f} s")
    check(all(ex["k1_equal"] for ex in exact),
          "(c) K1's picks at npoint 32, 16 and 64 bit-equal to the CPU's plain version's")
    check(all(ex["knn_diff"] == ex["knn_ties"] for ex in exact),
          "(c) PointBERT's kNN equal to the CPU's but for distance ties")
    check(all(ex["loss_rel_err"] <= LEGACY_LOSS_RTOL and ex["pointbert_rel_err"] <= LEGACY_LOSS_RTOL
              for ex in exact),
          f"(c) the five losses and PointBERT's embeddings within {LEGACY_LOSS_RTOL} relative "
          "of the CPU's")
    check(all(e["ok"] for ex in exact for e in ex["grads"].values()),
          f"(c) every gradient within {LEGACY_GRAD_RTOL} of the CPU's in norm (those at "
          f"rounding noise within {LEGACY_GRAD_ATOL} of their module's whole gradient norm)")
    ScanCache.clear()
    shutil.rmtree(exp_root / "legacy", ignore_errors=True)
    return dict(batch_ms=batch_ms, step_ms=ms, step_ms_all=step_ms, peak_gib=peak,
                losses=step_losses, launches_tokenize=tokenize_launches,
                launches_eval=eval_launches, launches_pointbert=pb_launches,
                pointbert_ms=pb_ms, pointbert_peak_gib=pb_peak, acc25=scores["acc25"],
                acc50=scores["acc50"], k1_ms_npoint64=k1_ms, k1_bound_ms_npoint64=k1_bound,
                k1_clouds=int(clouds.shape[0]), exact=exact)


# ---------------------------------------------------------------------------
# phase 23: multi-view reconstruction (NMR -> SRT) and the sparse-voxel stack
# (host geometry plans, Swin3D, SoftGroup). JAX computes all of it with plain
# XLA, so the path launches none of K1-K4

# (a) NMR's layout, the 13-class ShapeNet renders SRT trains on: 32 scenes
# (8 classes x 4) of 24 views of 64² RGBA, a batch of 32 train items of 8192
# target rays each; SRTEncoder and SRTDecoder at their defaults (768 wide)
NMR_CLASSES_USED, NMR_SCENES_PER_CLASS, NMR_VIEWS, NMR_SIZE = 8, 4, 24, 64
NMR_RAYS, NMR_BATCH = 8192, 32
NMR_KEYS = ("input_images", "input_camera_pos", "input_rays", "target_images",
            "target_camera_pos", "target_rays")
# (b) Swin3D-S of Yang et al., Swin3D (2023), for ScanNet segmentation, over
# two rooms of build_room_scene (8 x 8 x 3 m, ~100 000 voxels of 2 cm each)
SWIN3D_S = dict(depths=[2, 4, 9, 4, 4], channels=[48, 96, 192, 384, 384],
                num_heads=[6, 6, 12, 24, 24], window_sizes=[5, 7, 7, 7, 7], quant_size=4,
                num_layers=5, num_classes=13, stem_transformer=True, upsample="linear_attn",
                down_stride=3, up_k=3)
# (c) SoftGroup's grouping over the boxes' voxels: ball radius 2 voxels (its
# 0.04 m at 2 cm), components of at least 100 voxels, mask IoU threshold 0.5
SG_RADIUS, SG_MIN_VOXELS, SG_IOU_THR = 2.0, 100, 0.5
# (d) the same modules at small widths, on the card and on the CPU with the
# same weights and inputs (fp32, TF32 off): outputs within P23_OUT_RTOL
# relative L2 (other summation orders, some 1e-7 a sum, through a few
# layers); each gradient within P23_GRAD_RTOL of its own norm, those that are
# 0 in exact arithmetic (a key bias under the softmax, a bias that shifts
# every row before a training BatchNorm) within P23_GRAD_RTOL of the largest;
# running statistics within P23_STATS_RTOL relative L2; each octave of the
# ray encodings within P23_ENC_ATOL (the same fp32 arguments, up to ~1e5, in
# sinf and the CPU's sin); the restructured cRSE against its literal formula
# on the card within P23_CRSE_RTOL; SoftGroup's counts and labels equal, its
# means and IoUs within P23_IOU_ATOL
SRT_SMALL = dict(num_att_blocks=1, hidden_dim=64, num_heads=4, mlp_dim=128)
SWIN_SMALL = dict(depths=[1, 1, 1], channels=[16, 24, 32], num_heads=[2, 2, 2],
                  window_sizes=[5, 5, 5], quant_size=4, num_layers=3, num_classes=13,
                  stem_transformer=True, upsample="linear_attn", down_stride=2, up_k=3)
P23_OUT_RTOL, P23_GRAD_RTOL, P23_STATS_RTOL = 1e-4, 1e-3, 1e-4
P23_ENC_ATOL, P23_CRSE_RTOL, P23_IOU_ATOL = 1e-5, 1e-5, 1e-6
# SoftGroup's means (voxels, and the clusters' pools over ~10 000 voxels):
# fp32 sums in another order, relative to the largest value (call 2: 5.0e-06)
P23_MEAN_RTOL = 2e-5


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def grad_errors(card, cpu, zero_in_exact=()) -> dict:
    """Each parameter's gradient on the card against the CPU's: relative to
    its own norm, or to the largest norm for the ``zero_in_exact`` names."""
    want = {n: p.grad.double() for n, p in cpu.named_parameters()}
    largest = max(float(g.norm()) for g in want.values())
    out = {}
    for n, p in card.named_parameters():
        ref = largest if n in zero_in_exact else max(float(want[n].norm()), 1e-30)
        out[n] = float((p.grad.double().cpu() - want[n]).norm()) / ref
    return out


def median_ms(fn, n: int = 3) -> float:
    return statistics.median(wall_ms(fn) for _ in range(n))


def srt_reckon_gib(rows: int, hidden: int = 768) -> float:
    """fp32 activations the backward keeps a query row: the input MLP (180 +
    360), two cross-attention blocks (five 180-wide tensors, 12 heads x 16
    patch weights, the FFN's 2·hidden pre-gelu and post-gelu), the render
    MLP (four 2·hidden ReLU outputs) and the sigmoid's 3."""
    floats = 180 + 360 + 2 * (5 * 180 + 12 * 16 + 2 * 2 * hidden) + 4 * 2 * hidden + 3
    return rows * 4 * floats / 2**30


def nmr_batch(root: Path, n: int, rays: int, seed: int):
    """``n`` train items of ``NMRMVRecon`` over ``root``, stacked (numpy), and
    the host ms an item."""
    from msr3d_tpu_torch import registry
    from msr3d_tpu_torch.config import config_from_dict
    from msr3d_tpu_torch.data import build as _data_build  # noqa: F401 (registers NMR)
    from msr3d_tpu_torch.data.synthetic import nmr_config_dict

    cfg = config_from_dict(nmr_config_dict(root, rays, NMR_VIEWS))
    ds = registry.DATASET_REGISTRY.get("NMRMVRecon")(cfg, "train")
    random.seed(seed)
    np.random.seed(seed)
    t0 = time.perf_counter()
    items = [ds[i] for i in range(n)]
    item_ms = (time.perf_counter() - t0) * 1e3 / n
    return {k: np.stack([it[k] for it in items]) for k in NMR_KEYS}, item_ms


def srt_modules(dev, **kw):
    from msr3d_tpu_torch import registry
    from msr3d_tpu_torch.nn import build as _nn_build  # noqa: F401 (registers SRT)

    enc = registry.VISION_REGISTRY.get("SRTEncoder")(device=dev, **kw).eval()
    dec_kw = {"hidden_dim": kw["hidden_dim"]} if kw else {}
    dec = registry.HEADS_REGISTRY.get("SRTDecoder")(device=dev, **dec_kw).eval()
    return enc, dec


def srt_loss(enc, dec, b):
    """The reference's SRT objective, composed here: the mean squared error
    of the rendered target rays to their pixels → (loss, pixels)."""
    z = enc(b["input_images"], b["input_camera_pos"], b["input_rays"])
    pix = dec(z, b["target_camera_pos"], b["target_rays"])
    return ((pix - b["target_images"]) ** 2).mean(), pix


def nmr_srt_run(root: Path, dev) -> dict:
    from msr3d_tpu_torch.data.synthetic import build_nmr_tree

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    build_nmr_tree(root, np.random.default_rng(23), n_classes=NMR_CLASSES_USED,
                   scenes_per_class=NMR_SCENES_PER_CLASS, n_views=NMR_VIEWS, size=NMR_SIZE)
    write_s = time.perf_counter() - t0
    batch, item_ms = nmr_batch(root, NMR_BATCH, NMR_RAYS, 23)
    check(batch["input_images"].shape == (NMR_BATCH, 1, NMR_SIZE, NMR_SIZE, 3)
          and batch["target_rays"].shape == (NMR_BATCH, NMR_RAYS, 3)
          and np.allclose(np.linalg.norm(batch["target_rays"], axis=-1), 1.0, atol=1e-5),
          f"(a) {NMR_BATCH} NMR items: one input view of {NMR_SIZE}² and {NMR_RAYS} unit "
          f"target rays each ({item_ms:.1f} host ms an item, {NMR_VIEWS} PNGs read by "
          f"data/png.py; "
          f"tree written in {write_s:.1f} s)")
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    torch.manual_seed(23)
    enc, dec = srt_modules(dev)
    with torch.no_grad():
        srt_loss(enc, dec, b)
        fwd_ms = median_ms(lambda: srt_loss(enc, dec, b))
        loss0, pix = srt_loss(enc, dec, b)
    check(pix.shape == (NMR_BATCH, NMR_RAYS, 3) and bool(((pix > 0) & (pix < 1)).all())
          and bool(torch.isfinite(loss0)),
          f"(a) SRTEncoder (768, 5 layers, {NMR_SIZE}² → {NMR_SIZE // 16}² patches) → "
          f"SRTDecoder: "
          f"{NMR_BATCH} x {NMR_RAYS} pixels in (0, 1), MSE {float(loss0):.4f}")

    def step():
        enc.zero_grad(set_to_none=True)
        dec.zero_grad(set_to_none=True)
        loss, _ = srt_loss(enc, dec, b)
        loss.backward()

    step()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = median_ms(step)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    grads = {n: p.grad for m in (enc, dec) for n, p in m.named_parameters()}
    zero = [n for n, g in grads.items() if g is None or not bool((g != 0).any())]
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
          and all(n.endswith("k_proj.bias") for n in zero),
          f"(a) the MSE's backward reaches all {len(grads)} parameters of both modules with "
          f"finite gradients, nonzero but for the {len(zero)} key projections' biases (0 "
          "under the softmax)")
    reckon = srt_reckon_gib(NMR_BATCH * NMR_RAYS)
    print(f"  (a) forward {fwd_ms:.1f} ms, forward + backward {step_ms:.1f} ms (median of 3), "
          f"peak {peak:.2f} GiB (reckoned {reckon:.1f} GiB of activations for "
          f"{NMR_BATCH * NMR_RAYS} rows)")
    return dict(item_ms=item_ms, fwd_ms=fwd_ms, fwd_bwd_ms=step_ms, peak_gib=peak,
                reckon_gib=reckon, write_s=write_s)


def stage_shapes(plans) -> list:
    """(W, K) of the plain and the shifted windows of every stage."""
    return [{name: list(st[name]["windows"].shape) for name in ("win", "win_shift")}
            for st in plans["stages"]]


def step_kernels(fn, top: int = 6):
    """One call of ``fn`` under ``torch.profiler``: its ``top`` kernels by
    device time (ms, launches, name) and the device ms of all of them."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(kernel_rows(prof), reverse=True)
    return rows[:top], sum(ms for ms, _, _ in rows)


def timed_prepare(enc, record: dict):
    """``enc.prepare`` that records its host ms and its result."""
    prepare = enc.prepare

    def run(feats, xyz):
        t0 = time.perf_counter()
        out = prepare(feats, xyz)
        record.update(ms=(time.perf_counter() - t0) * 1e3, out=out)
        return out

    return run


def swin3d_run(dev):
    from msr3d_tpu_torch import registry
    from msr3d_tpu_torch.config import config_from_dict
    from msr3d_tpu_torch.data.synthetic import build_room_scene
    from msr3d_tpu_torch.nn import build as _nn_build  # noqa: F401 (registers the adapter)
    from msr3d_tpu_torch.nn.swin3d import plans_to_torch

    rooms = [build_room_scene(np.random.default_rng(seed)) for seed in (0, 1)]
    xyz = np.concatenate([np.concatenate([r[0], np.full((len(r[0]), 1), b, np.float32)], 1)
                          for b, r in enumerate(rooms)])
    colors = np.concatenate([r[1] for r in rooms])
    torch.manual_seed(23)
    enc = registry.build_module("vision", config_from_dict(
        {"name": "PCDSwin3DEncoder", "args": SWIN3D_S}), device=dev).eval()
    rec: dict = {}
    enc.prepare = timed_prepare(enc, rec)
    with torch.no_grad():
        feats, logits, keep = enc(colors, xyz)  # the entry point: host plans, then the UNet
    sig, plans, _ = rec["out"]
    plan_ms = rec["ms"]
    voxels = np.bincount(xyz[keep, 3].astype(np.int64)).tolist()
    shapes = stage_shapes(plans)
    print(f"  (b) two rooms of {len(rooms[0][0])} and {len(rooms[1][0])} points → "
          f"{voxels} voxels; host plans {plan_ms:.0f} ms; (W, K) by stage: "
          + "; ".join(f"{s}: win {v['win']}, shifted {v['win_shift']}"
                      for s, v in enumerate(shapes)))
    width, classes = SWIN3D_S["channels"][0], SWIN3D_S["num_classes"]
    check(feats.shape == (len(keep), width) and logits.shape == (len(keep), classes)
          and bool(torch.isfinite(feats).all() & torch.isfinite(logits).all()),
          f"(b) Swin3D-S eval forward of two rooms through PCDSwin3DEncoder: features "
          f"({len(keep)}, {width}) and logits ({len(keep)}, {classes}), finite")
    sig_t, plans_t = torch.from_numpy(sig).to(dev), plans_to_torch(plans, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        fwd_ms = median_ms(lambda: enc.unet(sig_t, plans_t))
    fwd_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del sig_t, plans_t, feats, logits

    # one room, training BatchNorm, forward and backward of sum(logits²)
    one = np.concatenate([rooms[0][0], np.zeros((len(rooms[0][0]), 1), np.float32)], 1)
    enc.train()
    before = enc.unet.cls_bn.running_var.clone()
    feats1, logits1, keep1 = enc(rooms[0][1], one, train=True)
    (logits1 ** 2).sum().backward()
    train_plan_ms = rec["ms"]
    grads = [p.grad for p in enc.parameters()]
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
          and not torch.equal(before, enc.unet.cls_bn.running_var),
          f"(b) one room ({len(keep1)} voxels) in training mode: finite gradients on all "
          f"{len(grads)} parameters, the running statistics moved")
    sig1, plans1, _ = rec["out"]
    sig1_t, plans1_t = torch.from_numpy(sig1).to(dev), plans_to_torch(plans1, dev)
    del feats1, logits1

    def step():
        enc.zero_grad(set_to_none=True)
        _, lg = enc.unet(sig1_t, plans1_t, train=True)
        (lg ** 2).sum().backward()

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = median_ms(step)
    step_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    top, busy = step_kernels(step)
    print(f"  (b) one room's step by kernel (device ms, torch.profiler; {busy:.1f} ms busy in "
          f"all): " + "; ".join(f"{name[:60]} {ms:.1f} ({n})" for ms, n, name in top))
    print(f"  (b) eval forward of two rooms {fwd_ms:.1f} ms (median of 3), peak "
          f"{fwd_peak:.2f} GiB; one room forward + backward {step_ms:.1f} ms (median of 3), "
          f"peak {step_peak:.2f} GiB; host plans of one room {train_plan_ms:.0f} ms")
    del enc.prepare
    return dict(voxels=voxels, plan_ms=plan_ms, plan_ms_one=train_plan_ms, stages=shapes,
                stages_one=stage_shapes(plans1), fwd_ms=fwd_ms, fwd_peak_gib=fwd_peak,
                fwd_bwd_ms=step_ms, fwd_bwd_peak_gib=step_peak, step_busy_ms=busy,
                step_top=[[round(ms, 3), n, name[:80]] for ms, n, name in top]), rooms[0]


def softgroup_inputs(room):
    """SoftGroup's host plans over one room → (numpy inputs of the device
    functions, host ms of each plan)."""
    from msr3d_tpu_torch.ops import softgroup as sg

    xyz, colors, inst = room
    coords = np.concatenate([np.zeros((len(xyz), 1), np.int64),
                             np.floor(xyz).astype(np.int64)], 1)
    ms = {}
    t0 = time.perf_counter()
    _, _, map1 = sg.voxelization_idx(coords, 1, mode=1)
    ms["voxelization_idx_mode1"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, _, map4 = sg.voxelization_idx(coords, 1, mode=4)
    ms["voxelization_idx_mode4"] = (time.perf_counter() - t0) * 1e3
    v_inst = inst[map1[:, 1]]
    fg = np.nonzero(v_inst >= 5)[0]  # the boxes' voxels
    counts = map4[:, :1].astype(np.float64)
    members = np.where(np.arange(map4.shape[1] - 1)[None] < counts, map4[:, 1:], -1)
    centers = np.stack([np.where(members[fg] >= 0, xyz[np.maximum(members[fg], 0), a], 0)
                        .sum(1) for a in range(3)], 1) / counts[fg]
    centers = centers.astype(np.float32)
    t0 = time.perf_counter()
    idx, start_len = sg.ballquery_batch_p(centers, np.zeros(len(fg), np.int32),
                                          np.array([0, len(fg)], np.int32), SG_RADIUS)
    ms["ballquery_batch_p"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    clusters, offsets = sg.bfs_cluster(np.array([-1.0], np.float32), idx, start_len,
                                       SG_MIN_VOXELS, 0)
    ms["bfs_cluster"] = (time.perf_counter() - t0) * 1e3
    labels = (v_inst[fg] - 5).astype(np.int64)
    n_inst = int(labels.max()) + 1
    return dict(feats=np.concatenate([colors, xyz], 1).astype(np.float32), map4=map4, fg=fg,
                prop_idx=clusters[:, 1].astype(np.int64), prop_off=offsets, labels=labels,
                pointnum=np.bincount(labels, minlength=n_inst).astype(np.int32),
                cls=np.arange(3, 3 + n_inst, dtype=np.int64),
                scores=np.random.default_rng(23).uniform(size=len(clusters)).astype(np.float32),
                n_neighbours=len(idx)), ms


def softgroup_device(x: dict, dev, timings: "dict | None" = None) -> dict:
    """SoftGroup's device functions on ``x``'s arrays on ``dev`` → results;
    with ``timings``, each one's ms (median of 3)."""
    from msr3d_tpu_torch.ops import softgroup as sg

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    out = {}
    calls = [
        ("voxelization", lambda: sg.voxelization(t["feats"], t["map4"], 4)),
        ("fg_feats", lambda: out["voxelization"][t["fg"]][t["prop_idx"]]),
        ("global_avg_pool", lambda: sg.global_avg_pool(out["fg_feats"], t["prop_off"])),
        ("sec_mean", lambda: sg.sec_mean(out["fg_feats"], t["prop_off"])),
        ("sec_min", lambda: sg.sec_min(out["fg_feats"], t["prop_off"])),
        ("sec_max", lambda: sg.sec_max(out["fg_feats"], t["prop_off"])),
        ("iou_on_cluster", lambda: sg.get_mask_iou_on_cluster(
            t["prop_idx"], t["prop_off"], t["labels"], t["pointnum"])),
        ("iou_on_pred", lambda: sg.get_mask_iou_on_pred(
            t["prop_idx"], t["prop_off"], t["labels"], t["pointnum"], t["scores"])),
        ("mask_label", lambda: sg.get_mask_label(
            t["prop_idx"], t["prop_off"], t["labels"], t["cls"], t["pointnum"],
            out["iou_on_cluster"], SG_IOU_THR)),
    ]
    for name, fn in calls:
        out[name] = fn()
        if timings is not None and name != "fg_feats":
            timings[name] = median_ms(fn)
    return out


def softgroup_run(room, dev):
    x, ms = softgroup_inputs(room)
    res = softgroup_device(x, dev, ms)
    n_clusters = len(x["prop_off"]) - 1
    best = res["iou_on_cluster"].max(dim=0).values
    check(res["voxelization"].shape == (x["map4"].shape[0], 6) and n_clusters >= 1
          and bool((best >= 0.9).all()) and bool((res["mask_label"] >= 0).any()),
          f"(c) SoftGroup over one room: {x['map4'].shape[0]} voxels of 6-channel means, "
          f"{len(x['fg'])} box voxels, {x['n_neighbours']} ball-query pairs, {n_clusters} "
          f"clusters, each box matched by one at IoU >= 0.9 "
          f"({[round(float(v), 4) for v in best]})")
    print("  (c) ms (host plans, then device functions, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    return dict(ms=ms, clusters=n_clusters, box_voxels=len(x["fg"])), x


def crse_literal(attn, feats, plan):
    """JAX's ``WindowAttentionCRSE`` as written (msr3d_tpu/nn/swin3d.py:
    267-344): three (W, K, K, H, hd) bias tensors."""
    from msr3d_tpu_torch.nn.swin3d import _masked_gather

    h = attn.num_heads
    hd = attn.dim // h
    windows, mask = plan["windows"], plan["mask"]
    w, k = windows.shape
    qkv = attn.qkv(feats).reshape(-1, 3, h, hd)
    q, key, val = qkv[:, 0] * hd ** -0.5, qkv[:, 1], qkv[:, 2]
    qg, kg, vg = (_masked_gather(x.reshape(-1, h * hd), windows).reshape(w, k, h, hd)
                  for x in (q, key, val))
    nc = _masked_gather(plan["n_coords"], windows)
    rel = nc[:, :, None, :] - nc[:, None, :, :]
    bias = {p: feats.new_zeros(w, k, k, h, hd) for p in ("query", "key", "value")}
    for name, length, sl in attn.groups:
        idx = torch.floor(rel[..., sl] + length).clamp(0, 2 * length - 1).long()
        for p in bias:
            table = getattr(attn, f"{p}_{name}_table")
            bias[p] = bias[p] + sum(table[a][idx[..., a]] for a in range(3))
    logits = (torch.einsum("wihd,wjhd->wijh", qg, kg)
              + torch.einsum("wihd,wijhd->wijh", qg, bias["query"])
              + torch.einsum("wjhd,wijhd->wijh", kg, bias["key"]))
    logits = torch.where(mask[:, None, :, None], logits,
                         logits.new_full((), torch.finfo(logits.dtype).min))
    a = torch.softmax(logits, dim=2)
    a = torch.where(mask[:, :, None, None], a, a.new_zeros(()))
    out = torch.einsum("wijh,wjhd->wihd", a, vg) + torch.einsum("wijh,wijhd->wihd", a,
                                                                bias["value"])
    n = feats.shape[0]
    flat = torch.where(mask, windows, n).reshape(-1)
    scattered = out.new_zeros(n + 1, attn.dim).index_put((flat,), out.reshape(w * k, -1))[:n]
    return attn.proj(scattered)


def p23_exact(nmr_root: Path, sg_inputs: dict, dev) -> dict:
    from msr3d_tpu_torch.data.synthetic import build_room_scene
    from msr3d_tpu_torch.nn.srt import ray_encoding
    from msr3d_tpu_torch.nn.swin3d import PCDSwin3DEncoder, crse_indices, plans_to_torch

    res = {}
    # SRT at hidden 64: 2 items x 1024 rays of (a)'s tree
    batch, _ = nmr_batch(nmr_root, 2, 1024, 24)
    cpu_b = {k: torch.from_numpy(v) for k, v in batch.items()}
    card_b = {k: v.to(dev) for k, v in cpu_b.items()}
    enc = ray_encoding(cpu_b["target_camera_pos"], cpu_b["target_rays"])
    enc_card = ray_encoding(card_b["target_camera_pos"], card_b["target_rays"]).cpu()
    octave_err = ((enc_card - enc).abs().reshape(-1, 2, 2, 3, 15).amax(dim=(0, 2, 3))
                  .amax(dim=0).tolist())
    torch.manual_seed(24)
    cpu_mods = srt_modules("cpu", **SRT_SMALL)
    # He-normal convolutions keep the images' variance through the pyramid:
    # under torch's default init each conv shrinks it by 3, after eight the
    # patches are all the per-patch bias, alike, and the decoder's q and k
    # gradients 0 in exact arithmetic (some 1e-10, noise to compare)
    with torch.no_grad():
        for mod in cpu_mods[0].modules():
            if isinstance(mod, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(mod.weight, nonlinearity="relu")
    card_mods = tuple(copy.deepcopy(m).to(dev) for m in cpu_mods)
    (loss_c, pix_c), (loss_g, pix_g) = srt_loss(*cpu_mods, cpu_b), srt_loss(*card_mods, card_b)
    loss_c.backward()
    loss_g.backward()
    srt_grads = {}
    for cm, gm in zip(cpu_mods, card_mods):
        srt_grads.update(grad_errors(gm, cm, [n for n, _ in cm.named_parameters()
                                              if n.endswith("k_proj.bias")]))
    res["srt"] = dict(pixels=rel_l2(pix_g, pix_c), worst_grad=max(srt_grads.values()),
                      octave_err=octave_err)
    check(max(octave_err) <= P23_ENC_ATOL,
          f"(d) the ray encodings' 15 octaves on the card against the CPU within "
          f"{P23_ENC_ATOL} (worst by octave: {[f'{e:.1e}' for e in octave_err]})")
    check(res["srt"]["pixels"] <= P23_OUT_RTOL and res["srt"]["worst_grad"] <= P23_GRAD_RTOL,
          f"(d) SRT at hidden 64 on the card against the CPU: pixels {res['srt']['pixels']:.1e} "
          f"(<= {P23_OUT_RTOL}), worst gradient {res['srt']['worst_grad']:.1e} "
          f"(<= {P23_GRAD_RTOL})")

    # Swin3D at channels (16, 24, 32), transformer stem, linear_attn upsampling
    xyz, colors, _ = build_room_scene(np.random.default_rng(24), room=(1.2, 1.2, 0.8),
                                      coverage=0.3, n_boxes=1)
    pts = np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)], 1)
    torch.manual_seed(25)
    cpu_enc = PCDSwin3DEncoder(**SWIN_SMALL, device="cpu").train()
    card_enc = copy.deepcopy(cpu_enc).to(dev)
    f_c, l_c, keep = cpu_enc(colors, pts, train=True)
    f_g, l_g, keep_g = card_enc(colors, pts, train=True)
    (l_c ** 2).sum().backward()
    (l_g ** 2).sum().backward()
    shift = ["unet.cls_fc1.bias", "unet.upsamples.1.block.attn.proj.bias",
             "unet.upsamples.1.block.mlp.fc2.bias"]
    swin_grads = grad_errors(card_enc, cpu_enc, shift)
    stats = max(rel_l2(b_g, b_c) for (n, b_g), (_, b_c)
                in zip(card_enc.named_buffers(), cpu_enc.named_buffers()) if "running" in n)
    res["swin3d"] = dict(voxels=len(keep), features=rel_l2(f_g, f_c), logits=rel_l2(l_g, l_c),
                         worst_grad=max(swin_grads.values()), stats=stats)
    check(np.array_equal(keep, keep_g) and res["swin3d"]["features"] <= P23_OUT_RTOL
          and res["swin3d"]["logits"] <= P23_OUT_RTOL
          and res["swin3d"]["worst_grad"] <= P23_GRAD_RTOL and stats <= P23_STATS_RTOL,
          f"(d) Swin3D at (16, 24, 32) over {len(keep)} voxels, training BatchNorm, on the card "
          f"against the CPU: features {res['swin3d']['features']:.1e}, logits "
          f"{res['swin3d']['logits']:.1e}, worst gradient {res['swin3d']['worst_grad']:.1e}, "
          f"running statistics {stats:.1e}")
    _, plans, _ = cpu_enc.prepare(colors, pts)
    same, pairs = True, 0
    for s, st in enumerate(plans["stages"]):
        for name in ("win", "win_shift"):
            ws = SWIN_SMALL["window_sizes"][s]
            a = crse_indices(plans_to_torch(st[name], "cpu"), ws, 4)
            b = crse_indices(plans_to_torch(st[name], dev), ws, 4)
            same &= all(torch.equal(a[g], b[g].cpu()) for g in a)
            pairs += sum(v.numel() for v in a.values())
    attn = card_enc.unet.layers[0].blocks[0].attn
    plan0 = plans_to_torch(plans["stages"][0]["win"], dev)
    x = torch.randn(len(keep), SWIN_SMALL["channels"][0], device=dev)
    with torch.no_grad():
        crse = rel_l2(attn(x, plan0), crse_literal(attn, x, plan0))
    res["swin3d"].update(crse_pairs=pairs, crse_vs_literal=crse)
    check(same and crse <= P23_CRSE_RTOL,
          f"(d) cRSE: the {pairs} table indices of every stage's windows equal on the card and "
          f"the CPU; stage 0's attention against the literal formula (three (W, K, K, H, hd) "
          f"tensors) on the card {crse:.1e} (<= {P23_CRSE_RTOL})")

    # SoftGroup's device functions, (c)'s inputs, on the card and the CPU
    from msr3d_tpu_torch.ops import softgroup as sg

    card = softgroup_device(sg_inputs, dev)
    cpu = softgroup_device(sg_inputs, torch.device("cpu"))
    # the minima and maxima again on the card from the CPU's rows: the voxel
    # means they read differ in the last bits (summed in another order)
    rows, off = cpu["fg_feats"].to(dev), torch.from_numpy(sg_inputs["prop_off"]).to(dev)
    card.update(sec_min=sg.sec_min(rows, off), sec_max=sg.sec_max(rows, off))
    exact = all(torch.equal(card[k].cpu(), cpu[k]) for k in ("sec_min", "sec_max", "mask_label"))
    means = max(float((card[k].cpu() - cpu[k]).abs().max() / cpu[k].abs().max())
                for k in ("voxelization", "global_avg_pool", "sec_mean"))
    iou = max(float((card[k].cpu() - cpu[k]).abs().max()) for k in ("iou_on_cluster",
                                                                     "iou_on_pred"))
    res["softgroup"] = dict(exact=exact, means=means, iou=iou)
    check(exact and means <= P23_MEAN_RTOL and iou <= P23_IOU_ATOL,
          f"(d) SoftGroup on the card against the CPU: mask labels equal, minima and maxima of "
          f"the same rows equal; means within {means:.1e} of the largest (<= {P23_MEAN_RTOL}), IoU tables within "
          f"{iou:.1e} (<= {P23_IOU_ATOL})")
    return res


def phase_nmr_swin3d(exp_root: Path, dev=None):
    dev = dev or torch.device("cuda", 0)
    print(f"== phase 23: multi-view reconstruction and the sparse-voxel stack ((a) NMR → "
          f"SRTEncoder → SRTDecoder at 768, {NMR_BATCH} x {NMR_RAYS} rays, forward and the "
          f"MSE's backward; (b) Swin3D-S over two ~100 000-voxel rooms, eval forward, then one "
          f"room forward and backward; (c) SoftGroup's plans and ops on one room; (d) small "
          f"widths on the card against the CPU; on {card_line()})")
    from msr3d_tpu_torch.ops import flash_attention as fa
    from msr3d_tpu_torch.ops import host_geometry
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL
    from msr3d_tpu_torch.ops.w4_matmul import W4_MATMUL_KERNEL
    from msr3d_tpu_torch.ops.w8_matmul import W8_MATMUL_KERNEL

    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL,
               W8_MATMUL_KERNEL, W4_MATMUL_KERNEL)
    for kernel in kernels:
        kernel.launches = 0
    out = {"a": nmr_srt_run(exp_root / "nmr", dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b"], room = swin3d_run(dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["c"], sg_inputs = softgroup_run(room, dev)
    out["launches"] = kernel_launches(kernels)
    check(not any(out["launches"].values()),
          f"(a)-(c) launched none of K1-K4 ({out['launches']}): SRT, cRSE and SoftGroup "
          "reach no Pallas kernel in the JAX package either")
    check(host_geometry.native_loaded(),
          "the plans came from native/geometry.cc, built into build/native/ (not the numpy "
          "versions)")
    out["d"] = p23_exact(exp_root / "nmr", sg_inputs, dev)
    print(f"  phase 23 figures: {json.dumps({k: out[k] for k in ('a', 'b', 'c', 'd')})}")
    return out


def phase23_launches(out, kernel: str) -> dict:
    """Phase 23's launches of one kernel for the kernels line: (a)-(c), none."""
    return dict(launches_nmr_swin3d=out["launches"][kernel])


def phase22_launches(out) -> dict:
    """Phase 22's launches of K1 for the kernels line: PointTokenizeEncoder's
    LEGACY_STEPS training steps, its eval forward, PointBERT's forward; and
    K1's device time at PointBERT's shape."""
    return dict(launches_legacy_tokenize=out["launches_tokenize"],
                launches_legacy_eval=out["launches_eval"],
                launches_legacy_pointbert=out["launches_pointbert"],
                legacy_ms_npoint64=out["k1_ms_npoint64"],
                legacy_bound_ms_npoint64=out["k1_bound_ms_npoint64"],
                legacy_clouds_npoint64=out["k1_clouds"])


def phase21_launches(out, kernel: str) -> dict:
    """Phase 21's launches of one kernel for the kernels line: each sp rank's
    run of (a) and, the flash kernels, (b)'s long-context steps at sp = 1
    and on each sp rank."""
    row = dict(launches_sp=[m["launches"][kernel] for m in out["a"]])
    if kernel != "fps":
        row["launches_sp_long"] = dict(sp1=out["b"]["one"]["launches"][kernel],
                                       sp2=[r["launches"][kernel] for r in out["b"]["ranks"]])
    return row


def phase20_launches(out, kernel: str) -> dict:
    """Phase 20's launches of one kernel for the kernels line: each pp rank's
    run of (a) and, K1 and K2f, each tp rank's greedy generate of (b)'s
    int8 and int4-grouped flagships."""
    row = dict(launches_pp=[m["launches"][kernel] for m in out["a"]])
    if kernel in ("fps", "flash_attn_fwd"):
        row["launches_tp_quantized_generate"] = {
            label: [g[label]["launches"][kernel] for g in out["b"]]
            for label, *_ in PP_QUANT_RUNS}
    return row


def phase19_launches(out, kernel: str) -> dict:
    """Phase 19's launches of one kernel for the kernels line: each tp rank's
    run of (a) and, K1 and K2f, each rank's greedy generate of (b)."""
    row = dict(launches_tp=[m["launches"][kernel] for m in out["a"]])
    if kernel in ("fps", "flash_attn_fwd"):
        row["launches_tp_generate"] = [g["greedy"]["launches"][kernel] for g in out["b"]]
    return row


def phase18_launches(out, kernel: str) -> dict:
    """Phase 18's launches of one kernel for the kernels line: the one-rank
    run (a) and each rank of the two-rank run (b)."""
    return dict(launches_dp_one_rank=out["a"][0]["launches"][kernel],
                launches_dp=[m["launches"][kernel] for m in out["b"]])


def phase17_launches(out, kernel: str) -> dict:
    """Phase 17's launches of one kernel for the kernels line: a step of
    OPTIONS_ACCUM micro-batches under each remat policy, and the entry's step
    with dots."""
    row = {f"launches_remat_{p}": out["a"][p]["launches"][kernel]
           for p in ("none", "full", "dots", "residuals")}
    row["launches_remat_entry"] = out["b"]["launches"][kernel]
    if kernel == "fps":
        row["launches_train_bn"] = out["d"]["launches"]
    return row


def phase16_launches(out, kernel: str) -> dict:
    """Phase 16's launches of one kernel for the kernels line."""
    return dict(launches_pool=out["a"]["pool"]["launches"][kernel],
                pool_prefix_prefills=out["a"]["pool"]["prefix_prefills"],
                launches_pool_spec=out["b"]["spec"]["launches"][kernel],
                launches_pool_beam=out["c"]["pool"]["launches"][kernel],
                launches_pool_http=out["d"]["launches"][kernel])


def phase15_launches(out, kernel: str) -> dict:
    """Phase 15's launches of one kernel for the kernels line."""
    return dict(launches_spec=out["a"]["launches"][kernel],
                launches_sampled=out["b"]["launches"][kernel],
                launches_grouped=out["c"]["greedy"]["grouped_launches"][kernel],
                launches_grouped_http=out["c"]["http"]["launches"][kernel])


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
    seconds = {}

    def timed(phase, *args):
        """Run one phase and print the seconds it took, so a growing script
        shows where its time limit goes (all of them again at the end)."""
        start = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        seconds[phase.__name__] = round(time.perf_counter() - start, 1)
        print(f"  {phase.__name__} took {seconds[phase.__name__]:.1f} s")
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
        entry = timed(phase_entry, exp_root)
        entry_launches = entry["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        evaluation = timed(phase_eval, exp_root)  # on phase 10's tree
        gc.collect()
        torch.cuda.empty_cache()
        serving = timed(phase_serve, exp_root)  # on phase 10's cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        leo = timed(phase_leo, exp_root)  # on phase 10's tree and cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        crops = timed(phase_crops, exp_root, entry)  # on phase 10's scans and cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        serving2 = timed(phase_serving2, exp_root)  # on phase 10's cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        pool = timed(phase_pool, exp_root)  # on phase 10's cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        options = timed(phase_train_options, exp_root)
        gc.collect()
        torch.cuda.empty_cache()
        dp = timed(phase_dp, exp_root)  # on phase 10's tree and cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        tp = timed(phase_tp, exp_root, dp)  # on phase 10's tree and cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        pp = timed(phase_pp, exp_root, tp, quantized)  # on phase 10's tree and cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        sp = timed(phase_sp, exp_root, dp)  # on phase 10's tree and cfg_path
        gc.collect()
        torch.cuda.empty_cache()
        legacy = timed(phase_legacy, exp_root)
        gc.collect()
        torch.cuda.empty_cache()
        recon = timed(phase_nmr_swin3d, exp_root)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    source = "msr3d_tpu_torch/csrc/flash_attn_bwd.cu"
    ev, retrieval = evaluation["launches"], evaluation["retrieval"]["launches"]
    rows = [
        # launches: greedy generate (phase 4); launches_beam: the beam-5
        # generate with the ancestry map (phase 9); launches_entry: the
        # training entry's run (phase 10); launches_eval: the entry's run of
        # phase 11 (a), one training step and eval_batches eval batches;
        # launches_retrieval: phase 11 (c)'s retrieval batch; launches_serve:
        # phase 12 (b)'s HTTP traffic, serve_requests requests; launches_leo:
        # phase 13 (b), the LEO entry's run (one step, eval_batches_leo eval
        # batches); launches_leo_modes: phase 13 (a), the prompter in each
        # of its rows; launches_crops: phase 14 (b), the entry with object
        # crops (one step of TRAIN_ACCUM micro-batches, eval_batches_crops
        # eval batches); launches_spec, launches_sampled, launches_grouped:
        # phase 15's speculative and sampled generate and its grouped greedy
        # generate (GROUP_SCENES scenes x GROUP_QUESTIONS questions);
        # launches_pool, launches_pool_spec, launches_pool_beam,
        # launches_pool_http: phase 16's greedy pool engine over the stream
        # (pool_prefix_prefills prefix prefills), its speculative pool, its
        # beam pool and its HTTP traffic; launches_remat_*: phase 17 (a), one
        # step of OPTIONS_ACCUM micro-batches without remat and under each
        # policy, launches_remat_entry (b) the entry's step with dots,
        # launches_train_bn (d) the unfrozen encoder's training forward;
        # launches_dp: phase 18 (b), each of the two ranks' run (one step of
        # TRAIN_ACCUM micro-batches, two eval batches), launches_dp_one_rank
        # (a) the launcher's one-rank run; launches_tp: phase 19 (a), each tp
        # rank's run (the same step and eval over its 16 heads a layer),
        # launches_tp_generate (b) each tp rank's greedy generate;
        # launches_pp: phase 20 (a), each pp rank's run (the step over its
        # stage's 16 layers at 2 pipeline micro-batches a loader batch, the
        # eval batch on stage 0 with the whole LLM),
        # launches_tp_quantized_generate (b) each tp rank's greedy generate
        # of the int8 (a) and int4-grouped (c) flagship; launches_sp: phase
        # 21 (a), each sp rank's run (the step through the ring, an eval
        # batch on each rank), launches_sp_long (b) the long-context steps at
        # sp = 1 and on each sp rank; launches_legacy_tokenize,
        # launches_legacy_eval, launches_legacy_pointbert: phase 22 (b), the
        # legacy stack's LEGACY_STEPS steps, its eval forward and PointBERT's
        # forward, legacy_ms_npoint64 K1's device time at PointBERT's shape;
        # launches_nmr_swin3d: phase 23 (a)-(c), NMR → SRT, Swin3D-S and
        # SoftGroup, which reach no kernel (0 in both packages)
        dict(name="fps", route="cuda", source="msr3d_tpu_torch/csrc/fps.cu",
             replaces="msr3d_tpu/ops/pallas/fps.py:28", launches=launches["fps"],
             launches_beam=beam[True]["launches"]["fps"],
             launches_entry=entry_launches["fps"], launches_eval=ev["fps"],
             eval_batches=evaluation["eval_batches"], launches_retrieval=retrieval["fps"],
             launches_serve=serving["b"]["launches"]["fps"], serve_requests=SERVE_REQUESTS,
             launches_leo=leo["launches"]["fps"], eval_batches_leo=leo["eval_batches"],
             launches_leo_modes=sum(r["launches"] for r in leo["modes"].values()),
             launches_crops=crops["launches"]["fps"], eval_batches_crops=crops["eval_batches"],
             **phase15_launches(serving2, "fps"), **phase16_launches(pool, "fps"),
             **phase17_launches(options, "fps"), **phase18_launches(dp, "fps"),
             **phase19_launches(tp, "fps"),
             **phase20_launches(pp, "fps"), **phase21_launches(sp, "fps"),
             **phase22_launches(legacy), **phase23_launches(recon, "fps"), **fps_row),
        dict(name="flash_attn_fwd", route="cuda", source="msr3d_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="msr3d_tpu/ops/flash_attention.py:97",
             launches=launches["flash_attn_fwd"],
             launches_beam=beam[True]["launches"]["flash_attn_fwd"],
             launches_entry=entry_launches["flash_attn_fwd"],
             launches_eval=ev["flash_attn_fwd"], eval_batches=evaluation["eval_batches"],
             launches_retrieval=retrieval["flash_attn_fwd"],
             launches_serve=serving["b"]["launches"]["flash_attn_fwd"],
             serve_requests=SERVE_REQUESTS, launches_leo=leo["launches"]["flash_attn_fwd"],
             eval_batches_leo=leo["eval_batches"],
             launches_crops=crops["launches"]["flash_attn_fwd"],
             eval_batches_crops=crops["eval_batches"],
             **phase15_launches(serving2, "flash_attn_fwd"),
             **phase16_launches(pool, "flash_attn_fwd"),
             **phase17_launches(options, "flash_attn_fwd"),
             **phase18_launches(dp, "flash_attn_fwd"),
             **phase19_launches(tp, "flash_attn_fwd"),
             **phase20_launches(pp, "flash_attn_fwd"), **phase21_launches(sp, "flash_attn_fwd"),
             **phase23_launches(recon, "flash_attn_fwd"), **flash_row),
        dict(name="flash_attn_bwd_dq", route="cuda", source=source,
             replaces="msr3d_tpu/ops/flash_attention.py:152",
             launches=train_launches["flash_attn_bwd_dq"],
             launches_entry=entry_launches["flash_attn_bwd_dq"],
             launches_eval=ev["flash_attn_bwd_dq"],
             launches_leo=leo["launches"]["flash_attn_bwd_dq"],
             launches_crops=crops["launches"]["flash_attn_bwd_dq"],
             **phase17_launches(options, "flash_attn_bwd_dq"),
             **phase18_launches(dp, "flash_attn_bwd_dq"),
             **phase19_launches(tp, "flash_attn_bwd_dq"),
             **phase20_launches(pp, "flash_attn_bwd_dq"), **phase21_launches(sp, "flash_attn_bwd_dq"),
             **phase23_launches(recon, "flash_attn_bwd_dq"), **dq_row),
        dict(name="flash_attn_bwd_dkv", route="cuda", source=source,
             replaces="msr3d_tpu/ops/flash_attention.py:193",
             launches=train_launches["flash_attn_bwd_dkv"],
             launches_entry=entry_launches["flash_attn_bwd_dkv"],
             launches_eval=ev["flash_attn_bwd_dkv"],
             launches_leo=leo["launches"]["flash_attn_bwd_dkv"],
             launches_crops=crops["launches"]["flash_attn_bwd_dkv"],
             **phase17_launches(options, "flash_attn_bwd_dkv"),
             **phase18_launches(dp, "flash_attn_bwd_dkv"),
             **phase19_launches(tp, "flash_attn_bwd_dkv"),
             **phase20_launches(pp, "flash_attn_bwd_dkv"), **phase21_launches(sp, "flash_attn_bwd_dkv"),
             **phase23_launches(recon, "flash_attn_bwd_dkv"), **dkv_row),
        # K3/K4: no serving path calls them, in either package, so their
        # launches over generate (a) and (b) are 0; held_on_path_operands
        # counts the launches on the 224 projections' own decode operands
        dict(name="w8_matmul", route="cuda", source="msr3d_tpu_torch/csrc/w8_matmul.cu",
             replaces="msr3d_tpu/ops/pallas/w8_matmul.py:36",
             launches=quantized["a"]["launches"]["w8_matmul"],
             held_on_path_operands=quantized["w8"][0], **quantized["w8"][1],
             **phase23_launches(recon, "w8_matmul"), phase7=phase7_rows(dequant_rows, 8)),
        dict(name="w4_matmul", route="cuda", source="msr3d_tpu_torch/csrc/w4_matmul.cu",
             replaces="msr3d_tpu/ops/pallas/w4_matmul.py:94",
             launches=quantized["b"]["launches"]["w4_matmul"],
             held_on_path_operands=quantized["w4"][0], **quantized["w4"][1],
             **phase23_launches(recon, "w4_matmul"), phase7=phase7_rows(dequant_rows, 4)),
    ]
    print(f"seconds by phase: {json.dumps(seconds)}")
    print(f"total {time.perf_counter() - t0:.1f} s on {card_line()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
