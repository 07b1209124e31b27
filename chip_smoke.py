"""Chip smoke test of the PyTorch/CUDA port (``msr3d_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``msr3d_tpu_torch/csrc`` with
``nvcc`` for ``sm_90a`` (one process per source, in parallel), holds each
kernel against its plain PyTorch version at the shapes of the main path,
then drives greedy ``MSR3D.generate`` at the flagship width (OSE3D
prompter: 60 objects x 1024 points; Vicuna-7B-geometry Llama, bf16, LoRA
r16, flash prefill) with random weights from a seed, and checks that the
path launched each kernel. Any failed check exits non-zero. The last two
lines of standard output are the per-kernel JSON line and the result line
``{"ok": true, "device": {...}}``; without a GPU, or without the package
beside it, it exits non-zero and prints no result. ``--profile`` adds the
device time by kernel of one more generate (``torch.profiler``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
N_REQUESTS, NEW_TOKENS, REP_PENALTY = 4, 32, 3.0


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


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card_and_build():
    print("== phase 1: card and kernel build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    from msr3d_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all(["fps", "flash_attn_fwd"])
    print(f"  built {[p.name for p in paths]} in {time.perf_counter() - t0:.1f} s")
    for name in ("fps", "flash_attn_fwd"):
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")


def phase_fps(dev):
    print("== phase 2: K1 (FPS) against its plain version")
    from msr3d_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_reference
    from msr3d_tpu_torch.ops.pointnet2 import gather_points

    gen = torch.Generator(device=dev).manual_seed(1)
    clouds = N_REQUESTS * 60
    xyz1 = torch.randn((clouds, 1024, 3), generator=gen, device=dev) * 0.3
    idx1 = furthest_point_sample(xyz1, 32)
    xyz2 = gather_points(xyz1, idx1).contiguous()  # the stage-2 input: 32 points
    cases = {"240x1024->32": (xyz1, 32), "240x32->16": (xyz2, 16)}
    padded = xyz1[:8].clone()
    padded[:, 700:] = 0.0  # trailing padding points
    padded[3] = 0.0  # a cloud of padding only
    padded[5, :, :] *= 1e-3  # every point inside the padding radius
    cases["padded"] = (padded, 32)
    cases["4096 points"] = (torch.randn((3, 4096, 3), generator=gen, device=dev), 64)
    worst = 0
    for name, (x, m) in cases.items():
        got, want = furthest_point_sample(x, m), furthest_point_sample_reference(x, m)
        torch.cuda.synchronize()
        worst = max(worst, (got - want).abs().max().item())
        check(torch.equal(got, want), f"K1 indices equal to the plain version ({name})")
    check(bool((furthest_point_sample(padded, 32)[3] == 0).all()),
          "K1 gives all zeros for an all-padding cloud")
    path = [(xyz1, 32), (xyz2, 16)]
    ms = time_ms(lambda: [furthest_point_sample(x, m) for x, m in path])
    plain_ms = time_ms(lambda: [furthest_point_sample_reference(x, m) for x, m in path], iters=5)
    nbytes = sum(x.numel() * 4 + x.shape[0] * m * 4 for x, m in path)
    flops = sum(x.shape[0] * x.shape[1] * (m - 1) * 9 for x, m in path)
    b_ms, b_by = bound(nbytes, flops, H100_FP32_FLOPS)
    print(f"  K1 per scene encode (both launches): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=float(worst))


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

    q, k, v, valid = cases["path 4x225x32x128 bf16"]
    ms = time_ms(lambda: flash_attention(q, k, v, key_valid=valid), iters=50)
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, key_valid=valid))
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=dev).tril()[None, None] & valid[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), iters=50)
    b, _, hq, d = q.shape
    pairs = (mask[:, 0].sum().item()) * hq  # unmasked (row, key) pairs over batch and heads
    # q, k, v and key_valid read once; the output and lse written once
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + valid.numel() \
        + b * hq * t * 4
    flops = pairs * 4 * d  # q.k and p.v, 2 flops per multiply-add
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
    print(f"  K2f at the path shape: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, max_abs_err=worst)


def make_requests(seed: int):
    """Four requests built like bench_qa.py's (60 objects x 1024 points)."""
    r = np.random.default_rng(seed)
    b, n_obj, n_pts = N_REQUESTS, 60, 1024
    return {
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


def phase_generate(dev, profile: bool):
    print("== phase 4: greedy MSR3D.generate at the flagship width")
    import dataclasses

    import msr3d_tpu_torch.models.llm.llama as llama
    import msr3d_tpu_torch.nn.pointnet as pointnet
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.ops.flash_attention import FLASH_FWD_KERNEL, flash_attention_reference
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL, furthest_point_sample_reference

    llm = llama.LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, lora_rank=16,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, flash_attention=True,
    )
    cfg = MSR3DNetworkConfig(prompter=OSE3DConfig(), llm=llm)
    t0 = time.perf_counter()
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=60, max_out_len=NEW_TOKENS,
                  repetition_penalty=REP_PENALTY, device=dev)
    model.init_params(seed=0)
    torch.cuda.synchronize()
    print(f"  built and initialised in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.network.parameters()) / 1e9:.3f} B parameters")
    data = make_requests(seed=0)
    model.generate(dict(data), use_beam=False)  # warm-up: cuBLAS handles, allocator

    FPS_KERNEL.launches = FLASH_FWD_KERNEL.launches = 0
    gen_ms = wall_ms(lambda: data.update(model.generate(dict(data), use_beam=False)))
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
    ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    attn_t = torch.as_tensor(attn, dtype=torch.int32, device=dev)
    with torch.no_grad():
        def prefill():
            return net.prefill(ids_t, attn_t, **scene, bos_id=model.tokenizer.bos_id,
                               max_cache_len=ids.shape[1] + 1)

        encode_ms = wall_ms(lambda: net.visual_prompter(**scene))
        prefill_ms = wall_ms(prefill)
        tokens_k = net.visual_prompter(**scene)["obj_tokens"]
        with mock.patch.object(pointnet, "fps", lambda xyz, m: furthest_point_sample_reference(
                xyz.float().contiguous(), m)):
            tokens_plain = net.visual_prompter(**scene)["obj_tokens"]
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

    finished_at = [list(row).index(model.tokenizer.eos_id) if model.tokenizer.eos_id in row
                   else NEW_TOKENS for row in tokens]
    decode_steps = max(1, min(NEW_TOKENS, max(finished_at) + 1) - 1)
    decode_ms = (gen_ms - prefill_ms) / decode_steps
    print(f"  scene encode {encode_ms:.2f} ms, prefill (encode included) {prefill_ms:.2f} ms, "
          f"decode {decode_ms:.2f} ms/token over {decode_steps} steps, "
          f"generate {gen_ms:.2f} ms, {N_REQUESTS / gen_ms * 1e3:.3f} QA/s")
    if profile:
        profile_generate(model, data)
    return launches


def profile_generate(model, data) -> None:
    """Device time by kernel over one generate (``--profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(dict(data), use_beam=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # kernels only; ops would count them twice
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  profile: generate {wall:.2f} ms wall, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    for ms, count, key in rows[:12]:
        print(f"    {ms:9.3f} ms {count:6d}x  {key[:100]}")


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
    t0 = time.perf_counter()
    try:
        phase_card_and_build()
        fps_row = phase_fps(dev)
        flash_row = phase_flash(dev)
        launches = phase_generate(dev, profile="--profile" in sys.argv[1:])
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    rows = [
        dict(name="fps", route="cuda", source="msr3d_tpu_torch/csrc/fps.cu",
             replaces="msr3d_tpu/ops/pallas/fps.py:28", launches=launches["fps"], **fps_row),
        dict(name="flash_attn_fwd", route="cuda", source="msr3d_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="msr3d_tpu/ops/flash_attention.py:97",
             launches=launches["flash_attn_fwd"], **flash_row),
    ]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
