"""Design variants of the int8 dequant-matmul kernel (K3) on one NVIDIA GPU,
beside its earlier design: build ``msr3d_tpu_torch/csrc/w8_matmul.cu``, a
copy of it with 16 KB stages in place of 8 KB (by text substitution) and
``scripts/w8_parent.cu`` (the earlier CUDA-core kernel, the int8 instance
of ``csrc/dequant_matmul.cuh``), one nvcc each, started together; hold
every instance against the plain PyTorch version, and print its device
time a launch by ``torch.profiler`` at
the three Vicuna-7B projection shapes at B 4 and 16, L2-warm and with the
weight read from HBM (copies spanning 256 MB, past the 50 MB L2).

    python3 scripts/w8_variants.py [--splits 1-16] [--quick] [--diagnose] [--json PATH]

The kernel's instances: split (K split across blocks, 1-16) x column tile
(32, 64, 128) x stages of the cp.async ring (2, 3, 4) x stage bytes (8 KB,
the source as it is; 16 KB, the copy), named ``8k-s4-t128-r4``, and
``default`` (``plan_w8``'s choice, the one the port takes). The earlier
design runs as ``parent``. One profile times every instance of a shape: a
marker kernel between instances separates their launches. The rounds go
parent, change, change, parent, so a drift of the card over the run shows.
``--quick`` times only the default and the parent; ``--diagnose`` adds the
default instance of two copies that each skip half the work (the copies
only, or the products only), to show which half sets the time. Nothing
here is used by the port.
"""

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from msr3d_tpu_torch.ops import _build  # noqa: E402
from msr3d_tpu_torch.ops.w8_matmul import (  # noqa: E402
    STAGE_BYTES,
    STAGES,
    TILES,
    matmul_w8_reference,
    plan_w8,
    split_counters,
)

SOURCE = _build.CSRC_DIR / "w8_matmul.cu"
PARENT = Path(__file__).with_name("w8_parent.cu")
STAGE_LINE = f"constexpr int kStageBytes = {STAGE_BYTES};"
OUT_DIR = _build.BUILD_DIR / "w8_variants"
ROUNDS = ("parent", "change", "change", "parent")
OURS = ("w8_matmul_kernel", "dequant_matmul_kernel")


# --diagnose: copies of the kernel that skip one half of its work (their
# outputs are wrong and not checked): the copies only, or the products only
# (on whatever the ring holds)
DIAGNOSE = {
    "copies-only": [("for (int step = 0; step < T::KSW; ++step) {",
                     "for (int step = 0; step < (k < 0 ? T::KSW : 0); ++step) {")],
    "products-only": [("    if (s < nt)\n", "    if (s < nt && k < 0)\n"),
                      ("    if (it + STAGES - 1 < nt)\n", "    if (it + STAGES - 1 < nt && k < 0)\n")],
}


def substituted(name, text, edits):
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"w8_variants: {SOURCE.name} lacks {old!r} for {name}")
        text = text.replace(old, new)
    path = OUT_DIR / f"w8_matmul_{name}.cu"
    path.write_text(text)
    return path


def sources(diagnose):
    """{library: source}: the parent, the kernel as it is (8 KB stages), its
    copy with 16 KB stages and, to diagnose, the copies of DIAGNOSE."""
    text = SOURCE.read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    other = 2 * STAGE_BYTES
    out = {"parent": PARENT, f"{STAGE_BYTES // 1024}k": SOURCE,
           f"{other // 1024}k": substituted(f"{other // 1024}k", text, [
               (STAGE_LINE, f"constexpr int kStageBytes = {other};")])}
    if diagnose:
        out.update({name: substituted(name, text, edits) for name, edits in DIAGNOSE.items()})
    return out


def build(diagnose):
    """Every source, one nvcc each, started together; prints each kernel
    instance's registers and spills (and the instances of the kernel or its
    copy that spill). Returns {name: CDLL}."""
    procs = {}
    for name, src in sources(diagnose).items():
        so = OUT_DIR / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so),
               str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, spills = {}, []
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = cs.kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip().replace('ptxas info    : ', '')}")
                if ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
                        and name != "parent"):  # the earlier design is timed as it was
                    spills.append(f"{name} {entry}")
        libs[name] = ctypes.CDLL(str(so))
    if spills:
        print(f"  REGISTER SPILLS in {spills}")
    return libs


def change_launcher(lib, split, tile, stages):
    """(x, wq, scale) -> y through the kernel's C entry at one instance."""
    fn = lib.w8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wq, scale):
        (b, k), n = x.shape, wq.shape[1]
        y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
        ws = torch.empty(split * b * n if split > 1 else 0, dtype=torch.float32, device=x.device)
        cnt = split_counters(x.device, -(-n // tile) * -(-b // 16))
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 ws.data_ptr() if split > 1 else None, cnt.data_ptr(), b, k, n, split, tile,
                 stages, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"w8_matmul_launch({split}, {tile}, {stages}) failed: {err}")
        return y
    return run


def parent_launcher(lib):
    fn = lib.w8_parent_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wq, scale):
        (b, k), n = x.shape, wq.shape[1]
        y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(), b, k, n,
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"w8_parent_launch failed: {err}")
        return y
    return run


def configurations(libs, which, shape, splits, quick):
    if which == "parent":
        return {"parent": parent_launcher(libs["parent"])}
    own = f"{STAGE_BYTES // 1024}k"
    runs = {"default": change_launcher(libs[own], *plan_w8(*shape))}
    if not quick:
        for lib, split, tile, stages in itertools.product(
                [n for n in libs if n != "parent" and n not in DIAGNOSE], splits, TILES,
                STAGES):
            runs[f"{lib}-s{split}-t{tile}-r{stages}"] = change_launcher(libs[lib], split, tile,
                                                                        stages)
    for lib in DIAGNOSE:
        if lib in libs:  # the default instance, halved
            runs[lib] = change_launcher(libs[lib], *plan_w8(*shape))
    return runs


def segment_times(dev, calls, iters):
    """Device time a call of each (name, fn) in ``calls``, from one
    ``torch.profiler`` profile: ``iters`` calls of each, a marker kernel
    (not one of ours) before each name's calls and after the last. Returns
    {name: (total ms, {kernel: ms})} a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device=dev)
    for _, fn in calls:
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a profile now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _, fn in calls:
                marker.add_(1)
                for _ in range(iters):
                    fn()
            marker.add_(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        segments, current = [], None
        for e in events:
            kernel = next((o for o in OURS if o in e.name), None)
            if kernel is None:
                if current is not None:
                    segments.append(current)
                current = {}
            elif current is not None:
                current[kernel] = current.get(kernel, 0.0) + e.time_range.elapsed_us() / 1e3
        if len(segments) == len(calls):
            break
        print(f"  {len(segments)} profile segments ({len(events)} device events) for "
              f"{len(calls)} instances; profiling again")
    else:
        raise SystemExit("w8_variants: three profiles without the expected segments")
    return {name: (sum(seg.values()) / iters, {k: v / iters for k, v in seg.items()})
            for (name, _), seg in zip(calls, segments)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="1-16")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--json", default=str(ROOT / "build" / "w8_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("w8_variants: no CUDA device", file=sys.stderr)
        return 2
    lo, _, hi = args.splits.partition("-")
    splits = list(range(int(lo), int(hi or lo) + 1))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    libs = build(args.diagnose)
    for name, lib in libs.items():
        if name != "parent" and name not in DIAGNOSE:
            fn = lib.w8_matmul_blocks_per_sm
            fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
            print(f"  {name}: blocks an SM (tile, stages): "
                  + ", ".join(f"({t}, {r}) {fn(t, r)}" for t in TILES for r in STAGES))
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = [(b, k, n) for b in (4, 16) for k, n in cs.SHAPES_7B]
    times = {}  # (config, shape, "warm" | "hbm") -> [ms, ...]
    parts = {}  # (config, shape) -> {kernel: ms}, from HBM, the last round
    for which in ROUNDS:
        print(f"== round: {which}")
        for shape in shapes:
            b, k, n = shape
            x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
            wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
            scale = torch.rand(n, generator=gen, device=dev) * (0.09 / 127)
            want = matmul_w8_reference(x, wq, scale)
            sets = cs.past_l2(wq, scale)
            runs = configurations(libs, which, shape, splits, args.quick)
            worst = 0.0
            for name, run in runs.items():
                if name in DIAGNOSE:
                    continue
                res = cs.dequant_errors(run(x, wq, scale), want, x, scale, 8)
                if not (res["finite"] and res["ratio"] <= 1.0):
                    raise SystemExit(f"w8_variants: {name} differs from plain at {shape}: {res}")
                worst = max(worst, res["ratio"])
            warm = segment_times(dev, [(nm, (lambda r: lambda: r(x, wq, scale))(run))
                                       for nm, run in runs.items()], iters=10)
            hbm = segment_times(dev, [(nm, cs.rotating(lambda w, s, r=run: r(x, w, s), sets))
                                      for nm, run in runs.items()], iters=len(sets))
            for name in runs:
                times.setdefault((name, shape, "warm"), []).append(warm[name][0])
                times.setdefault((name, shape, "hbm"), []).append(hbm[name][0])
                parts[(name, shape)] = hbm[name][1]
            best = min((c for c in runs), key=lambda c: hbm[c][0])
            print(f"  B={b:2d} K={k:5d} N={n:5d}: {len(runs)} instances within tolerance of "
                  f"plain (at most {worst:.3f} of it); fastest from HBM {best} "
                  f"{hbm[best][0] * 1e3:.2f} us; " + ("" if which == "parent" else
                                                     f"default {hbm['default'][0] * 1e3:.2f} us"))
            del sets
    print(f"== summary ({card}): device time a launch in us, L2-warm / from HBM, each round")
    summary = []
    for shape in shapes:
        b, k, n = shape
        names = sorted({c for c, s, _ in times if s == shape},
                       key=lambda c: statistics.mean(times[(c, shape, "hbm")]))
        mean = {c: statistics.mean(times[(c, shape, "hbm")]) for c in names}
        parent = mean["parent"]
        print(f"  B={b} K={k} N={n} (bound {cs.dequant_bound(b, k, n, 8)[0] * 1e3:.2f} us, "
              f"default {plan_w8(b, k, n)}):")
        shown = [c for c in names if c not in ("parent", "default", *DIAGNOSE)][:8] \
            + ["default", *[c for c in DIAGNOSE if c in names], "parent"]
        for name in shown:
            warm, hbm = times[(name, shape, "warm")], times[(name, shape, "hbm")]
            split = ", ".join(f"{kn.replace('_kernel', '')} {ms * 1e3:.2f}"
                              for kn, ms in parts[(name, shape)].items())
            print(f"    {name:18s} " + ", ".join(f"{t * 1e3:.2f}" for t in warm) + " / "
                  + ", ".join(f"{t * 1e3:.2f}" for t in hbm)
                  + f"  ({parent / mean[name]:.2f}x the parent; {split})")
        for name in names:
            summary.append(dict(b=b, k=k, n=n, name=name, warm_ms=times[(name, shape, "warm")],
                                hbm_ms=times[(name, shape, "hbm")],
                                parts_ms=parts[(name, shape)]))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(card=card, rows=summary)))
        print(f"  every instance's times: {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
