"""Design variants of the int8 dequant-matmul kernel (K3) on one NVIDIA GPU,
beside its earlier design, and the machinery that ``scripts/w4_variants.py``
runs for K4: build ``msr3d_tpu_torch/csrc/w8_matmul.cu`` (on
``csrc/wq_matmul.cuh``), copies of it made by text substitution in the
header (stages of twice the bytes; 8 warps a block with stages of twice
the bytes) and ``scripts/w8_parent.cu`` (the earlier CUDA-core kernel, the int8
instance of ``scripts/dequant_matmul.cuh``), one nvcc each, started
together; hold every instance against the plain PyTorch version, and print
its device time a launch by ``torch.profiler`` at the three Vicuna-7B
projection shapes at B 4 and 16, L2-warm and with the weight read from HBM
(copies spanning 256 MB, past the 50 MB L2).

    python3 scripts/w8_variants.py [--splits 1-16] [--quick] [--diagnose]
                                   [--baseline PATH] [--json PATH]

The kernel's instances: split (K split across blocks, 1-16) x column tile
(32, 64, 128) x stages of the cp.async ring (2, 3, 4) x source (``base``,
the source as it is: 8 KB of weight a stage for K3, 16 KB for K4;
``bigstage``, stages of twice the bytes; ``8warps``, 8 warps a block with
stages of twice the bytes, so each warp's stage is as large as in
``base``), named ``base-s4-t128-r4``, and
``default`` (the plan's choice, the one the port takes). The earlier design
runs as ``parent``. One profile times every instance of a shape: a marker
kernel between instances separates their launches. The rounds go parent,
change, change, parent, so a drift of the card over the run shows.
``--quick`` times only the default and the parent; ``--diagnose`` adds the
default instance of copies that skip part of the work (the products, the
copies, both, or x's copies), to show which part sets the time;
``--baseline PATH`` builds another source of the kernel as it is (the
parent commit's, from ``git archive``), requires every instance of it to
give the same bits as the same instance of the kernel at the six shapes and
the card tests' ragged shapes, and times its default instance as
``baseline``. Nothing here is used by the port.
"""

import argparse
import ctypes
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from msr3d_tpu_torch.ops import _build  # noqa: E402
from msr3d_tpu_torch.ops.w8_matmul import (  # noqa: E402
    ROW_TILE,
    STAGE_BYTES,
    STAGES,
    TILES,
    matmul_w8_reference,
    plan_w8,
    split_counters,
)

HEADER = _build.CSRC_DIR / "wq_matmul.cuh"
INCLUDE = '#include "wq_matmul.cuh"'
STAGE_LINE = f"constexpr int kStageBytes = {STAGE_BYTES};"
WARPS_LINE = "constexpr int kWarps = 4;"
ROUNDS = ("parent", "change", "change", "parent")
# the kernels timed (any other kernel is a marker): the kernel, a baseline
# source from before its header (w8_matmul_kernel), the parent
OURS = ("wq_matmul_kernel", "w8_matmul_kernel", "dequant_matmul_kernel")


@dataclasses.dataclass(frozen=True)
class Kernel:
    """What the machinery needs of K3 or K4: its source and the parent's,
    their C entries, the plan, the plain version and the operands (x's
    columns k, the weight for n outputs)."""
    name: str  # "w8" or "w4"
    bits: int
    plan: Callable
    reference: Callable
    weight: Callable  # (generator, k, n, device) -> (wq, scale)
    ragged: tuple = ()  # (B, K, N) of the card tests' ragged cases

    @property
    def source(self):
        return _build.CSRC_DIR / f"{self.name}_matmul.cu"

    @property
    def parent(self):
        return Path(__file__).with_name(f"{self.name}_parent.cu")

    @property
    def out_dir(self):
        return _build.BUILD_DIR / f"{self.name}_variants"


def int8_weight(gen, k, n, dev):
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    return wq, torch.rand(n, generator=gen, device=dev) * (0.09 / 127)


K3 = Kernel("w8", 8, plan_w8, matmul_w8_reference, int8_weight,
            ragged=((1, 520, 1001), (7, 4104, 1000), (37, 520, 640), (16, 777, 1001),
                    (5, 24, 96), (7, 2600, 1000)))


# Copies of the kernel made by substitution in the header: other stage
# bytes, other warps a block; with --diagnose, copies that skip one half of
# the work (their outputs are wrong and not checked): the copies only, or
# the products only (on whatever the ring holds)
VARIANTS = {
    "bigstage": [(STAGE_LINE, f"constexpr int kStageBytes = {2 * STAGE_BYTES};")],
    "8warps": [(STAGE_LINE, f"constexpr int kStageBytes = {2 * STAGE_BYTES};"),
               (WARPS_LINE, "constexpr int kWarps = 8;")],
}
_NO_PRODUCTS = [("for (int step = 0; step < T::KSW; ++step) {",
                 "for (int step = 0; step < (k < 0 ? T::KSW : 0); ++step) {")]
_NO_COPIES = [("    if (s < nt)\n", "    if (s < nt && k < 0)\n"),
              ("    if (it + STAGES - 1 < nt)\n", "    if (it + STAGES - 1 < nt && k < 0)\n")]
DIAGNOSE = {
    "copies-only": _NO_PRODUCTS,
    "products-only": _NO_COPIES,
    # neither: the launch, the ring's waits, the warps' sums and the split's epilogue
    "fixed": _NO_PRODUCTS + _NO_COPIES,
    # the whole kernel but x's copies: their share
    "no-x": [("  for (int side = 0; side < T::SIDES; ++side) {\n    if constexpr (XV) {",
              "  for (int side = 0; side < (k < 0 ? T::SIDES : 0); ++side) {\n    if constexpr (XV) {")],
}


def substituted(kernel, name, edits):
    """The kernel's source with the header pasted in place of its #include
    and ``edits`` made to it, written to the variants' build directory."""
    header = HEADER.read_text()
    for old, new in edits:
        if old not in header:
            raise SystemExit(f"{kernel.name}_variants: {HEADER.name} lacks {old!r} for {name}")
        header = header.replace(old, new)
    text = kernel.source.read_text()
    if INCLUDE not in text:
        raise SystemExit(f"{kernel.name}_variants: {kernel.source.name} lacks {INCLUDE!r}")
    path = kernel.out_dir / f"{kernel.name}_matmul_{name}.cu"
    path.write_text(text.replace(INCLUDE, header))
    return path


def sources(kernel, diagnose, baseline=None):
    """{library: source}: the parent, the kernel as it is (``base``), its
    copies of VARIANTS, to diagnose the copies of DIAGNOSE, and a baseline
    source as it is."""
    kernel.out_dir.mkdir(parents=True, exist_ok=True)
    out = {"parent": kernel.parent, "base": kernel.source}
    out.update({name: substituted(kernel, name, edits) for name, edits in VARIANTS.items()})
    if diagnose:
        out.update({name: substituted(kernel, name, edits) for name, edits in DIAGNOSE.items()})
    if baseline:
        out["baseline"] = Path(baseline)
    return out


def build(kernel, diagnose, baseline=None):
    """Every source, one nvcc each, started together; prints each kernel
    instance's registers and spills (and the instances of the kernel or its
    copies that spill). Returns {name: CDLL}."""
    procs = {}
    for name, src in sources(kernel, diagnose, baseline).items():
        so = kernel.out_dir / f"lib{name}.so"
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
                        and name not in ("parent", "baseline")):  # timed as they were
                    spills.append(f"{name} {entry}")
        libs[name] = ctypes.CDLL(str(so))
    if spills:
        print(f"  REGISTER SPILLS in {spills}")
    return libs


def change_launcher(kernel, lib, split, tile, stages):
    """(x, wq, scale) -> y through the kernel's C entry at one instance."""
    fn = getattr(lib, f"{kernel.name}_matmul_launch")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wq, scale):
        (b, k), n = x.shape, wq.shape[1]
        y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
        ws = torch.empty(split * b * n if split > 1 else 0, dtype=torch.float32, device=x.device)
        cnt = split_counters(x.device, -(-n // tile) * -(-b // ROW_TILE))
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 ws.data_ptr() if split > 1 else None, cnt.data_ptr(), b, k, n, split, tile,
                 stages, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"{kernel.name}_matmul_launch({split}, {tile}, {stages}) failed: "
                               f"{err}")
        return y
    return run


def parent_launcher(kernel, lib):
    fn = getattr(lib, f"{kernel.name}_parent_launch")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wq, scale):
        (b, k), n = x.shape, wq.shape[1]
        y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(), b, k, n,
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"{kernel.name}_parent_launch failed: {err}")
        return y
    return run


def configurations(kernel, libs, which, shape, splits, quick, fits):
    if which == "parent":
        return {"parent": parent_launcher(kernel, libs["parent"])}
    own = "base"
    plan = kernel.plan(*shape)
    runs = {"default": change_launcher(kernel, libs[own], *plan)}
    if "baseline" in libs:
        runs["baseline"] = change_launcher(kernel, libs["baseline"], *plan)
    if not quick:
        for lib, split, tile, stages in itertools.product(
                [own, *VARIANTS], splits, TILES, STAGES):
            if fits[(lib, tile, stages)]:  # else its shared memory exceeds a block's
                runs[f"{lib}-s{split}-t{tile}-r{stages}"] = change_launcher(
                    kernel, libs[lib], split, tile, stages)
    for lib in DIAGNOSE:
        if lib in libs:  # the default instance, halved
            runs[lib] = change_launcher(kernel, libs[lib], *plan)
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
        raise SystemExit("variants: three profiles without the expected segments")
    return {name: (sum(seg.values()) / iters, {k: v / iters for k, v in seg.items()})
            for (name, _), seg in zip(calls, segments)}


def same_bits_as_baseline(kernel, libs, dev, gen, shapes, splits):
    """Every instance (split x tile x stages) of the kernel as it is against
    the same instance of the baseline source, bit for bit, at ``shapes``."""
    own = "base"
    for b, k, n in shapes:
        x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
        wq, scale = kernel.weight(gen, k, n, dev)
        for split, tile, stages in itertools.product(splits, TILES, STAGES):
            got = change_launcher(kernel, libs[own], split, tile, stages)(x, wq, scale)
            was = change_launcher(kernel, libs["baseline"], split, tile, stages)(x, wq, scale)
            if not torch.equal(got, was):
                raise SystemExit(f"{kernel.name}_variants: instance ({split}, {tile}, {stages}) "
                                 f"differs from the baseline's at {(b, k, n)}")
    print(f"  every instance ({len(splits)} splits x {len(TILES)} tiles x {len(STAGES)} stages) "
          f"bit-identical to the baseline's at {list(shapes)}")


def run(kernel, argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="1-16")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--json", default=str(ROOT / "build" / f"{kernel.name}_variants.json"))
    args = ap.parse_args(argv)
    what = f"{kernel.name}_variants"
    if not torch.cuda.is_available():
        print(f"{what}: no CUDA device", file=sys.stderr)
        return 2
    lo, _, hi = args.splits.partition("-")
    splits = list(range(int(lo), int(hi or lo) + 1))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    libs = build(kernel, args.diagnose, args.baseline)
    fits = {}  # (library, tile, stages) -> blocks an SM; 0: the instance does not fit
    for name, lib in libs.items():
        if name not in ("parent", "baseline") and name not in DIAGNOSE:
            fn = getattr(lib, f"{kernel.name}_matmul_blocks_per_sm")
            fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
            fits.update({(name, t, r): fn(t, r) for t in TILES for r in STAGES})
            print(f"  {name}: blocks an SM (tile, stages): "
                  + ", ".join(f"({t}, {r}) {fits[(name, t, r)]}" for t in TILES for r in STAGES))
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = [(b, k, n) for b in (4, 16) for k, n in cs.SHAPES_7B]
    if "baseline" in libs:
        same_bits_as_baseline(kernel, libs, dev, gen, [*shapes, *kernel.ragged], splits)
    times = {}  # (config, shape, "warm" | "hbm") -> [ms, ...]
    parts = {}  # (config, shape) -> {kernel: ms}, from HBM, the last round
    for which in ROUNDS:
        print(f"== round: {which}")
        for shape in shapes:
            b, k, n = shape
            x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
            wq, scale = kernel.weight(gen, k, n, dev)
            want = kernel.reference(x, wq, scale)
            sets = cs.past_l2(wq, scale)
            runs = configurations(kernel, libs, which, shape, splits, args.quick, fits)
            worst, outs = 0.0, {}
            for name, fn in runs.items():
                if name in DIAGNOSE:
                    continue
                outs[name] = fn(x, wq, scale)
                res = cs.dequant_errors(outs[name], want, x, scale, kernel.bits)
                if not (res["finite"] and res["ratio"] <= 1.0):
                    raise SystemExit(f"{what}: {name} differs from plain at {shape}: {res}")
                worst = max(worst, res["ratio"])
            if "baseline" in outs and not torch.equal(outs["baseline"], outs["default"]):
                raise SystemExit(f"{what}: the baseline's output differs from the default's at "
                                 f"{shape}")
            del outs
            warm = segment_times(dev, [(nm, (lambda r: lambda: r(x, wq, scale))(fn))
                                       for nm, fn in runs.items()], iters=10)
            hbm = segment_times(dev, [(nm, cs.rotating(lambda w, s, r=fn: r(x, w, s), sets))
                                      for nm, fn in runs.items()], iters=len(sets))
            for name in runs:
                times.setdefault((name, shape, "warm"), []).append(warm[name][0])
                times.setdefault((name, shape, "hbm"), []).append(hbm[name][0])
                parts[(name, shape)] = hbm[name][1]
            best = min((c for c in runs), key=lambda c: hbm[c][0])
            print(f"  B={b:2d} K={k:5d} N={n:5d}: {len(runs)} instances within tolerance of "
                  f"plain (at most {worst:.3f} of it)"
                  + ("; the baseline bit-identical to the default" if "baseline" in runs else "")
                  + f"; fastest from HBM {best} {hbm[best][0] * 1e3:.2f} us; "
                  + ("" if which == "parent" else f"default {hbm['default'][0] * 1e3:.2f} us"))
            del sets
    print(f"== summary ({card}): device time a launch in us, L2-warm / from HBM, each round")
    summary = []
    fixed = ("parent", "default", "baseline", *DIAGNOSE)
    for shape in shapes:
        b, k, n = shape
        names = sorted({c for c, s, _ in times if s == shape},
                       key=lambda c: statistics.mean(times[(c, shape, "hbm")]))
        mean = {c: statistics.mean(times[(c, shape, "hbm")]) for c in names}
        parent = mean["parent"]
        print(f"  B={b} K={k} N={n} (bound {cs.dequant_bound(b, k, n, kernel.bits)[0] * 1e3:.2f} "
              f"us, default {kernel.plan(b, k, n)}):")
        shown = [c for c in names if c not in fixed][:8] + [c for c in fixed[1:] if c in names] \
            + ["parent"]
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
    sys.exit(run(K3))
