"""Design variants of the FPS kernel (K1) on one NVIDIA GPU, beside its
earlier design: build ``msr3d_tpu_torch/csrc/fps.cu`` and the earlier
``scripts/fps_parent.cu`` (one nvcc each, started together), hold every
configuration against the plain PyTorch version, and print its device time
by ``torch.profiler`` per launch at the scene encode's four shapes (60
clouds a scene at batch 4 and 16: 240 or 960 clouds, stage 1 1024 -> 32
points, stage 2 32 -> 16), L2-warm and with inputs rotating past the L2.

    python3 scripts/fps_variants.py

The kernel's configurations, through its ``fps_launch_config`` entry:
``W1``, ``W2``, ``W4``, ``W8`` (warps a cloud, one cloud a block),
``W1-C2``, ``W1-C4``, ``W1-C8`` (one warp a cloud and 2, 4 or 8 clouds a
block; stage 2 only, since the clouds a block apply only up to 64 points),
and ``default`` (``fps_launch``, the choice the port takes). The earlier
design runs as ``parent``. The rounds go parent, change, change, parent,
so a drift of the card over the run shows. Nothing here is used by the
port.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from msr3d_tpu_torch.ops import _build  # noqa: E402
from msr3d_tpu_torch.ops.fps import furthest_point_sample_reference  # noqa: E402

SOURCES = {"parent": Path(__file__).with_name("fps_parent.cu"),
           "change": _build.CSRC_DIR / "fps.cu"}
OUT_DIR = _build.BUILD_DIR / "fps_variants"
STAGE1_CONFIGS = {"W1": (1, 1), "W2": (2, 1), "W4": (4, 1), "W8": (8, 1)}
STAGE2_CONFIGS = {**STAGE1_CONFIGS, "W1-C2": (1, 2), "W1-C4": (1, 4), "W1-C8": (1, 8)}
ROUNDS = ("parent", "change", "change", "parent")


def build():
    """Both sources, one nvcc each, started together; prints each kernel
    instance's registers and spills. Returns {name: CDLL}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        so = OUT_DIR / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
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
        libs[name] = ctypes.CDLL(str(so))
    return libs


def launcher(lib, symbol, *config):
    """(xyz, npoint, out) -> out, through one C entry of a built library."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * (3 + len(config))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(x, m, out):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], m, *config, stream)
        if err:
            raise RuntimeError(f"{symbol}{config} failed with CUDA error {err}")
        return out
    return run


def configurations(libs, which, stage):
    if which == "parent":
        return {"parent": launcher(libs["parent"], "fps_launch")}
    table = STAGE1_CONFIGS if stage == 1 else STAGE2_CONFIGS
    runs = {name: launcher(libs["change"], "fps_launch_config", *cfg)
            for name, cfg in table.items()}
    runs["default"] = launcher(libs["change"], "fps_launch")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("fps_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build()
    shapes = {**cs.fps_path_inputs(dev, 240, 1), **cs.fps_path_inputs(dev, 960, 3)}
    ties = cs.fps_tie_cases(dev, 5)
    want = {name: furthest_point_sample_reference(x, m) for name, (x, m) in {**shapes, **ties}.items()}
    times = {}  # (config, shape, "warm" | "hbm") -> [ms, ...]
    for which in ROUNDS:
        print(f"== round: {which}")
        for shape, (x, m) in shapes.items():
            stage = 1 if x.shape[1] > 64 else 2
            out = torch.empty((x.shape[0], m), dtype=torch.int32, device=dev)
            sets = cs.past_l2(x, out)
            for name, run in configurations(libs, which, stage).items():
                for case, (cx, cm) in {shape: (x, m), **ties}.items():
                    got = run(cx, cm, torch.empty((cx.shape[0], cm), dtype=torch.int32,
                                                  device=dev))
                    torch.cuda.synchronize()
                    if not torch.equal(got, want[case]):
                        raise SystemExit(f"fps_variants: {name} differs from plain on {case}")
                warm = cs.device_ms(lambda: run(x, m, out), iters=50)
                hbm = cs.device_ms(cs.rotating(lambda x_, o_: run(x_, m, o_), sets),
                                   iters=min(6 * len(sets), 1200))
                times.setdefault((name, shape, "warm"), []).append(warm)
                times.setdefault((name, shape, "hbm"), []).append(hbm)
                print(f"  {shape} {name}: {warm * 1e3:.3f} us L2-warm, {hbm * 1e3:.3f} us from "
                      f"HBM (device time a launch); equal to plain on the shape and "
                      f"{len(ties)} tie cases")
            del sets
    print("== summary: device time a launch in us, L2-warm / from HBM, each round's value")
    for shape, (x, m) in shapes.items():
        names = sorted({n for n, s, _ in times if s == shape}, key=lambda n: (n != "parent", n))
        print(f"  {shape} (bound {cs.fps_bound((x, m))[0] * 1e3:.3f} us):")
        for name in names:
            warm, hbm = times[(name, shape, "warm")], times[(name, shape, "hbm")]
            print(f"    {name:8s} " + ", ".join(f"{t * 1e3:.3f}" for t in warm) + " / "
                  + ", ".join(f"{t * 1e3:.3f}" for t in hbm))
        change = {n: statistics.mean(times[(n, shape, "warm")]) for n in names if n != "parent"}
        best = min(change, key=change.get)
        parent = statistics.mean(times[("parent", shape, "warm")])
        print(f"    fastest L2-warm: {best}, {parent / change[best]:.2f}x the parent; "
              f"default {parent / change['default']:.2f}x the parent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
