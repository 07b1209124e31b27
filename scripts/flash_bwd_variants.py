"""Design variants of the flash-attention backward kernels (K2dq, K2dkv) on one
NVIDIA GPU: build each variant of ``msr3d_tpu_torch/csrc/flash_attn_bwd.cu``
by text substitution, hold it against the plain PyTorch version and print its
device time at the training shape (4 x 256 x 32 x 128 bf16), L2-warm and with
operands rotating past the L2.

    python3 scripts/flash_bwd_variants.py [variant ...]

Variants: ``base`` (the source as it is); ``dq16``/``dq32``/``dq64`` and
``dkv16``/``dkv32``/``dkv64`` (columns of the score tile a warp holds at a
time); ``one-rounding`` (p and ds rounded once to 16 bits instead of the
hi + lo split: the accuracy the kernels give up nowhere, measured for its
cost). The tolerance is ``chip_smoke.py``'s. Nothing here is used by the port.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
import msr3d_tpu_torch.ops.flash_attention as fa  # noqa: E402
from msr3d_tpu_torch.ops import _build  # noqa: E402

SOURCE = _build.CSRC_DIR / "flash_attn_bwd.cu"
OUT_DIR = _build.BUILD_DIR / "variants"
LO_PRODUCTS = re.compile(r"^ *mma::mma_16816\(acc\[[^\]]+\], lo, .*\n", re.M)


def chunk(kernel: str, width: int):
    return lambda src: re.sub(rf"(constexpr int kChunk{kernel} = )\d+;", rf"\g<1>{width};", src)


VARIANTS = {"base": lambda src: src, "one-rounding": lambda src: LO_PRODUCTS.sub("", src)}
for w in (16, 32, 64):
    VARIANTS[f"dq{w}"] = chunk("Dq", w)
    VARIANTS[f"dkv{w}"] = chunk("Dkv", w)


def build(names):
    """One nvcc per variant, all started together; returns {name: CDLL}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib{name}.so"
        cu.write_text(VARIANTS[name](text))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "Li128E" in line and "bfloat16" in line:
                used = " ".join(x.strip().replace("ptxas info    : ", "") for x in lines[i + 2:i + 4])
                print(f"  {name} {cs.kernel_label(line.split(chr(39))[1])}: {used}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib):
    """Point the port's two wrappers at a variant's entry points."""
    for kernel in (fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL):
        fn = getattr(lib, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        kernel._fn = fn


def make(gen, b, t, s, hq, hkv, d, dtype, pads):
    dev = gen.device
    q, do = (torch.randn((b, t, hq, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    for row, p in enumerate(pads):
        valid[row, :p] = False
    out, lse = fa.flash_attention_reference(q, k, v, key_valid=valid)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, valid


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build(names)
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(5)
    path = make(gen, 4, 256, 256, 32, 32, 128, torch.bfloat16, (17, 0, 5, 40))
    cases = {"path": path,
             "gqa": make(gen, 2, 300, 300, 32, 8, 128, torch.bfloat16, (0, 33)),
             "ragged fp16": make(gen, 2, 100, 333, 8, 8, 64, torch.float16, (3, 70))}
    *args, valid = path
    sets = cs.past_l2(*args)
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for name, lib in libs.items():
        bind(lib)
        ratios = {c: cs.bwd_against_plain(*inputs, wrappers)["ratio"] for c, inputs in cases.items()}
        times = []
        for fn in wrappers:
            def call(*a, fn=fn):
                return fn(*a, key_valid=valid)
            times += [cs.device_ms(lambda: call(*args), iters=50),
                      cs.device_ms(cs.rotating(call, sets), iters=6 * len(sets))]
        print(f"  {name}: K2dq {times[0]:.4f} ms L2-warm, {times[1]:.4f} ms from HBM; K2dkv "
              f"{times[2]:.4f} / {times[3]:.4f} ms; max |grad - plain| over the tolerance "
              + ", ".join(f"{c} {r:.3f}" for c, r in ratios.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
