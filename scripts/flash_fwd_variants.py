"""Design variants of the flash-attention forward kernel (K2f) on one NVIDIA
GPU: build each variant of ``msr3d_tpu_torch/csrc/flash_attn_fwd.cu`` by text
substitution, hold it against the plain PyTorch version and print its device
time at the prefill shape (4 x 225 x 32 x 128 bf16), L2-warm and with
operands rotating past the L2, and L2-warm at the training shape (T = 256),
beside SDPA's forward on the same inputs.

    python3 scripts/flash_fwd_variants.py [variant ...] [NAME=PATH ...]

Variants: ``base`` (the source as it is: 64 query rows and 4 warps a block,
a two-stage K/V ring); ``stages3`` (a three-stage ring); ``bm128`` (128
query rows and 8 warps a block); ``bm128-stages3``; ``mask-always`` (the mask
applied in every key tile, not only where it can bite). ``NAME=PATH`` builds
the source at PATH as it is, for example an older commit's kernel, which
then runs beside the others in the same process. The tolerance is
``chip_smoke.py``'s. Nothing here is used by the port.
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

SOURCE = _build.CSRC_DIR / "flash_attn_fwd.cu"
OUT_DIR = _build.BUILD_DIR / "fwd_variants"


def constant(name: str, value: int):
    return lambda src: re.sub(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", src)


def chain(*edits):
    def apply(src):
        for edit in edits:
            src = edit(src)
        return src
    return apply


BM128 = chain(constant("kWarps", 8), constant("kMinBlocks", 1))
VARIANTS = {
    "base": lambda src: src,
    "stages3": constant("kStages", 3),
    "bm128": BM128,
    "bm128-stages3": chain(BM128, constant("kStages", 3)),
    "mask-always": lambda src: re.sub(r"const bool bite = [^;]+;", "const bool bite = true;", src),
}


def build(specs):
    """One nvcc per variant, all started together; ``specs`` maps a name to
    its source text. Returns {name: CDLL}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in specs.items():
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib{name}.so"
        cu.write_text(text)
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
    """Point the port's K2f wrapper at a variant's entry point."""
    kernel = fa.FLASH_FWD_KERNEL
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    kernel._fn = fn


def make(gen, b, t, s, hq, hkv, d, dtype, pads):
    dev = gen.device
    q = torch.randn((b, t, hq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    for row, p in enumerate(pads):
        valid[row, :p] = False
    return q, k, v, valid


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:] or list(VARIANTS)
    text = SOURCE.read_text()
    specs = {}
    for arg in args:
        name, _, path = arg.partition("=")
        specs[name] = Path(path).read_text() if path else VARIANTS[name](text)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build(specs)
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(2)
    path = make(gen, 4, 225, 225, 32, 32, 128, torch.bfloat16, (17, 0, 5, 40))
    cases = {"path": path,
             "gqa": make(gen, 2, 300, 300, 32, 8, 128, torch.bfloat16, (0, 33)),
             "ragged fp16": make(gen, 2, 100, 333, 8, 8, 64, torch.float16, (3, 70)),
             "pad 70": make(gen, 2, 150, 150, 8, 2, 64, torch.bfloat16, (70, 0)),
             "T>S fp16": make(gen, 2, 333, 100, 4, 4, 128, torch.float16, (3, 70)),
             "row all invalid": make(gen, 3, 70, 70, 4, 2, 128, torch.bfloat16, (0, 5, 70))}
    *operands, valid = path
    sets = cs.past_l2(*operands)
    *train, train_valid = make(gen, 4, 256, 256, 32, 32, 128, torch.bfloat16, (17, 0, 5, 40))

    def k2f(q, k, v):
        return fa.flash_attention(q, k, v, key_valid=valid)

    for name, lib in libs.items():
        bind(lib)
        results = {c: cs.flash_against_plain(*inputs) for c, inputs in cases.items()}
        ok = all(r["finite"] and r["zeros"] and r["ratio"] <= 1.0 and r["lse_err"] <= cs.LSE_ATOL
                 for r in results.values())
        warm = cs.device_ms(lambda: k2f(*operands), iters=50)
        hbm = cs.device_ms(cs.rotating(k2f, sets), iters=6 * len(sets))
        at_train = cs.device_ms(lambda: fa.flash_attention(*train, key_valid=train_valid), iters=50)
        occupancy = getattr(lib, "flash_attn_fwd_blocks_per_sm", None)
        blocks = occupancy() if occupancy is not None else "not exposed"
        print(f"  {name}: K2f {warm:.4f} ms L2-warm, {hbm:.4f} ms from HBM, {at_train:.4f} ms "
              f"L2-warm at T = 256, {blocks} blocks an SM; {'within' if ok else 'OUTSIDE'} "
              f"tolerance, max |out - plain| over it "
              + ", ".join(f"{c} {r['ratio']:.3f}" for c, r in results.items()))
    t = operands[0].shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=valid.device).tril()[None, None] \
        & valid[:, None, None, :]

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)

    print(f"  SDPA forward (boolean mask, {cs.sdpa_backend(lambda: sdpa(*operands))}): "
          f"{cs.device_ms(lambda: sdpa(*operands), iters=50):.4f} ms L2-warm, "
          f"{cs.device_ms(cs.rotating(sdpa, sets), iters=6 * len(sets)):.4f} ms from HBM")
    return 0


if __name__ == "__main__":
    sys.exit(main())
