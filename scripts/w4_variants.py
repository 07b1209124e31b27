"""Design variants of the int4 dequant-matmul kernel (K4) on one NVIDIA GPU,
beside its earlier design: the machinery of ``scripts/w8_variants.py`` run
on ``msr3d_tpu_torch/csrc/w4_matmul.cu`` (the int4 instance of
``csrc/wq_matmul.cuh``), its copies made by text substitution in the header
(16 KB stages; 8 warps a block with 16 KB stages) and
``scripts/w4_parent.cu`` (the earlier CUDA-core kernel, the int4 instance
of ``scripts/dequant_matmul.cuh``). Every instance is held against the
plain version (``matmul_w4_reference``, within DEQ_ATOL, DEQ_RTOL and
DEQ_W4_BIAS of ``chip_smoke.py``) and timed by device time a launch at the
three Vicuna-7B projection shapes at B 4 and 16, L2-warm and from HBM, in
rounds parent, change, change, parent.

    python3 scripts/w4_variants.py [--splits 1-16] [--quick] [--diagnose]
                                   [--baseline PATH] [--json PATH]

Instances: split 1-16 of the K/2 packed rows x column tile 32/64/128 x 2-4
ring stages x source (``8k``, ``16k``, ``8w16k``); ``default`` is
``plan_w4``'s. ``--quick`` times the default and the parent only,
``--diagnose`` adds copies of the default instance that skip the products
or the copies. Every instance's times go to ``build/w4_variants.json`` or
``--json PATH``. Nothing here is used by the port.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from w8_variants import Kernel, run  # noqa: E402

from msr3d_tpu_torch.ops.w4_matmul import matmul_w4_reference, pack_w4, plan_w4  # noqa: E402


def int4_weight(gen, k, n, dev):
    """(K/2, N) int8 in ``pack_w4``'s layout from int4 values in [-8, 7], and
    a per-channel scale of the size quantization gives N(0, 0.02) weights."""
    w4 = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
    return pack_w4(w4), torch.rand(n, generator=gen, device=dev) * (0.09 / 7)


K4 = Kernel("w4", 4, plan_w4, matmul_w4_reference, int4_weight)

if __name__ == "__main__":
    sys.exit(run(K4))
