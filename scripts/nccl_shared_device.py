"""Two ranks on one card over NCCL: what NCCL does with them.

    python3 scripts/nccl_shared_device.py

Starts two processes that both take ``cuda:0``, join one NCCL group
(``device_id`` set, so the communicator is made at once) and all-reduce one
tensor; prints each rank's outcome and exits 0 when both were refused. The
port's backend rule (``msr3d_tpu_torch/parallel/mesh.py::backend_for``)
takes gloo for ranks that share a card for this reason. Each rank has a
60 s process-group timeout and the script kills both after 120 s.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys


def rank_main(r: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=r, timeout=datetime.timedelta(seconds=60),
                                device_id=device)
        t = torch.ones(1, device=device)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {r}: all_reduce returned {t.item()}", flush=True)
    except Exception as exc:  # noqa: BLE001 (what NCCL raises is the finding)
        print(f"rank {r}: REFUSED {type(exc).__name__}: {exc}", flush=True)
        sys.exit(3)


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    refused = 0
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + "\n[killed after 120 s: the rank hung]"
        print(f"--- rank {r} (exit {p.returncode}):\n{out[-3000:]}")
        refused += p.returncode == 3
    print(f"NCCL refused two ranks on one card: {refused == 2}")
    return 0 if refused == 2 else 1


if __name__ == "__main__":
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), int(sys.argv[2]))
    else:
        sys.exit(main())
