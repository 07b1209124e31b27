"""The port's launcher: the training entry as one process or one process a rank.

    python -m msr3d_tpu_torch.launch --mode python --config configs/debug_synthetic.yaml device=cpu
    python -m msr3d_tpu_torch.launch --mode accelerate --num_processes 2 \
        --config configs/debug_synthetic.yaml device=cpu
    python -m msr3d_tpu_torch.launch --mode accelerate --config configs/msr3d.yaml parallel.tp=2
    python -m msr3d_tpu_torch.launch --mode accelerate --config configs/msr3d.yaml parallel.pp=2
    python -m msr3d_tpu_torch.launch --mode accelerate --config configs/msr3d.yaml parallel.sp=2
    python -m msr3d_tpu_torch.launch --mode submitit --num_nodes 2 --partition P --config ...

Counterpart of the JAX package's root ``launch.py``, with its three modes:

  python      ``msr3d_tpu_torch.run.main`` in this process, one rank.
  accelerate  one process a rank on this node (``--num_processes``, the
              reference's ``accelerate launch`` flag; by default the card
              count rounded up to a multiple of ``parallel.tp`` x
              ``parallel.pp`` x ``parallel.sp``, so ``parallel.tp=2``,
              ``parallel.pp=2`` or ``parallel.sp=2`` on one card starts two
              ranks that share it over gloo), each ``python -m msr3d_tpu_torch.run`` under the
              ``torch.distributed`` env contract with node 0 at
              127.0.0.1:``--port``. It waits for every rank; when one fails
              it ends the others and exits with the first failure's code.
              SIGTERM and SIGINT are passed on to the ranks.
  submitit    one SLURM task a node (needs ``submitit``); each task spawns
              its node's ranks as ``accelerate`` does, with ``MASTER_ADDR``
              the first node's host name.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", default="python", choices=["python", "accelerate", "submitit"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--num_processes", type=int, default=None,
                        help="ranks on a node (accelerate, submitit); the card count by default")
    parser.add_argument("--name", default="msr3d_tpu", help="job name (submitit)")
    parser.add_argument("--partition", default="", help="SLURM partition")
    parser.add_argument("--num_nodes", type=int, default=1)
    parser.add_argument("--port", type=int, default=12345, help="node 0's rendezvous port")
    parser.add_argument("--time", type=int, default=4320, help="minutes")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def rank_envs(node: int, num_nodes: int, per_node: int, addr: str, port: int) -> List[Dict[str, str]]:
    """The env contract of each of node ``node``'s ranks."""
    return [dict(RANK=str(node * per_node + local), LOCAL_RANK=str(local),
                 WORLD_SIZE=str(num_nodes * per_node), LOCAL_WORLD_SIZE=str(per_node),
                 MASTER_ADDR=addr, MASTER_PORT=str(port))
            for local in range(per_node)]


def run_ranks(argv: List[str], envs: List[Dict[str, str]], grace_s: float = 30.0) -> int:
    """``python -m msr3d_tpu_torch.run argv`` once for each env; the exit code
    of the first rank that fails (0 when all succeed). A failure ends the
    other ranks: SIGTERM, then SIGKILL after ``grace_s``."""
    procs = [subprocess.Popen([sys.executable, "-m", "msr3d_tpu_torch.run", *argv],
                              env={**os.environ, **env}) for env in envs]

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    saved = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            saved[sig] = signal.signal(sig, forward)
    except ValueError:  # not the main thread: the ranks get signals directly
        pass
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or None not in codes:
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for sig, prev in saved.items():
            signal.signal(sig, prev)
        end = time.monotonic() + grace_s
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _model_parallel(args) -> int:
    """``parallel.tp`` x ``parallel.pp`` x ``parallel.sp`` of the config with
    its overrides (1 when unset)."""
    from msr3d_tpu_torch.config import load_config

    cfg = load_config(args.config, overrides=[o for o in args.opts if "=" in o])
    parallel = cfg.get("parallel") or {}
    return int(parallel.get("tp", 1)) * int(parallel.get("pp", 1)) * int(parallel.get("sp", 1))


def _per_node(args) -> int:
    """``--num_processes``, else a rank a card rounded up to a multiple of
    tp x pp x sp (those ranks share a card where there are fewer cards)."""
    if args.num_processes is not None:
        return args.num_processes
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        raise SystemExit("no CUDA device to count: give --num_processes (with device=cpu "
                         "for ranks on the CPU)")
    mp = _model_parallel(args)
    return -(-n // mp) * mp


def _entry_argv(args) -> List[str]:
    return ["--config", args.config, *args.opts]


def python_launch(args) -> int:
    from msr3d_tpu_torch import run

    run.main(_entry_argv(args))
    return 0


def accelerate_launch(args) -> int:
    return run_ranks(_entry_argv(args), rank_envs(0, 1, _per_node(args), "127.0.0.1", args.port))


def submitit_launch(args) -> int:
    try:
        import submitit
    except ImportError as e:
        raise SystemExit("submitit not installed; use --mode python for local runs") from e

    executor = submitit.AutoExecutor(folder="slurm_logs")
    executor.update_parameters(
        name=args.name,
        slurm_partition=args.partition,
        nodes=args.num_nodes,
        tasks_per_node=1,
        timeout_min=args.time,
        slurm_max_num_timeout=30,
        slurm_signal_delay_s=120,
    )

    def job():
        env = submitit.JobEnvironment()
        code = run_ranks(_entry_argv(args), rank_envs(env.node, env.num_nodes, _per_node(args),
                                                       env.hostnames[0], args.port))
        if code:
            raise SystemExit(code)

    executor.submit(job)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return {"python": python_launch, "accelerate": accelerate_launch,
            "submitit": submitit_launch}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
