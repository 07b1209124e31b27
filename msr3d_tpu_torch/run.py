"""The entry: a YAML config and dotlist overrides → training and evaluation.

    python -m msr3d_tpu_torch.run --config configs/debug_synthetic.yaml device=cpu
    python -m msr3d_tpu_torch.run --config configs/debug_synthetic.yaml device=cpu \
        mode=test

Counterpart of the JAX package's root ``run.py``: compose the experiment
directory from ``base_dir``, ``name`` and ``naming_keywords`` (unless
``exp_dir`` is set), save the resolved config there as ``config.yaml``,
then ``build_trainer(cfg).run()``: ``mode: train`` trains and evaluates val
and test, any other mode (``test``, ``eval``) evaluates the test split from
the ``best`` weights when there are some. It runs on the GPU; ``device=cpu`` picks
the CPU, and without a GPU any other device raises. The JAX-only keys
``jax_platform`` and ``compile_cache*`` are ignored with a log line.

Under the ``torch.distributed`` env contract (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, as ``python -m msr3d_tpu_torch.launch
--mode accelerate`` sets it) the process joins the group as one rank of a
run on the card ``cuda:LOCAL_RANK % cards``, rank 0 alone writes the
snapshot, and the group is left on the way out, also on an exception. The
ranks form dp × tp × pp × sp with ``parallel.tp``, ``parallel.pp`` and
``parallel.sp`` from the YAML or an override (``parallel.tp=2``,
``parallel.pp=2``, ``parallel.sp=2``; dp is what they leave). Each rank
ends with a ``run summary`` log line: its rank, dp, tp, pp, sp and its tp
rank, stage and sequence block, backend, device, the LLM parameters it
holds, the tp collectives', the pp transfers' and the ring's hops' counts
and host seconds (a step's too), steps and their ms, peak device memory
and its kernels' launches.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from msr3d_tpu_torch.config import load_config, save_config
from msr3d_tpu_torch.device import resolve_device
from msr3d_tpu_torch.parallel import mesh, pipeline, ring_attention, tensor_parallel
from msr3d_tpu_torch.utils.logging import get_logger

logger = get_logger("msr3d_tpu_torch.run")


def compose_exp_dir(cfg) -> str:
    """exp_dir = base_dir / name / the values of ``naming_keywords``."""
    if cfg.get("exp_dir"):
        return cfg.exp_dir
    base = cfg.get("base_dir") or "./outputs"
    parts = [cfg.get("name", "msr3d_tpu")]
    for key in cfg.get("naming_keywords", []):
        val = cfg.get(key, "")
        if val:
            parts.append(str(val))
    return str(Path(base, *parts))


def main(argv=None):
    """Parse, build and run; returns the trainer."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", "--config-name", dest="config", required=True)
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="key=value overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, overrides=[o for o in args.opts if "=" in o])
    device = resolve_device(cfg.get("device"))
    joined = mesh.initialize_distributed_from_env(device.type)
    try:
        device = mesh.rank_device(device)
        cfg["device"] = str(device)
        for key in cfg:
            if key == "jax_platform" or key.startswith("compile_cache"):
                logger.info(f"ignoring {key}={cfg.get(key)!r}: a JAX-only setting")
        cfg["exp_dir"] = compose_exp_dir(cfg)
        Path(cfg.exp_dir).mkdir(parents=True, exist_ok=True)
        if mesh.is_main_process():
            save_config(cfg, Path(cfg.exp_dir) / "config.yaml")
        logger.info(f"exp_dir: {cfg.exp_dir}, device: {device}, rank {mesh.rank()} of "
                    f"{mesh.world_size()}")

        from msr3d_tpu_torch.trainer.leo_trainer import build_trainer

        trainer = build_trainer(cfg)
        trainer.run()
        logger.info(f"run summary {json.dumps(run_summary(trainer, device))}")
        return trainer
    finally:
        if joined:
            mesh.destroy()


def run_summary(trainer, device: torch.device) -> dict:
    """What this rank did: steps, their ms (dispatch to read), peak device
    memory and each kernel's launches."""
    import torch.distributed as dist

    import msr3d_tpu_torch.ops.flash_attention as fa
    from msr3d_tpu_torch.ops.fps import FPS_KERNEL

    kernels = (FPS_KERNEL, fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_DQ_KERNEL, fa.FLASH_BWD_DKV_KERNEL)
    llm = trainer.model.network.llm
    return {
        "rank": mesh.rank(), "world": mesh.world_size(), "dp": trainer.dp, "tp": trainer.tp,
        "tp_rank": mesh.tp_rank(), "pp": trainer.pp, "pp_rank": mesh.pp_rank(),
        "sp": trainer.sp, "sp_rank": mesh.sp_rank(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        # the LLM's parameters this rank holds (its shards under tp), and
        # the tp operators' collectives with their host seconds
        "llm_params": sum(p.numel() for p in llm.parameters()),
        "tp_comm": dict(tensor_parallel.COMM), "step_tp_comm_s": trainer.tp_comm_history,
        # the pp transfers (activations, their gradients, the masks) with
        # their host seconds, the step's, and their bytes
        "pp_comm": dict(pipeline.COMM), "step_pp_comm_s": trainer.pp_comm_history,
        # the ring's hops (key/value blocks, their gradients) and the loss's
        # sums over sp, with their host seconds, the step's, and their bytes
        "sp_comm": dict(ring_attention.COMM), "step_sp_comm_s": trainer.sp_comm_history,
        "device": str(device), "steps": trainer.step,
        "step_ms": [1e3 * t for t in trainer.timer.history],
        # the loop's wait on the loader a step (under tp, tp rank 0's loading
        # and the batch's broadcast over the tp group)
        "data_wait_ms": [1e3 * t for t in trainer.data_wait_history],
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
        "launches": {k.symbol.replace("_launch", ""): k.launches for k in kernels},
    }


if __name__ == "__main__":
    main()
