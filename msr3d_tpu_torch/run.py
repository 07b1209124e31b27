"""The training entry: a YAML config and dotlist overrides → a trained model.

    python -m msr3d_tpu_torch.run --config configs/debug_synthetic.yaml \
        device=cpu task.msqa_scannet.mode=[]

Counterpart of the JAX package's root ``run.py``: compose the experiment
directory from ``base_dir``, ``name`` and ``naming_keywords`` (unless
``exp_dir`` is set), save the resolved config there as ``config.yaml``,
then ``build_trainer(cfg).run()``. It runs on the GPU; ``device=cpu`` picks
the CPU, and without a GPU any other device raises. The JAX-only keys
``jax_platform`` and ``compile_cache*`` are ignored with a log line.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from msr3d_tpu_torch.config import load_config, save_config
from msr3d_tpu_torch.device import resolve_device
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
    """Parse, build and train; returns the trainer."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", "--config-name", dest="config", required=True)
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="key=value overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, overrides=[o for o in args.opts if "=" in o])
    device = resolve_device(cfg.get("device"))
    cfg["device"] = str(device)
    for key in cfg:
        if key == "jax_platform" or key.startswith("compile_cache"):
            logger.info(f"ignoring {key}={cfg.get(key)!r}: a JAX-only setting")
    cfg["exp_dir"] = compose_exp_dir(cfg)
    Path(cfg.exp_dir).mkdir(parents=True, exist_ok=True)
    save_config(cfg, Path(cfg.exp_dir) / "config.yaml")
    logger.info(f"exp_dir: {cfg.exp_dir}, device: {device}")

    from msr3d_tpu_torch.trainer.leo_trainer import build_trainer

    trainer = build_trainer(cfg)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
