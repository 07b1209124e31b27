"""Evaluator registry + builders (reference evaluator/build.py:3-26).

Copy of ``msr3d_tpu/evaluator/build.py`` for the port: one evaluator a
task that names one in the YAML task table, saving under
``exp_dir/eval/<task>``."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from msr3d_tpu_torch.registry import EVALUATOR_REGISTRY


class BaseEvaluator:
    """Contract: update(data_dict) / record(split) → (is_best, eval_dict) /
    reset() (evaluator/build.py:6-20)."""

    def __init__(self, cfg=None, task_name: str = "", save_dir: str | Path = "."):
        self.cfg = cfg
        self.task_name = task_name
        self.save_dir = Path(save_dir)
        self.save = bool(cfg.get("eval", {}).get("save", True)) if cfg else True
        self.best_result = -float("inf")
        self.reset()

    def reset(self) -> None:
        raise NotImplementedError

    def update(self, data_dict: Dict[str, Any]) -> None:
        raise NotImplementedError

    def record(self, split: str = "val"):
        raise NotImplementedError


def build_eval_leo(cfg, evaluator_name: str, task_name: str, save_dir="."):
    return EVALUATOR_REGISTRY.get(evaluator_name)(
        cfg, task_name=task_name, save_dir=save_dir
    )


def build_task_evaluators(cfg, exp_dir: str | Path) -> Dict[str, Any]:
    """Build one evaluator per task that declares one (configs/msr3d.yaml
    task table)."""
    # imports for registration side effects
    from msr3d_tpu_torch.evaluator import msqa_eval, one_step_eval, sqa3d_eval  # noqa: F401

    evaluators: Dict[str, Any] = {}
    for task_name, task_cfg in cfg.get("task", {}).items():
        name = task_cfg.get("evaluator")
        if name:
            evaluators[task_name] = build_eval_leo(
                cfg, name, task_name, save_dir=Path(exp_dir) / "eval" / task_name
            )
    return evaluators
