"""MSNN next-step-navigation evaluators (reference evaluator/one_step_eval.py).

Copy of ``msr3d_tpu/evaluator/one_step_eval.py`` for the port."""

from __future__ import annotations

from typing import Any, Dict

from msr3d_tpu_torch.data.constants import ONESTEPNAVI_ACTION_SPACE_TOKENIZE
from msr3d_tpu_torch.evaluator.build import BaseEvaluator
from msr3d_tpu_torch.registry import EVALUATOR_REGISTRY


@EVALUATOR_REGISTRY.register(name="ObjNavEval")
class ObjNavEval(BaseEvaluator):
    def reset(self) -> None:
        self.eval_dict = {"target_metric": [], "accuracy": []}
        self.total_count = 0
        self.eval_results = []

    def batch_metrics(self, data_dict: Dict[str, Any]) -> Dict[str, float]:
        preds = data_dict["output_text"]
        gts = data_dict["text_output"]
        correct = sum(1 for p, g in zip(preds, gts) if p == g)
        n = len(gts)
        acc = correct / n if n else 0.0
        return {"total_count": n, "accuracy": acc, "target_metric": acc}

    def update(self, data_dict: Dict[str, Any]) -> None:
        metrics = self.batch_metrics(data_dict)
        self.total_count += metrics["total_count"]
        for key in self.eval_dict:
            self.eval_dict[key].append(float(metrics[key]) * metrics["total_count"])

    def record(self, split: str = "val"):
        results = {
            k: (sum(v) / self.total_count if self.total_count else 0.0)
            for k, v in self.eval_dict.items()
        }
        is_best = results["target_metric"] > self.best_result
        if is_best:
            self.best_result = results["target_metric"]
        return is_best, results


@EVALUATOR_REGISTRY.register(name="OneStepNavInstructionEval")
class OneStepNavInstructionEval(ObjNavEval):
    """Exact action-token accuracy + invalid-token rate
    (one_step_eval.py:65-85)."""

    def reset(self) -> None:
        super().reset()
        self.eval_dict["invalid"] = []

    def batch_metrics(self, data_dict: Dict[str, Any]) -> Dict[str, float]:
        preds = data_dict["output_text"]
        gts = data_dict["text_output"]
        valid_tokens = set(ONESTEPNAVI_ACTION_SPACE_TOKENIZE.values())
        correct = sum(1 for p, g in zip(preds, gts) if p == g)
        invalid = sum(1 for p in preds if p not in valid_tokens)
        n = len(gts)
        return {
            "total_count": n,
            "accuracy": correct / n if n else 0.0,
            "invalid": invalid / n if n else 0.0,
            "target_metric": correct / n if n else 0.0,
        }
