"""MSQA evaluator: EM-R + caption metrics (reference evaluator/msqa_eval.py,
cap_eval.py). Copy of ``msr3d_tpu/evaluator/msqa_eval.py`` for the port;
``record`` writes ``results.json`` on a new best and on ``test``."""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

from msr3d_tpu_torch.evaluator.build import BaseEvaluator
from msr3d_tpu_torch.evaluator.capeval import (
    BleuScorer,
    CiderScorer,
    MeteorScorer,
    RougeScorer,
)
from msr3d_tpu_torch.evaluator.text_utils import answer_match, clean_answer
from msr3d_tpu_torch.registry import EVALUATOR_REGISTRY


class GenerationEval(BaseEvaluator):
    """Caption-metric base (reference evaluator/cap_eval.py:18-145)."""

    def reset(self) -> None:
        self.eval_dict: Dict[str, List[float]] = {"target_metric": []}
        self.total_count = 0
        self.eval_results: List[Dict[str, Any]] = []
        self.gt_sentences: List[List[str]] = []
        self.pred_sentences: List[List[str]] = []
        self.cider_scorer = CiderScorer()
        self.bleu_scorer = BleuScorer()
        self.meteor_scorer = MeteorScorer()
        self.rouge_scorer = RougeScorer()

    def collect_sentences(self, data_dict: Dict[str, Any]) -> None:
        for pred, gts in zip(data_dict["output_text"], data_dict["answer_list"]):
            gt_answers = gts.split("[answer_seq]") if isinstance(gts, str) else list(gts)
            self.gt_sentences.append([clean_answer(g) for g in gt_answers])
            self.pred_sentences.append([clean_answer(pred)])

    def caption_metrics(self) -> Dict[str, float]:
        gts = {i: v for i, v in enumerate(self.gt_sentences)}
        res = {i: v for i, v in enumerate(self.pred_sentences)}
        if not gts:
            return {"cider": 0.0, "bleu": 0.0, "meteor": 0.0, "rouge": 0.0}
        return {
            "cider": self.cider_scorer.compute_score(gts, res)[0],
            "bleu": self.bleu_scorer.compute_score(gts, res)[0][-1],
            "meteor": self.meteor_scorer.compute_score(gts, res)[0],
            "rouge": self.rouge_scorer.compute_score(gts, res)[0],
        }


@EVALUATOR_REGISTRY.register(name="GenerationEval")
class GenerationEvalFull(GenerationEval):
    """The reference's registered GenerationEval (cap_eval.py:18-145):
    target metric = sentence-transformer cosine similarity between each
    prediction and its ground truth (MiniLM when available; documented
    hashing-cosine substitute otherwise — see evaluator/sentence_sim.py),
    plus corpus CIDEr/BLEU/METEOR/ROUGE at ``record``."""

    def __init__(self, cfg=None, task_name: str = "", save_dir=".",
                 sentence_encoder=None):
        from msr3d_tpu_torch.evaluator.sentence_sim import build_sentence_encoder

        self.sentence_encoder = sentence_encoder or build_sentence_encoder()
        super().__init__(cfg, task_name, save_dir)

    def reset(self) -> None:
        super().reset()
        self.eval_dict = {"target_metric": [], "sentence_sim": []}

    def update(self, data_dict: Dict[str, Any]) -> None:
        from msr3d_tpu_torch.evaluator.sentence_sim import sentence_cos_sim

        preds = list(data_dict["output_text"])
        gts = [
            (g.split("[answer_seq]")[0] if isinstance(g, str) else list(g)[0])
            for g in data_dict.get("text_output", data_dict.get("answer_list", preds))
        ]
        self.collect_sentences(
            {"output_text": preds, "answer_list": data_dict.get(
                "text_output", data_dict.get("answer_list", preds))}
        )
        sims = sentence_cos_sim(self.sentence_encoder, preds, gts)
        n = len(preds)
        self.total_count += n
        sim = float(np.mean(sims)) if n else 0.0
        self.eval_dict["sentence_sim"].append(sim * n)
        self.eval_dict["target_metric"].append(sim * n)
        if self.save:
            for i in range(n):
                self.eval_results.append(
                    {
                        "source": _get(data_dict, "source", i),
                        "scan_id": _get(data_dict, "scan_id", i),
                        "instruction": _get(data_dict, "prompt", i)
                        or _get(data_dict, "prompt_after_obj", i),
                        "response_gt": gts[i],
                        "response_pred": preds[i],
                    }
                )

    def record(self, split: str = "val"):
        results = {
            k: (sum(v) / self.total_count if self.total_count else 0.0)
            for k, v in self.eval_dict.items()
        }
        results.update(self.caption_metrics())
        is_best = results["target_metric"] > self.best_result
        if is_best:
            self.best_result = results["target_metric"]
        if self.save and (is_best or split == "test"):
            self.save_dir.mkdir(parents=True, exist_ok=True)
            with open(self.save_dir / "results.json", "w") as f:
                json.dump(self.eval_results, f, default=str)
        return is_best, results


@EVALUATOR_REGISTRY.register(name="MSQAEval")
class MSQAEval(GenerationEval):
    def reset(self) -> None:
        super().reset()
        self.eval_dict = {"target_metric": [], "ans1_acc_llm": []}

    def batch_metrics(self, data_dict: Dict[str, Any]) -> Dict[str, float]:
        correct = 0
        preds = data_dict["output_text"]
        gts_list = data_dict["answer_list"]
        for pred, gts in zip(preds, gts_list):
            pred_clean = clean_answer(pred)
            gt_answers = gts.split("[answer_seq]") if isinstance(gts, str) else list(gts)
            gt_clean = [clean_answer(g) for g in gt_answers]
            if answer_match(pred_clean, gt_clean):
                correct += 1
        total = len(gts_list)
        acc = correct / float(total) if total else 0.0
        return {"total_count": total, "ans1_acc_llm": acc, "target_metric": acc}

    def update(self, data_dict: Dict[str, Any]) -> None:
        metrics = self.batch_metrics(data_dict)
        self.collect_sentences(data_dict)
        self.total_count += metrics["total_count"]
        if self.save:
            n = metrics["total_count"]
            for i in range(n):
                self.eval_results.append(
                    {
                        "source": _get(data_dict, "source", i),
                        "scan_id": _get(data_dict, "scan_id", i),
                        "instruction": _get(data_dict, "prompt", i)
                        or _get(data_dict, "prompt_after_obj", i),
                        "response_gt": (
                            data_dict["answer_list"][i].split("[answer_seq]")
                            if isinstance(data_dict["answer_list"][i], str)
                            else data_dict["answer_list"][i]
                        ),
                        "response_pred": data_dict["output_text"][i],
                        "index": _get(data_dict, "index", i),
                        "type": _get(data_dict, "type", i),
                    }
                )
        for key in self.eval_dict:
            self.eval_dict[key].append(float(metrics[key]) * metrics["total_count"])

    def record(self, split: str = "val"):
        results = {
            k: (sum(v) / self.total_count if self.total_count else 0.0)
            for k, v in self.eval_dict.items()
        }
        results.update(self.caption_metrics())

        is_best = results["target_metric"] > self.best_result
        if is_best:
            self.best_result = results["target_metric"]

        if self.save and (is_best or split == "test"):
            self.save_dir.mkdir(parents=True, exist_ok=True)
            with open(self.save_dir / "results.json", "w") as f:
                json.dump(self.eval_results, f, default=str)
        return is_best, results


def _get(data_dict, key, i):
    val = data_dict.get(key)
    if val is None:
        return None
    try:
        return val[i]
    except (IndexError, TypeError, KeyError):
        return None
