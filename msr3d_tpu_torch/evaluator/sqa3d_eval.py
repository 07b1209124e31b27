"""SQA3D evaluators (reference evaluator/sqa3d_eval.py).

Copy of ``msr3d_tpu/evaluator/sqa3d_eval.py`` for the port.

Two variants, mirroring the reference:
  - ``SQA3DEval``: answer-vocabulary scoring — EM@1/EM@10 over
    ``answer_scores`` (B, A) against multi-hot ``answer_label``
    (sqa3d_eval.py:75-121), fed by ``MSR3D.predict_answers``.
  - ``SQA3DInstructionEval``: generation mode — strict EM of the decoded
    text against the per-question answer pool (sqa3d_eval.py:155-240).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np

from msr3d_tpu_torch.evaluator.build import BaseEvaluator
from msr3d_tpu_torch.evaluator.text_utils import clean_answer
from msr3d_tpu_torch.registry import EVALUATOR_REGISTRY

NUM_SQA_TYPES = 6  # what/is/how/can/which/others (data/data_utils.py:367-380)


@EVALUATOR_REGISTRY.register(name="SQA3DEval")
class SQA3DEval(BaseEvaluator):
    """Answer-vocabulary SQA3D eval (reference sqa3d_eval.py:13-152).

    ``update`` consumes ``answer_scores`` (B, A) — per-candidate scores over
    the SQA3D answer vocabulary (higher = better; ``MSR3D.predict_answers``
    emits −loss) — and multi-hot ``answer_label`` (B, A). Metrics:
    EM@1 (``ans1_acc``: the argmax candidate is a labeled answer), EM@10
    (``ans10_acc``: any of the top-10), per-question-type accuracy, and the
    legacy grounding-model object-classification accuracies when the
    ``obj_cls_{raw,pre,post}_logits`` keys are present (they are produced by
    the legacy pipeline, not MSR3D; absent keys score 0 as the reference
    would crash rather than skip — we skip to keep the evaluator usable
    from the generation-mode trainer).
    """

    def __init__(self, cfg=None, task_name: str = "", save_dir=".",
                 answer_vocab=None):
        self.answer_vocab = answer_vocab
        if self.answer_vocab is None and cfg is not None:
            base = cfg.get("data", {}).get("scan_family_base", "")
            path = Path(base) / "annotations" / "sqa_task" / "answer_dict.json"
            if base and path.exists():
                import collections

                from msr3d_tpu_torch.data.datasets.sqa3d import SQA3DAnswerVocab

                answer_data = json.load(open(path, encoding="utf-8"))[0]
                counter = collections.Counter(sorted(answer_data.keys()))
                self.answer_vocab = SQA3DAnswerVocab(counter.keys())
        super().__init__(cfg, task_name, save_dir)

    def reset(self) -> None:
        self.total_count = 0
        self._sums = {
            "ans1_acc": 0.0, "ans10_acc": 0.0, "obj_cls_raw_acc": 0.0,
            "obj_cls_pre_acc": 0.0, "obj_cls_post_acc": 0.0,
        }
        self._type_correct = [0.0] * NUM_SQA_TYPES
        self._type_count = [1e-10] * NUM_SQA_TYPES
        self.eval_results = []

    def _obj_cls_acc(self, data_dict, key):
        logits = data_dict.get(key)
        if logits is None:
            return 0.0
        logits = np.asarray(logits)
        labels = np.asarray(data_dict["obj_labels"])
        masks = np.asarray(data_dict["obj_masks"]).astype(bool)
        pred = logits.argmax(axis=2)
        return float((pred[masks] == labels[masks]).sum()) / float(masks.sum())

    def update(self, data_dict: Dict[str, Any]) -> None:
        scores = np.asarray(data_dict["answer_scores"])  # (B, A)
        labels = np.asarray(data_dict["answer_label"])  # (B, A) multi-hot
        types = [int(_item(t)) for t in data_dict["sqa_type"]]
        b = scores.shape[0]

        choice_1 = scores.argmax(axis=-1)  # (B,)
        k = min(10, scores.shape[1])
        top10 = np.argsort(-scores, axis=-1)[:, :k]  # (B, 10)
        correct1 = 0
        correct10 = 0
        for i in range(b):
            hit1 = labels[i, choice_1[i]] == 1
            if hit1:
                correct1 += 1
                self._type_correct[types[i]] += 1
            self._type_count[types[i]] += 1
            if labels[i, top10[i]].max() == 1:
                correct10 += 1
            if self.save:
                top10_answers = (
                    [self.answer_vocab.itos[int(j)] for j in top10[i]]
                    if self.answer_vocab is not None
                    else [int(j) for j in top10[i]]
                )
                self.eval_results.append(
                    {"pred_top10": top10_answers, "correct": bool(hit1),
                     "sqa_type": types[i]}
                )

        self.total_count += b
        self._sums["ans1_acc"] += correct1
        self._sums["ans10_acc"] += correct10
        for key in ("obj_cls_raw_acc", "obj_cls_pre_acc", "obj_cls_post_acc"):
            self._sums[key] += self._obj_cls_acc(
                data_dict, key.replace("_acc", "_logits")
            ) * b

    def record(self, split: str = "val"):
        n = max(self.total_count, 1)
        results = {k: v / n for k, v in self._sums.items()}
        for t in range(NUM_SQA_TYPES):
            results[f"type{t}_acc"] = self._type_correct[t] / self._type_count[t]
        results["target_metric"] = results["ans1_acc"]
        is_best = results["target_metric"] > self.best_result
        if is_best:
            self.best_result = results["target_metric"]
        if self.save and (is_best or split == "test"):
            self.save_dir.mkdir(parents=True, exist_ok=True)
            with open(self.save_dir / "results.json", "w") as f:
                json.dump(self.eval_results, f, default=str)
        return is_best, results


@EVALUATOR_REGISTRY.register(name="SQA3DInstructionEval")
class SQA3DInstructionEval(BaseEvaluator):
    """Generation-mode SQA3D eval: strict EM over the per-question answer
    pool + per-question-type accuracy."""

    def __init__(self, cfg=None, task_name: str = "", save_dir=".", qa_pool=None):
        # qa_pool: {question_id: {"answers": [str, ...]}} — loaded from the
        # balanced SQA3D annotation jsons when available
        self.qa_pool = qa_pool or {}
        if not self.qa_pool and cfg is not None:
            base = cfg.get("data", {}).get("scan_family_base", "")
            if base:
                self._load_qa_pool(base)
        super().__init__(cfg, task_name, save_dir)

    def _load_qa_pool(self, base_dir: str) -> None:
        anno = Path(base_dir) / "annotations" / "sqa_task" / "balanced"
        for split in ("val", "test"):
            qf = anno / f"v1_balanced_questions_{split}_scannetv2.json"
            af = anno / f"v1_balanced_sqa_annotations_{split}_scannetv2.json"
            if not (qf.exists() and af.exists()):
                continue
            with open(qf, encoding="utf-8") as f:
                for q in json.load(f)["questions"]:
                    self.qa_pool.setdefault(q["question_id"], {})["question"] = q[
                        "question"
                    ]
            with open(af, encoding="utf-8") as f:
                for a in json.load(f)["annotations"]:
                    self.qa_pool.setdefault(a["question_id"], {})["answers"] = [
                        t["answer"]
                        for t in a["answers"]
                        if t.get("answer_confidence") == "yes"
                    ]

    def reset(self) -> None:
        self.eval_dict: Dict[str, list] = {"target_metric": [], "ans1_acc_llm": []}
        for t in range(NUM_SQA_TYPES):
            self.eval_dict[f"type{t}_acc_llm"] = []
        self.total_count = 0
        self.eval_results = []
        self._type_correct = [0] * NUM_SQA_TYPES
        self._type_count = [0] * NUM_SQA_TYPES

    @staticmethod
    def answer_match(pred: str, gts) -> bool:
        # strict EM for SQA3D (containment variants commented out in the
        # reference, sqa3d_eval.py:194-202)
        return any(pred == gt for gt in gts)

    def update(self, data_dict: Dict[str, Any]) -> None:
        preds = data_dict["output_text"]
        n = len(preds)
        correct = 0
        for i in range(n):
            pred = clean_answer(preds[i])
            q_id = int(_item(data_dict["data_idx"][i]))
            gts = [clean_answer(a) for a in self.qa_pool.get(q_id, {}).get("answers", [])]
            sqa_type = int(_item(data_dict["sqa_type"][i]))
            hit = self.answer_match(pred, gts)
            if hit:
                correct += 1
                self._type_correct[sqa_type] += 1
            self._type_count[sqa_type] += 1
            if self.save:
                self.eval_results.append(
                    {"question_id": q_id, "pred": preds[i], "gt": gts, "correct": hit,
                     "sqa_type": sqa_type}
                )
        self.total_count += n
        acc = correct / n if n else 0.0
        self.eval_dict["ans1_acc_llm"].append(acc * n)
        self.eval_dict["target_metric"].append(acc * n)

    def record(self, split: str = "val"):
        results = {
            "ans1_acc_llm": sum(self.eval_dict["ans1_acc_llm"]) / self.total_count
            if self.total_count
            else 0.0,
        }
        results["target_metric"] = results["ans1_acc_llm"]
        for t in range(NUM_SQA_TYPES):
            results[f"type{t}_acc_llm"] = (
                self._type_correct[t] / self._type_count[t]
                if self._type_count[t]
                else 0.0
            )
        is_best = results["target_metric"] > self.best_result
        if is_best:
            self.best_result = results["target_metric"]
        if self.save and (is_best or split == "test"):
            self.save_dir.mkdir(parents=True, exist_ok=True)
            with open(self.save_dir / "results.json", "w") as f:
                json.dump(self.eval_results, f, default=str)
        return is_best, results


def _item(x):
    return x.item() if hasattr(x, "item") else x
