"""Offline MSQA evaluation from results files
(reference evaluator/evaluate_msqa.py + gptscore_offline_evaluator.py).

Takes per-dataset results (the ``results.json`` the online MSQAEval saves,
or the reference's results format) and emits EM-R / EM-strict per 9 QA
types, merged 6-category breakdown, and weighted overall — the leaderboard
numbers. The GPT-4 judge score is optional and requires an API caller
injected by the user (zero-egress environments skip it).

Copy of ``msr3d_tpu/evaluator/offline_msqa.py`` for the port.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from msr3d_tpu_torch.evaluator.text_utils import answer_match, clean_answer

QA_TYPE_LIST = [
    "counting",
    "existence",
    "attribute",
    "spatial relationship",
    "navigation",
    "refer",
    "affordance",
    "description",
    "room type",
]

MERGED_QA_TYPES = {
    "counting": ["counting"],
    "existence": ["existence"],
    "attribute_description": ["attribute", "description"],
    "spatial_refer": ["spatial relationship", "refer"],
    "navigation": ["navigation"],
    "others": ["affordance", "room type"],
}


def extract_question(text: str) -> Optional[str]:
    """Question between 'USER:' and 'ASSISTANT:' in a full instruction
    (reference evaluator/evaluate_msqa.py:8-11)."""
    import re

    match = re.search(r"USER: (.*?) ASSISTANT:", text)
    return match.group(1) if match else None


def extract_number(text: str) -> Optional[int]:
    """First integer in the judge's reply (evaluate_msqa.py:13-16)."""
    import re

    match = re.search(r"\d+", text)
    return int(match.group(0)) if match else None


def make_gpt_scorer(
    chat_fn: Callable[[List[Dict[str, str]]], str],
    prompt_messages: Optional[List[Dict[str, str]]] = None,
) -> Callable[[str, str, str], float]:
    """Build the reference's GPT-judge scorer around an injected chat
    callable (``chat_fn(messages) -> reply text`` — the zero-egress
    environment cannot ship a live client; production injects an Azure/
    OpenAI call here, tests inject a stub).

    Mirrors evaluate_msqa.py:44-57: system/few-shot messages (the
    reference loads them from ``gpt_score_prompt_path``, an external
    asset) + a user message ``Question:/Answer:/Ground Truth:``, judge
    reply parsed with :func:`extract_number`. The (score−1)·25 rescale
    happens in :func:`score_results`, as in the reference."""
    base = list(prompt_messages or [])

    def scorer(question: str, answer: str, gt: str) -> float:
        q = extract_question(question) or question
        user_prompt = "\n".join(
            [f"Question: {q}", f"Answer: {answer}", f"Ground Truth: {gt}"]
        )
        messages = base + [{"role": "user", "content": user_prompt}]
        reply = chat_fn(messages)
        score = extract_number(reply)
        return float(score) if score is not None else 1.0

    return scorer


def em_instance(pred: str, gts: List[str]) -> Dict[str, int]:
    """EM-R + EM-strict for one sample (evaluator/utils.py:91-117)."""
    pred = clean_answer(pred)
    gts = [clean_answer(g) for g in gts]
    return {
        "em1": int(answer_match(pred, gts)),
        "em1_strict": int(any(pred == g for g in gts)),
    }


def score_results(
    results_per_dataset: Dict[str, List[Dict[str, Any]]],
    gpt_scorer: Optional[Callable[[str, str, str], float]] = None,
) -> Dict[str, Any]:
    """results_per_dataset: {dataset_name: [record, ...]} where each record
    has response_pred / response_gt (list) / type (+ optional instruction).

    Returns {"EM-R_overall", "EM-R_<merged type>", per-dataset raw stats,
    optionally "GPT-Score_*"}.
    """
    metric_types = ["em1", "em1_strict"]
    if gpt_scorer is not None:
        metric_types.append("gpt_score")

    # per-dataset per-QA-type accumulation
    stats: Dict[str, Dict[str, Dict[str, Dict[str, Any]]]] = {}
    for ds_name, records in results_per_dataset.items():
        stats[ds_name] = {m: {} for m in metric_types}
        for rec in records:
            pred = rec["response_pred"]
            gts = rec["response_gt"]
            if isinstance(gts, str):
                gts = [gts]
            scores = em_instance(pred, gts)
            if gpt_scorer is not None:
                # reference precedence: an explicit `question` key, else
                # the question extracted from the full instruction
                # (evaluate_msqa.py:80-84)
                q = rec.get("question") or rec.get("instruction", "")
                raw = gpt_scorer(q, pred, gts[0])
                scores["gpt_score"] = (raw - 1) * 25
            qa_type = str(rec.get("type", "")).lower()
            for metric in metric_types:
                for qt in QA_TYPE_LIST:
                    if qt in qa_type:
                        bucket = stats[ds_name][metric].setdefault(
                            qt, {"score": 0.0, "cnt": 0}
                        )
                        bucket["score"] += scores[metric]
                        bucket["cnt"] += 1

    out: Dict[str, Any] = {"per_dataset": {}}
    for ds_name in stats:
        out["per_dataset"][ds_name] = {
            metric: {
                qt: bucket["score"] / bucket["cnt"]
                for qt, bucket in stats[ds_name][metric].items()
            }
            for metric in metric_types
        }

    # merged categories, weighted across datasets
    def merged_for(metric: str) -> Dict[str, float]:
        merged: Dict[str, float] = {}
        total_score = 0.0
        total_cnt = 0
        for cat, members in MERGED_QA_TYPES.items():
            score = 0.0
            cnt = 0
            for ds_name in stats:
                for member in members:
                    bucket = stats[ds_name][metric].get(member)
                    if bucket:
                        score += bucket["score"]
                        cnt += bucket["cnt"]
            if cnt > 0:
                merged[cat] = score / cnt
                merged[f"{cat}_cnt"] = cnt
                total_score += score
                total_cnt += cnt
        if total_cnt > 0:
            merged["weighted_avg_score"] = total_score / total_cnt
        return merged

    em_merged = merged_for("em1")
    for key, val in em_merged.items():
        if key.endswith("_cnt"):
            continue
        out["EM-R_overall" if key == "weighted_avg_score" else f"EM-R_{key}"] = val
    strict_merged = merged_for("em1_strict")
    for key, val in strict_merged.items():
        if key.endswith("_cnt"):
            continue
        out["EM_overall" if key == "weighted_avg_score" else f"EM_{key}"] = val
    if gpt_scorer is not None:
        gpt_merged = merged_for("gpt_score")
        for key, val in gpt_merged.items():
            if key.endswith("_cnt"):
                continue
            out[
                "GPT-Score_overall" if key == "weighted_avg_score" else f"GPT-Score_{key}"
            ] = val
    return out


def evaluate_results_files(
    paths: Dict[str, str | Path], **kwargs
) -> Dict[str, Any]:
    """Load {dataset_name: results.json path} and score."""
    results = {}
    for ds_name, path in paths.items():
        with open(path) as f:
            results[ds_name] = json.load(f)
    return score_results(results, **kwargs)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Offline MSQA EM-R scoring")
    parser.add_argument(
        "results", nargs="+",
        help="dataset=path pairs, e.g. scannet=exp/eval/msqa_scannet/results.json",
    )
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    paths = dict(p.split("=", 1) for p in args.results)
    scores = evaluate_results_files(paths)
    text = json.dumps(
        {k: v for k, v in scores.items() if k != "per_dataset"}, indent=2
    )
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(scores, f, indent=2)


if __name__ == "__main__":
    main()
