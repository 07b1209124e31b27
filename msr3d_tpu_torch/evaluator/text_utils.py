"""Answer normalization + matching (parity: data/data_utils.py:449-506,
evaluator/msqa_eval.py:21-29). Copy of ``msr3d_tpu/evaluator/text_utils.py``
for the port."""

from __future__ import annotations

import re
from typing import List

_NUM_WORDS = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
    "10": "ten", "11": "eleven", "12": "twelve", "13": "thirteen",
    "14": "fourteen", "15": "fifteen", "16": "sixteen", "17": "seventeen",
    "18": "eighteen", "19": "nineteen", "20": "twenty", "23": "twenty-three",
}

_TYPO_FIXES = [
    (r"\bletf\b", "left"),
    (r"\blet\b", "left"),
    (r"\btehre\b", "there"),
    (r"\brigth\b", "right"),
    (r"\brght\b", "right"),
    (r"\bbehine\b", "behind"),
    (r"\btv\b", "TV"),
    (r"\bchai\b", "chair"),
    (r"\bwasing\b", "washing"),
    (r"\bwaslked\b", "walked"),
    (r"\boclock\b", "o'clock"),
    (r"\bo'[ ]+clock\b", "o'clock"),
]


def clean_answer(data: str) -> str:
    """Normalize an answer string exactly like the reference."""
    data = data.lower()
    data = re.sub(r"[ ]+$", "", data)
    data = re.sub(r"^[ ]+", "", data)
    data = re.sub(r" {2,}", " ", data)

    data = re.sub(r"\.[ ]{2,}", ". ", data)
    data = re.sub(r"[^a-zA-Z0-9,'\s\-:]+", "", data)
    data = re.sub("ç", "c", data)
    data = re.sub("’", "'", data)
    for pat, rep in _TYPO_FIXES:
        data = re.sub(pat, rep, data)

    data = re.sub(r"\bnone\b", "zero", data)
    for digit, word in _NUM_WORDS.items():
        data = re.sub(rf"\b{digit}\b", word, data)

    # no1, mat2, etc → strip trailing digit; drop articles
    data = re.sub(r"\b([a-zA-Z]+)([0-9])\b", r"\g<1>", data)
    data = re.sub(r"\ba\b ([a-zA-Z]+)", r"\g<1>", data)
    data = re.sub(r"\ban\b ([a-zA-Z]+)", r"\g<1>", data)
    data = re.sub(r"\bthe\b ([a-zA-Z]+)", r"\g<1>", data)

    data = re.sub(r"\bbackwards\b", "backward", data)
    return data


def answer_match(pred: str, gts: List[str]) -> bool:
    """EM-R: exact or whitespace-stripped bidirectional containment."""
    for gt in gts:
        if pred == gt:
            return True
        if "".join(pred.split()) in "".join(gt.split()):
            return True
        if "".join(gt.split()) in "".join(pred.split()):
            return True
    return False
