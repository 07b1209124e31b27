"""METEOR scorer, pure Python (no JVM).

Copy of ``msr3d_tpu/evaluator/meteor.py`` for the port. The original
MSR3D drives METEOR 1.5 through a JVM subprocess
(its ``evaluator/capeval/meteor/meteor.py:20-36``) whose
``meteor-1.5.jar`` is a stripped large blob even in the reference repo
(``.MISSING_LARGE_BLOBS:3``) — i.e. the reference's METEOR path cannot
run either. This module is a from-scratch implementation of the METEOR
algorithm (Denkowski & Lavie 2014) with the **exact** and **stem**
matcher stages:

  score = (1 - gamma * (chunks / matches)^beta) * P*R / (alpha*P + (1-alpha)*R)

with the METEOR-1.5 English defaults alpha=0.85, beta=0.2, gamma=0.6 and
module weights exact=1.0, stem=0.6. Stemming is a self-contained Porter
stemmer. Divergences from the jar, documented:

  * no WordNet synonym or paraphrase-table stages (both need shipped
    data files); scores therefore run slightly LOWER than jar METEOR on
    paraphrased answers and are not comparable to published numbers at
    the third decimal, but preserve ranking behavior for the short
    MSQA-style answers this framework evaluates.
  * no content/function-word delta weighting (needs the jar's function
    word list).
  * alignment is resolved greedily left-to-right per stage (exact first,
    then stem), minimizing chunks only through match order — the jar
    uses beam search over alignments.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["porter_stem", "meteor_score", "MeteorScorer"]


# ---------------------------------------------------------------------------
# Porter stemmer (Porter 1980, the classic definition)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """The m in [C](VC)^m[V]."""
    forms = ""
    for i in range(len(stem)):
        forms += "c" if _is_cons(stem, i) else "v"
    # collapse runs
    collapsed = ""
    for ch in forms:
        if not collapsed or collapsed[-1] != ch:
            collapsed += ch
    return collapsed.count("vc")


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
    ):
        return False
    return word[-1] not in "wxy"


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                break
            if _measure(stem) > 1:
                w = stem
            break

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR alignment + score
# ---------------------------------------------------------------------------

_WEIGHTS = {"exact": 1.0, "stem": 0.6}


def _align(hyp: List[str], ref: List[str]) -> List[Tuple[int, int, float]]:
    """Stage-wise greedy alignment: exact, then stem. Returns
    (hyp_idx, ref_idx, module_weight) triples."""
    matches: List[Tuple[int, int, float]] = []
    hyp_used = [False] * len(hyp)
    ref_used = [False] * len(ref)

    def run_stage(key_fn, weight):
        ref_slots: Dict[str, List[int]] = {}
        for j, w in enumerate(ref):
            if not ref_used[j]:
                ref_slots.setdefault(key_fn(w), []).append(j)
        for i, w in enumerate(hyp):
            if hyp_used[i]:
                continue
            slots = ref_slots.get(key_fn(w))
            if slots:
                j = slots.pop(0)
                hyp_used[i] = True
                ref_used[j] = True
                matches.append((i, j, weight))

    run_stage(lambda w: w, _WEIGHTS["exact"])
    run_stage(porter_stem, _WEIGHTS["stem"])
    matches.sort()
    return matches


def _count_chunks(matches: List[Tuple[int, int, float]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (i0, j0, _), (i1, j1, _) in zip(matches, matches[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    return chunks


def meteor_score(
    hypothesis: str,
    references: List[str],
    *,
    alpha: float = 0.85,
    beta: float = 0.2,
    gamma: float = 0.6,
) -> float:
    """Best score over references (the jar's multi-reference behavior)."""
    hyp = hypothesis.lower().split()
    best = 0.0
    for reference in references:
        ref = reference.lower().split()
        if not hyp or not ref:
            continue
        matches = _align(hyp, ref)
        if not matches:
            continue
        m_w = sum(w for _, _, w in matches)  # weighted match count
        m = len(matches)
        precision = m_w / len(hyp)
        recall = m_w / len(ref)
        if precision + recall == 0:
            continue
        f_mean = precision * recall / (alpha * precision + (1 - alpha) * recall)
        frag = _count_chunks(matches) / m
        penalty = gamma * frag**beta
        best = max(best, (1.0 - penalty) * f_mean)
    return best


class MeteorScorer:
    """Drop-in for the capeval scorer contract: ``compute_score(gts, res)``
    → (corpus mean, per-sample list), matching the reference wrapper's
    outputs (``evaluator/capeval/meteor/meteor.py:38-57``)."""

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        scores = [meteor_score(res[k][0], list(gts[k])) for k in gts]
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
