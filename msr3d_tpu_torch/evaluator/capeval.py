"""Caption metrics: BLEU-4, CIDEr-D, ROUGE-L (pure Python, no deps).

Copy of ``msr3d_tpu/evaluator/capeval.py`` for the port.

Standalone implementations of the standard published algorithms (Papineni
et al. 2002; Vedantam et al. 2015 CIDEr-D; Lin 2004 ROUGE-L) with the
COCO-caption conventions the reference's vendored scorers follow
(evaluator/capeval/): BLEU uses closest-reference length for the brevity
penalty and the 'average' smoothing-free corpus formulation; CIDEr-D uses
n∈1..4, σ=6, ×10 scaling; ROUGE-L uses β=1.2 F-measure averaged over refs
with max aggregation.

METEOR (the reference's JVM jar is missing even in the reference repo)
is the pure-Python scorer of ``meteor.py``, re-exported here.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


class BleuScorer:
    """Corpus BLEU-{1..4} (COCO convention)."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(
        self, gts: Dict[int, List[str]], res: Dict[int, List[str]]
    ) -> Tuple[List[float], None]:
        clipped = [0] * self.n
        totals = [0] * self.n
        cand_len = 0
        ref_len = 0
        for key in gts:
            cand = res[key][0].split()
            refs = [r.split() for r in gts[key]]
            cand_len += len(cand)
            # closest reference length
            ref_len += min(
                (abs(len(r) - len(cand)), len(r)) for r in refs
            )[1]
            for n in range(1, self.n + 1):
                cand_ng = _ngrams(cand, n)
                max_ref = Counter()
                for r in refs:
                    for ng, c in _ngrams(r, n).items():
                        max_ref[ng] = max(max_ref[ng], c)
                totals[n - 1] += max(len(cand) - n + 1, 0)
                clipped[n - 1] += sum(
                    min(c, max_ref.get(ng, 0)) for ng, c in cand_ng.items()
                )
        bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
        scores = []
        log_sum = 0.0
        for n in range(self.n):
            p = clipped[n] / totals[n] if totals[n] > 0 else 0.0
            # tiny epsilon mirrors COCO's ratio trick to avoid log(0)
            log_sum += math.log(max(p, 1e-16))
            scores.append(bp * math.exp(log_sum / (n + 1)))
        return scores, None


class CiderScorer:
    """CIDEr-D (n=1..4, σ=6, ×10)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(
        self, gts: Dict[int, List[str]], res: Dict[int, List[str]]
    ) -> Tuple[float, List[float]]:
        keys = list(gts.keys())
        # document frequency over reference sets
        df = [defaultdict(float) for _ in range(self.n)]
        for key in keys:
            for n in range(self.n):
                seen = set()
                for ref in gts[key]:
                    seen.update(_ngrams(ref.split(), n + 1).keys())
                for ng in seen:
                    df[n][ng] += 1.0
        num_docs = max(len(keys), 1)

        def tfidf_vec(tokens: List[str]):
            vecs = []
            norms = []
            for n in range(self.n):
                counts = _ngrams(tokens, n + 1)
                vec = {}
                norm_sq = 0.0
                for ng, c in counts.items():
                    idf = math.log(num_docs) - math.log(max(df[n][ng], 1.0))
                    w = c * idf
                    vec[ng] = w
                    norm_sq += w * w
                vecs.append(vec)
                norms.append(math.sqrt(norm_sq))
            return vecs, norms

        scores = []
        for key in keys:
            cand_tokens = res[key][0].split()
            c_vecs, c_norms = tfidf_vec(cand_tokens)
            score_n = [0.0] * self.n
            for ref in gts[key]:
                ref_tokens = ref.split()
                r_vecs, r_norms = tfidf_vec(ref_tokens)
                delta = len(cand_tokens) - len(ref_tokens)
                length_pen = math.exp(-(delta**2) / (2 * self.sigma**2))
                for n in range(self.n):
                    # CIDEr-D: clip candidate weights by reference weights
                    dot = sum(
                        min(w, r_vecs[n].get(ng, 0.0)) * r_vecs[n].get(ng, 0.0)
                        for ng, w in c_vecs[n].items()
                    )
                    denom = c_norms[n] * r_norms[n]
                    if denom > 0:
                        score_n[n] += length_pen * dot / denom
            m = max(len(gts[key]), 1)
            scores.append(10.0 * sum(s / m for s in score_n) / self.n)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores


class RougeScorer:
    """ROUGE-L F-measure (β=1.2, max over references)."""

    beta = 1.2

    @staticmethod
    def _lcs(a: List[str], b: List[str]) -> int:
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for x in a:
            cur = [0] * (len(b) + 1)
            for j, y in enumerate(b, 1):
                cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
            prev = cur
        return prev[-1]

    def compute_score(
        self, gts: Dict[int, List[str]], res: Dict[int, List[str]]
    ) -> Tuple[float, List[float]]:
        scores = []
        for key in gts:
            cand = res[key][0].split()
            # COCO convention: max precision and max recall over references
            # are taken INDEPENDENTLY, then combined into F
            prec_max = 0.0
            rec_max = 0.0
            for ref in gts[key]:
                r = ref.split()
                lcs = self._lcs(cand, r)
                prec_max = max(prec_max, lcs / len(cand) if cand else 0.0)
                rec_max = max(rec_max, lcs / len(r) if r else 0.0)
            if prec_max > 0 and rec_max > 0:
                f = ((1 + self.beta**2) * prec_max * rec_max) / (
                    rec_max + self.beta**2 * prec_max
                )
            else:
                f = 0.0
            scores.append(f)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores


from msr3d_tpu_torch.evaluator.meteor import MeteorScorer  # noqa: E402  (re-export)
