"""Sentence-similarity target metric for GenerationEval.

The reference scores generated text against ground truth with
sentence-transformer cosine similarity (`all-MiniLM-L6-v2`,
evaluator/cap_eval.py:42,100-107). This module provides:

  - ``SentenceTransformerEncoder``: the faithful backend, used when the
    ``sentence_transformers`` package and its weights are present.
  - ``HashingSentenceEncoder``: a dependency-free documented substitute —
    L2-normalized hashing-trick bag of unigrams+bigrams. It preserves the
    metric's contract (cosine in [-1, 1], 1.0 for identical sentences,
    ~0 for disjoint ones) but measures lexical rather than semantic
    overlap; scores are NOT comparable to published MiniLM numbers.
    Without the package or its cached weights the substitute is taken;
    install both for the faithful backend (``build_sentence_encoder``
    auto-detects and logs its choice once).

Copy of ``msr3d_tpu/evaluator/sentence_sim.py`` for the port.
"""

from __future__ import annotations

import hashlib
import re
from typing import List

import numpy as np

from msr3d_tpu_torch.utils.logging import get_logger

logger = get_logger("msr3d_tpu_torch.evaluator")
_choice_logged = False

_TOKEN_RE = re.compile(r"[a-z0-9']+")


class HashingSentenceEncoder:
    """Hashing-trick unigram+bigram TF vectors, L2-normalized."""

    def __init__(self, n_features: int = 1 << 14):
        self.n_features = n_features

    def _bucket(self, token: str) -> int:
        h = hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest()
        return int.from_bytes(h, "little") % self.n_features

    def encode(self, sentences: List[str]) -> np.ndarray:
        out = np.zeros((len(sentences), self.n_features), np.float32)
        for i, s in enumerate(sentences):
            toks = _TOKEN_RE.findall(s.lower())
            grams = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
            for g in grams:
                out[i, self._bucket(g)] += 1.0
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out


class SentenceTransformerEncoder:
    """Faithful backend (reference cap_eval.py:42): MiniLM-L6-v2."""

    def __init__(self, model_name: str = "sentence-transformers/all-MiniLM-L6-v2"):
        from sentence_transformers import SentenceTransformer

        self.model = SentenceTransformer(model_name)

    def encode(self, sentences: List[str]) -> np.ndarray:
        emb = self.model.encode(sentences, convert_to_numpy=True)
        norm = np.linalg.norm(emb, axis=1, keepdims=True)
        return emb / np.maximum(norm, 1e-12)


def _choose_sentence_encoder():
    # Probe the local HF cache BEFORE importing: the sentence_transformers
    # import alone costs ~18 s (it pulls in TF), and constructing the model
    # without cached weights stalls in hub retries without a network.
    import os
    from pathlib import Path

    cache = Path(os.environ.get("HF_HOME", Path.home() / ".cache/huggingface")) / "hub"
    cached = cache.exists() and any(
        cache.glob("models--sentence-transformers--all-MiniLM-L6-v2*")
    )
    if not cached:
        return HashingSentenceEncoder()
    try:
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        return SentenceTransformerEncoder()
    except Exception:
        return HashingSentenceEncoder()


def build_sentence_encoder():
    """MiniLM when ``sentence_transformers`` and its cached weights are
    there, else the hashing encoder; the choice is logged once (it is the
    metric's backend: their scores do not compare)."""
    global _choice_logged
    encoder = _choose_sentence_encoder()
    if not _choice_logged:
        logger.info(f"GenerationEval's sentence similarity uses {type(encoder).__name__}")
        _choice_logged = True
    return encoder


def sentence_cos_sim(encoder, preds: List[str], gts: List[str]) -> np.ndarray:
    """Per-pair cosine similarity — the diagonal of the reference's
    ``pytorch_cos_sim(embed_pred, embed_gt)`` (cap_eval.py:100-107)."""
    if not preds:
        return np.zeros((0,), np.float32)
    e_pred = encoder.encode(list(preds))
    e_gt = encoder.encode(list(gts))
    return np.sum(e_pred * e_gt, axis=1)
