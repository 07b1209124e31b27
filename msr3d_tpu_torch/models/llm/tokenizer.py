"""Tokenizer layer with the CJK placeholder tokens.

A copy of ``msr3d_tpu/models/llm/tokenizer.py``, kept here so the port
imports nothing of the JAX package: ``BaseTokenizer``, the byte-level
``ByteTokenizer`` of the debug configs, the SentencePiece backend
``SPTokenizer`` (a stock Vicuna ``tokenizer.model``, read by the pure-Python
``sentencepiece.py``) and ``build_tokenizer``'s path resolution. Scene
prompts repeat 景 per scene token and 图 per image; their ids mark the
splice positions. The HF fast-tokenizer backend needs ``transformers`` and
is not ported (``HFTokenizer`` raises).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

IMAGE_PLACEHOLDER = "图"
OBJECT_PLACEHOLDER = "物"
SCENE_PLACEHOLDER = "景"


@dataclasses.dataclass
class Encoding:
    input_ids: np.ndarray  # (B, T) int32
    attention_mask: np.ndarray  # (B, T) int32


class BaseTokenizer:
    pad_id: int
    bos_id: int
    eos_id: int
    unk_id: int
    img_token_id: int
    obj_token_id: int
    scene_token_id: int
    vocab_size: int

    def encode_batch(
        self,
        texts: Sequence[str],
        *,
        padding_side: str = "left",
        add_bos: bool = True,
        add_eos: bool = False,
        max_length: Optional[int] = None,
        truncation_side: str = "right",
        pad_to: Optional[int] = None,
    ) -> Encoding:
        rows = []
        for t in texts:
            ids = self._encode_one(t)
            if add_bos:
                ids = [self.bos_id] + ids
            if add_eos:
                ids = ids + [self.eos_id]
            if max_length is not None and len(ids) > max_length:
                ids = ids[:max_length] if truncation_side == "right" else ids[-max_length:]
            rows.append(ids)
        longest = max(len(r) for r in rows) if rows else 0
        width = max(pad_to if pad_to is not None else longest, longest)
        input_ids = np.full((len(rows), width), self.pad_id, np.int32)
        mask = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            if padding_side == "left":
                input_ids[i, width - len(r):] = r
                mask[i, width - len(r):] = 1
            else:
                input_ids[i, : len(r)] = r
                mask[i, : len(r)] = 1
        return Encoding(input_ids, mask)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    def decode_batch(self, ids: np.ndarray, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in np.asarray(ids)]

    def _encode_one(self, text: str) -> List[int]:
        raise NotImplementedError


class HFTokenizer(BaseTokenizer):
    """The JAX package's HF fast-tokenizer backend (a checkpoint directory
    with ``tokenizer.json``). It needs ``transformers``, which the port does
    not depend on."""

    def __init__(self, path: str, truncation_side: str = "right"):
        raise NotImplementedError(
            f"the HF fast tokenizer ({path!r} holds no tokenizer.model) is not ported "
            "(ROADMAP.md, queue: the long tail); give cfg_path a directory with a "
            "SentencePiece tokenizer.model"
        )


class SPTokenizer(BaseTokenizer):
    """SentencePiece backend over a stock ``tokenizer.model``, with the
    special tokens as the reference's HF slow LlamaTokenizer sets them up:
    '[PAD]' appended as a new id (``vocab_size``), and the 图/物/景
    placeholders, single-character pieces of the Llama vocabulary, split the
    text; each fragment is encoded on its own (HF ``legacy=True``
    fragments)."""

    def __init__(self, model_path: str):
        from msr3d_tpu_torch.models.llm.sentencepiece import SentencePieceModel

        self.sp = SentencePieceModel.load(model_path)
        self.bos_id = self.sp.bos_id
        self.eos_id = self.sp.eos_id
        self.unk_id = self.sp.unk_id
        self.pad_id = len(self.sp.pieces)
        self.vocab_size = len(self.sp.pieces) + 1
        self._specials = {}
        for name, ch in (
            ("img_token_id", IMAGE_PLACEHOLDER),
            ("obj_token_id", OBJECT_PLACEHOLDER),
            ("scene_token_id", SCENE_PLACEHOLDER),
        ):
            pid = self.sp.piece_to_id.get(ch)
            if pid is None:
                raise ValueError(
                    f"placeholder {ch!r} not in the sentencepiece vocab — "
                    "not a Llama/Vicuna-family tokenizer.model"
                )
            setattr(self, name, pid)
            self._specials[ch] = pid

    def _encode_one(self, text: str) -> List[int]:
        ids: List[int] = []
        frag: List[str] = []
        for ch in text:
            if ch in self._specials:
                if frag:
                    ids.extend(self.sp.encode("".join(frag)))
                    frag = []
                ids.append(self._specials[ch])
            else:
                frag.append(ch)
        if frag:
            ids.extend(self.sp.encode("".join(frag)))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """The placeholders decode as text whether or not special tokens
        are skipped; '[PAD]' is dropped."""
        out: List[str] = []
        run: List[int] = []
        specials = set(self._specials.values())
        for i in (int(i) for i in ids):
            if i == self.pad_id:
                continue
            if i in specials:
                if run:
                    out.append(self.sp.decode_ids(run, skip_special_tokens))
                    run = []
                out.append(self.sp.pieces[i])
            else:
                run.append(i)
        if run:
            out.append(self.sp.decode_ids(run, skip_special_tokens))
        return "".join(out)


class ByteTokenizer(BaseTokenizer):
    """Byte-level tokenizer. Layout: 0=pad, 1=bos, 2=eos, 3=unk, 4=图,
    5=物, 6=景, then 7..262 = bytes 0..255."""

    _BYTE_OFFSET = 7

    def __init__(self):
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.unk_id = 3
        self.img_token_id = 4
        self.obj_token_id = 5
        self.scene_token_id = 6
        self.vocab_size = self._BYTE_OFFSET + 256
        self._special_chars = {
            IMAGE_PLACEHOLDER: self.img_token_id,
            OBJECT_PLACEHOLDER: self.obj_token_id,
            SCENE_PLACEHOLDER: self.scene_token_id,
        }

    def _encode_one(self, text: str) -> List[int]:
        ids: List[int] = []
        for ch in text:
            if ch in self._special_chars:
                ids.append(self._special_chars[ch])
            else:
                ids.extend(self._BYTE_OFFSET + b for b in ch.encode("utf-8"))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self._special_chars.items()}
        out_bytes = bytearray()
        out = []
        for i in ids:
            i = int(i)
            if self._BYTE_OFFSET <= i < self._BYTE_OFFSET + 256:
                out_bytes.append(i - self._BYTE_OFFSET)
            elif i >= self._BYTE_OFFSET + 256:
                continue  # out-of-vocab id (model vocab larger than the tokenizer's)
            else:
                if out_bytes:
                    out.append(out_bytes.decode("utf-8", errors="replace"))
                    out_bytes = bytearray()
                if not skip_special_tokens and i in inv:
                    out.append(inv[i])
        if out_bytes:
            out.append(out_bytes.decode("utf-8", errors="replace"))
        return "".join(out)


def build_tokenizer(cfg_path: str = "", truncation_side: str = "right") -> BaseTokenizer:
    """The tokenizer of a checkpoint path, as the JAX package resolves it:
    no path → ``ByteTokenizer`` (the debug configs); a ``.model`` file, or a
    directory with ``tokenizer.model`` and no ``tokenizer.json`` →
    ``SPTokenizer``; anything else → ``HFTokenizer`` (which raises)."""
    if not cfg_path:
        return ByteTokenizer()
    p = str(cfg_path)
    if p.endswith(".model"):
        return SPTokenizer(p)
    if os.path.isdir(p) and not os.path.exists(os.path.join(p, "tokenizer.json")):
        sp_file = os.path.join(p, "tokenizer.model")
        if os.path.exists(sp_file):
            return SPTokenizer(sp_file)
    return HFTokenizer(p, truncation_side=truncation_side)
