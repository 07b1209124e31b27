"""Pure-Python SentencePiece: load real ``tokenizer.model`` files.

Copy of ``msr3d_tpu/models/llm/sentencepiece.py`` for the port (the GPU host
has no ``sentencepiece`` wheel and the port imports nothing of the JAX
package):

  - a minimal protobuf wire-format parser (and writer, for tests and
    tooling) for the SentencePiece ``ModelProto`` schema: varints,
    length-delimited fields, 32/64-bit scalars, no generated code;
  - BPE segmentation matching sentencepiece's ``bpe_model.cc``: merge the
    best-scoring adjacent pair (ties: leftmost), byte fallback for
    out-of-vocab characters, ▁ whitespace escaping and the dummy prefix;
  - unigram segmentation (Viterbi over piece log-probs);
  - decoding (▁ → space, byte-piece fusion, control pieces skipped).

The JAX module's converter to an HF fast-tokenizer JSON needs the
``tokenizers`` wheel and is left out.

``SPTokenizer`` in ``tokenizer.py`` wraps this behind the model's tokenizer
interface, so ``build_tokenizer(vicuna_dir)`` works on a checkpoint
directory that holds only ``tokenizer.model``.
"""

from __future__ import annotations

import dataclasses
import heapq
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["SentencePieceModel", "serialize_model_proto"]

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# protobuf wire format (reader + writer)
# ---------------------------------------------------------------------------


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _parse_fields(data: bytes):
    """Yield (field_number, wire_type, value) over one message."""
    i = 0
    n = len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, i = _read_varint(data, i)
        elif wire == 1:  # 64-bit
            val = data[i : i + 8]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            val = data[i : i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            val = data[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _write_bytes(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _write_float(out: bytearray, field: int, v: float) -> None:
    _write_tag(out, field, 5)
    out.extend(struct.pack("<f", v))


def _write_uint(out: bytearray, field: int, v: int) -> None:
    _write_tag(out, field, 0)
    _write_varint(out, v)


def serialize_model_proto(
    pieces: List[Tuple[str, float, int]],
    *,
    model_type: int = 2,  # 1=unigram, 2=BPE
    byte_fallback: bool = True,
    add_dummy_prefix: bool = True,
    escape_whitespaces: bool = True,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    pad_id: int = -1,
) -> bytes:
    """Build a ModelProto blob (schema-compatible with sentencepiece) —
    used by tests to vendor miniature models and by tooling to patch
    vocabularies without the sentencepiece wheel."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sp = bytearray()
        _write_bytes(sp, 1, piece.encode("utf-8"))
        _write_float(sp, 2, score)
        _write_uint(sp, 3, ptype)
        _write_bytes(out, 1, bytes(sp))
    trainer = bytearray()
    _write_uint(trainer, 3, model_type)
    _write_uint(trainer, 35, 1 if byte_fallback else 0)
    for field, val in ((40, unk_id), (41, bos_id), (42, eos_id), (43, pad_id)):
        # ids are proto int32 varints; negative → 10-byte two's complement
        _write_tag(trainer, field, 0)
        _write_varint(trainer, val & 0xFFFFFFFFFFFFFFFF if val < 0 else val)
    _write_bytes(out, 2, bytes(trainer))
    norm = bytearray()
    _write_bytes(norm, 1, b"identity")
    _write_uint(norm, 3, 1 if add_dummy_prefix else 0)
    _write_uint(norm, 5, 1 if escape_whitespaces else 0)
    _write_bytes(out, 3, bytes(norm))
    return bytes(out)


def _to_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

_SPACE = "▁"  # ▁


@dataclasses.dataclass
class SentencePieceModel:
    pieces: List[str]
    scores: List[float]
    types: List[int]
    model_type: int = 2
    byte_fallback: bool = True
    add_dummy_prefix: bool = True
    escape_whitespaces: bool = True
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1

    def __post_init__(self):
        self.piece_to_id: Dict[str, int] = {
            p: i for i, p in enumerate(self.pieces)
        }
        self._byte_ids: Optional[List[int]] = None
        if self.byte_fallback:
            ids = []
            ok = True
            for b in range(256):
                pid = self.piece_to_id.get(f"<0x{b:02X}>")
                if pid is None:
                    ok = False
                    break
                ids.append(pid)
            self._byte_ids = ids if ok else None
        self._max_piece_chars = max((len(p) for p in self.pieces), default=1)

    # -- loading ---------------------------------------------------------

    @classmethod
    def load(cls, path: str | Path) -> "SentencePieceModel":
        return cls.from_bytes(Path(path).read_bytes())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces: List[str] = []
        scores: List[float] = []
        types: List[int] = []
        kw: Dict[str, object] = {}
        for field, wire, val in _parse_fields(data):
            if field == 1 and wire == 2:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _parse_fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                pieces.append(piece)
                scores.append(score)
                types.append(ptype)
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in _parse_fields(val):
                    if f2 == 3:
                        kw["model_type"] = v2
                    elif f2 == 35:
                        kw["byte_fallback"] = bool(v2)
                    elif f2 == 40:
                        kw["unk_id"] = _to_int32(v2)
                    elif f2 == 41:
                        kw["bos_id"] = _to_int32(v2)
                    elif f2 == 42:
                        kw["eos_id"] = _to_int32(v2)
                    elif f2 == 43:
                        kw["pad_id"] = _to_int32(v2)
            elif field == 3 and wire == 2:  # NormalizerSpec
                for f2, w2, v2 in _parse_fields(val):
                    if f2 == 3:
                        kw["add_dummy_prefix"] = bool(v2)
                    elif f2 == 5:
                        kw["escape_whitespaces"] = bool(v2)
        return cls(pieces, scores, types, **kw)  # type: ignore[arg-type]

    # -- normalization ---------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.escape_whitespaces:
            text = text.replace(" ", _SPACE)
        if self.add_dummy_prefix and text:
            text = _SPACE + text
        return text

    def _initial_symbols(self, text: str) -> List[str]:
        """Character symbols; unknown chars become byte pieces (byte
        fallback) or stay as raw chars (mapped to unk at id time)."""
        out: List[str] = []
        for ch in text:
            if ch in self.piece_to_id or self._byte_ids is None:
                out.append(ch)
            else:
                out.extend(f"<0x{b:02X}>" for b in ch.encode("utf-8"))
        return out

    # -- BPE (bpe_model.cc semantics) ------------------------------------

    def _encode_bpe(self, text: str) -> List[str]:
        syms = self._initial_symbols(text)
        if len(syms) <= 1:
            return syms
        # doubly-linked list over symbol slots
        nxt = list(range(1, len(syms))) + [-1]
        prv = [-1] + list(range(len(syms) - 1))
        alive = [True] * len(syms)

        heap: List[Tuple[float, int, int, str]] = []

        def push(left: int):
            right = nxt[left]
            if right == -1:
                return
            merged = syms[left] + syms[right]
            pid = self.piece_to_id.get(merged)
            if pid is None or self.types[pid] != NORMAL:
                return
            # higher score first; ties → leftmost pair (bpe_model.cc)
            heapq.heappush(heap, (-self.scores[pid], left, right, merged))

        for i in range(len(syms) - 1):
            push(i)

        while heap:
            _, left, right, merged = heapq.heappop(heap)
            if (
                not alive[left]
                or not alive[right]
                or nxt[left] != right
                or syms[left] + syms[right] != merged
            ):
                continue  # stale entry
            syms[left] = merged
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = left
            if prv[left] != -1:
                push(prv[left])
            push(left)

        out = []
        i = 0
        while i != -1:
            if alive[i]:
                out.append(syms[i])
            i = nxt[i]
        return out

    # -- unigram (Viterbi) -----------------------------------------------

    def _encode_unigram(self, text: str) -> List[str]:
        syms = self._initial_symbols(text)
        # operate on the char-symbol string (byte pieces are atomic)
        n = len(syms)
        NEG = -1e18
        min_score = min(self.scores) if self.scores else 0.0
        unk_score = min_score - 10.0  # kUnkPenalty
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            # single symbol (piece, byte piece, or unk fallback)
            one = syms[i]
            pid = self.piece_to_id.get(one)
            sc = self.scores[pid] if pid is not None else unk_score
            if best[i] + sc > best[i + 1]:
                best[i + 1] = best[i] + sc
                back[i + 1] = (i, one)
            # multi-symbol pieces (only over plain chars)
            cand = ""
            for j in range(i, min(n, i + self._max_piece_chars)):
                if len(syms[j]) != 1:
                    break
                cand += syms[j]
                if j == i:
                    continue
                pid = self.piece_to_id.get(cand)
                if pid is not None and self.types[pid] == NORMAL:
                    if best[i] + self.scores[pid] > best[j + 1]:
                        best[j + 1] = best[i] + self.scores[pid]
                        back[j + 1] = (i, cand)
        out: List[str] = []
        i = n
        while i > 0:
            j, piece = back[i]
            out.append(piece)
            i = j
        return out[::-1]

    # -- public API ------------------------------------------------------

    def encode_pieces(self, text: str) -> List[str]:
        text = self._normalize(text)
        if not text:
            return []
        if self.model_type == 1:
            return self._encode_unigram(text)
        return self._encode_bpe(text)

    def encode(self, text: str) -> List[int]:
        return [
            self.piece_to_id.get(p, self.unk_id) for p in self.encode_pieces(text)
        ]

    def decode_ids(self, ids, skip_special: bool = True) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            t = self.types[i]
            if t == BYTE:
                byte_buf.append(int(self.pieces[i][1:-1], 16))
                continue
            flush()
            if t in (CONTROL, UNKNOWN) and skip_special:
                continue
            out.append(self.pieces[i])
        flush()
        text = "".join(out).replace(_SPACE, " ")
        return text[1:] if text.startswith(" ") else text
