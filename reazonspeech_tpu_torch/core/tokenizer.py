"""Tokenizers: SentencePiece-model inference without the sentencepiece C++
library, plus simple char/vocab tokenizers for tests and k2-style token files.

A copy of ``reazonspeech_tpu/core/tokenizer.py`` with the same behaviour.

The reference decodes ids through NeMo's ``model.tokenizer.ids_to_text``
(pkg/nemo-asr/src/decode.py:41,47) and sherpa's tokens.txt
(pkg/k2-asr/src/huggingface.py:76). Here:

- :class:`SentencePieceTokenizer` parses the ``.model`` protobuf directly (a
  minimal wire-format reader extracting the pieces list) and implements
  detokenization semantics: concatenate pieces, map U+2581 to space, strip,
  skip control pieces.
- :class:`VocabTokenizer` reads k2 ``tokens.txt`` ("<piece> <id>" lines).
- :class:`CharTokenizer` builds a vocabulary from an explicit char list.
"""

import struct

__all__ = ["SentencePieceTokenizer", "VocabTokenizer", "CharTokenizer"]

_WS = "▁"  # SentencePiece meta symbol for whitespace

# SentencePiece piece types (model proto enum)
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2
_TYPE_CONTROL = 3
_TYPE_USER_DEFINED = 4
_TYPE_UNUSED = 5
_TYPE_BYTE = 6


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fnum, wt, val


class SentencePieceTokenizer:
    """Detokenizing SentencePiece model reader (unigram or BPE)."""

    def __init__(self, pieces, types=None, scores=None):
        self.pieces = list(pieces)
        self.types = list(types) if types else [_TYPE_NORMAL] * len(self.pieces)
        self.scores = list(scores) if scores else [0.0] * len(self.pieces)
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}

    @classmethod
    def from_model_file(cls, path):
        with open(path, "rb") as f:
            data = f.read()
        pieces, types, scores = [], [], []
        for fnum, wt, val in _iter_fields(data):
            if fnum == 1 and wt == 2:  # repeated SentencePiece
                piece, ptype, score = "", _TYPE_NORMAL, 0.0
                for sfnum, swt, sval in _iter_fields(val):
                    if sfnum == 1 and swt == 2:
                        piece = sval.decode("utf-8")
                    elif sfnum == 2 and swt == 5:
                        score = struct.unpack("<f", sval)[0]
                    elif sfnum == 3 and swt == 0:
                        ptype = sval
                pieces.append(piece)
                types.append(ptype)
                scores.append(score)
        if not pieces:
            raise ValueError(f"no pieces found in SentencePiece model: {path}")
        return cls(pieces, types, scores)

    @property
    def vocab_size(self):
        return len(self.pieces)

    def ids_to_tokens(self, ids):
        return [self.pieces[i] for i in ids]

    def ids_to_text(self, ids):
        out = []
        byte_run = bytearray()

        def flush_bytes():
            if byte_run:
                out.append(byte_run.decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            t = self.types[i]
            if t in (_TYPE_CONTROL, _TYPE_UNUSED):
                continue
            piece = self.pieces[i]
            if t == _TYPE_BYTE:
                # pieces like "<0xE3>"
                byte_run.append(int(piece[1:-1], 16))
                continue
            flush_bytes()
            if t == _TYPE_UNKNOWN:
                out.append(" ⁇ ")
                continue
            out.append(piece)
        flush_bytes()
        return "".join(out).replace(_WS, " ").strip()

    def tokens_to_ids(self, tokens):
        return [self.piece_to_id[t] for t in tokens]


class VocabTokenizer(SentencePieceTokenizer):
    """k2-style tokens.txt: one "<piece> <id>" per line
    (pkg/k2-asr/src/huggingface.py:76 feeds this file to sherpa)."""

    def __init__(self, pieces):
        types = []
        for p in pieces:
            if p in ("<blk>", "<sos/eos>", "<s>", "</s>", "<pad>"):
                types.append(_TYPE_CONTROL)
            elif p == "<unk>":
                types.append(_TYPE_UNKNOWN)
            else:
                types.append(_TYPE_NORMAL)
        super().__init__(pieces, types)

    @classmethod
    def from_tokens_file(cls, path):
        entries = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                piece, _, idx = line.rpartition(" ")
                entries.append((int(idx), piece))
        entries.sort()
        return cls([p for _, p in entries])


class CharTokenizer(SentencePieceTokenizer):
    """Character vocabulary tokenizer (tests / espnet char models)."""

    def __init__(self, chars):
        super().__init__(list(chars))

    def text_to_ids(self, text):
        return [self.piece_to_id[c] for c in text]
