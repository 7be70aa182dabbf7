"""Hypothesis post-processing: timestamps and segmentation heuristics.

A straight copy of ``reazonspeech_tpu.nemo.asr.decode`` (numpy only): the
port imports nothing of the JAX package.

Behavioral parity port of the reference's decode layer
(pkg/nemo-asr/src/decode.py:1-66): identical constants, identical timestamp
formula, identical end-of-segment heuristics — this layer is pure logic and
its outputs feed subtitle files, so it must be bit-for-bit.
"""

from dataclasses import dataclass

import numpy as np

from ...core.interface import Segment, Subword, TranscribeResult

__all__ = [
    "PAD_SECONDS",
    "SECONDS_PER_STEP",
    "Hypothesis",
    "decode_hypothesis",
    "find_end_of_segment",
]

# Hyper parameters (reference: pkg/nemo-asr/src/decode.py:3-11)
PAD_SECONDS = 0.5
SECONDS_PER_STEP = 0.08
SUBWORDS_PER_SEGMENTS = 10
PHONEMIC_BREAK = 0.5

TOKEN_EOS = {"。", "?", "!"}
TOKEN_COMMA = {"、", ","}
TOKEN_PUNC = TOKEN_EOS | TOKEN_COMMA


@dataclass
class Hypothesis:
    """Decode result in the ALSD artifact convention the reference consumes:

    ``y_sequence`` carries a leading blank token (the reference trims it,
    pkg/nemo-asr/src/decode.py:38-40) and ``timestamp[idx]`` encodes
    ``frame(idx) + idx + 1`` so the reference formula
    ``SECONDS_PER_STEP * (step - idx - 1) - PAD_SECONDS`` recovers the true
    encoder frame time of token ``idx`` (pkg/nemo-asr/src/decode.py:48).
    """

    y_sequence: np.ndarray
    timestamp: list
    score: float = 0.0
    text: str = None

    @classmethod
    def from_greedy(cls, tokens, frames, blank_id, score=0.0):
        """Build from raw (token, encoder-frame) emission pairs."""
        tokens = list(tokens)
        frames = list(frames)
        y_sequence = np.asarray([blank_id] + tokens, dtype=np.int64)
        timestamp = [f + i + 1 for i, f in enumerate(frames)]
        # mirror ALSD's len(timestamp) == len(y_sequence)
        timestamp.append((frames[-1] if frames else 0) + len(frames) + 1)
        return cls(y_sequence=y_sequence, timestamp=timestamp, score=score)


def find_end_of_segment(subwords, start):
    """Heuristics to identify speech boundaries
    (parity: pkg/nemo-asr/src/decode.py:13-26)."""
    length = len(subwords)
    idx = start
    for idx in range(start, length):
        if idx < length - 1:
            cur = subwords[idx]
            nex = subwords[idx + 1]
            if nex.token not in TOKEN_PUNC:
                if cur.token in TOKEN_EOS:
                    break
                elif idx - start >= SUBWORDS_PER_SEGMENTS:
                    if (
                        cur.token in TOKEN_COMMA
                        or nex.seconds - cur.seconds > PHONEMIC_BREAK
                    ):
                        break
    return idx


def decode_hypothesis(model, hyp) -> TranscribeResult:
    """Decode transducer emissions into a TranscribeResult
    (parity: pkg/nemo-asr/src/decode.py:28-66).

    Args:
        model: object exposing ``tokenizer.ids_to_text``
        hyp (Hypothesis): hypothesis in ALSD artifact convention

    Returns:
        TranscribeResult
    """
    # Trim the artifact leading blank token.
    y_sequence = hyp.y_sequence.tolist()[1:]
    text = model.tokenizer.ids_to_text(y_sequence)

    subwords = []
    for idx, (token_id, step) in enumerate(zip(y_sequence, hyp.timestamp)):
        subwords.append(
            Subword(
                token_id=token_id,
                token=model.tokenizer.ids_to_text([token_id]),
                seconds=max(SECONDS_PER_STEP * (step - idx - 1) - PAD_SECONDS, 0),
            )
        )

    # SentencePiece represents whitespace as a meta token (U+2581); such
    # tokens detokenize to the empty string and are trimmed.
    subwords = [x for x in subwords if x.token]

    segments = []
    start = 0
    while start < len(subwords):
        end = find_end_of_segment(subwords, start)
        segments.append(
            Segment(
                start_seconds=subwords[start].seconds,
                end_seconds=subwords[end].seconds + SECONDS_PER_STEP,
                text="".join(x.token for x in subwords[start : end + 1]),
            )
        )
        start = end + 1

    return TranscribeResult(text, subwords, segments)
