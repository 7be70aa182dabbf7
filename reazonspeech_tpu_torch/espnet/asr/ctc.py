"""espnet-flavor CTC utilities: blank detection, alignment, segmentation.

Port of ``reazonspeech_tpu/espnet/asr/ctc.py`` (signature and behaviour
parity with pkg/espnet-asr/src/ctc.py:1-101). The CTC matrix comes from the
model's own encoder pass, and the alignment is the Viterbi DP of
``decoding/ctc.py``, run on the model's device.
"""

import numpy as np
import torch

from ...decoding.ctc import Blank
from ...decoding.ctc import find_blank as _find_blank_lpz
from ...decoding.ctc import get_timings as _get_timings_lpz

__all__ = ["Blank", "ctc_decode", "find_blank", "get_timings", "find_end_of_segment",
           "split_text"]

TOKEN_EOS = {"。", "?", "!"}
TOKEN_COMMA = {"、", ","}
TOKEN_PUNC = TOKEN_EOS | TOKEN_COMMA
PHONEMIC_BREAK = 8000  # samples (reference: pkg/espnet-asr/src/ctc.py:9)
CHARS_PER_SEGMENT = 15


def ctc_decode(model, samples):
    """Character probabilities per frame using the CTC network
    (parity: pkg/espnet-asr/src/ctc.py:12-27)."""
    return model.ctc_probs(np.asarray(samples, np.float32))


def find_blank(model, samples, threshold=0.98):
    """Find the longest no-speech segment in an audio chunk
    (parity: pkg/espnet-asr/src/ctc.py:29-58)."""
    lpz = ctc_decode(model, samples)
    return _find_blank_lpz(lpz, len(samples), model.blank_id, threshold)


def _text_to_token_ids(model, text):
    """Map text characters to token-list ids; raises KeyError on unknown
    chars (split_text's fallback then returns the whole-audio segment)."""
    return model.tokenizer.tokens_to_ids(list(text))


def get_timings(model, samples, text, lpz_log=None):
    """Playback timing (in samples) of each character
    (parity: pkg/espnet-asr/src/ctc.py:60-72). ``lpz_log``: the chunk's CTC
    log-probabilities (a tensor or numpy), or None to compute them."""
    samples = np.asarray(samples, np.float32)
    if lpz_log is None:
        lpz = ctc_decode(model, samples)
        lpz_log = np.log(np.maximum(lpz, 1e-10))
    ids = _text_to_token_ids(model, text)
    timings = _get_timings_lpz(torch.as_tensor(lpz_log, device=model.device), ids,
                               len(samples), model.blank_id)
    if len(timings) != len(text):
        raise ValueError("alignment failed")
    return timings


def find_end_of_segment(text, timings, start):
    """(parity: pkg/espnet-asr/src/ctc.py:74-86)"""
    nchar = len(text)
    idx = start
    for idx in range(start, nchar):
        if idx < nchar - 1:
            cur = text[idx]
            nex = text[idx + 1]
            if nex not in TOKEN_PUNC:
                if cur in TOKEN_EOS:
                    break
                elif idx - start >= CHARS_PER_SEGMENT:
                    if cur in TOKEN_COMMA or timings[idx + 1] - timings[idx] > PHONEMIC_BREAK:
                        break
    return idx


def split_text(model, samples, text, lpz_log=None):
    """Split text into (start_sample, end_sample, text) segments
    (parity: pkg/espnet-asr/src/ctc.py:88-101, including the whole-audio
    fallback on any alignment failure)."""
    try:
        timings = get_timings(model, samples, text, lpz_log=lpz_log)
    except Exception:
        return [(0, len(samples), text)]

    ret = []
    start = 0
    while start < len(text):
        end = find_end_of_segment(text, timings, start)
        ret.append((timings[start], timings[end], text[start:end + 1]))
        start = end + 1
    return ret
