"""Caption-to-audio forced alignment and utterance extraction.

A copy of ``reazonspeech_tpu/oneseg/align.py`` with the same behaviour:
:class:`CTCSegmentationAligner` takes the port's espnet container, whose
``ctc_probs`` runs the encoder on its device, and aligns with the port's
CTC Viterbi (``decoding/ctc.py``).

Behavior parity with the reference (pkg/espnet-oneseg/src/align.py:1-95):
each caption is aligned within a 25 s lookback window (live captions lag the
audio), a 0.1 s pad fixes the chronically-clipped last syllable, the 'lax'
strategy redistributes up to 3 s of inter-utterance silence, and optional
re-ASR adds CER quality-control fields to each utterance.

The ESPnet CTCSegmentation dependency is replaced by
:class:`CTCSegmentationAligner` — the espnet-flavor model + the
first-party Viterbi CTC alignment — exposing the same calling
convention (``aligner(samples, text) -> .segments = [(start_s, end_s,
score)]`` and ``.fs``), so user code written against the reference's aligner
object ports directly.
"""

import numpy as np

from ..decoding.ctc import ctc_viterbi_align
from .caption import get_captions
from .interface import Utterance
from .sentence import build_sentences
from .text import cer, normalize
from .utils import load_audio

__all__ = ["CTCSegmentationAligner", "get_utterances"]

# Live programs show captions with up to ~25 s delay; align within that
# lookback window. (reference: pkg/espnet-oneseg/src/align.py:9-11)
_MARGIN = 25

# CTC alignment tends to clip the last syllable; pad the cut.
# (reference: pkg/espnet-oneseg/src/align.py:13-15)
_PADDING = 0.1


class _Aligned:
    def __init__(self, segments):
        self.segments = segments


class CTCSegmentationAligner:
    """Drop-in replacement for ESPnet's CTCSegmentation callable."""

    def __init__(self, model, fs=16000):
        """Args:
        model: the espnet-flavor container
          (reazonspeech_tpu_torch.espnet.asr.load_model)
        fs (int): sample rate
        """
        self.model = model
        self.fs = fs

    def __call__(self, samples, text):
        samples = np.asarray(samples, np.float32)
        lpz = self.model.ctc_probs(samples)
        lpz_log = np.log(np.maximum(lpz, 1e-10))
        try:
            ids = self.model.tokenizer.tokens_to_ids(list(text))
        except KeyError:
            raise ValueError(f"text contains out-of-vocabulary characters: {text!r}")
        frames = ctc_viterbi_align(lpz_log, ids, self.model.blank_id)
        if len(frames) != len(ids) or len(frames) == 0:
            raise ValueError("alignment failed")
        spf = len(samples) / (lpz.shape[0] + 1) / self.fs  # seconds per frame
        start = float(frames[0]) * spf
        end = float(frames[-1] + 1) * spf
        # score: mean log prob of the aligned tokens at their frames
        score = float(np.mean(lpz_log[frames, ids]))
        return _Aligned([(start, end, score)])


def _slice(buffer, samplerate, start, end):
    return buffer[int(start * samplerate) : int(end * samplerate)]


def _align(buffer, samplerate, caption, aligner):
    t0 = max(caption.start_seconds - _MARGIN, 0)
    t1 = caption.end_seconds

    source = _slice(buffer, samplerate, t0, t1)
    try:
        aligned = aligner(source, normalize(caption.text))
    except (IndexError, ValueError, RuntimeError):
        return None

    if aligned.segments:
        d0, d1, score = aligned.segments[0]
        return Utterance(
            buffer=None,
            samplerate=samplerate,
            duration=None,
            start_seconds=t0 + d0,
            end_seconds=t0 + d1 + _PADDING,
            text=caption.text,
            ctc=score,
        )
    return None


def _add_space(utterances):
    """'lax' strategy: split inter-utterance silence (≤3 s) between
    neighbors (reference: pkg/espnet-oneseg/src/align.py:46-51)."""
    for u0, u1 in zip(utterances, utterances[1:]):
        blank = (u1.start_seconds - u0.end_seconds) / 2
        blank = max(min(blank, 3), 0)
        u0.end_seconds += blank
        u1.start_seconds -= blank


def get_utterances(path, ctc_segmentation, speech2text=None, strategy="optim"):
    """Extract utterances from MPEG-TS data.

    Strategies: "optim" cuts at optimal low-noise points (clean corpus);
    "lax" includes surrounding audio (robust training).

    Args:
      path (str): path to an M2TS file
      ctc_segmentation: an audio aligner (CTCSegmentationAligner here; any
        object with ``.fs`` and ``(samples, text) -> .segments`` works)
      speech2text: optional recognizer ``(samples) -> text`` or an espnet
        container, used to add asr/cer QC fields
      strategy (str): "optim" or "lax"

    Returns:
      list[Utterance]
    """
    samplerate = int(ctc_segmentation.fs)
    captions = build_sentences(get_captions(path))
    buffer = load_audio(path, samplerate)
    utterances = []

    for caption in captions:
        utt = _align(buffer, samplerate, caption, ctc_segmentation)
        if utt:
            utterances.append(utt)

    if strategy == "lax":
        _add_space(utterances)

    for utt in utterances:
        utt.buffer = _slice(buffer, samplerate, utt.start_seconds, utt.end_seconds)
        utt.duration = utt.end_seconds - utt.start_seconds
        utt.samplerate = samplerate
        if speech2text:
            utt.asr = _recognize(speech2text, utt.buffer)
            utt.cer = cer(utt.text, utt.asr)

    return utterances


def _recognize(speech2text, samples):
    """Accept either a plain callable or an espnet container."""
    if hasattr(speech2text, "decode_with_ctc"):
        ids, _ = speech2text.decode_with_ctc(np.asarray(samples, np.float32))
        return speech2text.ids_to_text(ids)
    out = speech2text(samples)
    # espnet Speech2Text-style [(text, ...), ...] or a plain string
    if isinstance(out, str):
        return out
    return out[0][0]
