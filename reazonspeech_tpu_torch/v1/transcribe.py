"""v1 streaming transcription: a generator that yields captions as chunks
decode.

A copy of ``reazonspeech_tpu/v1/transcribe.py`` with the same behaviour; the
recognizer is the port's espnet container (on CUDA unless the caller loads
it on the CPU), whose ``decode_with_ctc`` keeps the chunk's CTC log-probs on
its device for the Viterbi alignment.

Behavior parity with the reference (pkg/_v1/src/transcribe.py:91-168):
20 s (configurable) windows cut at the END of the longest CTC-blank run,
dynamic text splitting at the 98th-percentile inter-character gap, captions
yielded incrementally. The ESPnet backend becomes the espnet-flavor
container; the chunk's encoder pass is shared between decode and alignment.
"""

import numpy as np

from ..core.audio import audio_from_path
from ..decoding.ctc import ctc_viterbi_align, find_blank
from .interface import Caption, TranscribeConfig

__all__ = ["transcribe", "load_default_model"]


def load_default_model(device=None):
    """Load the default v1 recognition model onto ``device`` (default CUDA,
    which raises without a GPU; pass ``device="cpu"`` for the CPU). API
    parity: pkg/_v1/src/transcribe.py:116-127; beam/lm weights are
    espnet-specific and do not apply to the transducer decode. Weights
    resolve from $REAZONSPEECH_TPU_V1_CHECKPOINT, else the
    reazonspeech-espnet-next HF repo, offline-cache first (a cached
    snapshot is converted on the first load); raises
    CheckpointNotFoundError when nothing is resolvable."""
    import os

    from ..espnet.asr.model import load_model_container

    checkpoint = os.environ.get("REAZONSPEECH_TPU_V1_CHECKPOINT")
    if checkpoint is None:
        from ..core.hub import resolve_converted
        from ..espnet.asr.model import _convert_snapshot

        checkpoint = resolve_converted(
            "reazon-research/reazonspeech-espnet-next", "model", _convert_snapshot
        )
    return load_model_container(checkpoint=checkpoint, device=device)


def _get_timings(asr, lpz_log, nsamples, model):
    ids = model.tokenizer.tokens_to_ids(list(asr))
    frames = ctc_viterbi_align(lpz_log, ids, model.blank_id)
    if len(frames) != len(ids) or len(frames) == 0:
        raise ValueError("alignment failed")
    return frames.astype(np.float64) * (nsamples / (lpz_log.shape[0] + 1))


def _split_text(asr, audio, model, lpz_log=None):
    """Split text by phonemic pauses using a dynamic threshold: the 98th
    percentile of inter-character gaps (parity: pkg/_v1/src/transcribe.py:91-110,
    including the first/last-character bogus-timing guards)."""
    if len(asr) < 2:
        return [(0, len(audio), asr)]

    try:
        if lpz_log is None:
            lpz = model.ctc_probs(np.asarray(audio, np.float32))
            lpz_log = np.log(np.maximum(lpz, 1e-10))
        timings = _get_timings(asr, lpz_log, len(audio), model)
    except Exception:
        return [(0, len(audio), asr)]

    threshold = np.percentile(timings[1:] - timings[:-1], 98, method="nearest")

    text, start, prev = "", timings[0], timings[0]
    remain = len(asr)
    ret = []
    curr = timings[0]

    for char, curr in zip(asr, timings):
        # CTC segmentation sometimes returns bogus timings for the
        # first/last characters.
        if len(text) > 1 and remain > 1 and curr - prev > threshold:
            ret.append((start, curr, text))
            start, text = curr, ""
        prev = curr
        text += char
        remain -= 1
    if text:
        ret.append((start, curr, text))
    return ret


def transcribe(audio, speech2text=None, config=None):
    """Transcribe audio data, yielding captions incrementally.

    Args:
      audio (str or np.ndarray): path to an audio file, or raw 16 kHz samples
      speech2text: the espnet-flavor container (see load_default_model)
      config (TranscribeConfig)

    Yields:
      Caption
    """
    if config is None:
        config = TranscribeConfig()

    if speech2text is None:
        speech2text = load_default_model()

    if isinstance(audio, str):
        loaded = audio_from_path(audio)
        from ..core.audio import norm_audio

        audio = norm_audio(loaded).waveform

    nsamples = len(audio)
    pos = 0

    while pos < nsamples:
        segment = audio[pos:]

        # For long input, decode up to the end of the longest no-speech
        # region inside the window (v1 cuts at blank.end, not the midpoint:
        # pkg/_v1/src/transcribe.py:155-157).
        if len(segment) > config.window:
            lpz = speech2text.ctc_probs(
                np.asarray(segment[: config.window], np.float32)
            )
            blank = find_blank(
                lpz, config.window, speech2text.blank_id, config.blank_threshold
            )
            segment = segment[: blank.end]

        padded = np.pad(segment, config.padding, mode="constant")
        token_ids, lpz_log = speech2text.decode_with_ctc(padded)
        asr = speech2text.ids_to_text(token_ids)

        for start, end, text in _split_text(asr, padded, speech2text, lpz_log=lpz_log):
            start = min(max(start - config.padding[0], 0), len(segment))
            end = min(max(end - config.padding[0], 0), len(segment))
            yield Caption(
                start_seconds=(pos + start) / config.samplerate,
                end_seconds=(pos + end) / config.samplerate,
                text=text,
            )
        pos += len(segment)
