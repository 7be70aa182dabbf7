"""Long-form chunked transcription (espnet flavor).

Port of ``reazonspeech_tpu.espnet.asr.transcribe`` (flow parity with
pkg/espnet-asr/src/transcribe.py:34-82): 20 s sliding window, cut at the
longest CTC-blank run's midpoint, pad (1.0 s, 0.5 s), decode, split into
timed segments. The chunk's encoder pass is computed once and shared
between decode and alignment. ``TranscribeConfig.verbose`` is accepted; the
port draws no progress bar.
"""

import numpy as np

from ...core.audio import norm_audio
from .ctc import find_blank, split_text
from .interface import Segment, TranscribeConfig, TranscribeResult
from .model import EspnetTorchModel, load_model_container

# Hyper parameters (reference: pkg/espnet-asr/src/transcribe.py:8-10)
WINDOW_SECONDS = 20
PADDING = (16000, 8000)

__all__ = ["transcribe", "load_model", "WINDOW_SECONDS", "PADDING"]


def load_model(device=None, **kwargs) -> EspnetTorchModel:
    """Load the ReazonSpeech espnet-v2 flavor model onto ``device`` (default
    CUDA, which raises without a GPU; pass ``device="cpu"`` for the CPU).
    Keyword arguments go to :func:`.model.load_model_container`."""
    return load_model_container(device=device, **kwargs)


def transcribe(model: EspnetTorchModel, audio, config=None) -> TranscribeResult:
    """Transcribe audio data (flow parity: pkg/espnet-asr/src/transcribe.py:34-82).

    Args:
      model (EspnetTorchModel): ReazonSpeech model
      audio (AudioData): audio to transcribe
      config (TranscribeConfig): additional settings

    Returns:
      TranscribeResult
    """
    if config is None:
        config = TranscribeConfig()

    audio = norm_audio(audio)

    pos = 0
    fulltext = ""
    segments = []
    window = int(WINDOW_SECONDS * audio.samplerate)

    while pos < len(audio.waveform):
        samples = audio.waveform[pos:]

        # For long audio, cut at the longest non-speech region so chunk
        # boundaries never split a word.
        if len(samples) > window:
            blank = find_blank(model, samples[:window])
            mid = int((blank.start + blank.end) / 2)
            samples = samples[:mid]

        padded = np.pad(samples, PADDING, mode="constant")
        token_ids, lpz_log = model.decode_with_ctc(padded)
        asr = model.ids_to_text(token_ids)
        fulltext += asr

        # Alignment reuses the decode pass's CTC matrix (computed over the
        # padded chunk); timings come back in padded-sample coordinates and
        # are shifted by the front padding.
        for start, end, text in split_text(model, padded, asr, lpz_log=lpz_log):
            start = min(max(start - PADDING[0], 0), len(samples))
            end = min(max(end - PADDING[0], 0), len(samples))
            segments.append(Segment(start_seconds=(pos + start) / audio.samplerate,
                                    end_seconds=(pos + end) / audio.samplerate, text=text))
        pos += len(samples)

    return TranscribeResult(fulltext, segments)
