"""k2-flavor transcribe() and transcribe_batch().

Port of ``reazonspeech_tpu.k2.asr.transcribe``: behaviour parity with the
reference (pkg/k2-asr/src/transcribe.py:10-45): 0.9 s silence padding both
sides, a warning above 30 s of input, greedy transducer decode, per-subword
timestamps on the 0.04 s Zipformer output grid (relative to the padded
waveform start, exactly as sherpa reports them).
"""

import warnings

import numpy as np

from ...core.audio import norm_audio, pad_audio
from .interface import Subword, TranscribeConfig, TranscribeResult
from .model import BUCKET_SAMPLES, SECONDS_PER_FRAME, K2TorchModel

__all__ = ["transcribe", "transcribe_batch", "PAD_SECONDS", "TOO_LONG_SECONDS"]

PAD_SECONDS = 0.9
TOO_LONG_SECONDS = 30.0


def transcribe(model: K2TorchModel, audio, config=None) -> TranscribeResult:
    """Transcribe audio data with the k2 (Zipformer) model.

    Args:
        model (K2TorchModel): ReazonSpeech model (see huggingface.load_model)
        audio (AudioData): audio data to transcribe
        config (TranscribeConfig): additional settings

    Returns:
        TranscribeResult
    """
    if config is None:
        config = TranscribeConfig()

    audio = pad_audio(norm_audio(audio), PAD_SECONDS)

    duration = audio.waveform.shape[0] / audio.samplerate
    if duration > TOO_LONG_SECONDS:
        warnings.warn(
            f"Passing a long audio input ({duration:.1f}s) is not recommended, "
            "because attention memory grows quadratically with length. "
            "Read the upstream discussion for more details: "
            "https://github.com/k2-fsa/icefall/issues/1680"
        )

    token_ids, frames = model.decode_single(audio.waveform)
    return _build_result(model, token_ids, frames)


def _build_result(model, token_ids, frames) -> TranscribeResult:
    subwords = [Subword(token=model.tokenizer.ids_to_tokens([tid])[0],
                        seconds=frame * SECONDS_PER_FRAME)
                for tid, frame in zip(token_ids, frames)]
    return TranscribeResult(model.tokenizer.ids_to_text(token_ids), subwords)


def transcribe_batch(model: K2TorchModel, audios, config=None):
    """Transcribe a batch of utterances padded to one bucket and decoded
    together (the throughput path; the reference's sherpa backend is
    strictly one stream at a time).

    Args:
        model (K2TorchModel)
        audios (list[AudioData])

    Returns:
        list[TranscribeResult]
    """
    if config is None:
        config = TranscribeConfig()

    waves = [pad_audio(norm_audio(a), PAD_SECONDS).waveform for a in audios]
    lengths = np.asarray([len(w) for w in waves], np.int32)
    n_max = int(lengths.max())
    padded_n = max(BUCKET_SAMPLES, -(-n_max // BUCKET_SAMPLES) * BUCKET_SAMPLES)
    buf = np.zeros((len(waves), padded_n), np.float32)
    for i, w in enumerate(waves):
        buf[i, : len(w)] = w

    tokens, frames, counts, _ = model.decode_batch(buf, lengths)
    return [_build_result(model, tokens[i, :int(counts[i])].tolist(),
                          frames[i, :int(counts[i])].tolist())
            for i in range(len(waves))]
