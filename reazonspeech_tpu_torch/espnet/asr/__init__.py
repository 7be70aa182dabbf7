"""reazonspeech_tpu_torch.espnet.asr — Conformer-Transducer (espnet-v2
flavor) ASR.

The surface of ``reazonspeech_tpu.espnet.asr`` (same function names,
dataclasses and output semantics) on the PyTorch/CUDA pipeline: long-form
chunked decoding with CTC-guided chunk boundaries and per-segment
timestamps.
"""

from ...core.audio import (
    audio_from_numpy,
    audio_from_path,
    audio_from_tensor,
    audio_to_file,
    norm_audio,
)
from .interface import AudioData, Segment, TranscribeConfig, TranscribeResult
from .transcribe import load_model, transcribe

__all__ = [
    "TranscribeConfig",
    "TranscribeResult",
    "AudioData",
    "Segment",
    "transcribe",
    "load_model",
    "audio_from_numpy",
    "audio_from_tensor",
    "audio_from_path",
    "audio_to_file",
    "norm_audio",
]
