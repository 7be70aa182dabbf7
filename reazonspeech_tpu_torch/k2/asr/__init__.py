"""reazonspeech_tpu_torch.k2.asr — Zipformer transducer (k2-v2 flavor) ASR,
including the bilingual ja-en models.

The surface of ``reazonspeech_tpu.k2.asr`` (same function names,
dataclasses and output semantics), plus ``transcribe_batch``, on the
PyTorch/CUDA pipeline.
"""

from ...core.audio import (
    audio_from_numpy,
    audio_from_path,
    audio_from_tensor,
    audio_to_file,
    norm_audio,
    pad_audio,
)
from .huggingface import load_model
from .interface import AudioData, Subword, TranscribeConfig, TranscribeResult
from .transcribe import transcribe, transcribe_batch

__all__ = [
    "TranscribeConfig",
    "TranscribeResult",
    "AudioData",
    "Subword",
    "load_model",
    "transcribe",
    "transcribe_batch",
    "audio_from_numpy",
    "audio_from_tensor",
    "audio_from_path",
    "audio_to_file",
    "norm_audio",
    "pad_audio",
]
