"""reazonspeech_tpu_torch.nemo.asr — FastConformer-RNNT (nemo-v2 flavor) ASR.

The surface of ``reazonspeech_tpu.nemo.asr`` (same function names,
dataclasses and output semantics) on the PyTorch/CUDA pipeline.
"""

from ...core.audio import (
    audio_from_numpy,
    audio_from_path,
    audio_from_tensor,
    audio_to_file,
    norm_audio,
    pad_audio,
)
from ...core.interface import (
    AudioData,
    Segment,
    Subword,
    TranscribeConfig,
    TranscribeResult,
)
from .transcribe import load_model, transcribe, transcribe_batch

__all__ = [
    "TranscribeConfig",
    "TranscribeResult",
    "AudioData",
    "Subword",
    "Segment",
    "transcribe",
    "transcribe_batch",
    "load_model",
    "audio_from_numpy",
    "audio_from_tensor",
    "audio_from_path",
    "audio_to_file",
    "norm_audio",
    "pad_audio",
]
