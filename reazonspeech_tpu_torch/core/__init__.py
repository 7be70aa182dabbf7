"""The port's own copies of the jax-free ``reazonspeech_tpu.core`` modules
(audio I/O, interface dataclasses, hub resolution, tokenizers, writers and
the CLI runner): the port imports nothing of the JAX package."""

from .interface import (
    AudioData,
    Segment,
    Subword,
    TranscribeConfig,
    TranscribeResult,
)

__all__ = [
    "AudioData",
    "Segment",
    "Subword",
    "TranscribeConfig",
    "TranscribeResult",
]
