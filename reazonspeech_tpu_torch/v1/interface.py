"""v1 dataclasses (parity: pkg/_v1/src/interface.py).

A copy of ``reazonspeech_tpu/v1/interface.py``."""

from dataclasses import dataclass

from ..core.interface import Caption, Utterance

__all__ = ["Caption", "Utterance", "TranscribeConfig"]


@dataclass
class TranscribeConfig:
    """Parameters for transcribe() — the v1 API exposes the long-form knobs
    the v2/v3 packages freeze (pkg/_v1/src/interface.py:25-31)."""

    samplerate: int = 16000
    window: int = 320000
    blank_threshold: float = 0.98
    padding: tuple = (16000, 8000)
