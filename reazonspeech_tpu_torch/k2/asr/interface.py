"""k2-flavor public dataclasses: a copy of
``reazonspeech_tpu/k2/asr/interface.py`` (parity: pkg/k2-asr/src/interface.py)."""

from dataclasses import dataclass

from ...core.interface import AudioData

__all__ = ["AudioData", "Subword", "TranscribeResult", "TranscribeConfig"]


@dataclass
class Subword:
    """A subword with a single-point timestamp."""

    seconds: float
    token: str


@dataclass
class TranscribeResult:
    text: str
    subwords: list[Subword]


@dataclass
class TranscribeConfig:
    verbose: bool = True
