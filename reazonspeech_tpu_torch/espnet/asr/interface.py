"""espnet-flavor public dataclasses: a copy of
``reazonspeech_tpu/espnet/asr/interface.py`` (parity:
pkg/espnet-asr/src/interface.py)."""

from dataclasses import dataclass

from ...core.interface import AudioData, Segment

__all__ = ["AudioData", "Segment", "TranscribeResult", "TranscribeConfig"]


@dataclass
class TranscribeResult:
    text: str
    segments: list


@dataclass
class TranscribeConfig:
    verbose: bool = True
