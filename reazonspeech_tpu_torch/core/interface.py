"""Core interface dataclasses shared by every ASR flavor.

A copy of ``reazonspeech_tpu/core/interface.py`` with the same fields: the
port imports nothing of the JAX package, so these are classes of their own
(compare a port result with a JAX one field by field).

These pin the public data contract of the framework. The shapes follow the
reference toolkit's richest variant (reference: pkg/nemo-asr/src/interface.py:4-36);
the per-flavor packages (k2 / espnet) re-expose narrowed variants so each
public API stays drop-in compatible with its reference counterpart
(reference: pkg/k2-asr/src/interface.py:10-25, pkg/espnet-asr/src/interface.py:17-24).
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AudioData:
    """Container for an audio waveform.

    ``waveform`` is a float32 numpy array (1-D mono, or [channels, samples]
    multi-channel before :func:`norm_audio`); ``samplerate`` is in Hz.
    """

    waveform: np.float32
    samplerate: int

    @property
    def duration_seconds(self) -> float:
        n = self.waveform.shape[-1]
        return n / self.samplerate


@dataclass
class Subword:
    """A decoded subword with a single-point timestamp."""

    seconds: float
    token_id: int
    token: str


@dataclass
class Segment:
    """A segment of transcription with start/end timestamps."""

    start_seconds: float
    end_seconds: float
    text: str


@dataclass
class TranscribeResult:
    """Full transcription result: text plus token- and segment-level timing."""

    text: str
    subwords: list[Subword] = field(default_factory=list)
    segments: list[Segment] = field(default_factory=list)
    hypothesis: object = None


@dataclass
class TranscribeConfig:
    """Runtime knobs for transcribe().

    ``verbose``/``raw_hypothesis`` match the reference contract
    (pkg/nemo-asr/src/interface.py:33-36). The TPU build additionally
    surfaces long-form chunking knobs the reference hard-codes (it sends the
    whole waveform in one call regardless of length,
    pkg/nemo-asr/src/transcribe.py:44-53):

    - ``chunk_seconds``: above this duration, audio is split into overlapped
      chunks decoded as ONE batch (peak-throughput path) and merged by
      keeping each chunk's center region. None = reference behavior
      (single full-length pass).
    - ``chunk_overlap_seconds``: context shared between neighboring chunks.
    """

    verbose: bool = True
    raw_hypothesis: bool = False
    chunk_seconds: float = None
    chunk_overlap_seconds: float = 4.0


@dataclass
class Caption:
    """A caption packet extracted from an MPEG-TS stream.

    Reference contract: pkg/espnet-oneseg/src/interface.py:5-10.
    """

    start_seconds: int
    end_seconds: int
    text: str


@dataclass
class Utterance:
    """A pair of audio data and transcription produced by corpus building.

    Reference contract: pkg/espnet-oneseg/src/interface.py:12-23.
    """

    buffer: list
    samplerate: int
    duration: float
    start_seconds: float
    end_seconds: float
    text: str
    ctc: float
    asr: str = None
    cer: float = None
