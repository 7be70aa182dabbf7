"""reazonspeech_tpu_torch.v1 — legacy v1 API (superset of oneseg + streaming
transcribe generator).

A copy of ``reazonspeech_tpu/v1/__init__.py``; the recognizer is the port's
espnet container.

Surface parity with the reference package ``reazonspeech`` v1
(pkg/_v1/src/__init__.py): corpus tooling re-exported from oneseg plus the
incremental ``transcribe()`` generator.
"""

from ..oneseg.align import CTCSegmentationAligner, get_utterances
from ..oneseg.caption import get_captions
from ..oneseg.sentence import build_sentences
from ..oneseg.utils import load_audio, save_as_zip
from .interface import Caption, TranscribeConfig, Utterance
from .transcribe import load_default_model, transcribe

__all__ = [
    "get_captions",
    "build_sentences",
    "get_utterances",
    "CTCSegmentationAligner",
    "load_audio",
    "save_as_zip",
    "Caption",
    "Utterance",
    "TranscribeConfig",
    "transcribe",
    "load_default_model",
]
