"""reazonspeech_tpu_torch.oneseg — 1seg TV stream → ASR corpus pipeline.

A copy of ``reazonspeech_tpu/oneseg/__init__.py``; the aligner runs the
port's espnet container.

Surface parity with the reference package ``reazonspeech.espnet.oneseg``
(pkg/espnet-oneseg/src/__init__.py): MPEG-TS caption extraction, ARIB
c-profile decoding, sentence rebuilding, CTC forced alignment, and zip+manifest
corpus writing.
"""

from .align import CTCSegmentationAligner, get_utterances
from .caption import get_captions
from .interface import Caption, Utterance
from .sentence import build_sentences
from .text import cer, normalize
from .utils import load_audio, save_as_zip

__all__ = [
    "get_captions",
    "build_sentences",
    "get_utterances",
    "CTCSegmentationAligner",
    "load_audio",
    "save_as_zip",
    "Caption",
    "Utterance",
    "cer",
    "normalize",
]
