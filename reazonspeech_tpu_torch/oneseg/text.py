"""oneseg text utilities (parity: pkg/espnet-oneseg/src/text.py).

A copy of ``reazonspeech_tpu/oneseg/text.py``."""

from ..core.text import cer, normalize

__all__ = ["cer", "normalize"]
