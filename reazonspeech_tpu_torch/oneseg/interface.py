"""oneseg dataclasses (parity: pkg/espnet-oneseg/src/interface.py).

A copy of ``reazonspeech_tpu/oneseg/interface.py``."""

from ..core.interface import Caption, Utterance

__all__ = ["Caption", "Utterance"]
