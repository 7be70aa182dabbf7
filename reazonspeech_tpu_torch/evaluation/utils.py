"""Evaluation-side text normalization and CER.

A copy of ``reazonspeech_tpu/evaluation/utils.py``. Contract parity with
pkg/evaluation/src/utils.py:1-33; the implementations live in the port's
core.text (shared with the corpus tooling's opposite-direction normalizer)
with the editdistance/num2words C/pip dependencies replaced by first-party
code.
"""

from ..core.text import CERResult, calculate_cer, normalize_eval as normalize

__all__ = ["CERResult", "normalize", "calculate_cer"]
