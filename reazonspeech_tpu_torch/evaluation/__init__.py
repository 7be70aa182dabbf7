"""reazonspeech_tpu_torch.evaluation — CER evaluation harness over HF datasets.

A copy of ``reazonspeech_tpu.evaluation`` (contract parity with the
reference package ``reazonspeech.evaluation``, pkg/evaluation/src/__init__.py):
BaseEvaluator + CER utilities, process-level data parallelism via
datasets.map, and :func:`mesh_model`, one evaluator over a mesh of devices.
"""

from .base import BaseEvaluator, EvaluationResult, EvaluationResultBatch
from .mesh import mesh_model
from .utils import CERResult, calculate_cer, normalize

__all__ = [
    "BaseEvaluator",
    "EvaluationResult",
    "EvaluationResultBatch",
    "CERResult",
    "calculate_cer",
    "normalize",
    "mesh_model",
]
