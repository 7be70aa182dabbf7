"""Weight-only int8 param trees: reading them.

A copy of the reading half of ``reazonspeech_tpu/convert/quantize.py``
(numpy only): a quantized leaf is ``{"__q8__": int8, "scale": fp32}`` with
per-output-channel scales over the last axis, and dequantizes to
``q8 · scale``. The k2 loader restores int8 precision variants with it.
"""

import numpy as np

__all__ = ["dequantize_tree", "is_quantized"]


def _is_qleaf(x):
    return isinstance(x, dict) and "__q8__" in x


def dequantize_tree(params, dtype=np.float32):
    """Restore a quantized tree to dense arrays."""
    if _is_qleaf(params):
        return (params["__q8__"].astype(np.float32) * params["scale"]).astype(dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(dequantize_tree(v, dtype) for v in params)
    return params


def is_quantized(params) -> bool:
    if _is_qleaf(params):
        return True
    if isinstance(params, dict):
        return any(is_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(is_quantized(v) for v in params)
    return False
