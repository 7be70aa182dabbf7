"""Weight-only int8 quantization of param trees.

A copy of ``reazonspeech_tpu/convert/quantize.py`` (numpy only). The
reference's k2 flavor ships int8 / int8-fp32 ONNX variants
(pkg/k2-asr/src/huggingface.py:40-59). Here quantization is a property of
the param tree: matmul/conv kernels are stored as int8 with
per-output-channel fp32 scales (symmetric absmax over the last axis), and a
quantized leaf ``{"__q8__": int8, "scale": fp32}`` dequantizes to
``q8 · scale``; the k2 loader restores int8 precision variants with it.
Norms, biases, and small tensors stay fp32.
"""

import numpy as np

__all__ = ["quantize_tree", "dequantize_tree", "is_quantized"]

_MIN_ELEMS = 4096  # don't quantize tiny tensors


def _quantize_leaf(x):
    x = np.asarray(x)
    if x.dtype != np.float32 or x.size < _MIN_ELEMS or x.ndim < 2:
        return x
    # per-output-channel scales over the last axis
    absmax = np.max(np.abs(x), axis=tuple(range(x.ndim - 1)), keepdims=True)
    scale = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return {"__q8__": q, "scale": scale}


def _is_qleaf(x):
    return isinstance(x, dict) and "__q8__" in x


def quantize_tree(params):
    """Quantize every large ≥2-D fp32 leaf to int8 + scales."""
    if isinstance(params, dict):
        return {k: quantize_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(v) for v in params)
    return _quantize_leaf(params)


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
