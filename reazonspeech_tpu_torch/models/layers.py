"""Functional layer primitives on param dicts (PyTorch).

Port of ``reazonspeech_tpu.models.layers``. Params keep the JAX layouts
(dense ``w`` [in, out]; conv1d ``w`` [K, in, out]; depthwise ``w``
[K, 1, C]; conv2d ``w`` HWIO) and activations keep the JAX data layouts
(channels last), so a tree and a tensor move between the two packages
unchanged. The dtype chains are the reference's: matmul and conv inputs are
cast to the caller's compute dtype and produce it, biases are cast to the
output dtype and added, and normalization statistics are fp32.

The ``*_init`` functions draw the same distributions as the reference's
from a ``torch.Generator`` (the values differ: the generators differ).
"""

import math

import torch
import torch.nn.functional as F

__all__ = [
    "dense_init", "dense", "layer_norm_init", "layer_norm", "batch_norm_init",
    "batch_norm_infer", "conv1d_init", "conv1d", "depthwise_conv1d_init",
    "depthwise_conv1d", "conv2d_init", "conv2d", "embedding_init", "swish", "glu",
]


def _uniform(gen, shape, scale, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (u * 2.0 - 1.0) * scale


def _cast(x, w, dtype):
    if dtype is None:
        return x, w
    return x.to(dtype), w.to(dtype)


def _add_bias(y, p):
    return y + p["b"].to(y.dtype) if "b" in p else y


# -- dense ------------------------------------------------------------------

def dense_init(gen, in_dim, out_dim, bias=True, device="cpu"):
    scale = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (in_dim, out_dim), scale, device)}
    if bias:
        p["b"] = _uniform(gen, (out_dim,), scale, device)
    return p


def dense(p, x, dtype=None):
    x, w = _cast(x, p["w"], dtype)
    return _add_bias(x @ w, p)


# -- normalization ----------------------------------------------------------

def layer_norm_init(dim, device="cpu"):
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def layer_norm(p, x, eps=1e-5):
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def batch_norm_init(dim, device="cpu"):
    """Inference batch norm: the running statistics are params."""
    return {
        "scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device),
        "mean": torch.zeros(dim, device=device), "var": torch.ones(dim, device=device),
    }


def batch_norm_infer(p, x, eps=1e-5):
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return ((x32 - p["mean"]) * inv + p["bias"]).to(x.dtype)


# -- convolutions -----------------------------------------------------------

def conv1d_init(gen, in_ch, out_ch, kernel, bias=True, device="cpu"):
    scale = 1.0 / math.sqrt(in_ch * kernel)
    p = {"w": _uniform(gen, (kernel, in_ch, out_ch), scale, device)}
    if bias:
        p["b"] = _uniform(gen, (out_ch,), scale, device)
    return p


def _same_pad_time(x, k):
    """Stride-1 SAME zero padding of the time axis of [B, C, T]."""
    left = (k - 1) // 2
    return F.pad(x, (left, k - 1 - left))


def conv1d(p, x, dtype=None):
    """Stride-1 SAME conv, x: [B, T, C_in] -> [B, T, C_out]."""
    x, w = _cast(x, p["w"], dtype)
    k = w.shape[0]
    if k == 1:
        return _add_bias(x @ w[0], p)
    y = F.conv1d(_same_pad_time(x.transpose(1, 2), k), w.permute(2, 1, 0))
    return _add_bias(y.transpose(1, 2), p)


def depthwise_conv1d_init(gen, ch, kernel, bias=True, device="cpu"):
    scale = 1.0 / math.sqrt(kernel)
    p = {"w": _uniform(gen, (kernel, 1, ch), scale, device)}
    if bias:
        p["b"] = _uniform(gen, (ch,), scale, device)
    return p


def depthwise_conv1d(p, x, dtype=None):
    """Stride-1 SAME conv with one filter per channel, x: [B, T, C]."""
    x, w = _cast(x, p["w"], dtype)
    k, _, ch = w.shape
    y = F.conv1d(_same_pad_time(x.transpose(1, 2), k), w.permute(2, 1, 0), groups=ch)
    return _add_bias(y.transpose(1, 2), p)


def conv2d_init(gen, in_ch, out_ch, kernel, groups=1, bias=True, device="cpu"):
    scale = 1.0 / math.sqrt(in_ch // groups * kernel * kernel)
    p = {"w": _uniform(gen, (kernel, kernel, in_ch // groups, out_ch), scale, device)}
    if bias:
        p["b"] = _uniform(gen, (out_ch,), scale, device)
    return p


def conv2d(p, x, stride=1, padding=((0, 0), (0, 0)), groups=1, dtype=None):
    """x: [B, H, W, C_in] -> [B, H', W', C_out]; ``padding`` is the explicit
    ((top, bottom), (left, right)) zero padding ("VALID" is all zeros)."""
    x, w = _cast(x, p["w"], dtype)
    (pt, pb), (pl, pr) = padding
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return _add_bias(y.permute(0, 2, 3, 1), p)


# -- embeddings / activations ----------------------------------------------

def embedding_init(gen, vocab, dim, scale=1.0, device="cpu"):
    return {"table": torch.randn((vocab, dim), generator=gen, device=device) * scale}


def swish(x):
    return x * torch.sigmoid(x)


def glu(x, dim=-1):
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)
