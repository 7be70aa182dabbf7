"""Fused Conformer convolution module (folded batch norm or per-frame
LayerNorm).

``fused_conv_module`` is the port of
``reazonspeech_tpu.ops.conformer_conv.fused_conv_module``:

    [LayerNorm →] pointwise D→2D (+b) → GLU → zero rows ≥ length →
    depthwise K-tap SAME (+b) → norm → swish → pointwise D→D (+b)

with ``norm="folded"`` (nemo: batch norm folded into a scale and bias) or
``norm="layer"`` (espnet: a LayerNorm over D per frame, fp32 statistics,
eps 1e-5, then the given scale and bias).

The pre-module LayerNorm is done by the caller (x is the normalized input
in the compute dtype), or, with ``ln_scale``/``ln_bias``, inside the kernel
(x is the raw fp32 residual stream, normalized in fp32 and rounded to
``compute_dtype``). On a CUDA tensor it launches the hand-written Hopper
kernels in ``csrc/conformer_conv.cu`` through two scratch tensors: the GLU
product and the output product on the TMA + wgmma GEMM of
``csrc/gemm_sm90.cuh`` with the depthwise, norm and swish pass between them,
and one more launch for the in-kernel LayerNorm. Its four C entries count
apart:
``fused_conv_module`` and ``fused_conv_module_ln`` (folded norm, caller-side
and in-kernel LayerNorm), ``fused_conv_module_layer`` and
``fused_conv_module_ln_layer`` (the per-frame LayerNorm). On a CPU tensor it runs
:func:`fused_conv_module_plain`, the plain formula with the JAX kernel's
dtype chain (bf16 matmul inputs with fp32 accumulation, fp32 GLU,
depthwise, norm and swish, output in the compute dtype).
"""

import torch
import torch.nn.functional as F

from ._kernels import check_cuda, launch, stream_of
from .ln_dense import layer_norm_fp32

__all__ = ["fold_batch_norm", "fused_conv_module", "fused_conv_module_plain"]


def fold_batch_norm(p, eps=1e-5):
    """{scale, bias, mean, var} -> fp32 (scale', bias') with
    x·scale' + bias' == (x - mean)/sqrt(var + eps)·scale + bias."""
    inv = p["scale"] / torch.sqrt(p["var"] + eps)
    return inv.to(torch.float32), (p["bias"] - p["mean"] * inv).to(torch.float32)


def fused_conv_module_plain(x, lengths, w_in, b_in, dw, b_dw, bn_scale, bn_bias,
                            w_out, b_out, *, norm="folded", ln_scale=None, ln_bias=None,
                            compute_dtype=None):
    """Plain PyTorch twin of the kernel (same contract as
    :func:`fused_conv_module`)."""
    b, t, d = x.shape
    dt, f32 = compute_dtype or x.dtype, torch.float32
    if ln_scale is not None:
        x = layer_norm_fp32(x, ln_scale, ln_bias).to(dt)
    k = dw.shape[0]
    h2 = x.to(f32) @ w_in.to(dt).to(f32) + b_in.to(f32)
    h = h2[..., :d] * torch.sigmoid(h2[..., d:])
    valid = torch.arange(t, device=x.device)[None, :] < lengths.to(x.device)[:, None]
    h = torch.where(valid[..., None], h, 0.0)
    half = k // 2
    hp = F.pad(h, (0, 0, half, k - 1 - half))  # SAME zero padding of time
    taps = dw.reshape(k, d).to(f32)
    acc = torch.zeros_like(h)
    for j in range(k):
        acc = acc + hp[:, j : j + t] * taps[j]
    acc = acc + b_dw.to(f32)
    if norm == "layer":
        mean = acc.mean(dim=-1, keepdim=True)
        var = (acc - mean).square().mean(dim=-1, keepdim=True)
        acc = (acc - mean) * torch.rsqrt(var + 1e-5)
    y = acc * bn_scale.to(f32) + bn_bias.to(f32)
    y = y * torch.sigmoid(y)
    out = y.to(dt).to(f32) @ w_out.to(dt).to(f32) + b_out.to(f32)
    return out.to(dt)


def fused_conv_module(x, lengths, w_in, b_in, dw, b_dw, bn_scale, bn_bias,
                      w_out, b_out, *, norm="folded", ln_scale=None, ln_bias=None,
                      compute_dtype=None):
    """Fused Conformer conv module.

    Args:
      x: [B, T, D] layer-normed input in the compute dtype, or the raw
        residual stream when ``ln_scale``/``ln_bias`` are given
      lengths: [B] int32 valid frame counts
      w_in: [D, 2D], b_in: [2D]   pointwise expansion (GLU halves it)
      dw: [K, D] or [K, 1, D], b_dw: [D]   depthwise taps
      bn_scale, bn_bias: [D] folded batch norm (:func:`fold_batch_norm`), or
        the per-frame LayerNorm's scale and bias with ``norm="layer"``
      norm: "folded" or "layer"
      w_out: [D, D], b_out: [D]
      ln_scale, ln_bias: [D] pre-module LayerNorm affine (fp32 statistics,
        eps 1e-5), or None
      compute_dtype: the matmul dtype (default x.dtype)

    Returns [B, T, D] in the compute dtype. On CUDA the compute dtype is
    bf16, x is bf16 (fp32 with the in-kernel LayerNorm) and D a multiple of
    8 (TMA's 16-byte rows); with ``norm="layer"`` one frame's D fp32 sums
    must fit in a block's shared memory (D <= 58,112 on the H100: the
    kernel refuses a wider D before it launches anything, and this raises);
    weights are cast to the kernel's dtypes here, as the JAX wrapper casts
    them.
    """
    if norm not in ("folded", "layer"):
        raise ValueError(f"fused_conv_module: unknown norm {norm!r}")
    if x.device.type == "cpu":
        return fused_conv_module_plain(x, lengths, w_in, b_in, dw, b_dw, bn_scale, bn_bias,
                                       w_out, b_out, norm=norm, ln_scale=ln_scale,
                                       ln_bias=ln_bias, compute_dtype=compute_dtype)
    b, t, d = x.shape
    k = dw.shape[0]
    layer = norm == "layer"
    if d % 8:
        raise ValueError(f"fused_conv_module: D={d} must be a multiple of 8")
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    in_ln = ln_scale is not None
    if (compute_dtype or x.dtype) != bf16:
        raise TypeError(f"fused_conv_module: compute dtype {compute_dtype or x.dtype}, "
                        "the CUDA kernel multiplies in bf16")
    check_cuda("x", x, f32 if in_ln else bf16, (b, t, d))
    check_cuda("lengths", lengths, torch.int32, (b,), dev)
    w_in = w_in.to(bf16).contiguous()
    w_out = w_out.to(bf16).contiguous()
    taps = dw.reshape(k, d).to(f32).contiguous()
    vecs = [v.to(f32).contiguous() for v in (b_in, b_dw, bn_scale, bn_bias, b_out)]
    check_cuda("w_in", w_in, bf16, (d, 2 * d), dev)
    check_cuda("w_out", w_out, bf16, (d, d), dev)
    check_cuda("dw", taps, f32, (k, d), dev)
    for name, v, n in zip(("b_in", "b_dw", "bn_scale", "bn_bias", "b_out"), vecs,
                          (2 * d, d, d, d, d)):
        check_cuda(name, v, f32, (n,), dev)
    b_in, b_dw, bn_scale, bn_bias, b_out = vecs
    glu = torch.empty((b, t, d), dtype=f32, device=dev)  # scratch: masked GLU output
    y = torch.empty((b, t, d), dtype=bf16, device=dev)  # scratch: depthwise + norm + swish
    out = torch.empty((b, t, d), dtype=bf16, device=dev)
    weights = (w_in.data_ptr(), b_in.data_ptr(), taps.data_ptr(), b_dw.data_ptr(),
               bn_scale.data_ptr(), bn_bias.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
               lengths.data_ptr())
    suffix = "_layer" if layer else ""
    with torch.cuda.device(dev):
        if in_ln:
            g, bb = (v.to(f32).contiguous() for v in (ln_scale, ln_bias))
            check_cuda("ln_scale", g, f32, (d,), dev)
            check_cuda("ln_bias", bb, f32, (d,), dev)
            xn = torch.empty((b, t, d), dtype=bf16, device=dev)  # scratch: bf16(LN(x))
            launch("rs_fused_conv_module_ln" + suffix, x.data_ptr(), g.data_ptr(),
                   bb.data_ptr(), *weights, xn.data_ptr(), glu.data_ptr(), y.data_ptr(),
                   out.data_ptr(), b, t, d, k, stream_of(x))
        else:
            launch("rs_fused_conv_module" + suffix, x.data_ptr(), *weights, glu.data_ptr(),
                   y.data_ptr(), out.data_ptr(), b, t, d, k, stream_of(x))
    return out

