"""LayerNorm fused into the following dense projection, and the Conformer
block's residual tail.

Ports of ``reazonspeech_tpu.ops.ln_dense``:

- :func:`ln_dense`: ``act(LN(x)·W + c)``, where W is one [D, N] matrix or up
  to three [D, Ni] segments whose products are written side by side (the
  packed q/k/v projection);
- :func:`ln_dense_add`: the same on ``x = r + scale·delta``, which is also
  returned as the new residual stream;
- :func:`add_ln`: ``mask(LN(r + scale·y))``, rows at or past an
  utterance's length exactly zero.

The dtype chain is the JAX kernels': fp32 LayerNorm statistics (mean,
centred variance, eps) and affine, the normalized rows rounded to the
weights' dtype, products accumulated in fp32, then the fp32 bias and
optional swish and one rounding at the end. On CUDA tensors the ops launch
the hand-written kernels in ``csrc/ln_dense.cu`` (the projection on
``csrc/gemm_sm90.cuh``'s TMA + wgmma GEMM); on CPU tensors they run their
``*_plain`` twins.

The ``*_diff`` functions are the ports of the JAX package's custom-VJP
wrappers (``ln_dense_diff``, ``ln_dense_add_diff``, ``add_ln_diff``): the
kernel forward, the backward by autograd through the twin recomputed at
the same dtypes (the JAX ``_bwd`` differentiates the XLA formula, which
the twin is). Training calls them; on a CUDA tensor that requires grad the
plain entries raise, since a ctypes launch records no ``grad_fn``.
"""

import torch

from ._kernels import check_cuda, launch, refuse_grad, stream_of
from ._vjp import kernel_forward

__all__ = ["add_ln", "add_ln_diff", "add_ln_plain", "layer_norm_fp32", "ln_dense",
           "ln_dense_add", "ln_dense_add_diff", "ln_dense_add_plain", "ln_dense_diff",
           "ln_dense_plain"]

_MAX_SEGMENTS = 3
_ALIGN = 8  # D and every segment width: the CUDA GEMM's TMA reads rows of whole 16-byte units


def _segments(w, c):
    ws = tuple(w) if isinstance(w, (tuple, list)) else (w,)
    cs = tuple(c) if isinstance(c, (tuple, list)) else (c,) * len(ws)
    if not 1 <= len(ws) <= _MAX_SEGMENTS or len(cs) != len(ws):
        raise ValueError(f"ln_dense: 1 to {_MAX_SEGMENTS} weight segments, each with a bias")
    return ws, cs


def _check_activation(activation):
    if activation not in (None, "swish"):
        raise ValueError(f"ln_dense: activation {activation!r} is not None or 'swish'")


def layer_norm_fp32(x, ln_scale, ln_bias, eps=1e-5):
    """LayerNorm over the last axis in fp32 (the kernels' statistics and
    affine); returns fp32."""
    f32 = torch.float32
    x32 = x.to(f32)
    mean = x32.mean(dim=-1, keepdim=True)
    cent = x32 - mean
    var = cent.square().mean(dim=-1, keepdim=True)
    return cent * torch.rsqrt(var + eps) * ln_scale.to(f32) + ln_bias.to(f32)


def ln_dense_plain(x, ln_scale, ln_bias, w, c=None, activation=None, eps=1e-5):
    """Plain PyTorch twin of the kernel (same contract as :func:`ln_dense`)."""
    ws, cs = _segments(w, c)
    _check_activation(activation)
    f32 = torch.float32
    xn = layer_norm_fp32(x, ln_scale, ln_bias, eps).to(ws[0].dtype).to(f32)
    outs = []
    for wi, ci in zip(ws, cs):
        y = xn @ wi.to(f32)
        if ci is not None:
            y = y + ci.to(f32)
        if activation == "swish":
            y = y * torch.sigmoid(y)
        outs.append(y)
    return torch.cat(outs, dim=-1).to(ws[0].dtype)


def ln_dense_add_plain(r, delta, ln_scale, ln_bias, w, c=None, scale=1.0, activation=None,
                       eps=1e-5):
    """Plain PyTorch twin of the kernel (same contract as :func:`ln_dense_add`)."""
    x = r.to(torch.float32) + scale * delta.to(torch.float32)
    return ln_dense_plain(x, ln_scale, ln_bias, w, c, activation, eps), x.to(r.dtype)


def add_ln_plain(r, y, lengths, ln_scale, ln_bias, scale=1.0, eps=1e-5, out_dtype=None):
    """Plain PyTorch twin of the kernel (same contract as :func:`add_ln`)."""
    x = r.to(torch.float32) + scale * y.to(torch.float32)
    xn = layer_norm_fp32(x, ln_scale, ln_bias, eps)
    valid = torch.arange(r.shape[1], device=r.device)[None, :] < lengths.to(r.device)[:, None]
    return torch.where(valid[..., None], xn, 0.0).to(out_dtype or r.dtype)


def ln_dense(x, ln_scale, ln_bias, w, c=None, *, activation=None, eps=1e-5):
    """``dense(layer_norm(x))`` with an optional fused swish.

    Args:
      x: [B, T, D] residual stream (fp32 on CUDA)
      ln_scale, ln_bias: [D] LayerNorm affine
      w: [D, N] weights in the compute dtype, or a tuple of up to three
        [D, Ni] segments (bf16 with D and Ni multiples of 8 on CUDA)
      c: [N] bias, a matching tuple, or None
      activation: None or "swish"

    Returns [B, T, ΣNi] in w's dtype.
    """
    if x.device.type == "cpu":
        return ln_dense_plain(x, ln_scale, ln_bias, w, c, activation, eps)
    return _ln_dense_cuda(x, None, 1.0, ln_scale, ln_bias, w, c, activation, eps)[0]


def ln_dense_add(r, delta, ln_scale, ln_bias, w, c=None, *, scale=1.0, activation=None,
                 eps=1e-5):
    """:func:`ln_dense` of ``x = r + scale·delta`` (summed in fp32).

    Returns (out [B, T, ΣNi] in w's dtype, x [B, T, D] in r's dtype). On
    CUDA, r is fp32 and delta bf16.
    """
    if r.device.type == "cpu":
        return ln_dense_add_plain(r, delta, ln_scale, ln_bias, w, c, scale, activation, eps)
    return _ln_dense_cuda(r, delta, scale, ln_scale, ln_bias, w, c, activation, eps)


def add_ln(r, y, lengths, ln_scale, ln_bias, *, scale=1.0, eps=1e-5, out_dtype=None):
    """Fused residual tail of a Conformer block: ``mask(LN(r + scale·y))``.

    Args:
      r: [B, T, D] residual stream (fp32 on CUDA)
      y: [B, T, D] branch output (bf16 on CUDA)
      lengths: [B] int32 valid frame counts; rows at or past them are zero
      out_dtype: output dtype (default r's; fp32 on CUDA)

    Returns [B, T, D].
    """
    if r.device.type == "cpu":
        return add_ln_plain(r, y, lengths, ln_scale, ln_bias, scale, eps, out_dtype)
    refuse_grad("add_ln", r, y, ln_scale, ln_bias, hint="call add_ln_diff")
    f32, dev = torch.float32, r.device
    b, t, d = r.shape
    if (out_dtype or r.dtype) != f32:
        raise TypeError(f"add_ln: output dtype {out_dtype}, the CUDA kernel writes fp32")
    check_cuda("r", r, f32, (b, t, d))
    check_cuda("y", y, torch.bfloat16, (b, t, d), dev)
    check_cuda("lengths", lengths, torch.int32, (b,), dev)
    g, bb = _affine(ln_scale, ln_bias, d, dev)
    out = torch.empty_like(r)
    with torch.cuda.device(dev):
        launch("rs_add_ln", r.data_ptr(), y.data_ptr(), g.data_ptr(), bb.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), b, t, d, float(scale), float(eps),
               stream_of(r))
    return out


def _affine(ln_scale, ln_bias, d, dev):
    g, bb = (v.to(torch.float32).contiguous() for v in (ln_scale, ln_bias))
    check_cuda("ln_scale", g, torch.float32, (d,), dev)
    check_cuda("ln_bias", bb, torch.float32, (d,), dev)
    return g, bb


def _ln_dense_cuda(x, delta, scale, ln_scale, ln_bias, w, c, activation, eps):
    """The kernel path."""
    ws, cs = _segments(w, c)
    kernel = "ln_dense" if delta is None else "ln_dense_add"
    refuse_grad(kernel, x, delta, ln_scale, ln_bias, *ws, *cs, hint=f"call {kernel}_diff")
    _check_activation(activation)
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    b, t, d = x.shape
    if d % _ALIGN:
        raise ValueError(f"ln_dense: D={d} must be a multiple of {_ALIGN}")
    check_cuda("x", x, f32, (b, t, d))
    if delta is not None:
        check_cuda("delta", delta, bf16, (b, t, d), dev)
    g, bb = _affine(ln_scale, ln_bias, d, dev)
    ns, biases = [], []
    for i, (wi, ci) in enumerate(zip(ws, cs)):
        check_cuda(f"w[{i}]", wi, bf16, device=dev)
        if wi.dim() != 2 or wi.shape[0] != d or wi.shape[1] % _ALIGN or not wi.shape[1]:
            raise ValueError(f"ln_dense: w[{i}] shape {tuple(wi.shape)}, expected "
                             f"[{d}, a positive multiple of {_ALIGN}]")
        n = wi.shape[1]
        ci = torch.zeros(n, dtype=f32, device=dev) if ci is None else ci.to(f32).contiguous()
        check_cuda(f"c[{i}]", ci, f32, (n,), dev)
        ns.append(n)
        biases.append(ci)
    pad = _MAX_SEGMENTS - len(ws)
    w_ptrs = [wi.data_ptr() for wi in ws] + [None] * pad
    c_ptrs = [ci.data_ptr() for ci in biases] + [None] * pad
    widths = ns + [0] * pad
    xn = torch.empty((b, t, d), dtype=bf16, device=dev)  # scratch: bf16(LN(x))
    out = torch.empty((b, t, sum(ns)), dtype=bf16, device=dev)
    swish = int(activation == "swish")
    with torch.cuda.device(dev):
        if delta is None:
            launch("rs_ln_dense", x.data_ptr(), g.data_ptr(), bb.data_ptr(), *w_ptrs, *c_ptrs,
                   *widths, xn.data_ptr(), out.data_ptr(), b * t, d, swish, float(eps),
                   stream_of(x))
            return out, None
        summed = torch.empty_like(x)
        launch("rs_ln_dense_add", x.data_ptr(), delta.data_ptr(), g.data_ptr(), bb.data_ptr(),
               *w_ptrs, *c_ptrs, *widths, xn.data_ptr(), summed.data_ptr(), out.data_ptr(),
               b * t, d, swish, float(scale), float(eps), stream_of(x))
    return out, summed


# --- differentiable wrappers: the kernel forward, the twin's backward ----------


def ln_dense_diff(x, ln_scale, ln_bias, w, c=None, *, activation=None, eps=1e-5):
    """Differentiable :func:`ln_dense` (JAX ``ln_dense_diff``): gradients
    for x, the LayerNorm affine, every weight segment and bias."""
    ws, cs = _segments(w, c)
    n = len(ws)

    def kernel(x, g, b, *wc):
        return ln_dense(x, g, b, wc[:n], wc[n:], activation=activation, eps=eps)

    def twin(x, g, b, *wc):
        return ln_dense_plain(x, g, b, wc[:n], wc[n:], activation, eps)

    return kernel_forward(kernel, twin, x, ln_scale, ln_bias, *ws, *cs)


def ln_dense_add_diff(r, delta, ln_scale, ln_bias, w, c=None, *, scale=1.0, activation=None,
                      eps=1e-5):
    """Differentiable :func:`ln_dense_add` (JAX ``ln_dense_add_diff``):
    both outputs, the projection and the summed stream, carry gradients."""
    ws, cs = _segments(w, c)
    n = len(ws)

    def kernel(r, dl, g, b, *wc):
        return ln_dense_add(r, dl, g, b, wc[:n], wc[n:], scale=scale, activation=activation,
                            eps=eps)

    def twin(r, dl, g, b, *wc):
        return ln_dense_add_plain(r, dl, g, b, wc[:n], wc[n:], scale, activation, eps)

    return kernel_forward(kernel, twin, r, delta, ln_scale, ln_bias, *ws, *cs)


def add_ln_diff(r, y, lengths, ln_scale, ln_bias, *, scale=1.0, eps=1e-5, out_dtype=None):
    """Differentiable :func:`add_ln` (JAX ``add_ln_diff``); ``lengths``
    takes no gradient."""

    def kernel(r, y, lens, g, b):
        return add_ln(r, y, lens, g, b, scale=scale, eps=eps, out_dtype=out_dtype)

    def twin(r, y, lens, g, b):
        return add_ln_plain(r, y, lens, g, b, scale, eps, out_dtype)

    return kernel_forward(kernel, twin, r, y, lengths, ln_scale, ln_bias)
