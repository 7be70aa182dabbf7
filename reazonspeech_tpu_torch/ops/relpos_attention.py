"""Relative-position multi-head attention on projection-layout tensors.

``relpos_attention_fused`` is the port of
``reazonspeech_tpu.ops.relpos_attention.relpos_attention_fused``: per head,

    scores = ((q+u)·kᵀ + shift((q+v)·posᵀ)) / √dh,  keys ≥ length at -1e30,
    out    = softmax(scores) · v                       (fp32 softmax)

read from and written to [B, T, D] tensors with the u/v biases added to q
inside. ``relpos_attention_fused_packed`` (the port of
``relpos_attention_fused_packed``) reads q, k and v from one packed
[B, T, 3D] projection, the output of the q/k/v :func:`~.ln_dense.ln_dense`.
On CUDA tensors both launch the hand-written Hopper kernel in
``csrc/relpos_attention.cu`` (one kernel with a row stride, online softmax
over key tiles, so no T cap); on CPU tensors they run their ``*_plain``
twins, the plain PyTorch formula with the JAX kernel's dtype chain.
"""

import math

import torch
import torch.nn.functional as F

from ._kernels import check_cuda, launch, stream_of

__all__ = ["rel_shift", "relpos_attention_fused", "relpos_attention_fused_packed",
           "relpos_attention_fused_packed_plain", "relpos_attention_fused_plain"]

_MASK = -1.0e30  # score of a key past the valid length (the JAX kernel's constant)
_HEAD_DIMS = (16, 32, 64, 128)  # head sizes the CUDA kernel is instantiated for


def rel_shift(x):
    """Transformer-XL relative shift, [B, H, T, 2T-1] -> [B, H, T, T]:
    out[..., t, s] = x[..., t, T-1-t+s] (pad/reshape/slice, no gather)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)
    return x[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]


def relpos_attention_fused_plain(q, k, v, pos, bias_u, bias_v, lengths, heads):
    """Plain PyTorch twin of the kernel (same contract, same dtype chain as
    the JAX kernel: q+u and q+v rounded to q.dtype, fp32 scores and softmax,
    probabilities cast to v.dtype before ·v with fp32 accumulation)."""
    b, t, d = q.shape
    h = heads
    dh = d // h
    f32 = torch.float32
    qh = q.reshape(b, t, h, dh)
    qu = (qh + bias_u.to(q.dtype)).to(f32)
    qv = (qh + bias_v.to(q.dtype)).to(f32)
    ac = torch.einsum("bthd,bshd->bhts", qu, k.reshape(b, t, h, dh).to(f32))
    bd = rel_shift(torch.einsum("bthd,lhd->bhtl", qv, pos.to(f32)))
    scores = (ac + bd) * (1.0 / math.sqrt(dh))
    col = torch.arange(t, device=q.device)
    valid = col[None, None, None, :] < lengths.to(q.device)[:, None, None, None]
    probs = torch.softmax(torch.where(valid, scores, _MASK), dim=-1)
    out = torch.einsum(
        "bhts,bshd->bthd", probs.to(v.dtype).to(f32), v.reshape(b, t, h, dh).to(f32))
    return out.to(q.dtype).reshape(b, t, d)


def relpos_attention_fused_packed_plain(qkv, pos, bias_u, bias_v, lengths, heads):
    """Plain PyTorch twin of the packed kernel (same contract as
    :func:`relpos_attention_fused_packed`)."""
    d = qkv.shape[-1] // 3
    return relpos_attention_fused_plain(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], pos,
                                        bias_u, bias_v, lengths, heads)


def _head_dim(d, h, name):
    dh = d // h
    if dh * h != d or dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}/{h} not in {_HEAD_DIMS}")
    return dh


def _check_table(pos, bias_u, bias_v, lengths, b, t, h, dh, dev):
    """Check pos and lengths; return the biases as contiguous bf16."""
    bf16 = torch.bfloat16
    check_cuda("pos", pos, bf16, (2 * t - 1, h, dh), dev)
    check_cuda("lengths", lengths, torch.int32, (b,), dev)
    bu = bias_u.to(bf16).contiguous()
    bv = bias_v.to(bf16).contiguous()
    check_cuda("bias_u", bu, bf16, (h, dh), dev)
    check_cuda("bias_v", bv, bf16, (h, dh), dev)
    return bu, bv


def relpos_attention_fused(q, k, v, pos, bias_u, bias_v, lengths, heads):
    """Rel-pos attention.

    Args:
      q, k, v: [B, T, D] (D = heads·dh), straight from the q/k/v denses
      pos: [2T-1, H, dh] projected relative-position table, offsets T-1 … -(T-1)
      bias_u, bias_v: [H, dh] content/position biases (cast to q.dtype)
      lengths: [B] int32 valid key counts

    Returns [B, T, D] in q.dtype. CUDA tensors must be bf16 and contiguous,
    with dh in (16, 32, 64, 128); anything else raises.
    """
    if q.device.type == "cpu":
        return relpos_attention_fused_plain(q, k, v, pos, bias_u, bias_v, lengths, heads)
    b, t, d = q.shape
    h = heads
    dh = _head_dim(d, h, "relpos_attention_fused")
    bf16, dev = torch.bfloat16, q.device
    check_cuda("q", q, bf16, (b, t, d))
    for name, x in (("k", k), ("v", v)):
        check_cuda(name, x, bf16, (b, t, d), dev)
    bu, bv = _check_table(pos, bias_u, bias_v, lengths, b, t, h, dh, dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        launch("rs_relpos_attention_fused", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               pos.data_ptr(), bu.data_ptr(), bv.data_ptr(), lengths.data_ptr(),
               out.data_ptr(), b, t, h, dh, stream_of(q))
    return out


def relpos_attention_fused_packed(qkv, pos, bias_u, bias_v, lengths, heads):
    """Rel-pos attention reading q, k and v from one packed projection.

    Args:
      qkv: [B, T, 3D] with q, k, v at columns [0, D), [D, 2D), [2D, 3D)
      pos, bias_u, bias_v, lengths: as in :func:`relpos_attention_fused`

    Returns [B, T, D] in qkv.dtype. Every query row is computed; only keys
    at or past ``lengths`` are masked. CUDA tensors must be bf16 and
    contiguous, with dh in (16, 32, 64, 128).
    """
    if qkv.device.type == "cpu":
        return relpos_attention_fused_packed_plain(qkv, pos, bias_u, bias_v, lengths, heads)
    b, t, d3 = qkv.shape
    h = heads
    if d3 % 3:
        raise ValueError(f"relpos_attention_fused_packed: last dim {d3} is not 3·D")
    d = d3 // 3
    dh = _head_dim(d, h, "relpos_attention_fused_packed")
    dev = qkv.device
    check_cuda("qkv", qkv, torch.bfloat16, (b, t, d3))
    bu, bv = _check_table(pos, bias_u, bias_v, lengths, b, t, h, dh, dev)
    out = torch.empty((b, t, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        launch("rs_relpos_attention_fused_packed", qkv.data_ptr(), pos.data_ptr(),
               bu.data_ptr(), bv.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, t, h, dh,
               stream_of(qkv))
    return out
