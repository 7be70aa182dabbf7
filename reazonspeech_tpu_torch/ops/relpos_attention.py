"""Relative-position multi-head attention on projection-layout tensors.

``relpos_attention_fused`` is the port of
``reazonspeech_tpu.ops.relpos_attention.relpos_attention_fused``: per head,

    scores = ((q+u)·kᵀ + shift((q+v)·posᵀ)) / √dh,  keys ≥ length at -1e30,
    out    = softmax(scores) · v                       (fp32 softmax)

read from and written to [B, T, D] tensors with the u/v biases added to q
inside. On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/relpos_attention.cu`` (online softmax over key tiles, so no T cap);
on a CPU tensor it runs :func:`relpos_attention_fused_plain`, the plain
PyTorch formula with the JAX kernel's dtype chain.
"""

import math

import torch
import torch.nn.functional as F

from ._kernels import check_cuda, launch, stream_of

__all__ = ["relpos_attention_fused", "relpos_attention_fused_plain", "rel_shift"]

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
    dh = d // h
    if dh * h != d or dh not in _HEAD_DIMS:
        raise ValueError(f"relpos_attention_fused: head dim {d}/{h} not in {_HEAD_DIMS}")
    bf16, dev = torch.bfloat16, q.device
    check_cuda("q", q, bf16, (b, t, d))
    for name, x in (("k", k), ("v", v)):
        check_cuda(name, x, bf16, (b, t, d), dev)
    check_cuda("pos", pos, bf16, (2 * t - 1, h, dh), dev)
    check_cuda("lengths", lengths, torch.int32, (b,), dev)
    bu = bias_u.to(bf16).contiguous()
    bv = bias_v.to(bf16).contiguous()
    check_cuda("bias_u", bu, bf16, (h, dh), dev)
    check_cuda("bias_v", bv, bf16, (h, dh), dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        launch("rs_relpos_attention_fused", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               pos.data_ptr(), bu.data_ptr(), bv.data_ptr(), lengths.data_ptr(),
               out.data_ptr(), b, t, h, dh, stream_of(q))
    relpos_attention_fused.launches += 1
    return out


relpos_attention_fused.launches = 0
