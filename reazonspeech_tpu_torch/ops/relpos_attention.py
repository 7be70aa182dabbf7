"""Relative-position multi-head attention: the four contracts of the JAX
kernels.

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
over key tiles, so no T cap, and any head size up to 256); on CPU tensors
they run their ``*_plain`` twins, the plain PyTorch formula with the JAX
kernel's dtype chain.

``relpos_attention`` and ``relpos_attention_blockwise`` are the ports of the
JAX kernels of the same names: qu = q+u and qv = q+v (summed and rounded by
the caller), k and v as [B, H, T, dh], the output [B, H, T, dh] in fp32.
They differ where the probabilities round, as the JAX kernels do: the
single-pass one normalises them in fp32 before the cast to v's dtype, the
streamed one casts the unnormalised probabilities of each key block and
divides by the row sum at the end. On CUDA tensors both launch the same
kernel (entries ``rs_relpos_attention``, two key sweeps, and
``rs_relpos_attention_blockwise``, one online sweep over 64-key tiles); on
CPU tensors their twins (the streamed one at the JAX kernel's 256-key
block; its ``block`` and ``round_lanes`` set the twin's geometry).
"""

import math

import torch
import torch.nn.functional as F

from ._kernels import check_cuda, launch, stream_of

__all__ = ["rel_shift", "relpos_attention", "relpos_attention_blockwise",
           "relpos_attention_blockwise_plain", "relpos_attention_fused",
           "relpos_attention_fused_packed", "relpos_attention_fused_packed_plain",
           "relpos_attention_fused_plain", "relpos_attention_plain"]

_MASK = -1.0e30  # score of a key past the valid length (the JAX kernel's constant)
_MAX_HEAD_DIM = 256  # the widest head the CUDA kernel takes (the JAX kernels take any)


def rel_shift(x):
    """Transformer-XL relative shift, [B, H, T, 2T-1] -> [B, H, T, T]:
    out[..., t, s] = x[..., t, T-1-t+s] (pad/reshape/slice, no gather)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)
    return x[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]


def relpos_attention_fused_plain(q, k, v, pos, bias_u, bias_v, lengths, heads):
    """Plain PyTorch twin of the kernel (same contract, same dtype chain as
    the JAX kernel: q+u and q+v rounded to q.dtype, fp32 scores and softmax,
    probabilities cast to v.dtype before ·v with fp32 accumulation): the
    single-pass twin on the heads, the output rounded to q.dtype."""
    b, t, d = q.shape
    h = heads
    dh = d // h

    def heads_first(x):
        return x.reshape(b, t, h, dh).transpose(1, 2)

    qu = heads_first(q) + bias_u.to(q.dtype)[:, None, :]
    qv = heads_first(q) + bias_v.to(q.dtype)[:, None, :]
    out = relpos_attention_plain(qu, qv, heads_first(k), heads_first(v), pos, lengths)
    return out.transpose(1, 2).to(q.dtype).reshape(b, t, d)


def relpos_attention_fused_packed_plain(qkv, pos, bias_u, bias_v, lengths, heads):
    """Plain PyTorch twin of the packed kernel (same contract as
    :func:`relpos_attention_fused_packed`)."""
    d = qkv.shape[-1] // 3
    return relpos_attention_fused_plain(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], pos,
                                        bias_u, bias_v, lengths, heads)


def _head_dim(d, h, name):
    dh = d // h if h > 0 else 0
    if dh * h != d or not 0 < dh <= _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d}/{h} is not an integer from 1 to "
                         f"{_MAX_HEAD_DIM}")
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

    Returns [B, T, D] in q.dtype. CUDA tensors must be bf16, contiguous and
    16-byte aligned, with dh at most 256; anything else raises.
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
    at or past ``lengths`` are masked. CUDA tensors must be bf16, contiguous
    and 16-byte aligned, with dh at most 256.
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


# --- [B, H, T, dh] contracts (the biases already added, fp32 out) -------------


def relpos_attention_plain(qu, qv, k, v, pos, lengths):
    """Plain twin of the single-pass contract: fp32 scores, e / Σe in fp32,
    probabilities cast to v.dtype before ·v with fp32 accumulation."""
    f32 = torch.float32
    t, dh = qu.shape[2], qu.shape[3]
    ac = torch.einsum("bhtd,bhsd->bhts", qu.to(f32), k.to(f32))
    bd = torch.einsum("bhtd,lhd->bhtl", qv.to(f32), pos.to(f32))
    scores = (ac + rel_shift(bd)) * (1.0 / math.sqrt(dh))
    col = torch.arange(t, device=qu.device)
    valid = col[None, None, None, :] < lengths.to(qu.device)[:, None, None, None]
    scores = torch.where(valid, scores, _MASK)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype).to(f32), v.to(f32))


def relpos_attention_blockwise_plain(qu, qv, k, v, pos, lengths, block=256, round_lanes=False):
    """Plain twin of the streamed contract, the JAX block loop as written:
    q/k/v zero-padded to a multiple of the block, the table re-indexed into
    the padded length, an online softmax over key blocks with fp32 running
    max/sum/accumulator, unnormalised probabilities cast to v.dtype, and the
    division by the sum at the end. All query blocks of one key block are
    done together (rows are independent). ``round_lanes`` rounds the block
    up to a multiple of 64, the JAX kernel's hardware geometry."""
    b, h, t, dh = qu.shape
    f32 = torch.float32
    blk = min(block, t)
    if round_lanes:
        blk = -(-blk // 64) * 64
    t_pad = -(-t // blk) * blk
    pad = (0, 0, 0, t_pad - t)
    qu, qv, k, v = (F.pad(x, pad) for x in (qu, qv, k, v))
    off = t_pad - t
    # table row l_pad = off + l, zero rows beyond [off, off + 2t - 1)
    pos_pad = F.pad(pos, (0, 0, 0, 0, off, 2 * t_pad - (2 * t - 1) - off)).to(f32)
    quf, qvf = qu.to(f32), qv.to(f32)
    lens = lengths.to(qu.device)[:, None, None, None]
    rows = torch.arange(t_pad, device=qu.device)[:, None]
    cols = torch.arange(blk, device=qu.device)[None, :]
    m = torch.full((b, h, t_pad, 1), -math.inf, dtype=f32, device=qu.device)
    l = torch.zeros((b, h, t_pad, 1), dtype=f32, device=qu.device)
    acc = torch.zeros((b, h, t_pad, dh), dtype=f32, device=qu.device)
    for j in range(t_pad // blk):
        kj, vj = k[:, :, j * blk:(j + 1) * blk], v[:, :, j * blk:(j + 1) * blk]
        ac = torch.einsum("bhtd,bhsd->bhts", quf, kj.to(f32))
        # query t, key s = j·blk + c reads padded table row t_pad - 1 - t + s
        idx = t_pad + j * blk + cols - rows - 1  # [t_pad, blk]
        bd = torch.einsum("bhtd,tchd->bhtc", qvf, pos_pad[idx])
        s = (ac + bd) * (1.0 / math.sqrt(dh))
        s = torch.where(j * blk + cols[None, None] < lens, s, _MASK)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).to(f32), vj.to(f32))
        m = m_new
    return (acc / l)[:, :, :t]


def _launch_bhtd(entry, qu, qv, k, v, pos, lengths):
    """Check the [B, H, T, dh] inputs the CUDA kernel takes and launch
    ``entry``; returns the fp32 [B, H, T, dh] output."""
    b, h, t, dh = qu.shape
    if dh > _MAX_HEAD_DIM:
        raise ValueError(f"{entry}: head dim {dh} past the kernel's {_MAX_HEAD_DIM}")
    bf16, dev = torch.bfloat16, qu.device
    check_cuda("qu", qu, bf16, (b, h, t, dh))
    for name, x in (("qv", qv), ("k", k), ("v", v)):
        check_cuda(name, x, bf16, (b, h, t, dh), dev)
    check_cuda("pos", pos, bf16, (2 * t - 1, h, dh), dev)
    check_cuda("lengths", lengths, torch.int32, (b,), dev)
    out = torch.empty((b, h, t, dh), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(entry, qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), b, t, h, dh, stream_of(qu))
    return out


def relpos_attention(qu, qv, k, v, pos, lengths):
    """Rel-pos attention, single-pass contract.

    Args:
      qu, qv: [B, H, T, dh] query + content bias, query + position bias
      k, v: [B, H, T, dh]
      pos: [2T-1, H, dh] projected relative-position table, offsets T-1 … -(T-1)
      lengths: [B] int32 valid key counts

    Returns [B, H, T, dh] fp32. CUDA tensors must be contiguous, 16-byte
    aligned bf16 (lengths int32) with dh at most 256; anything else raises.
    """
    if qu.device.type == "cpu":
        return relpos_attention_plain(qu, qv, k, v, pos, lengths)
    return _launch_bhtd("rs_relpos_attention", qu, qv, k, v, pos, lengths)


def relpos_attention_blockwise(qu, qv, k, v, pos, lengths):
    """:func:`relpos_attention` with KV streamed in blocks (any T): on the
    card 64-key tiles, on the CPU the twin's 256-key blocks."""
    if qu.device.type == "cpu":
        return relpos_attention_blockwise_plain(qu, qv, k, v, pos, lengths)
    return _launch_bhtd("rs_relpos_attention_blockwise", qu, qv, k, v, pos, lengths)
