"""Zipformer shared-weights attention, one application per call.

Ports of ``reazonspeech_tpu.ops.zipformer_attention``: per row g of
G = B·H (or B for the single-head nonlin attention), with table
``pos[g % heads]``,

    out = softmax_s( (q·kᵀ + qp·pos[T-1-t+s]) / √qd, keys s ≥ len[g] at -1e30 ) · v

q, k [G, T, qd], qp [G, T, pd], pos [heads, 2T-1, pd] and v [G, T, dv] in
bf16 on the card; lengths [G] int32; the output is [G, T, dv] fp32. Rows at
or past a length are garbage (finite), and the caller masks them.

- :func:`shared_rel_attention` (the single-pass entry): probabilities
  normalised in fp32, then cast to v's dtype for ·v.
- :func:`shared_rel_attention_blockwise` (the streamed entry): an online
  softmax over key blocks; the unnormalised probabilities are cast to v's
  dtype, and the division by the row sum comes at the end.

On CUDA tensors both launch the hand-written Hopper kernel in
``csrc/zipformer_attention.cu`` (scores, probabilities and the output
accumulator in registers, on mma.sync tensor-core tiles): one kernel source,
two C entries with their own launch counts. The single-pass entry sweeps the
keys twice (row max and sum, then normalised probabilities times v), so it
rounds where the JAX kernel rounds without holding a [T, T] row block; the
streamed entry sweeps once with the online softmax over 64-key tiles. On CPU
tensors they run
their ``*_plain`` twins (the streamed one at the JAX kernel's default block,
256; its ``block`` and ``round_lanes`` set the twin's geometry).
"""

import math

import torch
import torch.nn.functional as F

from ._kernels import check_cuda, launch, stream_of
from .relpos_attention import rel_shift

__all__ = ["shared_rel_attention", "shared_rel_attention_blockwise",
           "shared_rel_attention_blockwise_plain", "shared_rel_attention_plain"]

_MASK = -1.0e30  # score of a key past the valid length (the JAX kernels' constant)
_MAX_QD = 128  # the widest query/key the CUDA kernel takes (the JAX kernels take any)
_MAX_PD = 32  # the widest position query it takes


def _row_tables(pos, g, heads):
    """[G, 2T-1, pd]: row g's table pos[g % heads]."""
    return pos[torch.arange(g, device=pos.device) % heads]


def shared_rel_attention_plain(q, k, qp, pos, v, lengths, heads=1):
    """Plain twin of the single-pass entry: the materialized [G, T, T]
    softmax with the JAX kernel's dtype chain (fp32 scores, e / Σe in fp32,
    probabilities cast to v.dtype before ·v with fp32 accumulation)."""
    g, t, qd = q.shape
    f32 = torch.float32
    ac = torch.einsum("gtd,gsd->gts", q.to(f32), k.to(f32))
    bd_all = torch.einsum("gtd,gld->gtl", qp.to(f32), _row_tables(pos, g, heads).to(f32))
    scores = (ac + rel_shift(bd_all[:, None])[:, 0]) * (1.0 / math.sqrt(qd))
    col = torch.arange(t, device=q.device)
    scores = torch.where(col[None, None, :] < lengths.to(q.device)[:, None, None], scores, _MASK)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("gts,gsd->gtd", probs.to(v.dtype).to(f32), v.to(f32))


def shared_rel_attention_blockwise_plain(q, k, qp, pos, v, lengths, heads=1, block=256,
                                         round_lanes=False):
    """Plain twin of the streamed entry, the JAX block loop as written: k/v
    (and q/qp) zero-padded to a multiple of the block, the pos table padded
    so that block pair (i, j) reads its 2·blk-row window, an online softmax
    over key blocks with fp32 running max/sum/accumulator, unnormalised
    probabilities cast to v.dtype, and the division by the sum at the end.
    All query blocks of one key block are done together (rows are
    independent). ``round_lanes`` rounds the block up to a multiple of 64,
    the JAX kernel's hardware geometry."""
    g, t, qd = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    blk = min(block, t)
    if round_lanes:
        blk = -(-blk // 64) * 64
    t_pad = -(-t // blk) * blk
    pad = (0, 0, 0, t_pad - t)
    q, qp, k, v = (F.pad(x, pad) for x in (q, qp, k, v))
    off = t_pad - t
    pos_pad = F.pad(pos, (0, 0, off, 2 * t_pad - (2 * t - 1) - off))  # [heads, 2·t_pad, pd]
    tables = _row_tables(pos_pad, g, heads).to(f32)
    qf, qpf = q.to(f32), qp.to(f32)
    lens = lengths.to(q.device)[:, None, None]
    rows = torch.arange(t_pad, device=q.device)[:, None]
    cols = torch.arange(blk, device=q.device)[None, :]
    m = torch.full((g, t_pad, 1), -math.inf, dtype=f32, device=q.device)
    l = torch.zeros((g, t_pad, 1), dtype=f32, device=q.device)
    acc = torch.zeros((g, t_pad, dv), dtype=f32, device=q.device)
    for j in range(t_pad // blk):
        kj, vj = k[:, j * blk:(j + 1) * blk], v[:, j * blk:(j + 1) * blk]
        ac = torch.einsum("gtd,gsd->gts", qf, kj.to(f32))
        # row t of query block i reads window row c + blk-1-r of its block
        # pair's window, i.e. table row t_pad + s - t - 1 (s = j·blk + c)
        idx = t_pad + j * blk + cols - rows - 1
        bd = torch.einsum("gtp,gtcp->gtc", qpf, tables[:, idx])
        s = (ac + bd) * (1.0 / math.sqrt(qd))
        s = torch.where(j * blk + cols[None] < lens, s, _MASK)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("gts,gsd->gtd", p.to(v.dtype).to(f32), vj.to(f32))
        m = m_new
    return (acc / l)[:, :t]


def _launch(entry, q, k, qp, pos, v, lengths, heads):
    """Check the inputs the CUDA kernel takes and launch ``entry``."""
    g, t, qd = q.shape
    pd, dv = qp.shape[-1], v.shape[-1]
    if not 0 < qd <= _MAX_QD or not 0 < pd <= _MAX_PD or heads <= 0:
        raise ValueError(f"{entry}: qd={qd} (up to {_MAX_QD}), pd={pd} (up to {_MAX_PD}), "
                         f"heads={heads} not taken")
    bf16, dev = torch.bfloat16, q.device
    check_cuda("q", q, bf16, (g, t, qd))
    check_cuda("k", k, bf16, (g, t, qd), dev)
    check_cuda("qp", qp, bf16, (g, t, pd), dev)
    check_cuda("pos", pos, bf16, (heads, 2 * t - 1, pd), dev)
    check_cuda("v", v, bf16, (g, t, dv), dev)
    check_cuda("lengths", lengths, torch.int32, (g,), dev)
    out = torch.empty((g, t, dv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(entry, q.data_ptr(), k.data_ptr(), qp.data_ptr(), pos.data_ptr(), v.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), g, t, qd, pd, dv, heads,
               1.0 / math.sqrt(qd), stream_of(q))
    return out


def shared_rel_attention(q, k, qp, pos, v, lengths, heads=1):
    """One application of the shared attention weights (single-pass entry).

    Args:
      q, k: [G, T, qd] content query/key; qp: [G, T, pd] position query
      pos: [heads, 2T-1, pd] projected compact rel-pos table, offsets
        T-1 … -(T-1); row g reads table g % heads
      v: [G, T, dv]; lengths: [G] int32 valid key counts

    Returns [G, T, dv] fp32. CUDA tensors must be contiguous, 16-byte
    aligned bf16 (lengths int32) with qd up to 128 and pd up to 32; anything
    else raises.
    """
    if q.device.type == "cpu":
        return shared_rel_attention_plain(q, k, qp, pos, v, lengths, heads)
    return _launch("rs_shared_rel_attention", q, k, qp, pos, v, lengths, heads)


def shared_rel_attention_blockwise(q, k, qp, pos, v, lengths, heads=1):
    """:func:`shared_rel_attention` with KV streamed in blocks (any T): on
    the card 64-key tiles, on the CPU the twin's 256-key blocks."""
    if q.device.type == "cpu":
        return shared_rel_attention_blockwise_plain(q, k, qp, pos, v, lengths, heads)
    return _launch("rs_shared_rel_attention_blockwise", q, k, qp, pos, v, lengths, heads)
