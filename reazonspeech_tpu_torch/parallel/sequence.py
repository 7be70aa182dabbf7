"""Sequence parallelism: split the TIME axis of a long-audio encode.

Port of ``reazonspeech_tpu.parallel.sequence``. When one device cannot hold
the [B, T, D] stream of a very long utterance, the subsampled stream is
split over the entries of a mesh axis, each holding its own T/n frames:

- the FFNs, the LayerNorms and the pointwise convs run on each shard alone;
- each query shard attends over the gathered K/V, with its own rows of the
  relative-position band (the T + T/n - 1 offsets its queries see);
- the depthwise conv takes a (K-1)/2-frame halo from its neighbours, zeros
  past either end, as the unsplit conv's SAME padding.

As in the JAX package, the kernel impls are pinned off: the
sequence-parallel path runs the plain formulas (``sequence_parallel_config``),
the kernels being a single-device optimization. The subsampling runs on the
first entry, over the whole feature stream.
"""

import math
from dataclasses import replace

import numpy as np
import torch

from ..models.fastconformer import (
    FastConformerConfig, _check_supported, _encode_prologue, _ffn, _layer,
)
from ..models.layers import (
    batch_norm_infer, conv1d, dense, depthwise_conv1d, glu, layer_norm, swish,
)
from .mesh import MODEL_AXIS, replicate

__all__ = ["sequence_parallel_config", "sequence_parallel_encode"]


def sequence_parallel_config(cfg: FastConformerConfig, axis: str = MODEL_AXIS):
    """The sequence-parallel variant of an encoder config: the time axis on
    ``axis``, the plain impls."""
    return replace(cfg, seq_axis=axis, attn_impl="xla", conv_impl="xla", lnd_impl="xla")


def _axis_entries(mesh, axis):
    idx = [0] * len(mesh.axis_names)
    idx[mesh.axis_names.index(axis)] = slice(None)
    return list(mesh.devices[tuple(idx)])


def sequence_parallel_encode(params, feats, feat_lengths, cfg: FastConformerConfig, mesh,
                             axis: str = MODEL_AXIS):
    """Encode [B, T, F] log-mel features with the encoder stream's time
    axis split over ``mesh[axis]``.

    Same math as ``fastconformer_encode`` on one device with the plain
    impls. Returns ``(encoded [B, T', D] fp32, encoded_lengths [B])``, the
    shards gathered on the axis's first entry."""
    shards, lengths = sequence_parallel_shards(params, feats, feat_lengths, cfg, mesh, axis)
    first = shards[0].device
    return torch.cat([s.to(first) for s in shards], 1), lengths


def sequence_parallel_shards(params, feats, feat_lengths, cfg: FastConformerConfig, mesh,
                             axis: str = MODEL_AXIS):
    """:func:`sequence_parallel_encode` before the gather: the list of the
    entries' output shards (shard ``c`` on the axis's entry ``c``, its rows
    of T') and the lengths."""
    sp_cfg = sequence_parallel_config(cfg, axis)
    _check_supported(sp_cfg)
    entries = _axis_entries(mesh, axis)
    n_shard = len(entries)
    t_in = feats.shape[1]
    if t_in % n_shard:
        # as the reference: there a trailing pad would shift the
        # subsampling grid, silently changing every output frame
        raise ValueError(
            f"sequence_parallel_encode: feature frames ({t_in}) must be a "
            f"multiple of the '{axis}' axis size ({n_shard}); pad or bucket "
            "the feature stream first (pad frames past feat_lengths are "
            "masked by the encoder)")
    first = entries[0]
    replicas = {dev: replicate(params, dev) for dev in dict.fromkeys(entries)}
    x, lengths, pos_emb, mask = _encode_prologue(
        replicas[first], feats.to(first), feat_lengths.to(first, torch.int32), sp_cfg)
    t = x.shape[1]
    bounds = np.linspace(0, t, n_shard + 1).round().astype(int)  # shard c: [bounds[c], bounds[c+1])
    xs = [x[:, a:b].to(dev) for a, b, dev in zip(bounds[:-1], bounds[1:], entries)]
    masks = [mask[:, a:b].to(dev) for a, b, dev in zip(bounds[:-1], bounds[1:], entries)]
    key_masks = [mask.to(dev) for dev in entries]
    pos = [pos_emb.to(dev) for dev in entries]
    for i in range(sp_cfg.num_layers):
        ps = [_layer(replicas[dev]["blocks"], i) for dev in entries]
        xs = _block(ps, xs, pos, masks, key_masks, bounds, sp_cfg)
    if sp_cfg.final_norm:
        xs = [layer_norm(replicas[dev]["after_norm"], h) for dev, h in zip(entries, xs)]
    return [h.to(torch.float32) for h in xs], lengths


def _block(ps, xs, pos, masks, key_masks, bounds, cfg):
    """One Conformer block over the shards (the plain path of
    ``models.fastconformer._block``)."""
    res_dt = getattr(torch, cfg.residual_dtype)
    xs = [h + 0.5 * _ffn(p, "ffn1", h, cfg) for p, h in zip(ps, xs)]
    xs = [h + a for h, a in zip(xs, _attention(ps, xs, pos, key_masks, bounds, cfg))]
    xs = [h + c for h, c in zip(xs, _conv_module(ps, xs, masks, cfg))]
    xs = [h + 0.5 * _ffn(p, "ffn2", h, cfg) for p, h in zip(ps, xs)]
    return [torch.where(m[..., None], layer_norm(p["final_ln"], h), 0).to(res_dt)
            for p, h, m in zip(ps, xs, masks)]


def _attention(ps, xs, pos, key_masks, bounds, cfg):
    """Each query shard over the gathered K/V, with its rows of the band."""
    h, dh, dt, f32 = cfg.num_heads, cfg.head_dim, cfg.dtype, torch.float32
    t = int(bounds[-1])
    qkv = []
    for p, x in zip(ps, xs):
        y = layer_norm(p["attn_ln"], x).to(dt)
        qkv.append([dense(p[f"attn_{n}"], y, dtype=dt) for n in ("q", "k", "v")])
    outs = []
    for c, (p, x) in enumerate(zip(ps, xs)):
        dev, (a, b) = x.device, bounds[c:c + 2]
        bsz, tc = x.shape[:2]
        k = torch.cat([kv[1].to(dev) for kv in qkv], 1).reshape(bsz, t, h, dh)
        v = torch.cat([kv[2].to(dev) for kv in qkv], 1).reshape(bsz, t, h, dh)
        q = qkv[c][0].reshape(bsz, tc, h, dh)
        qu = (q + p["attn_bias_u"].to(dt)).to(f32)
        qv = (q + p["attn_bias_v"].to(dt)).to(f32)
        # the offsets these queries see: rows [T-b, 2T-1-a) of the table
        band = dense(p["attn_pos"], pos[c][t - b:2 * t - 1 - a], dtype=dt).reshape(-1, h, dh)
        ac = torch.einsum("bthd,bshd->bhts", qu, k.to(f32))
        bd_full = torch.einsum("bthd,lhd->bhtl", qv, band.to(f32))
        # query i, key j of the shard: band row (tc-1) - i + j
        idx = (tc - 1) - torch.arange(tc, device=dev)[:, None] + torch.arange(t, device=dev)
        bd = torch.gather(bd_full, 3, idx.expand(bsz, h, tc, t))
        scores = (ac + bd) / math.sqrt(dh)
        scores = torch.where(key_masks[c][:, None, None, :], scores, torch.finfo(f32).min)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhts,bshd->bthd", probs.to(f32), v.to(f32))
        outs.append(dense(p["attn_out"], out.to(dt).reshape(bsz, tc, h * dh), dtype=dt))
    return outs


def _halo(us, c, rows, before):
    """``rows`` frames of the neighbours of shard ``c`` (before or after
    it), on its device; zeros past the stream's ends."""
    dev = us[c].device
    parts, have = [], 0
    for j in (range(c - 1, -1, -1) if before else range(c + 1, len(us))):
        if have == rows:
            break
        u = us[j]
        take = min(rows - have, u.shape[1])
        parts.append((u[:, u.shape[1] - take:] if before else u[:, :take]).to(dev))
        have += take
    if before:
        parts.reverse()
    zeros = us[c].new_zeros((us[c].shape[0], rows - have, us[c].shape[2]))
    return torch.cat([zeros] + parts if before else parts + [zeros], 1)


def _conv_module(ps, xs, masks, cfg):
    """LN → pointwise + GLU → mask on each shard; the depthwise conv over
    the shard and its halo; norm → swish → pointwise on each shard."""
    dt = cfg.dtype
    us = []
    for p, x, m in zip(ps, xs, masks):
        u = glu(conv1d(p["conv_in"], layer_norm(p["conv_ln"], x).to(dt), dtype=dt))
        us.append(torch.where(m[..., None], u, 0))
    left = (cfg.conv_kernel - 1) // 2
    right = cfg.conv_kernel - 1 - left
    outs = []
    for c, p in enumerate(ps):
        ext = torch.cat([_halo(us, c, left, True), us[c], _halo(us, c, right, False)], 1)
        y = depthwise_conv1d(p["conv_dw"], ext, dtype=dt, padding="VALID")
        if cfg.conv_norm == "batch_norm":
            y = batch_norm_infer(p["conv_bn"], y).to(dt)
        else:
            y = layer_norm(p["conv_bn"], y)
        outs.append(conv1d(p["conv_out"], swish(y), dtype=dt))
    return outs
