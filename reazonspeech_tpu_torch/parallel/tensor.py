"""Data x tensor parallel training: the encoder as Megatron partials.

The port's counterpart of what GSPMD does for the JAX package's train step
over a ``('data', 'model')`` mesh with ``parallel.mesh`` rules. The batch is
split over ``data``; on data row ``d`` the encoder's FFNs and attention run
as partials over the row's ``model`` entries, from the shards that
:func:`parallel.mesh.shard_params` placed:

- FFN: on entry ``j`` the LayerNorm and the column shard of the in-projection
  (the ``ln_dense`` kernel at N = dff/n_model), swish, and the partial
  product with the row shard of the out-projection;
- attention: on entry ``j`` the head group ``j`` (its columns of q/k/v/pos,
  its position biases) through the same attention route as one device
  (the packed route: ``ln_dense_add`` with the group's q|k|v re-packed, then
  the packed attention kernel on H/n_model heads), then the partial product
  with the row shard of the out-projection;
- the partials are summed in fp32 on the residual's entry, cast to the
  compute dtype and the bias added, the order of the single-device product's
  output; the conv module, the norms and the rest run there whole.

Gradients reach the master shards through autograd (the ``.to()`` copies
of data rows other than the first sum their gradients back). Only the
encoder is split; the predictor, joint and losses run per data shard.
"""

from dataclasses import replace

import torch

from ..frontend.features import log_mel_spectrogram
from ..models.fastconformer import (
    _attend, _attend_packed, _check_supported, _conv_module, _encode_prologue, _ffn_hidden,
    _run_blocks, attention_route,
)
from ..models.layers import dense, layer_norm
from ..ops._kernels import records
from ..ops.ln_dense import add_ln, add_ln_diff
from .mesh import Mesh, Shards, shard_batch, unshard_params

__all__ = ["sharded_loss", "tensor_parallel_encode"]

# the leaves the rules split, by sub-block
_FFN = ("{}_in/w", "{}_in/b", "{}_out/w")
_ATTN = ("attn_q/w", "attn_k/w", "attn_v/w", "attn_pos/w", "attn_out/w", "attn_q/b", "attn_k/b",
         "attn_v/b", "attn_bias_u", "attn_bias_v")


def _part(tree, j, device):
    """Shard ``j`` of a layer's tree on ``device``: split leaves give their
    ``j``-th part, whole leaves themselves."""
    if isinstance(tree, dict):
        return {k: _part(v, j, device) for k, v in tree.items()}
    return (tree[j] if isinstance(tree, Shards) else tree).to(device)


def _split(p, paths):
    """True where every leaf of ``p`` at ``paths`` ('a/b') is split."""
    def leaf(path):
        node = p
        for k in path.split("/"):
            node = node[k]
        return node
    return all(isinstance(leaf(path), Shards) for path in paths)


def _whole(p, device):
    """A layer's tree with every split leaf concatenated on ``device`` (a
    sub-block some of whose leaves did not divide runs whole)."""
    return unshard_params(p, device, stacked_prefixes=())


def _reduce(partials, out, device, dt):
    """Σ fp32 partials on ``device``, cast to ``dt``, plus the out-projection's
    bias: ``dense``'s output, its product split over the model entries."""
    y = partials[0].to(device)
    for part in partials[1:]:
        y = y + part.to(device)
    return y.to(dt) + out["b"].to(device, dt)


def _ffn(p, shards, name, x, cfg, entries):
    """The FFN of ``name``, split over the entries where its leaves are
    (else whole, on the residual's entry)."""
    dt = cfg.dtype
    if not _split(p, [f.format(name) for f in _FFN]):
        whole = _whole(p, x.device)
        return dense(whole[f"{name}_out"], _ffn_hidden(whole, name, x, cfg), dtype=dt)
    partials = []
    for pj, dev in zip(shards, entries):
        y = _ffn_hidden(pj, name, x.to(dev), cfg)
        partials.append(y.float() @ pj[f"{name}_out"]["w"].to(dt).float())
    return _reduce(partials, shards[0][f"{name}_out"], x.device, dt)


def _attention(p, shards, x, y1, pos_emb, mask, lengths, cfg, entries):
    """The ffn1 add and the attention sub-block, its heads split over the
    entries where its leaves are. On the packed route the add runs in each
    head group's q|k|v kernel (``ln_dense_add``). Returns ``(attention out,
    the stream after the ffn1 add)``."""
    dt = cfg.dtype
    groups = list(zip(shards, entries)) if _split(p, _ATTN) else [(_whole(p, x.device), x.device)]
    heads = cfg.num_heads // len(groups)
    sub = replace(cfg, d_model=heads * cfg.head_dim, num_heads=heads)
    packed = attention_route(sub, x.shape[1]) == "packed"
    if not packed:
        x = x + 0.5 * y1
    partials, streams = [], []
    for pj, dev in groups:
        if packed:
            out, stream = _attend_packed(pj, x.to(dev), y1.to(dev), pos_emb.to(dev),
                                         lengths.to(dev), sub)
            streams.append(stream)
        else:
            out = _attend(pj, x.to(dev), pos_emb.to(dev), mask.to(dev), lengths.to(dev), sub)
        partials.append(out.float() @ pj["attn_out"]["w"].to(dt).float())
    return _reduce(partials, shards[0]["attn_out"], x.device, dt), (streams or [x])[0]


def _block(p, x, pos_emb, mask, lengths, cfg, entries):
    """One Conformer block on a data row's model entries, ``x`` on the first
    (the math of ``models.fastconformer._block``: the packed route's fused
    tail, or the unfused one)."""
    res_dt = getattr(torch, cfg.residual_dtype)
    shards = [_part(p, j, dev) for j, dev in enumerate(entries)]
    y1 = _ffn(p, shards, "ffn1", x, cfg, entries)
    attn_y, r = _attention(p, shards, x, y1, pos_emb, mask, lengths, cfg, entries)
    r = r + attn_y.to(r.dtype)
    r = r + _conv_module(shards[0], r, mask, lengths, cfg).to(r.dtype)
    y3 = _ffn(p, shards, "ffn2", r, cfg, entries)
    final = shards[0]["final_ln"]
    if attention_route(cfg, x.shape[1]) == "packed":
        tail = add_ln_diff if records(r, y3) else add_ln
        return tail(r, y3, lengths, final["scale"], final["bias"], scale=0.5, out_dtype=res_dt)
    r = r + 0.5 * y3
    return torch.where(mask[..., None], layer_norm(final, r), 0).to(res_dt)


def tensor_parallel_encode(params, feats, feat_lengths, cfg, entries):
    """``fastconformer_encode`` on one data row's model ``entries``:
    ``params`` an encoder tree whose split leaves are lists of shards (shard
    ``j`` on entry ``j``), whole leaves on the first entry, where the
    stream runs. Returns ``(encoded [B, T', D] fp32, lengths)`` there."""
    _check_supported(cfg)
    first = entries[0]
    x, lengths, pos_emb, mask = _encode_prologue(
        params, feats.to(first), feat_lengths.to(first, torch.int32), cfg)
    key_lengths = mask.sum(dim=-1, dtype=torch.int32)

    def block(p, x, pos_emb, mask, key_lengths, cfg):
        return _block(p, x, pos_emb, mask, key_lengths, cfg, entries)

    x = _run_blocks(params["blocks"], cfg.num_layers, x, pos_emb, mask, key_lengths, cfg,
                    block=block)
    if cfg.final_norm:
        x = layer_norm(params["after_norm"], x)
    return x.to(torch.float32), lengths


def _row(tree, entries):
    """A :func:`parallel.mesh.shard_params` tree on one data row: shard
    ``j`` on ``entries[j]``, whole leaves on ``entries[0]`` (autograd sums
    the gradients of the copies back into the master leaves)."""
    if isinstance(tree, dict):
        return {k: _row(v, entries) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return Shards(part.to(dev) for part, dev in zip(tree, entries))
    if isinstance(tree, list):
        return [_row(v, entries) for v in tree]
    return tree.to(entries[0])


def sharded_loss(params, batch, fe_cfg, enc_cfg, rnnt_cfg, mesh: Mesh, **loss_kw):
    """The mean loss of ``training.compute_loss`` over a ``('data',
    'model')`` mesh: the batch's rows split over ``data`` (it must divide),
    on each data row the frontend, the encoder as partials over the row's
    ``model`` entries, and the transducer loss of its rows; the rows' means
    averaged on the first entry."""
    from ..training.train_step import transducer_loss

    first = mesh.devices[0, 0]
    total = None
    parts = shard_batch(batch, mesh)
    for d, part in enumerate(parts):
        entries = list(mesh.devices[d])
        p = _row(params, entries)
        feats, flens = log_mel_spectrogram(part["waveform"], part["lengths"], fe_cfg)
        enc, elens = tensor_parallel_encode(p["encoder"], feats, flens, enc_cfg, entries)
        nll = transducer_loss(p, part, enc, elens, rnnt_cfg, **loss_kw).to(first)
        total = nll if total is None else total + nll
    return total / len(parts)
