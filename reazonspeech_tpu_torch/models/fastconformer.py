"""FastConformer / Conformer encoder (PyTorch).

Port of ``reazonspeech_tpu.models.fastconformer``: conv subsampling, then
N Conformer blocks (½FFN → rel-pos MHSA → conv module → ½FFN → LN). Two
presets of the reference run on it: nemo-v2 (dw-striding 8× subsampling,
batch-norm conv modules, 0.08 s per output frame) and espnet
(``models/conformer.py``: VALID conv2d 4× subsampling, LayerNorm conv
modules, an encoder-level ``after_norm``). Params are the reference's tree
(block leaves stacked [L, ...]); the block loop indexes layer i out of the
stack.

Two implementations per sub-block, chosen by the config as in the
reference: ``attn_impl``/``conv_impl``/``lnd_impl="pallas"`` runs the
port's kernels (``ops/``; on CPU tensors their plain twins), ``"xla"`` the
plain PyTorch formula of the reference's XLA branch. ``lnd_impl="pallas"``
fuses each pre-sub-block LayerNorm into the kernel that follows it: FFN-in
with its swish (``ln_dense``), the conv module, and, with
``attn_impl="pallas"``, one packed q/k/v projection that also takes the
ffn1 residual add (``ln_dense_add``) feeding the packed attention kernel,
with the ffn2 add, final LayerNorm and length mask in one ``add_ln``.

The TPU-only machinery is not ported: the 128-alignment pad of T and the
VMEM byte budgets. ``seq_axis`` names the mesh axis of a sequence-parallel
encode (``parallel/sequence.py`` splits the time axis): this encoder accepts
it with the plain impls and runs unsplit, and raises with a kernel impl, as
the reference does. So every kernel runs at the true T, and
the conv kernel runs at every T where the reference's byte gate sends long
inputs to its XLA branch; at fp32 the two branches compute the same
function. One shape gate is mirrored, the attention route
(:func:`attention_route`): with ``attn_impl="pallas"`` the reference picks
one of three kernel contracts by T and the head shape (packed q/k/v with
the fused block tail, separate q/k/v, or [B, H, T, dh] inputs with the
biases added and an fp32 output), and the contracts round at other points,
so the port picks the same one at every T.

Training (``training/train_step.py``) differentiates the encoder. Where
autograd records, the kernel sub-blocks call the ops' ``*_diff`` wrappers
(the kernel forward, the twin's backward), as the reference's call sites
do; in inference mode they call the kernels directly, with no
``autograd.Function`` on the serving path. ``remat=True`` recomputes each
block in the backward (``torch.utils.checkpoint``, as the reference's
``jax.checkpoint``). The conv-module kernel has no backward in either
package: ``conv_impl="pallas"`` under autograd raises.
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops._kernels import records
from ..ops.conformer_conv import fold_batch_norm, fused_conv_module
from ..ops.ln_dense import (
    add_ln, add_ln_diff, ln_dense, ln_dense_add, ln_dense_add_diff, ln_dense_diff,
)
# _SINGLE_PASS_MAX_T: T up to which the [B, H, T, dh] contract runs single-pass
from ..ops.relpos_attention import (
    _SINGLE_PASS_MAX_T, rel_shift, relpos_attention, relpos_attention_blockwise,
    relpos_attention_diff, relpos_attention_fused, relpos_attention_fused_diff,
    relpos_attention_fused_packed, relpos_attention_fused_packed_diff,
)
from .layers import (
    batch_norm_infer, batch_norm_init, conv1d, conv1d_init, conv2d, conv2d_init,
    dense, dense_init, depthwise_conv1d, depthwise_conv1d_init, glu, layer_norm,
    layer_norm_init, swish,
)

__all__ = ["FastConformerConfig", "attention_route", "encoder_output_length",
           "fastconformer_encode", "init_fastconformer"]


@dataclass(frozen=True)
class FastConformerConfig:
    """Field names and defaults as in the JAX package, so a checkpoint's
    ``enc_cfg`` meta builds either package's config. The defaults are the
    nemo-v2 encoder; ``models.conformer.espnet_encoder_config`` gives the
    espnet one (``subsampling_style="conv2d"``, ``conv_norm="layer_norm"``,
    ``final_norm=True``)."""

    feat_in: int = 80
    num_layers: int = 24
    d_model: int = 1024
    num_heads: int = 8
    ff_expansion: int = 4
    conv_kernel: int = 9
    subsampling_factor: int = 8
    subsampling_channels: int = 256
    subsampling_style: str = "dw_striding"  # or "conv2d" (espnet, VALID full convs)
    conv_norm: str = "batch_norm"  # or "layer_norm" (espnet)
    xscaling: bool = True
    final_norm: bool = False
    compute_dtype: str = "bfloat16"
    attn_impl: str = "xla"  # "pallas": the port's attention kernel
    conv_impl: str = "xla"  # "pallas": the port's conv-module kernel
    lnd_impl: str = "xla"  # "pallas": LayerNorms fused into the following kernels
    residual_dtype: str = "float32"
    remat: bool = False  # recompute each block in the backward; inference ignores it
    seq_axis: Optional[str] = None

    @property
    def dtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    @staticmethod
    def xlarge(**overrides) -> "FastConformerConfig":
        """The published reazonspeech-nemo-v2 encoder (~600M)."""
        return FastConformerConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "FastConformerConfig":
        cfg = dict(num_layers=2, d_model=64, num_heads=4, subsampling_channels=32)
        cfg.update(overrides)
        return FastConformerConfig(**cfg)


def _check_supported(cfg: FastConformerConfig):
    if cfg.subsampling_style not in ("dw_striding", "conv2d"):
        raise ValueError(f"unknown subsampling_style {cfg.subsampling_style!r}")
    if cfg.conv_norm not in ("batch_norm", "layer_norm"):
        raise ValueError(f"unknown conv_norm {cfg.conv_norm!r}")
    impls = (cfg.attn_impl, cfg.conv_impl, cfg.lnd_impl)
    if any(impl not in ("xla", "pallas") for impl in impls):
        raise ValueError(f"unknown impl in attn/conv/lnd_impl={impls}")


# ---------------------------------------------------------------------------
# init (same tree and distributions as the reference; torch.Generator draws)
# ---------------------------------------------------------------------------


def _init_block(gen, cfg: FastConformerConfig, device):
    d, dff = cfg.d_model, cfg.d_model * cfg.ff_expansion
    dn = lambda i, o, **kw: dense_init(gen, i, o, device=device, **kw)  # noqa: E731
    ln = lambda: layer_norm_init(d, device)  # noqa: E731
    p = {
        "ffn1_ln": ln(), "ffn1_in": dn(d, dff), "ffn1_out": dn(dff, d),
        "attn_ln": ln(), "attn_q": dn(d, d), "attn_k": dn(d, d), "attn_v": dn(d, d),
        "attn_pos": dn(d, d, bias=False), "attn_out": dn(d, d),
        "attn_bias_u": torch.zeros(cfg.num_heads, cfg.head_dim, device=device),
        "attn_bias_v": torch.zeros(cfg.num_heads, cfg.head_dim, device=device),
        "conv_ln": ln(),
        "conv_in": conv1d_init(gen, d, 2 * d, 1, device=device),
        "conv_dw": depthwise_conv1d_init(gen, d, cfg.conv_kernel, device=device),
        "conv_out": conv1d_init(gen, d, d, 1, device=device),
        "ffn2_ln": ln(), "ffn2_in": dn(d, dff), "ffn2_out": dn(dff, d),
        "final_ln": ln(),
    }
    p["conv_bn"] = batch_norm_init(d, device) if cfg.conv_norm == "batch_norm" else ln()
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def encoder_output_length(n_frames, cfg: FastConformerConfig):
    """Encoder frames produced for ``n_frames`` feature frames: the host
    mirror of the length arithmetic in :func:`_subsample` (the serving
    executor's lane clocks run on it, with no device readback)."""
    return _sub_out_dim(n_frames, int(np.log2(cfg.subsampling_factor)), cfg.subsampling_style)


def _sub_out_dim(n, stages, style="dw_striding"):
    for _ in range(stages):
        n = (n - 1) // 2 if style == "conv2d" else (n - 1) // 2 + 1  # VALID / SAME k=3 s=2
    return n


def init_fastconformer(gen, cfg: FastConformerConfig, device="cpu"):
    _check_supported(cfg)
    stages = int(np.log2(cfg.subsampling_factor))
    c = cfg.subsampling_channels
    sub = {"conv0": conv2d_init(gen, 1, c, 3, device=device)}
    for i in range(1, stages):
        if cfg.subsampling_style == "conv2d":
            sub[f"conv{i}"] = conv2d_init(gen, c, c, 3, device=device)
        else:
            sub[f"dw{i}"] = conv2d_init(gen, c, c, 3, groups=c, device=device)
            sub[f"pw{i}"] = conv2d_init(gen, c, c, 1, device=device)
    f_out = _sub_out_dim(cfg.feat_in, stages, cfg.subsampling_style)
    sub["proj"] = dense_init(gen, c * f_out, cfg.d_model, device=device)
    blocks = _stack([_init_block(gen, cfg, device) for _ in range(cfg.num_layers)])
    tree = {"subsampling": sub, "blocks": blocks}
    if cfg.final_norm:
        tree["after_norm"] = layer_norm_init(cfg.d_model, device)
    return tree


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _subsample(p, feats, lengths, cfg: FastConformerConfig):
    """[B, T, F] -> [B, T/factor, d_model] (channels-last, as the reference):
    dw-striding (SAME padding, nemo) or VALID full convs (conv2d, espnet)."""
    stages = int(np.log2(cfg.subsampling_factor))
    dt = cfg.dtype
    x = feats[..., None].to(dt)
    if cfg.subsampling_style == "conv2d":
        for i in range(stages):
            x = torch.relu(conv2d(p[f"conv{i}"], x, 2, dtype=dt))
        for _ in range(stages):
            lengths = (lengths - 1) // 2
    else:
        pad = ((1, 1), (1, 1))
        x = torch.relu(conv2d(p["conv0"], x, 2, pad, dtype=dt))
        for i in range(1, stages):
            x = conv2d(p[f"dw{i}"], x, 2, pad, groups=cfg.subsampling_channels, dtype=dt)
            x = torch.relu(conv2d(p[f"pw{i}"], x, dtype=dt))
        for _ in range(stages):
            lengths = (lengths - 1) // 2 + 1
    b, t, f, ch = x.shape
    return dense(p["proj"], x.reshape(b, t, f * ch), dtype=dt), lengths


def _sinusoid_rel_pos(t, d_model, device):
    """Relative sinusoidal table for offsets [t-1 ... -(t-1)]: [2t-1, d] fp32."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)
    inv = np.exp(-np.arange(0, d_model, 2, dtype=np.float64) * (np.log(10000.0) / d_model))
    ang = pos[:, None] * inv[None, :]
    pe = np.zeros((2 * t - 1, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return torch.from_numpy(pe).to(device)


# the reference's fused attention kernels block T and packed heads by its
# 128-lane width and hold one query block of at most 512 rows
_LANES, _FUSED_MAX_T = 128, 512


def attention_route(cfg: FastConformerConfig, t) -> str:
    """Which attention contract runs at ``t`` encoder frames: "packed" (the
    attention LayerNorm and q/k/v as one packed ln_dense_add feeding the
    packed kernel, then the fused block tail), "fused" (separate q/k/v, the
    biases added in the kernel), "generic" ([B, H, T, dh] inputs with the
    biases added, fp32 out) or "xla" (the plain formula).

    This mirrors the reference's choice of kernel contract
    (``_packed_attn_ok``, ``fused_supported``): T rounded up to 128 at most
    512, dh ≤ 128 dividing 128, and heads a multiple of 128/dh. It is not a
    memory limit of the card: the port's kernel has no T cap. It keeps the
    contracts apart because they round at other points (bf16 q+u in the
    kernel or before it, the bf16 or fp32 output, the fused or unfused
    block tail). ``ln_dense_supported``'s weight budget is not mirrored."""
    if cfg.attn_impl != "pallas":
        return "xla"
    h, dh = cfg.num_heads, cfg.head_dim
    fits = (dh <= _LANES and _LANES % dh == 0 and h % (_LANES // dh) == 0
            and -(-t // _LANES) * _LANES <= _FUSED_MAX_T)
    if not fits:
        return "generic"
    return "packed" if cfg.lnd_impl == "pallas" else "fused"


def _generic_attn_kernel(t):
    """The [B, H, T, dh] kernel for T frames, as ``relpos_attention_diff``
    picks it: single-pass up to 1024, streamed beyond."""
    return relpos_attention if t <= _SINGLE_PASS_MAX_T else relpos_attention_blockwise


def _mhsa_packed(p, r, delta, pos_emb, lengths, cfg: FastConformerConfig):
    """The MHSA sub-block on the packed path, with the preceding residual add
    fused in: ``x = r + 0.5·delta`` (fp32) runs inside the q/k/v kernel,
    whose three weight segments share one LN pass and are written side by
    side into one [B, T, 3D] projection (no concatenated weight). Returns
    ``(attn_out [B, T, D], x)``."""
    out, stream = _attend_packed(p, r, delta, pos_emb, lengths, cfg)
    return dense(p["attn_out"], out, dtype=cfg.dtype), stream


def _attend_packed(p, r, delta, pos_emb, lengths, cfg: FastConformerConfig):
    """:func:`_mhsa_packed` before the output projection: ``(heads
    [B, T, H·dh] in the compute dtype, x)``; the heads are ``cfg``'s (a
    tensor-parallel shard passes its own head group's weights and count)."""
    h, dh, dt = cfg.num_heads, cfg.head_dim, cfg.dtype
    w_qkv = tuple(p[k]["w"].to(dt) for k in ("attn_q", "attn_k", "attn_v"))
    c_qkv = tuple(p[k]["b"] for k in ("attn_q", "attn_k", "attn_v"))
    diff = records(r, delta, *w_qkv)
    qkv, stream = (ln_dense_add_diff if diff else ln_dense_add)(
        r, delta, p["attn_ln"]["scale"], p["attn_ln"]["bias"], w_qkv, c_qkv, scale=0.5)
    pos = dense(p["attn_pos"], pos_emb, dtype=dt).reshape(-1, h, dh)
    attend = relpos_attention_fused_packed_diff if diff else relpos_attention_fused_packed
    return attend(qkv, pos, p["attn_bias_u"], p["attn_bias_v"], lengths, h), stream


def _mhsa_relpos(p, x_raw, pos_emb, mask, lengths, cfg: FastConformerConfig):
    """Pre-LN relative-position MHSA (Transformer-XL form). x_raw: [B, T, D]
    residual stream; pos_emb: [2T-1, D]; mask: [B, T]. Returns [B, T, D]."""
    return dense(p["attn_out"], _attend(p, x_raw, pos_emb, mask, lengths, cfg), dtype=cfg.dtype)


def _attend(p, x_raw, pos_emb, mask, lengths, cfg: FastConformerConfig):
    """:func:`_mhsa_relpos` before the output projection: the heads
    [B, T, H·dh] in the compute dtype (``cfg``'s heads, as in
    :func:`_attend_packed`)."""
    b, t, _ = x_raw.shape
    h, dh = cfg.num_heads, cfg.head_dim
    d = h * dh
    dt = cfg.dtype
    x = layer_norm(p["attn_ln"], x_raw).to(dt)
    q = dense(p["attn_q"], x, dtype=dt)
    k = dense(p["attn_k"], x, dtype=dt)
    v = dense(p["attn_v"], x, dtype=dt)
    pos = dense(p["attn_pos"], pos_emb, dtype=dt).reshape(-1, h, dh)  # [2T-1, H, dh]

    route = attention_route(cfg, t)
    diff = records(q, k, v, pos)
    if route == "fused":
        attend = relpos_attention_fused_diff if diff else relpos_attention_fused
        return attend(q, k, v, pos, p["attn_bias_u"], p["attn_bias_v"], lengths, h)

    f32 = torch.float32
    q = q.reshape(b, t, h, dh)
    qu = q + p["attn_bias_u"].to(dt)
    qv = q + p["attn_bias_v"].to(dt)
    if route == "generic":
        heads_first = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
        attend = relpos_attention_diff if diff else _generic_attn_kernel(t)
        out = attend(
            heads_first(qu), heads_first(qv), heads_first(k.reshape(b, t, h, dh)),
            heads_first(v.reshape(b, t, h, dh)), pos, lengths)  # [B, H, T, dh] fp32
        return out.transpose(1, 2).to(dt).reshape(b, t, d)

    qu, qv = qu.to(f32), qv.to(f32)
    ac = torch.einsum("bthd,bshd->bhts", qu, k.reshape(b, t, h, dh).to(f32))
    bd = rel_shift(torch.einsum("bthd,lhd->bhtl", qv, pos.to(f32)))
    scores = (ac + bd) / math.sqrt(dh)
    scores = torch.where(mask[:, None, None, :], scores, torch.finfo(f32).min)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhts,bshd->bthd", probs.to(f32), v.reshape(b, t, h, dh).to(f32))
    return out.to(dt).reshape(b, t, d)


def _conv_module(p, x_raw, mask, lengths, cfg: FastConformerConfig):
    """LN -> pointwise(2d)+GLU -> mask -> depthwise(k) -> norm -> swish ->
    pointwise. Padded frames are zeroed before the depthwise conv."""
    dt = cfg.dtype
    if cfg.conv_impl == "pallas":
        if cfg.conv_norm == "batch_norm":
            scale, bias = fold_batch_norm(p["conv_bn"])
            norm = "folded"
        else:
            scale, bias = p["conv_bn"]["scale"], p["conv_bn"]["bias"]
            norm = "layer"
        weights = (p["conv_in"]["w"][0], p["conv_in"]["b"], p["conv_dw"]["w"],
                   p["conv_dw"]["b"], scale, bias, p["conv_out"]["w"][0], p["conv_out"]["b"])
        if cfg.lnd_impl == "pallas":  # the LayerNorm inside the kernel
            return fused_conv_module(x_raw, lengths, *weights, norm=norm,
                                     ln_scale=p["conv_ln"]["scale"], ln_bias=p["conv_ln"]["bias"],
                                     compute_dtype=dt)
        return fused_conv_module(layer_norm(p["conv_ln"], x_raw).to(dt), lengths, *weights,
                                 norm=norm)
    x = layer_norm(p["conv_ln"], x_raw).to(dt)
    x = glu(conv1d(p["conv_in"], x, dtype=dt))
    x = torch.where(mask[..., None], x, 0)
    x = depthwise_conv1d(p["conv_dw"], x, dtype=dt)
    if cfg.conv_norm == "batch_norm":
        x = batch_norm_infer(p["conv_bn"], x).to(dt)
    else:
        x = layer_norm(p["conv_bn"], x)
    return conv1d(p["conv_out"], swish(x), dtype=dt)


def _ffn(p, name, x, cfg: FastConformerConfig):
    return dense(p[f"{name}_out"], _ffn_hidden(p, name, x, cfg), dtype=cfg.dtype)


def _ffn_hidden(p, name, x, cfg: FastConformerConfig):
    """LN → in-projection → swish: the FFN before its out-projection."""
    dt = cfg.dtype
    if cfg.lnd_impl == "pallas":
        w = p[f"{name}_in"]["w"].to(dt)
        return (ln_dense_diff if records(x, w) else ln_dense)(
            x, p[f"{name}_ln"]["scale"], p[f"{name}_ln"]["bias"], w, p[f"{name}_in"]["b"],
            activation="swish")
    y = layer_norm(p[f"{name}_ln"], x).to(dt)
    return swish(dense(p[f"{name}_in"], y, dtype=dt))


def _block(p, x, pos_emb, mask, lengths, cfg: FastConformerConfig):
    """One Conformer block; returns the masked stream in cfg.residual_dtype.

    On the packed attention route the residual chain runs in the kernels,
    as in the reference's fused tail: the ffn1 add rides the q/k/v
    projection (ln_dense_add), and the ffn2 add, the final LayerNorm and
    the length mask are one add_ln. On the other routes the tail is the
    reference's unfused one (adds, LayerNorm and mask in plain PyTorch)."""
    res_dt = getattr(torch, cfg.residual_dtype)
    if attention_route(cfg, x.shape[1]) == "packed":
        y1 = _ffn(p, "ffn1", x, cfg)
        attn_y, r1 = _mhsa_packed(p, x, y1, pos_emb, lengths, cfg)
        r2 = r1 + attn_y.to(r1.dtype)
        r3 = r2 + _conv_module(p, r2, mask, lengths, cfg).to(r1.dtype)
        y3 = _ffn(p, "ffn2", r3, cfg)
        tail = add_ln_diff if records(r3, y3) else add_ln
        return tail(r3, y3, lengths, p["final_ln"]["scale"], p["final_ln"]["bias"],
                    scale=0.5, out_dtype=res_dt)
    x = x + 0.5 * _ffn(p, "ffn1", x, cfg)
    x = x + _mhsa_relpos(p, x, pos_emb, mask, lengths, cfg)
    x = x + _conv_module(p, x, mask, lengths, cfg)
    x = x + 0.5 * _ffn(p, "ffn2", x, cfg)
    y = layer_norm(p["final_ln"], x)
    return torch.where(mask[..., None], y, 0).to(res_dt)


def _encode_prologue(params, feats, feat_lengths, cfg: FastConformerConfig):
    """subsample → xscale → rel-pos table → mask → residual-dtype cast.
    Returns ``(x, lengths, pos_emb, mask)``."""
    x, lengths = _subsample(params["subsampling"], feats, feat_lengths, cfg)
    b, t, _ = x.shape
    if cfg.xscaling:
        # the reference multiplies by a numpy float32 scalar, which promotes
        # the compute-dtype stream to fp32
        x = x.to(torch.float32) * np.float32(np.sqrt(cfg.d_model)).item()
    pos_emb = _sinusoid_rel_pos(t, cfg.d_model, x.device)
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    x = torch.where(mask[..., None], x, 0).to(getattr(torch, cfg.residual_dtype))
    return x, lengths, pos_emb, mask


def _layer(tree, i):
    """Layer ``i`` of a stacked tree (a list leaf holds tensor-parallel
    shards, each stacked: layer ``i`` of each)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return type(tree)(part[i] for part in tree)
    return tree[i]


def _run_blocks(blocks, n_layers, x, pos_emb, mask, key_lengths, cfg: FastConformerConfig,
                block=_block):
    """``n_layers`` blocks of the stacked tree ``blocks`` over the stream
    ``x``, each recomputed in the backward under ``cfg.remat``."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n_layers):
        p = _layer(blocks, i)
        if remat:  # the block's activations recomputed in the backward
            x = checkpoint(block, p, x, pos_emb, mask, key_lengths, cfg, use_reentrant=False)
        else:
            x = block(p, x, pos_emb, mask, key_lengths, cfg)
    return x


def fastconformer_encode(params, feats, feat_lengths, cfg: FastConformerConfig):
    """Encode log-mel features.

    Args:
      params: tree from init_fastconformer (or the JAX package, via the bridge)
      feats: [B, T, feat_in] float
      feat_lengths: [B] int

    Returns (encoded [B, T', d_model] fp32, encoded_lengths [B] int32),
    T' = T / subsampling_factor (0.08 s per frame at 10 ms hop).
    """
    _check_supported(cfg)
    if cfg.seq_axis and "pallas" in (cfg.attn_impl, cfg.conv_impl, cfg.lnd_impl):
        # the sequence-parallel encode splits the plain formulas only
        raise ValueError(
            "seq_axis requires the XLA impls (attn_impl/conv_impl/lnd_impl='xla'); use "
            "parallel.sequence.sequence_parallel_config/sequence_parallel_encode")
    feat_lengths = feat_lengths.to(torch.int32)
    x, lengths, pos_emb, mask = _encode_prologue(params, feats, feat_lengths, cfg)
    # what the reference's kernels are given: the valid count within T
    key_lengths = mask.sum(dim=-1, dtype=torch.int32)
    x = _run_blocks(params["blocks"], cfg.num_layers, x, pos_emb, mask, key_lengths, cfg)
    if cfg.final_norm:
        x = layer_norm(params["after_norm"], x)
    return x.to(torch.float32), lengths
