"""FastConformer encoder (PyTorch).

Port of ``reazonspeech_tpu.models.fastconformer`` for the nemo-v2 path:
dw-striding 8× subsampling, then N Conformer blocks (½FFN → rel-pos MHSA →
conv module → ½FFN → LN) at 0.08 s per output frame. Params are the
reference's tree (block leaves stacked [L, ...]); the block loop indexes
layer i out of the stack.

Two implementations per sub-block, chosen by the config as in the
reference: ``attn_impl``/``conv_impl``/``lnd_impl="pallas"`` runs the
port's kernels (``ops/``; on CPU tensors their plain twins), ``"xla"`` the
plain PyTorch formula of the reference's XLA branch. ``lnd_impl="pallas"``
fuses each pre-sub-block LayerNorm into the kernel that follows it: FFN-in
with its swish (``ln_dense``), the conv module, and, with
``attn_impl="pallas"``, one packed q/k/v projection that also takes the
ffn1 residual add (``ln_dense_add``) feeding the packed attention kernel,
with the ffn2 add, final LayerNorm and length mask in one ``add_ln``.

The TPU-only machinery is not ported: the 128-alignment pad of T, the VMEM
shape gates and sequence sharding. So every kernel runs at the true T, and
the conv kernel runs at every T where the reference's byte gate sends long
inputs to its XLA branch; at fp32 the two branches compute the same
function.
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.conformer_conv import fold_batch_norm, fused_conv_module
from ..ops.ln_dense import add_ln, ln_dense, ln_dense_add
from ..ops.relpos_attention import (
    rel_shift, relpos_attention_fused, relpos_attention_fused_packed,
)
from .layers import (
    batch_norm_infer, batch_norm_init, conv1d, conv1d_init, conv2d, conv2d_init,
    dense, dense_init, depthwise_conv1d, depthwise_conv1d_init, glu, layer_norm,
    layer_norm_init, swish,
)

__all__ = ["FastConformerConfig", "init_fastconformer", "fastconformer_encode"]


@dataclass(frozen=True)
class FastConformerConfig:
    """Field names and defaults as in the JAX package, so a checkpoint's
    ``enc_cfg`` meta builds either package's config."""

    feat_in: int = 80
    num_layers: int = 24
    d_model: int = 1024
    num_heads: int = 8
    ff_expansion: int = 4
    conv_kernel: int = 9
    subsampling_factor: int = 8
    subsampling_channels: int = 256
    subsampling_style: str = "dw_striding"
    conv_norm: str = "batch_norm"
    xscaling: bool = True
    final_norm: bool = False
    compute_dtype: str = "bfloat16"
    attn_impl: str = "xla"  # "pallas": the port's attention kernel
    conv_impl: str = "xla"  # "pallas": the port's conv-module kernel
    lnd_impl: str = "xla"  # "pallas": LayerNorms fused into the following kernels
    residual_dtype: str = "float32"
    remat: bool = False  # training only; inference ignores it
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
    if cfg.subsampling_style != "dw_striding":
        raise ValueError("only dw_striding subsampling is ported (nemo)")
    if cfg.seq_axis is not None:
        raise ValueError("seq_axis: sequence sharding is not ported")
    impls = (cfg.attn_impl, cfg.conv_impl, cfg.lnd_impl)
    if any(impl not in ("xla", "pallas") for impl in impls):
        raise ValueError(f"unknown impl in attn/conv/lnd_impl={impls}")
    if cfg.conv_impl == "pallas" and cfg.conv_norm != "batch_norm":
        raise ValueError("the conv-module kernel is ported for batch_norm only")


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


def _sub_out_dim(n, stages):
    for _ in range(stages):
        n = (n - 1) // 2 + 1  # SAME k=3 s=2 (pad 1)
    return n


def init_fastconformer(gen, cfg: FastConformerConfig, device="cpu"):
    _check_supported(cfg)
    stages = int(np.log2(cfg.subsampling_factor))
    c = cfg.subsampling_channels
    sub = {"conv0": conv2d_init(gen, 1, c, 3, device=device)}
    for i in range(1, stages):
        sub[f"dw{i}"] = conv2d_init(gen, c, c, 3, groups=c, device=device)
        sub[f"pw{i}"] = conv2d_init(gen, c, c, 1, device=device)
    sub["proj"] = dense_init(gen, c * _sub_out_dim(cfg.feat_in, stages), cfg.d_model,
                             device=device)
    blocks = _stack([_init_block(gen, cfg, device) for _ in range(cfg.num_layers)])
    tree = {"subsampling": sub, "blocks": blocks}
    if cfg.final_norm:
        tree["after_norm"] = layer_norm_init(cfg.d_model, device)
    return tree


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _subsample(p, feats, lengths, cfg: FastConformerConfig):
    """[B, T, F] -> [B, T/factor, d_model] (channels-last, as the reference)."""
    stages = int(np.log2(cfg.subsampling_factor))
    dt = cfg.dtype
    pad = ((1, 1), (1, 1))
    x = torch.relu(conv2d(p["conv0"], feats[..., None].to(dt), 2, pad, dtype=dt))
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


def _packed_attn(cfg: FastConformerConfig):
    """The attention LayerNorm and q/k/v projection as one packed ln_dense_add
    feeding the packed attention kernel (the reference's serving path)."""
    return cfg.attn_impl == "pallas" and cfg.lnd_impl == "pallas"


def _mhsa_packed(p, r, delta, pos_emb, lengths, cfg: FastConformerConfig):
    """The MHSA sub-block on the packed path, with the preceding residual add
    fused in: ``x = r + 0.5·delta`` (fp32) runs inside the q/k/v kernel,
    whose three weight segments share one LN pass and are written side by
    side into one [B, T, 3D] projection (no concatenated weight). Returns
    ``(attn_out [B, T, D], x)``."""
    h, dh, dt = cfg.num_heads, cfg.head_dim, cfg.dtype
    w_qkv = tuple(p[k]["w"].to(dt) for k in ("attn_q", "attn_k", "attn_v"))
    c_qkv = tuple(p[k]["b"] for k in ("attn_q", "attn_k", "attn_v"))
    qkv, stream = ln_dense_add(r, delta, p["attn_ln"]["scale"], p["attn_ln"]["bias"], w_qkv,
                               c_qkv, scale=0.5)
    pos = dense(p["attn_pos"], pos_emb, dtype=dt).reshape(-1, h, dh)
    out = relpos_attention_fused_packed(qkv, pos, p["attn_bias_u"], p["attn_bias_v"], lengths, h)
    return dense(p["attn_out"], out, dtype=dt), stream


def _mhsa_relpos(p, x_raw, pos_emb, mask, lengths, cfg: FastConformerConfig):
    """Pre-LN relative-position MHSA (Transformer-XL form). x_raw: [B, T, D]
    residual stream; pos_emb: [2T-1, D]; mask: [B, T]. Returns [B, T, D]."""
    b, t, d = x_raw.shape
    h, dh = cfg.num_heads, cfg.head_dim
    dt = cfg.dtype
    x = layer_norm(p["attn_ln"], x_raw).to(dt)
    q = dense(p["attn_q"], x, dtype=dt)
    k = dense(p["attn_k"], x, dtype=dt)
    v = dense(p["attn_v"], x, dtype=dt)
    pos = dense(p["attn_pos"], pos_emb, dtype=dt).reshape(-1, h, dh)  # [2T-1, H, dh]

    if cfg.attn_impl == "pallas":
        out = relpos_attention_fused(q, k, v, pos, p["attn_bias_u"], p["attn_bias_v"],
                                     lengths, h)
        return dense(p["attn_out"], out, dtype=dt)

    f32 = torch.float32
    q = q.reshape(b, t, h, dh)
    qu = (q + p["attn_bias_u"].to(dt)).to(f32)
    qv = (q + p["attn_bias_v"].to(dt)).to(f32)
    ac = torch.einsum("bthd,bshd->bhts", qu, k.reshape(b, t, h, dh).to(f32))
    bd = rel_shift(torch.einsum("bthd,lhd->bhtl", qv, pos.to(f32)))
    scores = (ac + bd) / math.sqrt(dh)
    scores = torch.where(mask[:, None, None, :], scores, torch.finfo(f32).min)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhts,bshd->bthd", probs.to(f32), v.reshape(b, t, h, dh).to(f32))
    return dense(p["attn_out"], out.to(dt).reshape(b, t, d), dtype=dt)


def _conv_module(p, x_raw, mask, lengths, cfg: FastConformerConfig):
    """LN -> pointwise(2d)+GLU -> mask -> depthwise(k) -> norm -> swish ->
    pointwise. Padded frames are zeroed before the depthwise conv."""
    dt = cfg.dtype
    if cfg.conv_impl == "pallas":
        scale, bias = fold_batch_norm(p["conv_bn"])
        weights = (p["conv_in"]["w"][0], p["conv_in"]["b"], p["conv_dw"]["w"],
                   p["conv_dw"]["b"], scale, bias, p["conv_out"]["w"][0], p["conv_out"]["b"])
        if cfg.lnd_impl == "pallas":  # the LayerNorm inside the kernel
            return fused_conv_module(x_raw, lengths, *weights, ln_scale=p["conv_ln"]["scale"],
                                     ln_bias=p["conv_ln"]["bias"], compute_dtype=dt)
        return fused_conv_module(layer_norm(p["conv_ln"], x_raw).to(dt), lengths, *weights)
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
    dt = cfg.dtype
    if cfg.lnd_impl == "pallas":
        y = ln_dense(x, p[f"{name}_ln"]["scale"], p[f"{name}_ln"]["bias"],
                     p[f"{name}_in"]["w"].to(dt), p[f"{name}_in"]["b"], activation="swish")
        return dense(p[f"{name}_out"], y, dtype=dt)
    y = layer_norm(p[f"{name}_ln"], x).to(dt)
    y = swish(dense(p[f"{name}_in"], y, dtype=dt))
    return dense(p[f"{name}_out"], y, dtype=dt)


def _block(p, x, pos_emb, mask, lengths, cfg: FastConformerConfig):
    """One Conformer block; returns the masked stream in cfg.residual_dtype.

    On the packed path the residual chain runs in the kernels, as in the
    reference's fused tail: the ffn1 add rides the q/k/v projection
    (ln_dense_add), and the ffn2 add, the final LayerNorm and the length
    mask are one add_ln."""
    res_dt = getattr(torch, cfg.residual_dtype)
    if _packed_attn(cfg):
        y1 = _ffn(p, "ffn1", x, cfg)
        attn_y, r1 = _mhsa_packed(p, x, y1, pos_emb, lengths, cfg)
        r2 = r1 + attn_y.to(r1.dtype)
        r3 = r2 + _conv_module(p, r2, mask, lengths, cfg).to(r1.dtype)
        y3 = _ffn(p, "ffn2", r3, cfg)
        return add_ln(r3, y3, lengths, p["final_ln"]["scale"], p["final_ln"]["bias"],
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
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


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
    feat_lengths = feat_lengths.to(torch.int32)
    x, lengths, pos_emb, mask = _encode_prologue(params, feats, feat_lengths, cfg)
    # what the reference's kernels are given: the valid count within T
    key_lengths = mask.sum(dim=-1, dtype=torch.int32)
    for i in range(cfg.num_layers):
        x = _block(_layer(params["blocks"], i), x, pos_emb, mask, key_lengths, cfg)
    if cfg.final_norm:
        x = layer_norm(params["after_norm"], x)
    return x.to(torch.float32), lengths
