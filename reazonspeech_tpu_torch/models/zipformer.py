"""Zipformer2 encoder (PyTorch).

Port of ``reazonspeech_tpu.models.zipformer`` for the k2 flavor: a conv
embed (≈2× time reduction), a U-Net-like series of encoder stacks at
per-stack downsampling factors with channel widths that grow then shrink,
and a final 2× output downsample, 0.04 s per output frame at a 10 ms fbank
hop. BiasNorm, SwooshL/SwooshR, per-channel bypass, SimpleDownsample
(softmax-weighted frame pooling) and SimpleUpsample (frame repetition), and
channel changes between stacks by zero-pad / truncate, as in the reference.
Params are the reference's tree (a list of stacks, each with its layer
leaves stacked [L, ...]); the layer loop indexes layer i out of the stack.

Each layer computes its softmax attention weights once and applies them
three times (nonlin attention with head 0, two value attentions), chosen by
``attn_impl`` as in the reference: ``"xla"`` materializes the [B, H, T, T]
weights (the CPU spec), ``"pallas"`` recomputes the scores per application
in the shared-attention kernel (``ops/zipformer_attention.py``; on CPU
tensors its plain twins), single pass up to 2048 frames and streamed beyond
(:func:`_shared_attn_kernel`).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.relpos_attention import rel_shift
from ..ops.zipformer_attention import shared_rel_attention, shared_rel_attention_blockwise
from .layers import conv2d, conv2d_init, dense, dense_init, depthwise_conv1d, depthwise_conv1d_init

__all__ = [
    "ZipformerConfig", "init_zipformer", "zipformer_encode", "zipformer_output_length",
    "swoosh_l", "swoosh_r",
]


@dataclass(frozen=True)
class ZipformerConfig:
    """Field names and defaults as in the JAX package, so a checkpoint's
    ``enc_cfg`` meta builds either package's config."""

    feat_in: int = 80
    num_layers: Tuple[int, ...] = (2, 2, 4, 5, 4, 2)
    downsampling: Tuple[int, ...] = (1, 2, 4, 8, 4, 2)
    encoder_dim: Tuple[int, ...] = (192, 256, 512, 768, 512, 256)
    ffn_dim: Tuple[int, ...] = (512, 768, 1536, 2048, 1536, 768)
    num_heads: Tuple[int, ...] = (4, 4, 4, 8, 4, 4)
    cnn_kernel: Tuple[int, ...] = (31, 31, 15, 15, 15, 31)
    query_head_dim: int = 32
    value_head_dim: int = 12
    pos_head_dim: int = 4
    pos_dim: int = 48
    embed_channels: Tuple[int, ...] = (8, 32, 128)
    output_downsampling: int = 2
    attn_impl: str = "xla"  # "pallas": the port's shared-attention kernel
    compute_dtype: str = "bfloat16"
    residual_dtype: str = "float32"

    @property
    def dtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def out_dim(self) -> int:
        return max(self.encoder_dim)

    @staticmethod
    def large(**overrides) -> "ZipformerConfig":
        """The published reazonspeech-k2-v2 encoder shape."""
        return ZipformerConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "ZipformerConfig":
        cfg = dict(
            num_layers=(1, 1, 1),
            downsampling=(1, 2, 4),
            encoder_dim=(32, 48, 64),
            ffn_dim=(48, 64, 96),
            num_heads=(2, 2, 2),
            cnn_kernel=(7, 7, 7),
            query_head_dim=8,
            value_head_dim=4,
            pos_head_dim=2,
            pos_dim=12,
            embed_channels=(4, 8, 16),
        )
        cfg.update(overrides)
        return ZipformerConfig(**cfg)


def _check_supported(cfg: ZipformerConfig):
    if cfg.attn_impl not in ("xla", "pallas"):
        raise ValueError(f"attn_impl={cfg.attn_impl!r}: expected 'xla' or 'pallas'")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def swoosh_l(x):
    """SwooshL(x) = log(1 + e^(x-4)) - 0.08x - 0.035"""
    return torch.logaddexp(torch.zeros_like(x), x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x):
    """SwooshR(x) = log(1 + e^(x-1)) - 0.08x - 0.313"""
    return torch.logaddexp(torch.zeros_like(x), x - 1.0) - 0.08 * x - 0.313


def bias_norm_init(dim, device="cpu"):
    return {"bias": torch.zeros(dim, device=device), "log_scale": torch.zeros((), device=device)}


def bias_norm(p, x, eps=1e-5):
    """x · exp(log_scale) / RMS(x - bias), statistics in fp32, out in x.dtype."""
    x32 = x.to(torch.float32)
    rms = torch.sqrt((x32 - p["bias"]).square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * (torch.exp(p["log_scale"]) / rms)).to(x.dtype)


def bypass_init(dim, initial=0.5, device="cpu"):
    return {"scale": torch.full((dim,), initial, device=device)}


def bypass_apply(p, x_orig, x):
    """x_orig·(1-c) + x·c with c = clip(scale, 0, 1), in fp32."""
    c = torch.clamp(p["scale"], 0.0, 1.0).to(torch.float32)
    return x_orig.to(torch.float32) * (1.0 - c) + x.to(torch.float32) * c


# ---------------------------------------------------------------------------
# init (same tree and distributions as the reference; torch.Generator draws)
# ---------------------------------------------------------------------------


def _init_layer(gen, si, cfg: ZipformerConfig, device):
    d, h, ffn = cfg.encoder_dim[si], cfg.num_heads[si], cfg.ffn_dim[si]
    qd, vd, pd = cfg.query_head_dim, cfg.value_head_dim, cfg.pos_head_dim
    hidden = d * 3 // 4
    dn = lambda i, o, **kw: dense_init(gen, i, o, device=device, **kw)  # noqa: E731
    dw = lambda: depthwise_conv1d_init(gen, d, cfg.cnn_kernel[si], device=device)  # noqa: E731
    return {
        "attn_qkp": dn(d, h * (2 * qd + pd)),
        "attn_pos": dn(cfg.pos_dim, h * pd, bias=False),
        "sa1_v": dn(d, h * vd), "sa1_out": dn(h * vd, d),
        "sa2_v": dn(d, h * vd), "sa2_out": dn(h * vd, d),
        "na_in": dn(d, 3 * hidden), "na_out": dn(hidden, d),
        "ff1_in": dn(d, ffn), "ff1_out": dn(ffn, d),
        "ff2_in": dn(d, ffn), "ff2_out": dn(ffn, d),
        "ff3_in": dn(d, ffn), "ff3_out": dn(ffn, d),
        "cv1_in": dn(d, 2 * d), "cv1_dw": dw(), "cv1_out": dn(d, d),
        "cv2_in": dn(d, 2 * d), "cv2_dw": dw(), "cv2_out": dn(d, d),
        "norm": bias_norm_init(d, device),
        "bypass_mid": bypass_init(d, device=device),
        "bypass": bypass_init(d, device=device),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_zipformer(gen, cfg: ZipformerConfig, device="cpu"):
    c1, c2, c3 = cfg.embed_channels
    embed = {
        "conv0": conv2d_init(gen, 1, c1, 3, device=device),
        "conv1": conv2d_init(gen, c1, c2, 3, device=device),
        "conv2": conv2d_init(gen, c2, c3, 3, device=device),
    }
    f = cfg.feat_in
    f = (f - 3) // 2 + 1  # conv0: freq stride 2, VALID
    f = (f - 3) // 2 + 1  # conv1: freq stride 2, VALID
    f = f - 2  # conv2: freq stride 1, VALID
    embed["proj"] = dense_init(gen, c3 * f, cfg.encoder_dim[0], device=device)
    embed["norm"] = bias_norm_init(cfg.encoder_dim[0], device)
    stacks = []
    for si in range(len(cfg.num_layers)):
        stack = {"layers": _stack([_init_layer(gen, si, cfg, device)
                                   for _ in range(cfg.num_layers[si])])}
        if cfg.downsampling[si] > 1:
            stack["ds_weights"] = torch.zeros(cfg.downsampling[si], device=device)
            stack["out_bypass"] = bypass_init(cfg.encoder_dim[si], device=device)
        stacks.append(stack)
    return {"embed": embed, "stacks": stacks}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _embed(p, feats, lengths, cfg: ZipformerConfig):
    """[B, T, F] -> [B, T', encoder_dim[0]], T' = (T-7)//2 + 1."""
    dt = cfg.dtype
    x = feats[..., None].to(dt)
    x = swoosh_r(conv2d(p["conv0"], x, stride=(1, 2), dtype=dt))
    x = swoosh_r(conv2d(p["conv1"], x, stride=(2, 2), dtype=dt))
    x = swoosh_r(conv2d(p["conv2"], x, stride=(1, 1), dtype=dt))
    b, t, f, c = x.shape
    x = bias_norm(p["norm"], dense(p["proj"], x.reshape(b, t, f * c), dtype=dt))
    lengths = (lengths - 2 - 3) // 2 + 1 - 2
    return x, torch.clamp(lengths, min=0)


def _compact_rel_pos(t, pos_dim):
    """Compact relative positional embedding [2T-1, pos_dim] (numpy fp32):
    sinusoids over a log-compressed relative distance."""
    rel = np.arange(t - 1, -t, -1, dtype=np.float64)
    compressed = np.sign(rel) * np.log1p(np.abs(rel))
    half = pos_dim // 2
    freqs = np.exp(np.arange(half, dtype=np.float64) * (-np.log(100.0) / max(half - 1, 1)))
    ang = compressed[:, None] * freqs[None, :] * np.pi
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return pe[:, :pos_dim].astype(np.float32)


def _qkp(p, x, si, cfg: ZipformerConfig):
    """The shared projection, split: q, k [B, T, H, qd], qp [B, T, H, pd]."""
    b, t, _ = x.shape
    h, qd = cfg.num_heads[si], cfg.query_head_dim
    qkp = dense(p["attn_qkp"], x, dtype=cfg.dtype).reshape(b, t, h, -1)
    return qkp[..., :qd], qkp[..., qd:2 * qd], qkp[..., 2 * qd:]


def _pos_table(p, pos_emb, si, cfg: ZipformerConfig):
    """Projected compact rel-pos table [2T-1, H, pd] in the compute dtype."""
    return dense(p["attn_pos"], pos_emb, dtype=cfg.dtype).reshape(
        pos_emb.shape[0], cfg.num_heads[si], cfg.pos_head_dim)


def _attn_weights(p, x, pos_emb, mask, si, cfg: ZipformerConfig):
    """Softmax attention weights [B, H, T, T] in the compute dtype, computed
    once per layer (fp32 scores and softmax)."""
    f32 = torch.float32
    q, k, qp = _qkp(p, x, si, cfg)
    scores = torch.einsum("bthd,bshd->bhts", q.to(f32), k.to(f32))
    pos = _pos_table(p, pos_emb, si, cfg)
    pos_scores = torch.einsum("bthd,lhd->bhtl", qp.to(f32), pos.to(f32))
    scores = (scores + rel_shift(pos_scores)) / math.sqrt(cfg.query_head_dim)
    scores = torch.where(mask[:, None, None, :], scores, torch.finfo(f32).min)
    return torch.softmax(scores, dim=-1).to(cfg.dtype)


def _self_attn(p, prefix, x, weights, si, cfg: ZipformerConfig):
    b, t, _ = x.shape
    h, vd, dt = cfg.num_heads[si], cfg.value_head_dim, cfg.dtype
    v = dense(p[f"{prefix}_v"], x, dtype=dt).reshape(b, t, h, vd)
    out = torch.einsum("bhts,bshd->bthd", weights.to(torch.float32), v.to(torch.float32))
    return dense(p[f"{prefix}_out"], out.to(dt).reshape(b, t, h * vd), dtype=dt)


def _nonlin_attention(p, x, weights_head0, cfg: ZipformerConfig):
    """tanh-gated channel mixing attended with one head's weights."""
    dt = cfg.dtype
    s, v, y = dense(p["na_in"], x, dtype=dt).chunk(3, dim=-1)
    v = torch.tanh(s) * v
    attended = torch.einsum("bts,bsd->btd", weights_head0.to(torch.float32),
                            v.to(torch.float32)).to(dt)
    return dense(p["na_out"], attended * y, dtype=dt)


def _ffn(p, prefix, x, cfg: ZipformerConfig):
    dt = cfg.dtype
    return dense(p[f"{prefix}_out"], swoosh_l(dense(p[f"{prefix}_in"], x, dtype=dt)), dtype=dt)


def _conv_module(p, prefix, x, mask, cfg: ZipformerConfig):
    dt = cfg.dtype
    a, g = dense(p[f"{prefix}_in"], x, dtype=dt).chunk(2, dim=-1)
    y = torch.where(mask[..., None], a * torch.sigmoid(g), 0)
    y = swoosh_r(depthwise_conv1d(p[f"{prefix}_dw"], y, dtype=dt))
    return dense(p[f"{prefix}_out"], y, dtype=dt)


def _attn_context(p, x, pos_emb, si, cfg: ZipformerConfig):
    """The shared attention inputs, projected once per layer and laid out
    for the kernel: q, k [B·H, T, qd], qp [B·H, T, pd], pos [H, 2T-1, pd]."""
    b, t, _ = x.shape
    h = cfg.num_heads[si]

    def flat(a):  # [B, T, H, c] -> [B·H, T, c]
        return a.permute(0, 2, 1, 3).reshape(b * h, t, -1).contiguous()

    q, k, qp = (flat(a) for a in _qkp(p, x, si, cfg))
    pos = _pos_table(p, pos_emb, si, cfg).permute(1, 0, 2).contiguous()
    return q, k, qp, pos


def _shared_attn_kernel(t):
    """The single-pass entry up to 2048 frames, the streamed one beyond (the
    reference's VMEM dispatch; the card's kernel has no T cap, but the
    entries map one to one)."""
    return shared_rel_attention if t <= 2048 else shared_rel_attention_blockwise


def _self_attn_pallas(p, prefix, x, ctx, lengths, si, cfg: ZipformerConfig):
    attention = _shared_attn_kernel(x.shape[1])
    b, t, _ = x.shape
    h, vd, dt = cfg.num_heads[si], cfg.value_head_dim, cfg.dtype
    q, k, qp, pos = ctx
    v = dense(p[f"{prefix}_v"], x, dtype=dt).reshape(b, t, h, vd)
    v = v.permute(0, 2, 1, 3).reshape(b * h, t, vd).contiguous()
    out = attention(q, k, qp, pos, v, lengths.repeat_interleave(h), heads=h)  # fp32
    out = out.reshape(b, h, t, vd).permute(0, 2, 1, 3).to(dt)
    return dense(p[f"{prefix}_out"], out.reshape(b, t, h * vd), dtype=dt)


def _nonlin_attention_pallas(p, x, ctx, lengths, si, cfg: ZipformerConfig):
    attention = _shared_attn_kernel(x.shape[1])
    b, t, _ = x.shape
    h, dt = cfg.num_heads[si], cfg.dtype
    q, k, qp, pos = ctx
    s, v, y = dense(p["na_in"], x, dtype=dt).chunk(3, dim=-1)
    v = (torch.tanh(s) * v).to(dt).contiguous()  # [B, T, hidden]

    def head0(a):  # [B·H, T, c] -> head-0 rows [B, T, c]
        return a.reshape(b, h, t, -1)[:, 0].contiguous()

    attended = attention(head0(q), head0(k), head0(qp), pos[:1], v, lengths, heads=1).to(dt)
    return dense(p["na_out"], attended * y, dtype=dt)


def _layer(p, x, pos_emb, mask, si, cfg: ZipformerConfig):
    dt = cfg.dtype
    x_orig = x
    if cfg.attn_impl == "pallas":
        ctx = _attn_context(p, x.to(dt), pos_emb, si, cfg)
        lengths = mask.sum(dim=-1, dtype=torch.int32)
        nonlin = lambda y: _nonlin_attention_pallas(p, y, ctx, lengths, si, cfg)  # noqa: E731
        attn = lambda pre, y: _self_attn_pallas(p, pre, y, ctx, lengths, si, cfg)  # noqa: E731
    else:
        weights = _attn_weights(p, x.to(dt), pos_emb, mask, si, cfg)
        nonlin = lambda y: _nonlin_attention(p, y, weights[:, 0], cfg)  # noqa: E731
        attn = lambda pre, y: _self_attn(p, pre, y, weights, si, cfg)  # noqa: E731

    x = x + _ffn(p, "ff1", x.to(dt), cfg)
    x = x + nonlin(x.to(dt))
    x = x + attn("sa1", x.to(dt))
    x = x + _conv_module(p, "cv1", x.to(dt), mask, cfg)
    x = x + _ffn(p, "ff2", x.to(dt), cfg)
    x = bypass_apply(p["bypass_mid"], x_orig, x)
    x = x + attn("sa2", x.to(dt))
    x = x + _conv_module(p, "cv2", x.to(dt), mask, cfg)
    x = x + _ffn(p, "ff3", x.to(dt), cfg)
    x = bias_norm(p["norm"], x)
    return bypass_apply(p["bypass"], x_orig, x)


def _downsample(weights, x, lengths, ds):
    """Softmax-weighted pooling of frame groups, edge-padded:
    [B, T, D] -> [B, ⌈T/ds⌉, D] fp32."""
    b, t, d = x.shape
    t_out = -(-t // ds)
    pad = t_out * ds - t
    if pad:
        x = torch.cat([x, x[:, -1:].expand(b, pad, d)], dim=1)
    w = torch.softmax(weights.to(torch.float32), dim=0)
    x = torch.einsum("btsd,s->btd", x.to(torch.float32).reshape(b, t_out, ds, d), w)
    return x, -((-lengths) // ds)


def _upsample(x, t_target, ds):
    """Repeat frames ds times and crop: [B, T, D] -> [B, t_target, D]."""
    return x.repeat_interleave(ds, dim=1)[:, :t_target]


def _convert_channels(x, new_dim):
    d = x.shape[-1]
    if new_dim == d:
        return x
    if new_dim < d:
        return x[..., :new_dim]
    return torch.nn.functional.pad(x, (0, new_dim - d))


def _layer_params(tree, i):
    if isinstance(tree, dict):
        return {k: _layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def zipformer_output_length(n_frames, cfg: ZipformerConfig):
    """Encoder frames produced for ``n_frames`` feature frames (the host
    mirror of the length arithmetic in :func:`_embed` and the output
    pair-averaging)."""
    e = max((int(n_frames) - 2 - 3) // 2 + 1 - 2, 0)
    return -(-e // cfg.output_downsampling)


def zipformer_encode(params, feats, feat_lengths, cfg: ZipformerConfig):
    """Encode log-mel features.

    Args:
      params: tree from init_zipformer (or the JAX package, via the bridge)
      feats: [B, T, feat_in] float
      feat_lengths: [B] int

    Returns (encoded [B, T_out, max(encoder_dim)] fp32, lengths [B] int32),
    T_out ≈ T / (2 · output_downsampling): 0.04 s per frame.
    """
    _check_supported(cfg)
    x, lengths = _embed(params["embed"], feats, feat_lengths.to(torch.int32), cfg)
    res_dt = getattr(torch, cfg.residual_dtype)
    x = x.to(res_dt)
    t1 = x.shape[1]
    dev = x.device
    valid = (torch.arange(t1, device=dev)[None, :] < lengths[:, None])[..., None]

    stack_outputs = []
    for si, stack in enumerate(params["stacks"]):
        ds = cfg.downsampling[si]
        x = _convert_channels(x, cfg.encoder_dim[si])
        stack_in = x
        ds_lengths = lengths
        if ds > 1:
            x, ds_lengths = _downsample(stack["ds_weights"], x, lengths, ds)
        t_ds = x.shape[1]
        mask = torch.arange(t_ds, device=dev)[None, :] < ds_lengths[:, None]
        pos_emb = torch.from_numpy(_compact_rel_pos(t_ds, cfg.pos_dim)).to(dev)
        x = x.to(res_dt)
        for i in range(cfg.num_layers[si]):
            y = _layer(_layer_params(stack["layers"], i), x, pos_emb, mask, si, cfg)
            x = torch.where(mask[..., None], y, 0).to(res_dt)
        if ds > 1:
            x = _upsample(x, t1, ds)
            x = bypass_apply(stack["out_bypass"], stack_in, x).to(res_dt)
        x = torch.where(valid, x, 0)
        stack_outputs.append(x)

    # the full-dim output from the widest channels available
    # (icefall _get_full_dim_output)
    pieces = [stack_outputs[-1]]
    cur_dim = cfg.encoder_dim[-1]
    for si in range(len(stack_outputs) - 2, -1, -1):
        d = cfg.encoder_dim[si]
        if d > cur_dim:
            pieces.append(stack_outputs[si][..., cur_dim:d])
            cur_dim = d
    out = torch.cat(pieces, dim=-1)

    # output downsample by averaging groups of frames (edge-padded)
    ods = cfg.output_downsampling
    if ods > 1:
        b, t, d = out.shape
        t_out = -(-t // ods)
        if t_out * ods > t:
            out = torch.cat([out, out[:, -1:].expand(b, t_out * ods - t, d)], dim=1)
        out = out.reshape(b, t_out, ods, d).mean(dim=2)
        lengths = -((-lengths) // ods)

    valid = (torch.arange(out.shape[1], device=dev)[None, :] < lengths[:, None])[..., None]
    return torch.where(valid, out, 0).to(torch.float32), lengths.to(torch.int32)
