"""Plain FastConformer encoder (NeMo's ConformerEncoder as nemo-v2 runs it).

dw-striding subsampling (a 3x3 conv of stride 2, then per further stage a
depthwise 3x3 of stride 2 and a pointwise conv, ReLU after each stage, SAME
padding of 1), a dense projection of the flattened channels × frequencies,
the stream scaled by sqrt(d_model); then per block ½FFN → rel-pos MHSA
(Transformer-XL, biases u and v) → conv module (pointwise GLU, padded frames
zeroed, depthwise conv, batch norm with running statistics, swish,
pointwise) → ½FFN → LayerNorm, padded frames zeroed. Everything in fp32;
the products through ``Numerics``.

The weights are the tree the benchmark makes (``families/nemo.py``): dense
``w`` [in, out], conv ``w`` HWIO or [K, in, out], block leaves stacked
[L, ...].
"""

import math

import numpy as np
import torch

__all__ = ["encode"]


def layer_norm(p, x, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def swish(x):
    return x * torch.sigmoid(x)


def rel_shift(x):
    """[B, H, T, 2T-1] over offsets T-1 … -(T-1) -> [B, H, T, T]:
    out[..., t, s] = x[..., t, T-1-t+s]."""
    t = x.shape[2]
    idx = (t - 1 - torch.arange(t, device=x.device)[:, None]
           + torch.arange(t, device=x.device)[None, :])
    return x.gather(-1, idx.expand(*x.shape[:2], t, t))


def sinusoid_rel_pos(t, d, device):
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)
    inv = np.exp(-np.arange(0, d, 2, dtype=np.float64) * (np.log(10000.0) / d))
    ang = pos[:, None] * inv[None, :]
    pe = np.zeros((2 * t - 1, d), dtype=np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return torch.from_numpy(pe).to(device)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def subsample(p, feats, lengths, cfg, nm):
    stages = int(math.log2(cfg["subsampling_factor"]))
    c = cfg["subsampling_channels"]
    pad = (1, 1, 1, 1)
    x = torch.relu(nm.conv2d(p["conv0"], feats[..., None], 2, pad))
    for i in range(1, stages):
        x = nm.conv2d(p[f"dw{i}"], x, 2, pad, groups=c)
        x = torch.relu(nm.conv2d(p[f"pw{i}"], x, 1))
    for _ in range(stages):
        lengths = (lengths - 1) // 2 + 1
    b, t, f, ch = x.shape
    return nm.dense(p["proj"], x.reshape(b, t, f * ch)), lengths


def mhsa(p, x, pos_emb, mask, cfg, nm):
    b, t, d = x.shape
    h = cfg["num_heads"]
    dh = d // h
    y = layer_norm(p["attn_ln"], x)
    q = nm.dense(p["attn_q"], y).reshape(b, t, h, dh)
    k = nm.dense(p["attn_k"], y).reshape(b, t, h, dh)
    v = nm.dense(p["attn_v"], y).reshape(b, t, h, dh)
    pos = nm.dense(p["attn_pos"], pos_emb).reshape(-1, h, dh)
    ac = nm.einsum("bthd,bshd->bhts", q + p["attn_bias_u"], k)
    bd = rel_shift(nm.einsum("bthd,lhd->bhtl", q + p["attn_bias_v"], pos))
    scores = (ac + bd) / math.sqrt(dh)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = nm.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, d)
    return nm.dense(p["attn_out"], out)


def conv_module(p, x, mask, nm):
    y = layer_norm(p["conv_ln"], x)
    y = nm.dense({"w": p["conv_in"]["w"][0], "b": p["conv_in"]["b"]}, y)
    a, g = y.chunk(2, dim=-1)
    y = torch.where(mask[..., None], a * torch.sigmoid(g), 0.0)
    w = p["conv_dw"]["w"]  # [K, 1, C]
    k = w.shape[0]
    yc = torch.nn.functional.pad(y.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
    y = torch.nn.functional.conv1d(yc, w.permute(2, 1, 0), groups=w.shape[2])
    y = y.transpose(1, 2) + p["conv_dw"]["b"]
    bn = p["conv_bn"]
    y = (y - bn["mean"]) * torch.rsqrt(bn["var"] + 1e-5) * bn["scale"] + bn["bias"]
    return nm.dense({"w": p["conv_out"]["w"][0], "b": p["conv_out"]["b"]}, swish(y))


def ffn(p, name, x, nm):
    y = swish(nm.dense(p[f"{name}_in"], layer_norm(p[f"{name}_ln"], x)))
    return nm.dense(p[f"{name}_out"], y)


def encode(params, feats, feat_lengths, cfg, nm):
    """feats [B, T, F] fp32 -> (enc [B, T', d] fp32, lengths [B])."""
    x, lengths = subsample(params["subsampling"], feats, feat_lengths.long(), cfg, nm)
    b, t, d = x.shape
    x = x * math.sqrt(d)
    pos_emb = sinusoid_rel_pos(t, d, x.device)
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    x = torch.where(mask[..., None], x, 0.0)
    for i in range(cfg["num_layers"]):
        p = _layer(params["blocks"], i)
        x = x + 0.5 * ffn(p, "ffn1", x, nm)
        x = x + mhsa(p, x, pos_emb, mask, cfg, nm)
        x = x + conv_module(p, x, mask, nm)
        x = x + 0.5 * ffn(p, "ffn2", x, nm)
        x = torch.where(mask[..., None], layer_norm(p["final_ln"], x), 0.0)
    return x, lengths
