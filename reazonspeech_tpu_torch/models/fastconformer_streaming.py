"""Streaming (cache-based) FastConformer inference (PyTorch).

Port of ``reazonspeech_tpu.models.fastconformer_streaming``: the
latency-bounded streaming mode of the offline encoder.

- audio arrives in fixed mel chunks (``chunk_frames`` encoder frames after
  8× subsampling);
- each Conformer block attends over [left-context cache ‖ current chunk]
  keys (chunk-wise attention) and runs a CAUSAL depthwise conv fed by a
  per-layer conv cache;
- the subsampling stack sees a small mel-frame cache so chunk boundaries
  don't lose its receptive field;
- all caches are fixed-shape tensors on the params' device (the JAX
  package's keys and shapes), so one :func:`streaming_step` is the same
  work at every chunk, and :func:`streaming_encode` steps a whole
  utterance through it (bit-identical to stepping by hand).

The numerics are the JAX package's: an fp32 stream and fp32 caches, K/V
from the layer-normed ``[x_cache ‖ chunk]``, bf16 (compute-dtype)
projections whose score and value products accumulate in fp32, invalid
cache slots and future chunk frames masked with fp32's most negative
value, and the encoder's ``after_norm`` after the block loop. The blocks
run the port's ``fastconformer`` helpers: the FFNs through ``_ffn``, so
with ``lnd_impl="pallas"`` on CUDA each FFN-in is the ``ln_dense`` kernel
(``csrc/ln_dense.cu``, two launches a block a chunk at M = B ×
``chunk_frames`` rows); the rest is plain PyTorch, as the JAX module is
XLA.

Streaming outputs deliberately differ from the offline encoder (no right
context); accuracy at a given latency is a property of streaming-trained
weights. The defining property — future audio cannot change past outputs —
is tested.
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import param_device, resolve_device
from .fastconformer import (
    FastConformerConfig, _check_supported, _ffn, _layer, _sinusoid_rel_pos, _subsample,
)
from .layers import (
    batch_norm_infer, conv1d, dense, depthwise_conv1d, glu, layer_norm, swish,
)

__all__ = ["StreamingConfig", "streaming_init_state", "streaming_step", "streaming_encode"]

# mel frames per encoder frame (the nemo encoder's 8x dw-striding subsampling)
_MEL_PER_FRAME = 8


@dataclass(frozen=True)
class StreamingConfig:
    # encoder frames produced per step (x8 mel frames consumed): 16 -> 1.28 s
    chunk_frames: int = 16
    # encoder frames of attention left context kept per layer
    left_context: int = 64
    # mel frames of subsampling context (receptive field of the conv stack)
    sub_context: int = 16


def streaming_init_state(cfg: FastConformerConfig, scfg: StreamingConfig, batch: int,
                         device=None):
    """Fresh streaming caches for a batch, on ``device`` (None: the card;
    pass the params' device, ``"cpu"`` on the CPU)."""
    dev = resolve_device(device)
    d, k, n_layers = cfg.d_model, cfg.conv_kernel, cfg.num_layers
    f32 = torch.float32
    return {
        "mel_cache": torch.zeros((batch, scfg.sub_context, cfg.feat_in), dtype=f32, device=dev),
        # per-layer attention K/V caches hold the layer INPUT activations of
        # the last `left_context` encoder frames (projections recomputed —
        # keeps the cache layout independent of head packing)
        "x_cache": torch.zeros((n_layers, batch, scfg.left_context, d), dtype=f32, device=dev),
        # per-layer causal-conv cache (kernel-1 frames)
        "conv_cache": torch.zeros((n_layers, batch, k - 1, d), dtype=f32, device=dev),
        # frames seen so far (drives validity masks for the first chunks)
        "frames_seen": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


@functools.lru_cache(maxsize=8)
def _rel_pos_table(t, d_model, device):
    """The [2t-1, d] sinusoid table, made once per (t, d, device): every
    layer of every step uses the same one (no host-to-device copy a step)."""
    return _sinusoid_rel_pos(t, d_model, device)


def _streaming_attention(p, x, x_cache, cache_valid, pos_emb, cfg: FastConformerConfig):
    """Chunk-wise attention: queries = current chunk, keys/values =
    [cache ‖ chunk]. cache_valid: [B] number of valid cache frames;
    pos_emb: the [2(L+C)-1, D] relative table."""
    b, c, d = x.shape
    l = x_cache.shape[1]
    h, dh, dt, f32 = cfg.num_heads, cfg.head_dim, cfg.dtype, torch.float32
    dev = x.device

    y = layer_norm(p["attn_ln"], x).to(dt)
    ycache = layer_norm(p["attn_ln"], x_cache).to(dt)
    keys_in = torch.cat([ycache, y], dim=1)  # [B, L+C, D]

    q = dense(p["attn_q"], y, dtype=dt).reshape(b, c, h, dh)
    k = dense(p["attn_k"], keys_in, dtype=dt).reshape(b, l + c, h, dh)
    v = dense(p["attn_v"], keys_in, dtype=dt).reshape(b, l + c, h, dh)

    qu = q + p["attn_bias_u"].to(dt)
    qv = q + p["attn_bias_v"].to(dt)

    # compute-dtype operands, fp32 products and sums
    ac = torch.einsum("bqhd,bkhd->bhqk", qu.to(f32), k.to(f32))

    # relative positions: query i (global L+i) vs key j -> offset (L+i) - j;
    # table ordered [max_off ... -(T-1)], so table index = (T-1) - off
    t_all = l + c
    pos = dense(p["attn_pos"], pos_emb, dtype=dt).reshape(-1, h, dh)
    bd_full = torch.einsum("bqhd,ohd->bhqo", qv.to(f32), pos.to(f32))
    qi = torch.arange(c, device=dev)[:, None]
    kj = torch.arange(t_all, device=dev)[None, :]
    idx = (t_all - 1) - ((l + qi) - kj)  # [C, L+C]
    bd = torch.gather(bd_full, 3, idx.expand(b, h, c, t_all))

    scores = (ac + bd) / math.sqrt(dh)
    # mask: cache frames beyond cache_valid (stored right-aligned) + causal
    # within the chunk (queries can't see future chunk frames)
    cache_ok = kj[None] >= (l - cache_valid[:, None, None])  # [B, 1, L+C]
    causal = kj <= (l + qi)  # [C, L+C]
    mask = cache_ok & causal[None]
    scores = torch.where(mask[:, None], scores, torch.finfo(f32).min)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(f32), v.to(f32))
    return dense(p["attn_out"], out.to(dt).reshape(b, c, d), dtype=dt)


def _streaming_conv(p, x, conv_cache, cfg: FastConformerConfig):
    """Causal conv module: depthwise conv left-padded with the cache.
    Returns (out, new cache = the last K-1 GLU outputs in fp32)."""
    dt = cfg.dtype
    y = layer_norm(p["conv_ln"], x).to(dt)
    y = glu(conv1d(p["conv_in"], y, dtype=dt))
    full = torch.cat([conv_cache.to(dt), y], dim=1)
    new_cache = full[:, -(cfg.conv_kernel - 1):].to(torch.float32)
    y = depthwise_conv1d(p["conv_dw"], full, dtype=dt, padding="VALID")
    if cfg.conv_norm == "batch_norm":
        y = batch_norm_infer(p["conv_bn"], y).to(dt)
    else:
        y = layer_norm(p["conv_bn"], y)
    y = swish(y)
    return conv1d(p["conv_out"], y, dtype=dt), new_cache


def _streaming_block(p, x, x_cache, conv_cache, cache_valid, pos_emb, cfg):
    x = x + 0.5 * _ffn(p, "ffn1", x, cfg)
    x = x + _streaming_attention(p, x, x_cache, cache_valid, pos_emb, cfg)
    conv_out, new_conv_cache = _streaming_conv(p, x, conv_cache, cfg)
    x = x + conv_out
    x = x + 0.5 * _ffn(p, "ffn2", x, cfg)
    return layer_norm(p["final_ln"], x), new_conv_cache


@torch.inference_mode()
def streaming_step(params, state, mel_chunk, cfg: FastConformerConfig,
                   scfg: StreamingConfig):
    """Process one mel chunk.

    Args:
      state: caches from streaming_init_state / a previous step (on the
        params' device)
      mel_chunk: [B, 8*chunk_frames, feat_in] log-mel frames (the frontend's
        per_feature normalization must be disabled or computed streaming-side)

    Returns:
      (enc_chunk [B, chunk_frames, d_model] fp32, new_state)
    """
    _check_supported(cfg)
    f32 = torch.float32
    dev = state["mel_cache"].device
    b = mel_chunk.shape[0]
    c = scfg.chunk_frames
    sub_in = torch.cat([state["mel_cache"], mel_chunk.to(dev, f32)], dim=1)
    new_mel_cache = sub_in[:, -scfg.sub_context:]
    lengths = torch.full((b,), sub_in.shape[1], dtype=torch.int32, device=dev)
    x, _ = _subsample(params["subsampling"], sub_in, lengths, cfg)
    x = x[:, -c:]  # keep the chunk's own encoder frames
    if cfg.xscaling:
        # the reference multiplies by a numpy float32 scalar, which promotes
        # the compute-dtype stream to fp32
        x = x.to(f32) * np.float32(np.sqrt(cfg.d_model)).item()
    x = x.to(f32)

    cache_valid = torch.clamp(state["frames_seen"], max=scfg.left_context)
    pos_emb = _rel_pos_table(scfg.left_context + c, cfg.d_model, dev)

    new_x_caches = []
    new_conv_caches = []
    for li in range(cfg.num_layers):
        lp = _layer(params["blocks"], li)
        x_cache = state["x_cache"][li]
        # the cache stores this layer's INPUT frames; update right-aligned
        new_x_caches.append(torch.cat([x_cache, x], dim=1)[:, -scfg.left_context:])
        x_new, new_conv = _streaming_block(
            lp, x, x_cache, state["conv_cache"][li], cache_valid, pos_emb, cfg)
        new_conv_caches.append(new_conv)
        x = x_new.to(f32)

    new_state = {
        "mel_cache": new_mel_cache,
        "x_cache": torch.stack(new_x_caches),
        "conv_cache": torch.stack(new_conv_caches),
        "frames_seen": state["frames_seen"] + c,
    }
    if cfg.final_norm:
        x = layer_norm(params["after_norm"], x)
    return x, new_state


def streaming_encode(params, feats, cfg: FastConformerConfig,
                     scfg: StreamingConfig = StreamingConfig()):
    """Encode a whole utterance chunk by chunk through :func:`streaming_step`
    (bit-identical to stepping by hand; useful for simulating streaming and
    for O(T·L) long-form encoding), on the params' device.

    feats: [B, T_mel, feat_in]; T_mel is truncated to a multiple of
    8·chunk_frames. Returns [B, T_enc, d_model] fp32.
    """
    dev = param_device(params)
    b, t_mel, _ = feats.shape
    mel_per_chunk = _MEL_PER_FRAME * scfg.chunk_frames
    state = streaming_init_state(cfg, scfg, b, device=dev)
    outs = []
    for i in range(t_mel // mel_per_chunk):
        chunk = feats[:, i * mel_per_chunk:(i + 1) * mel_per_chunk]
        out, state = streaming_step(params, state, chunk, cfg, scfg)
        outs.append(out)
    if not outs:
        return torch.zeros((b, 0, cfg.d_model), dtype=torch.float32, device=dev)
    return torch.cat(outs, dim=1)
