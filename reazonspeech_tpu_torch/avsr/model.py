"""AVHuBERT encoder + seq2seq decoder (PyTorch), with greedy/beam generation.

The port of ``reazonspeech_tpu/avsr/model.py``. Architecture parity with the
reference models (pkg/avsr/src/avhubert/modeling_avhubert.py:40-391,
decoder.py:47-1102):

- AudioFeatureExtractor: one Linear 104→hidden;
- VideoFeatureExtractor: ResNet3D trunk + Linear 512→hidden;
- missing modality substituted with zeros; fusion by feature concat or add;
- layer_norm → post-extract projection → HuBERT-style transformer encoder
  (conv positional embedding, pre-LN "StableLayerNorm" blocks);
- decoder: token embedding (×√d), sinusoidal positions, pre-LN blocks with
  causal self-attention + cross-attention, tied lm_head;
- generation: greedy and beam search over fixed-shape KV caches
  [L, B, max_len, D], with the JAX package's semantics.

The loops are eager: each step is fixed-shape tensor work with no host
sync, elements that are done are masked, and the host checks for
termination once every ``CHECK_EVERY`` steps (extra steps after every
element is done change nothing). The beam's top-2k picks are a stable
descending sort, so ties go to the lower index as ``lax.top_k``'s do.

Everything runs in fp32, as every JAX container call does. GELU is the tanh
approximation: ``jax.nn.gelu``'s default, which the JAX package calls (the
reference's HF ``"gelu"`` is the erf form; ROADMAP.md, deliberate
differences).
"""

import math
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.from_jax import params_from_numpy
from ..device import param_device, resolve_device, set_fp32_matmul_policy
from ..models.layers import dense, dense_init, embedding_init, layer_norm, layer_norm_init
from .configuration_avhubert import AVHubertConfig
from .resnet3d import RESNET_OUT_DIM, init_resnet3d, resnet3d_apply

__all__ = ["AVHubertModel", "AVHubertForConditionalGeneration"]

CHECK_EVERY = 32  # decode steps between host-side termination checks
_NEG = -1e9  # score of an empty beam or pool slot
_F32_MIN = torch.finfo(torch.float32).min


def _gelu(x):
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(stack, i):
    """Layer ``i`` of a stacked [L, ...] tree (views)."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _layers(stack):
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_layer(stack, i) for i in range(leaf.shape[0])]


def _attn_init(gen, d, kv_dim, device):
    return {
        "q": dense_init(gen, d, d, device=device),
        "k": dense_init(gen, kv_dim, d, device=device),
        "v": dense_init(gen, kv_dim, d, device=device),
        "out": dense_init(gen, d, d, device=device),
    }


def _enc_layer_init(gen, cfg: AVHubertConfig, device):
    d, ffn = cfg.hidden_size, cfg.intermediate_size
    return {
        "attn_ln": layer_norm_init(d, device),
        "attn": _attn_init(gen, d, d, device),
        "ffn_ln": layer_norm_init(d, device),
        "ffn_in": dense_init(gen, d, ffn, device=device),
        "ffn_out": dense_init(gen, ffn, d, device=device),
    }


def _dec_layer_init(gen, cfg: AVHubertConfig, device):
    d, ffn = cfg.decoder_hidden_size, cfg.decoder_ffn_dim
    return {
        "self_ln": layer_norm_init(d, device),
        "self_attn": _attn_init(gen, d, d, device),
        "cross_ln": layer_norm_init(d, device),
        "cross_attn": _attn_init(gen, d, cfg.hidden_size, device),
        "ffn_ln": layer_norm_init(d, device),
        "ffn_in": dense_init(gen, d, ffn, device=device),
        "ffn_out": dense_init(gen, ffn, d, device=device),
    }


def _conv_pos_init(gen, d, kernel, groups, device):
    scale = 1.0 / math.sqrt(kernel * d / groups)

    def uniform(shape):
        return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * scale

    return {"w": uniform((kernel, d // groups, d)), "b": uniform((d,))}


def init_avhubert(gen, cfg: AVHubertConfig):
    """Random weights drawn from the torch.Generator ``gen``, on its device:
    the JAX package's tree and distributions (the values differ)."""
    device = gen.device
    d = cfg.hidden_size
    p = {
        "audio_proj": dense_init(gen, cfg.audio_feat_dim, d, device=device),
        "video_resnet": init_resnet3d(gen, cfg.resnet_relu_type, device),
        "video_proj": dense_init(gen, RESNET_OUT_DIM, d, device=device),
        "fuse_ln": layer_norm_init(cfg.fused_dim, device),
        "conv_pos": _conv_pos_init(gen, d, cfg.num_conv_pos_embeddings,
                                   cfg.num_conv_pos_embedding_groups, device),
        "enc_final_ln": layer_norm_init(d, device),
    }
    if cfg.fused_dim != d:
        p["post_proj"] = dense_init(gen, cfg.fused_dim, d, device=device)
    p["enc_layers"] = _stack([_enc_layer_init(gen, cfg, device)
                              for _ in range(cfg.num_hidden_layers)])
    dd = cfg.decoder_hidden_size
    p["embed_tokens"] = embedding_init(gen, cfg.vocab_size, dd, scale=0.02, device=device)
    p["dec_layers"] = _stack([_dec_layer_init(gen, cfg, device)
                              for _ in range(cfg.decoder_layers)])
    p["dec_final_ln"] = layer_norm_init(dd, device)
    if not cfg.tie_word_embeddings:
        p["lm_head"] = dense_init(gen, dd, cfg.vocab_size, bias=False, device=device)
    if cfg.ctc_loss_weight > 0:
        # auxiliary CTC head over encoder frames (reference trains with
        # ctc_loss_weight=0.3, configuration_avhubert.py:54)
        p["ctc_head"] = dense_init(gen, d, cfg.vocab_size + 1, device=device)
    return p


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attend(p_out, q, k, v, mask):
    """q: [B, Tq, H, dh], k/v: [B, Tk, H, dh], mask: broadcastable
    [B, Tq, Tk]; the softmax in fp32, then the output projection."""
    b, tq, heads, dh = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask[:, None], scores, _F32_MIN)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return dense(p_out, out.reshape(b, tq, heads * dh))


def _mha(p, q_in, kv_in, heads, mask=None):
    """q_in: [B, Tq, D], kv_in: [B, Tk, Dkv], mask: broadcastable [B, Tq, Tk]."""
    b, tq, d = q_in.shape
    dh = d // heads
    q = dense(p["q"], q_in).reshape(b, tq, heads, dh)
    k = dense(p["k"], kv_in).reshape(b, -1, heads, dh)
    v = dense(p["v"], kv_in).reshape(b, -1, heads, dh)
    return _attend(p["out"], q, k, v, mask)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _conv_pos_embed(p, x, groups):
    """HubertPositionalConvEmbedding: grouped Conv1d with padding K//2 and
    the even-kernel trailing-frame trim (HubertSamePadLayer)."""
    w = p["w"]  # [K, in/groups, out]
    k = w.shape[0]
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=k // 2, groups=groups)
    y = y.transpose(1, 2)
    if k % 2 == 0:
        y = y[:, :-1]
    if "b" in p:
        y = y + p["b"]
    return y


def _sinusoid_pos(t, d):
    """[t, d] fp32 table, computed in float64 numpy as the JAX package does."""
    pos = np.arange(t, dtype=np.float64)
    half = d // 2
    inv = np.exp(np.arange(half, dtype=np.float64) * (-np.log(10000.0) / max(half - 1, 1)))
    ang = pos[:, None] * inv[None, :]
    pe = np.zeros((t, d), np.float32)
    pe[:, 0:half] = np.sin(ang)
    pe[:, half: 2 * half] = np.cos(ang)
    return torch.from_numpy(pe)


def encode(params, cfg: AVHubertConfig, audio=None, video=None, lengths=None):
    """Fuse modalities and run the transformer encoder.

    Args:
      audio: [B, T, audio_feat_dim] or None
      video: [B, T, H, W] grayscale or None (missing modality -> zeros,
        reference modeling_avhubert.py:170-180)
      lengths: [B] valid frame counts (defaults to full)

    Returns:
      (hidden [B, T, hidden], mask [B, T])
    """
    if audio is None and video is None:
        raise ValueError("at least one of audio/video is required")

    if audio is not None:
        a = dense(params["audio_proj"], audio.to(torch.float32))
    if video is not None:
        v = dense(params["video_proj"], resnet3d_apply(params["video_resnet"], video))
    if audio is None:
        a = torch.zeros_like(v)
    if video is None:
        v = torch.zeros_like(a)

    x = torch.cat([a, v], dim=-1) if cfg.modality_fuse == "concat" else a + v
    x = layer_norm(params["fuse_ln"], x)
    if "post_proj" in params:
        x = dense(params["post_proj"], x)

    b, t, _ = x.shape
    if lengths is None:
        lengths = torch.full((b,), t, device=x.device)
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    x = torch.where(mask[..., None], x, 0.0)

    x = x + _gelu(_conv_pos_embed(params["conv_pos"], x, cfg.num_conv_pos_embedding_groups))

    heads = cfg.num_attention_heads
    attn_mask = mask[:, None, :]  # [B, 1(Tq), Tk]
    for lp in _layers(params["enc_layers"]):
        y = layer_norm(lp["attn_ln"], x)
        x = x + _mha(lp["attn"], y, y, heads, attn_mask)
        y = layer_norm(lp["ffn_ln"], x)
        x = x + dense(lp["ffn_out"], _gelu(dense(lp["ffn_in"], y)))
        x = torch.where(mask[..., None], x, 0.0)
    return layer_norm(params["enc_final_ln"], x), mask


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_layer(lp, h, enc, enc_mask, self_mask, heads):
    y = layer_norm(lp["self_ln"], h)
    h = h + _mha(lp["self_attn"], y, y, heads, self_mask)
    y = layer_norm(lp["cross_ln"], h)
    h = h + _mha(lp["cross_attn"], y, enc, heads, enc_mask)
    y = layer_norm(lp["ffn_ln"], h)
    return h + dense(lp["ffn_out"], _gelu(dense(lp["ffn_in"], y)))


def _embed(params, cfg, tokens):
    return params["embed_tokens"]["table"][tokens] * math.sqrt(cfg.decoder_hidden_size)


def decode_logits(params, cfg: AVHubertConfig, tokens, enc, enc_mask):
    """Teacher-forced decoder: tokens [B, U] -> logits [B, U, vocab]."""
    u = tokens.shape[1]
    x = _embed(params, cfg, tokens) + _sinusoid_pos(u, cfg.decoder_hidden_size).to(enc.device)
    causal = torch.tril(torch.ones((u, u), dtype=torch.bool, device=enc.device))[None]
    cross_mask = enc_mask[:, None, :]
    for lp in _layers(params["dec_layers"]):
        x = _dec_layer(lp, x, enc, cross_mask, causal, cfg.decoder_attention_heads)
    return _lm_head(params, cfg, layer_norm(params["dec_final_ln"], x))


def _lm_head(params, cfg, h):
    if cfg.tie_word_embeddings:
        return h @ params["embed_tokens"]["table"].T
    return dense(params["lm_head"], h)


# ---------------------------------------------------------------------------
# generation (greedy + beam) over fixed-shape KV caches
# ---------------------------------------------------------------------------


class _Decoder:
    """What every cached step of one generate call reads: the layers (views
    of the stacked tree), the position table, the step masks and the
    encoder output with its key mask."""

    def __init__(self, params, cfg, enc, enc_mask, max_length):
        dev = enc.device
        self.params, self.cfg = params, cfg
        self.layers = _layers(params["dec_layers"])
        self.enc, self.cross_mask = enc, enc_mask[:, None, :]
        self.pe = _sinusoid_pos(max_length, cfg.decoder_hidden_size).to(dev)
        # row ``pos`` is the self-attention mask of step ``pos`` (keys <= pos)
        self.valid = torch.tril(torch.ones((max_length, max_length), dtype=torch.bool,
                                           device=dev))
        self.max_length = max_length

    def caches(self, b):
        shape = (len(self.layers), b, self.max_length, self.cfg.decoder_hidden_size)
        dev = self.enc.device
        return torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)

    def step(self, tok, pos, kc, vc):
        """One decoder step. tok: [B] current token; pos: the step index (a
        host int); kc/vc: [L, B, max_len, D], written in place at ``pos``.
        Returns logits [B, vocab]."""
        cfg = self.cfg
        heads = cfg.decoder_attention_heads
        dd = cfg.decoder_hidden_size
        dh = dd // heads
        b = tok.shape[0]
        h = (_embed(self.params, cfg, tok) + self.pe[pos])[:, None, :]  # [B, 1, D]
        valid = self.valid[pos][None, None, :]  # [1, 1, max_len]
        for li, lp in enumerate(self.layers):
            y = layer_norm(lp["self_ln"], h)
            kc[li, :, pos] = dense(lp["self_attn"]["k"], y)[:, 0]
            vc[li, :, pos] = dense(lp["self_attn"]["v"], y)[:, 0]
            q = dense(lp["self_attn"]["q"], y).reshape(b, 1, heads, dh)
            kk = kc[li].reshape(b, self.max_length, heads, dh)
            vv = vc[li].reshape(b, self.max_length, heads, dh)
            h = h + _attend(lp["self_attn"]["out"], q, kk, vv, valid)
            y = layer_norm(lp["cross_ln"], h)
            h = h + _mha(lp["cross_attn"], y, self.enc, heads, self.cross_mask)
            y = layer_norm(lp["ffn_ln"], h)
            h = h + dense(lp["ffn_out"], _gelu(dense(lp["ffn_in"], y)))
        h = layer_norm(self.params["dec_final_ln"], h)
        return _lm_head(self.params, cfg, h)[:, 0]


def _chunks(max_length):
    """Step ranges between the host's termination checks."""
    for start in range(0, max_length, CHECK_EVERY):
        yield range(start, min(start + CHECK_EVERY, max_length))


def greedy_generate(params, cfg: AVHubertConfig, enc, enc_mask, max_length=128):
    """[B] greedy decode. Returns tokens [B, max_length] (eos-padded)."""
    b = enc.shape[0]
    eos = cfg.eos_token_id
    dec = _Decoder(params, cfg, enc, enc_mask, max_length)
    kc, vc = dec.caches(b)
    tokens = torch.full((b, max_length), eos, dtype=torch.long, device=enc.device)
    cur = torch.full((b,), cfg.bos_token_id, dtype=torch.long, device=enc.device)
    done = torch.zeros((b,), dtype=torch.bool, device=enc.device)
    for steps in _chunks(max_length):
        for pos in steps:
            nxt = dec.step(cur, pos, kc, vc).argmax(dim=-1)
            cur = torch.where(done, eos, nxt)
            tokens[:, pos] = cur
            done = done | (cur == eos)
        if bool(done.all()):
            break
    return tokens


def _top_candidates(cand, n):
    """The top ``n`` of each row in rank order, the lower index first on ties
    (as ``lax.top_k``): a stable descending sort (``torch.topk`` promises no
    order among equal values on CUDA)."""
    vals, idx = torch.sort(cand, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def _pool_insert(pool, bi, ins, cand_norm, cand_tokens, cand_count):
    """HF BeamHypotheses.add, in place: replace the worst slot when better
    (empty slots are -1e9 and always lose). ``ins`` masks per batch element."""
    pn, pt, pc = pool
    worst = pn.argmin(dim=1)  # [B], the first on ties
    old = pn[bi, worst]
    do = ins & (cand_norm > old)
    pn[bi, worst] = torch.where(do, cand_norm, old)
    pt[bi, worst] = torch.where(do[:, None], cand_tokens, pt[bi, worst])
    pc[bi, worst] = torch.where(do, cand_count, pc[bi, worst])


def beam_generate(params, cfg: AVHubertConfig, enc, enc_mask, num_beams=5, max_length=128,
                  length_penalty=1.0):
    """Beam search with HF ``BeamSearchScorer`` semantics (the reference's
    ``generate(num_beams=5)``, modeling_avhubert.py:330-370 + transformers
    beam_search), as the JAX package's ``beam_generate``:

    - per step the top 2·beam candidates are processed in rank order; an EOS
      candidate (rank < beam only) banks its running hypothesis into a
      worst-replaced pool of size ``beam`` scored
      ``sum_logprobs / len^length_penalty`` (len counts the decoder-start
      token, not the EOS); the first ``beam`` non-EOS candidates become the
      next beams;
    - early_stopping=False: a batch element finishes when its pool is full
      and the worst pooled score beats best_candidate/(cur_len+1)^penalty,
      else at ``max_length`` generated tokens, where the surviving beams are
      banked too.

    Returns the best hypothesis's generated tokens [B, max_length]
    (eos-padded; no leading bos)."""
    b = enc.shape[0]
    k = num_beams
    vocab = cfg.vocab_size
    eos = cfg.eos_token_id
    dev = enc.device
    bi = torch.arange(b, device=dev)

    dec = _Decoder(params, cfg, enc.repeat_interleave(k, dim=0),
                   enc_mask.repeat_interleave(k, dim=0), max_length)
    kc, vc = dec.caches(b * k)
    # lengths^penalty in fp32 on the device: entry n divides a score of a
    # hypothesis of n tokens (the decoder-start token included)
    norm = torch.arange(max_length + 2, dtype=torch.float32, device=dev) ** length_penalty
    tokens = torch.full((b, k, max_length), eos, dtype=torch.long, device=dev)
    scores = torch.tensor([0.0] + [_NEG] * (k - 1), device=dev).repeat(b, 1)
    cur = torch.full((b * k,), cfg.bos_token_id, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    pool = (torch.full((b, k), _NEG, device=dev),
            torch.full((b, k, max_length), eos, dtype=torch.long, device=dev),
            torch.zeros((b, k), dtype=torch.long, device=dev))  # generated tokens banked
    pos = 0
    for steps in _chunks(max_length):
        for pos in steps:
            logp = torch.log_softmax(dec.step(cur, pos, kc, vc), dim=-1).reshape(b, k, vocab)
            vals, idx = _top_candidates((scores[..., None] + logp).reshape(b, k * vocab), 2 * k)
            src = idx // vocab
            tok = idx % vocab
            is_eos = tok == eos

            # bank EOS candidates of rank < k (sequential worst-replacement,
            # exactly HF's in-order adds)
            for r in range(k):
                _pool_insert(pool, bi, ~done & is_eos[:, r], vals[:, r] / norm[pos + 1],
                             tokens[bi, src[:, r]], pos)

            # next beams: the first k non-EOS candidates in rank order
            keep = ~is_eos
            slot = torch.cumsum(keep.long(), dim=1) - 1
            valid = keep & (slot < k)
            slot_w = torch.where(valid, slot, k)  # column k is scratch
            new_scores = torch.full((b, k + 1), _NEG, device=dev).scatter_(
                1, slot_w, torch.where(valid, vals, _NEG))[:, :k]
            new_src = torch.zeros((b, k + 1), dtype=torch.long, device=dev).scatter_(
                1, slot_w, torch.where(valid, src, 0))[:, :k]
            new_tok = torch.full((b, k + 1), eos, dtype=torch.long, device=dev).scatter_(
                1, slot_w, torch.where(valid, tok, eos))[:, :k]

            # reorder the beam state (the whole cache pair, as the JAX
            # package does), append the new token
            gflat = (new_src + bi[:, None] * k).reshape(-1)
            kc, vc = kc.index_select(1, gflat), vc.index_select(1, gflat)
            new_tokens = tokens.gather(1, new_src[..., None].expand(b, k, max_length))
            new_tokens[:, :, pos] = new_tok

            # is_done (early_stopping=False)
            pool_full = (pool[0] > _NEG / 2).sum(dim=1) >= k
            worst = pool[0].min(dim=1).values
            done_now = pool_full & (worst >= vals[:, 0] / norm[pos + 2])

            # freeze finished elements; their caches go stale, which nothing
            # reads (every consumer of their logits is done-masked)
            scores = torch.where(done[:, None], scores, new_scores)
            tokens = torch.where(done[:, None, None], tokens, new_tokens)
            cur = torch.where(done.repeat_interleave(k), cur, new_tok.reshape(-1))
            done = done | done_now
        if bool(done.all()):
            break
    else:
        pos = max_length

    # finalize: elements that hit max_length bank their surviving beams
    if pos == max_length:
        for i in range(k):
            _pool_insert(pool, bi, ~done, scores[:, i] / norm[pos + 1], tokens[:, i], pos)

    pool_norm, pool_tokens, pool_count = pool
    best = pool_norm.argmax(dim=1)  # the first on ties
    out = pool_tokens[bi, best]
    cnt = pool_count[bi, best]
    # eos-pad beyond the hypothesis (HF appends eos when one was emitted;
    # the buffer is eos-padded either way, callers stop at the first eos)
    return torch.where(torch.arange(max_length, device=dev)[None, :] < cnt[:, None], out, eos)


# ---------------------------------------------------------------------------
# user-facing wrappers
# ---------------------------------------------------------------------------


def _entry_device(device):
    """``device`` resolved as the port's entry points do (None: CUDA, which
    raises without a GPU), with the fp32 policy (no TF32) set on CUDA."""
    device = resolve_device(device)
    if device.type == "cuda":
        set_fp32_matmul_policy()
    return device


def _tree_to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_device(v, device) for v in tree]
    return tree.to(device)


def _load_pretrained(cls, path, config=None, device=None):
    """Shared loader: a native param tree (.npz/.json from convert.store) or
    an HF checkpoint directory (config.json + safetensors/bin, converted on
    the fly)."""
    device = _entry_device(device)
    if os.path.isdir(path):
        from ..convert.hf_avhubert import convert_avhubert_checkpoint

        with tempfile.TemporaryDirectory() as td:
            params, cfg = convert_avhubert_checkpoint(path, os.path.join(td, "tree"), cfg=config)
        return cls(config=cfg, params=params_from_numpy(params, device))

    from ..convert.store import load_param_tree

    params, meta = load_param_tree(path)
    if config is None:
        cfg_dict = meta.get("cfg", {})
        config = AVHubertConfig(**cfg_dict) if cfg_dict else AVHubertConfig()
    return cls(config=config, params=params_from_numpy(params, device))


def _init(cls, gen, config, device):
    device = _entry_device(device)
    return cls(config=config, params=_tree_to_device(init_avhubert(gen, config), device))


class _AVHubertBase:
    """What both containers share: the device of ``params`` and the encoder."""

    @property
    def device(self):
        return param_device(self.params)

    def _input(self, x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(self.device)
        return torch.from_numpy(np.asarray(x)).to(self.device)

    def encoder(self, audio=None, video=None, lengths=None):
        """(hidden [B, T, hidden], mask [B, T]) on the model's device."""
        with torch.inference_mode():
            return encode(self.params, self.config, self._input(audio), self._input(video),
                          self._input(lengths))


@dataclass
class AVHubertModel(_AVHubertBase):
    """Encoder-only model (feature fusion + transformer)."""

    config: AVHubertConfig
    params: dict

    @classmethod
    def init(cls, gen, config: AVHubertConfig, device=None):
        """Random weights from the torch.Generator ``gen``, moved to
        ``device`` (default CUDA, which raises without a GPU)."""
        return _init(cls, gen, config, device)

    @classmethod
    def from_pretrained(cls, path, config: AVHubertConfig = None, device=None):
        return _load_pretrained(cls, path, config, device)

    def __call__(self, audio=None, video=None, lengths=None):
        return self.encoder(audio, video, lengths)


@dataclass
class AVHubertForConditionalGeneration(_AVHubertBase):
    """Seq2seq model with generate(), on the device of its params."""

    config: AVHubertConfig
    params: dict

    @classmethod
    def init(cls, gen, config: AVHubertConfig, device=None):
        """Random weights from the torch.Generator ``gen``, moved to
        ``device`` (default CUDA, which raises without a GPU)."""
        if config.vocab_size is None:
            raise ValueError("AVHubertForConditionalGeneration requires config.vocab_size")
        return _init(cls, gen, config, device)

    @classmethod
    def from_pretrained(cls, path, config: AVHubertConfig = None, device=None):
        """Load from a native param tree or an HF checkpoint directory
        (see _load_pretrained) onto ``device`` (default CUDA)."""
        return _load_pretrained(cls, path, config, device)

    def forward_logits(self, decoder_input_ids, audio=None, video=None, lengths=None):
        with torch.inference_mode():
            enc, mask = self.encoder(audio, video, lengths)
            return decode_logits(self.params, self.config, self._input(decoder_input_ids),
                                 enc, mask)

    def loss(self, decoder_input_ids, labels, audio=None, video=None, lengths=None):
        """Label-smoothed cross-entropy (reference modeling_avhubert.py:314-316),
        plus the auxiliary encoder CTC term weighted by config.ctc_loss_weight
        when a ctc_head is present. Differentiable in the params."""
        cfg = self.config
        enc, mask = encode(self.params, cfg, self._input(audio), self._input(video),
                           self._input(lengths))
        lbl = self._input(labels).long()
        logits = decode_logits(self.params, cfg, self._input(decoder_input_ids), enc, mask)
        logp = torch.log_softmax(logits, dim=-1)
        eps = cfg.label_smoothing
        nll = -logp.gather(-1, lbl[..., None])[..., 0]
        smooth = -logp.mean(dim=-1)
        ce = (1 - eps) * nll + eps * smooth
        pad_mask = lbl != cfg.pad_token_id
        loss = (ce * pad_mask).sum() / pad_mask.sum().clamp(min=1)

        w = cfg.ctc_loss_weight
        if w > 0 and "ctc_head" in self.params:
            ctc_logp = torch.log_softmax(dense(self.params["ctc_head"], enc), dim=-1)
            c = F.ctc_loss(ctc_logp.transpose(0, 1), lbl, mask.sum(dim=-1), pad_mask.sum(dim=-1),
                           blank=cfg.vocab_size,  # the extra last logit
                           reduction="none").mean()
            loss = (1 - w) * loss + w * c
        return loss

    def generate(self, audio=None, video=None, lengths=None, num_beams=5, max_length=128):
        """Tokens [B, max_length] (eos-padded, no leading bos) on the model's
        device: greedy at ``num_beams`` <= 1, else beam search."""
        with torch.inference_mode():
            enc, mask = self.encoder(audio, video, lengths)
            if num_beams <= 1:
                return greedy_generate(self.params, self.config, enc, mask, max_length)
            return beam_generate(self.params, self.config, enc, mask, num_beams, max_length)
