"""The nemo family: FastConformer encoder, LSTM predictor, ALSD beam search.

What the benchmark needs of a configuration of this family: the weight
tree it makes (the port's layout: dense ``w`` [in, out], conv ``w`` HWIO or
[K, in, out], block leaves stacked [L, ...]), the program's model built
through the port's loader with those weights, the program's entry points,
the function that produces its encoder output (``ENCODER``, as the entry
calls it), the plain reference's encoder, and the FLOPs an utterance needs.
"""

import importlib
import math

from ..reference import fastconformer as ref_encoder

__all__ = ["ENCODER", "spec", "build", "transcribe_batch", "layers", "reference_encode",
           "flops"]

# the encoder as ``asr_forward`` calls it: (module, name)
ENCODER = ("reazonspeech_tpu_torch.nemo.asr.model", "fastconformer_encode")

LN_SPREAD = 0.1  # LayerNorm/batch-norm affines and attention biases: near neutral


def _dense(path, i, o, bias=True, stack=()):
    s = 1.0 / math.sqrt(i)
    out = [(path + ("w",), (*stack, i, o), "uniform", 0.0, s)]
    if bias:
        out.append((path + ("b",), (*stack, o), "uniform", 0.0, s))
    return out


def _conv(path, shape, fan_in, stack=()):
    s = 1.0 / math.sqrt(fan_in)
    return [(path + ("w",), (*stack, *shape), "uniform", 0.0, s),
            (path + ("b",), (*stack, shape[-1]), "uniform", 0.0, s)]


def _ln(path, d, stack=()):
    return [(path + ("scale",), (*stack, d), "uniform", 1.0, LN_SPREAD),
            (path + ("bias",), (*stack, d), "uniform", 0.0, LN_SPREAD)]


def spec(cfg):
    e, r = cfg["encoder"], cfg["rnnt"]
    d, L, h, c = e["d_model"], e["num_layers"], e["num_heads"], e["subsampling_channels"]
    dff, k = d * e["ff_expansion"], e["conv_kernel"]
    stages = int(math.log2(e["subsampling_factor"]))
    f_out = e["feat_in"]
    for _ in range(stages):
        f_out = (f_out - 1) // 2 + 1
    sub = ("encoder", "subsampling")
    leaves = _conv(sub + ("conv0",), (3, 3, 1, c), 9)
    for i in range(1, stages):
        leaves += _conv(sub + (f"dw{i}",), (3, 3, 1, c), 9)
        leaves += _conv(sub + (f"pw{i}",), (1, 1, c, c), c)
    leaves += _dense(sub + ("proj",), c * f_out, d)
    blk, st = ("encoder", "blocks"), (L,)
    for name in ("ffn1", "ffn2"):
        leaves += _ln(blk + (f"{name}_ln",), d, st)
        leaves += _dense(blk + (f"{name}_in",), d, dff, stack=st)
        leaves += _dense(blk + (f"{name}_out",), dff, d, stack=st)
    leaves += _ln(blk + ("attn_ln",), d, st)
    for name in ("attn_q", "attn_k", "attn_v", "attn_out"):
        leaves += _dense(blk + (name,), d, d, stack=st)
    leaves += _dense(blk + ("attn_pos",), d, d, bias=False, stack=st)
    for name in ("attn_bias_u", "attn_bias_v"):
        leaves.append((blk + (name,), (L, h, d // h), "uniform", 0.0, LN_SPREAD))
    leaves += _ln(blk + ("conv_ln",), d, st)
    leaves += _conv(blk + ("conv_in",), (1, d, 2 * d), d, st)
    leaves += _conv(blk + ("conv_dw",), (k, 1, d), k, st)
    leaves += _conv(blk + ("conv_out",), (1, d, d), d, st)
    bn = blk + ("conv_bn",)
    leaves += _ln(bn, d, st)
    leaves += [(bn + ("mean",), (L, d), "uniform", 0.0, LN_SPREAD),
               (bn + ("var",), (L, d), "uniform", 1.0, 2 * LN_SPREAD)]
    leaves += _ln(blk + ("final_ln",), d, st)
    hp, v = r["pred_hidden"], r["vocab_size"]
    leaves.append((("predictor", "embed", "table"), (v, hp), "normal", 1.0, 0.0))
    s = 1.0 / math.sqrt(hp)
    for li in range(r["pred_rnn_layers"]):
        lp = ("predictor", "lstm", li)
        leaves += [(lp + ("w_ih",), (hp, 4 * hp), "uniform", 0.0, s),
                   (lp + ("w_hh",), (hp, 4 * hp), "uniform", 0.0, s),
                   (lp + ("b_ih",), (4 * hp,), "uniform", 0.0, s),
                   (lp + ("b_hh",), (4 * hp,), "uniform", 0.0, s)]
    j = r["joint_hidden"]
    leaves += _dense(("joint", "enc"), d, j) + _dense(("joint", "pred"), hp, j)
    leaves += _dense(("joint", "out"), j, v + 1)
    return leaves


def build(cfg, params, device, seed):
    """The program's model as its loader serves it on ``device``, holding
    ``params``; raises where the loader's configuration is not ``cfg``."""
    from dataclasses import asdict

    from reazonspeech_tpu_torch.decoding.rnnt_beam import BeamDecodeConfig
    from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
    from reazonspeech_tpu_torch.nemo.asr.model import load_model

    program = importlib.import_module("reazonspeech_tpu_torch.nemo.asr.transcribe")
    dec, num = cfg["decoding"], cfg["numerics"]
    sizes = {}
    if device.type != "cuda":  # the tests' tiny sizes, on the plain formulas
        sizes = dict(
            enc_cfg=FastConformerConfig(**cfg["encoder"], compute_dtype=num["compute_dtype"],
                                        residual_dtype=num["residual_dtype"]),
            rnnt_cfg=RNNTConfig(**cfg["rnnt"], enc_dim=cfg["encoder"]["d_model"],
                                compute_dtype=num["compute_dtype"]))
    model = load_model(device=device, checkpoint="random", seed=seed, **sizes)
    enc, rnnt = asdict(model.enc_cfg), asdict(model.rnnt_cfg)
    want = {**cfg["encoder"], "compute_dtype": cfg["numerics"]["compute_dtype"],
            "residual_dtype": cfg["numerics"]["residual_dtype"]}
    got = {**enc, **rnnt}
    wrong = {k: (got.get(k), v) for k, v in {**want, **cfg["rnnt"]}.items()
             if k in got and got[k] != v and k != "enc_dim"}
    if not isinstance(model.decode_cfg, BeamDecodeConfig):
        wrong["strategy"] = (type(model.decode_cfg).__name__, dec["strategy"])
    else:
        for key in ("beam_size", "alsd_max_target_len", "score_norm"):
            if getattr(model.decode_cfg, key) != dec[key]:
                wrong[key] = (getattr(model.decode_cfg, key), dec[key])
    if program.PAD_SECONDS != cfg["pad_seconds"] or model.bucket_samples != cfg["bucket_samples"]:
        wrong["padding"] = ((program.PAD_SECONDS, model.bucket_samples),
                            (cfg["pad_seconds"], cfg["bucket_samples"]))
    if wrong:
        raise RuntimeError(f"the program's nemo configuration differs: {wrong}")
    model.params = params
    return model


def transcribe_batch(model, audios):
    from reazonspeech_tpu_torch.nemo.asr.transcribe import transcribe_batch as entry

    return entry(model, audios)


def layers(model):
    """(frontend, encoder, decode) of ``asr_forward``, on tensors."""
    from reazonspeech_tpu_torch.decoding.rnnt_beam import rnnt_beam_decode
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode

    p = model.params

    def decode(enc, lens):
        return rnnt_beam_decode(p["predictor"], p["joint"], enc, lens, model.rnnt_cfg,
                                model.decode_cfg)[:3]

    return (lambda wav, lens: log_mel_spectrogram(wav, lens, model.fe_cfg),
            lambda feats, lens: fastconformer_encode(p["encoder"], feats, lens, model.enc_cfg),
            decode)


def reference_encode(cfg, params, feats, feat_lengths, nm):
    return ref_encoder.encode(params["encoder"], feats, feat_lengths, cfg["encoder"], nm)


def flops(cfg, n_feat, n_enc, n_labels):
    """FLOPs one utterance needs: the encoder over its valid frames (every
    product, the attention's three T² products per head dimension, the
    convolutions' taps), the joint's encoder projection, and per alignment
    step (frames + labels, each beam row) the predictor and the joint."""
    e, r = cfg["encoder"], cfg["rnnt"]
    d, c, k = e["d_model"], e["subsampling_channels"], e["conv_kernel"]
    dff = d * e["ff_expansion"]
    total, t, f = 0.0, n_feat, e["feat_in"]
    for s in range(int(math.log2(e["subsampling_factor"]))):
        t, f = (t - 1) // 2 + 1, (f - 1) // 2 + 1
        total += t * f * (2 * 9 * c if s == 0 else 2 * 9 * c + 2 * c * c)
    total += n_enc * 2 * c * f * d
    per_frame = 8 * d * dff + 8 * d * d + 6 * d * d + 2 * k * d + 6 * n_enc * d
    total += e["num_layers"] * (n_enc * per_frame + 2 * (2 * n_enc - 1) * d * d)
    hp, j, v = r["pred_hidden"], r["joint_hidden"], r["vocab_size"] + 1
    total += n_enc * 2 * d * j
    rows = cfg["decoding"]["beam_size"]
    per_step = 2 * 2 * hp * 4 * hp + 2 * hp * j + 2 * j * v
    return total + (n_enc + n_labels) * rows * per_step
