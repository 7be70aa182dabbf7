"""Convert an ESPnet Conformer-Transducer checkpoint (reazonspeech-espnet-v2)
into this framework's param tree.

A copy of ``reazonspeech_tpu/convert/espnet_conformer.py`` with the same
behaviour and output, written by the port's store; the per-block trees are
stacked with ``stack_trees``.

The reference loads this through ESPnet's Speech2Text
(pkg/espnet-asr/src/transcribe.py:27-32). Input: the ``.pth`` state dict with
ESPnet naming:

    encoder.embed.conv.{0,2}.{weight,bias}           Conv2dSubsampling
    encoder.embed.out.0.{weight,bias}                flatten projection
    encoder.encoders.N.feed_forward.w_{1,2} / norm_ff
    encoder.encoders.N.feed_forward_macaron.w_{1,2} / norm_ff_macaron
    encoder.encoders.N.self_attn.{linear_q,linear_k,linear_v,linear_out,
        linear_pos,pos_bias_u,pos_bias_v} / norm_mha
    encoder.encoders.N.conv_module.{pointwise_conv1,depthwise_conv,norm,
        pointwise_conv2} / norm_conv
    encoder.encoders.N.norm_final
    encoder.after_norm
    ctc.ctc_lo.{weight,bias}
    decoder.* / joint_network.*                      (transducer variants)

ESPnet's macaron order is FFN_macaron → MHSA → conv → FFN, mapping onto our
block as ffn1 = feed_forward_macaron, ffn2 = feed_forward.
"""

import os

import numpy as np

from ..models.fastconformer import FastConformerConfig
from .store import save_param_tree
from .torch_utils import (
    t_conv1d,
    t_conv2d,
    t_depthwise_conv1d,
    t_flatten_proj,
    t_layer_norm,
    stack_trees,
    t_linear,
    t_lstm_layer,
    to_numpy,
)

__all__ = ["convert_espnet_state_dict", "convert_espnet_checkpoint"]


def _ln(sd, prefix):
    return t_layer_norm(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])


def _lin(sd, prefix, bias=True):
    return t_linear(sd[f"{prefix}.weight"], sd.get(f"{prefix}.bias") if bias else None)


def convert_espnet_state_dict(sd, enc_cfg: FastConformerConfig, num_tokens=None):
    sd = {k: to_numpy(v) for k, v in sd.items()}

    sub = {
        "conv0": t_conv2d(sd["encoder.embed.conv.0.weight"], sd.get("encoder.embed.conv.0.bias")),
        "conv1": t_conv2d(sd["encoder.embed.conv.2.weight"], sd.get("encoder.embed.conv.2.bias")),
    }
    sub["proj"] = t_flatten_proj(
        sd["encoder.embed.out.0.weight"], sd.get("encoder.embed.out.0.bias"),
        sd["encoder.embed.conv.2.weight"].shape[0],
    )

    blocks = []
    for n in range(enc_cfg.num_layers):
        p = f"encoder.encoders.{n}"
        blk = {
            "ffn1_ln": _ln(sd, f"{p}.norm_ff_macaron"),
            "ffn1_in": _lin(sd, f"{p}.feed_forward_macaron.w_1"),
            "ffn1_out": _lin(sd, f"{p}.feed_forward_macaron.w_2"),
            "attn_ln": _ln(sd, f"{p}.norm_mha"),
            "attn_q": _lin(sd, f"{p}.self_attn.linear_q"),
            "attn_k": _lin(sd, f"{p}.self_attn.linear_k"),
            "attn_v": _lin(sd, f"{p}.self_attn.linear_v"),
            "attn_out": _lin(sd, f"{p}.self_attn.linear_out"),
            "attn_pos": _lin(sd, f"{p}.self_attn.linear_pos", bias=False),
            "attn_bias_u": sd[f"{p}.self_attn.pos_bias_u"],
            "attn_bias_v": sd[f"{p}.self_attn.pos_bias_v"],
            "conv_ln": _ln(sd, f"{p}.norm_conv"),
            "conv_in": t_conv1d(
                sd[f"{p}.conv_module.pointwise_conv1.weight"],
                sd.get(f"{p}.conv_module.pointwise_conv1.bias"),
            ),
            "conv_dw": t_depthwise_conv1d(
                sd[f"{p}.conv_module.depthwise_conv.weight"],
                sd.get(f"{p}.conv_module.depthwise_conv.bias"),
            ),
            # espnet conv module uses a norm (layer/batch depending on
            # recipe); our espnet preset uses layer_norm
            "conv_bn": _ln(sd, f"{p}.conv_module.norm"),
            "conv_out": t_conv1d(
                sd[f"{p}.conv_module.pointwise_conv2.weight"],
                sd.get(f"{p}.conv_module.pointwise_conv2.bias"),
            ),
            "ffn2_ln": _ln(sd, f"{p}.norm_ff"),
            "ffn2_in": _lin(sd, f"{p}.feed_forward.w_1"),
            "ffn2_out": _lin(sd, f"{p}.feed_forward.w_2"),
            "final_ln": _ln(sd, f"{p}.norm_final"),
        }
        blocks.append(blk)
    stacked = stack_trees(blocks)

    params = {"encoder": {"subsampling": sub, "blocks": stacked}}
    if "encoder.after_norm.weight" in sd:
        params["encoder"]["after_norm"] = _ln(sd, "encoder.after_norm")
    if "ctc.ctc_lo.weight" in sd:
        params["ctc"] = {"out": _lin(sd, "ctc.ctc_lo")}

    # --- transducer prediction network + joint (espnet2 TransducerDecoder /
    # JointNetwork naming: decoder.embed, decoder.decoder.{i}.*_l0,
    # joint_network.lin_{enc,dec,out})
    if "decoder.embed.weight" in sd:
        lstm = []
        i = 0
        while f"decoder.decoder.{i}.weight_ih_l0" in sd:
            lstm.append(
                t_lstm_layer(
                    sd[f"decoder.decoder.{i}.weight_ih_l0"],
                    sd[f"decoder.decoder.{i}.weight_hh_l0"],
                    sd[f"decoder.decoder.{i}.bias_ih_l0"],
                    sd[f"decoder.decoder.{i}.bias_hh_l0"],
                )
            )
            i += 1
        params["predictor"] = {
            "embed": {"table": sd["decoder.embed.weight"]},
            "lstm": lstm,
        }
    if "joint_network.lin_out.weight" in sd:
        params["joint"] = {
            "enc": _lin(sd, "joint_network.lin_enc"),
            "pred": _lin(sd, "joint_network.lin_dec"),
            "out": _lin(sd, "joint_network.lin_out"),
        }
    return params


def read_espnet_config(config_yaml):
    """Parse an ESPnet experiment config.yaml: (token_list, encoder_conf).

    The zoo layout ships the training config next to the .pth
    (exp/<run>/config.yaml); token_list is the authoritative vocabulary
    (blank first, <sos/eos> last — espnet2 convention)."""
    import yaml

    with open(config_yaml) as f:
        cfg = yaml.safe_load(f)
    return cfg.get("token_list"), cfg.get("encoder_conf") or {}


def infer_config_from_espnet(encoder_conf):
    """Derive a FastConformerConfig (espnet preset) from encoder_conf."""
    from ..models.conformer import espnet_encoder_config

    kw = {}
    if "output_size" in encoder_conf:
        kw["d_model"] = encoder_conf["output_size"]
        # ESPnet Conv2dSubsampling uses odim (= output_size) as its conv
        # channel count; recording the preset default instead would persist
        # a meta enc_cfg whose re-init shapes mismatch the checkpoint
        kw["subsampling_channels"] = encoder_conf["output_size"]
    if "attention_heads" in encoder_conf:
        kw["num_heads"] = encoder_conf["attention_heads"]
    if "num_blocks" in encoder_conf:
        kw["num_layers"] = encoder_conf["num_blocks"]
    if "linear_units" in encoder_conf and "output_size" in encoder_conf:
        kw["ff_expansion"] = encoder_conf["linear_units"] // encoder_conf["output_size"]
    if "cnn_module_kernel" in encoder_conf:
        kw["conv_kernel"] = encoder_conf["cnn_module_kernel"]
    return espnet_encoder_config(**kw)


def load_global_mvn_stats(config_yaml):
    """Locate and load GlobalMVN feature-normalization stats when the config
    pins ``normalize: global_mvn`` (the published reazonspeech-espnet-v2
    recipe normalizes log-mel features with corpus statistics — without them
    real weights decode garbage). Accepts every espnet2 GlobalMVN stats
    layout: {count,sum,sum_square} npz, {mean,std} npz, and the legacy
    [2, D+1] array. The recorded stats_file path is usually the training
    machine's absolute path, so the basename is searched next to the config.

    Returns {"mean": [D], "std": [D]} (np.float32) or None."""
    import glob as _glob

    import yaml

    with open(config_yaml) as f:
        cfg = yaml.safe_load(f)
    if (cfg or {}).get("normalize") != "global_mvn":
        return None
    conf = cfg.get("normalize_conf") or {}
    base = os.path.dirname(os.path.abspath(config_yaml))
    cands = []
    rec = conf.get("stats_file")
    if rec:
        cands += [rec, os.path.join(base, os.path.basename(rec))]
    cands += sorted(_glob.glob(os.path.join(base, "**", "*stats*.npz"),
                               recursive=True))
    for cand in cands:
        if cand and os.path.exists(cand):
            stats = np.load(cand)
            if isinstance(stats, np.ndarray):  # legacy [2, D+1]
                count = stats[0].flatten()[-1]
                mean = stats[0, :-1] / count
                var = stats[1, :-1] / count - mean * mean
            elif "count" in stats:
                count = float(np.asarray(stats["count"]).reshape(-1)[0])
                mean = np.asarray(stats["sum"], np.float64).reshape(-1) / count
                var = (np.asarray(stats["sum_square"], np.float64).reshape(-1)
                       / count - mean * mean)
            elif "mean" in stats:
                mean = np.asarray(stats["mean"], np.float64).reshape(-1)
                var = np.square(
                    np.asarray(stats["std"], np.float64).reshape(-1))
            else:
                continue
            std = np.sqrt(np.maximum(var, 1.0e-20))
            return {"mean": mean.astype(np.float32),
                    "std": std.astype(np.float32)}
    raise FileNotFoundError(
        f"{config_yaml} pins normalize: global_mvn but no stats npz was "
        "found next to it — download feats_stats.npz from the model repo")


def convert_espnet_checkpoint(pth_path, out_path, enc_cfg=None, config_yaml=None):
    import torch

    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    token_list = None
    mvn = None
    if config_yaml:
        token_list, encoder_conf = read_espnet_config(config_yaml)
        if enc_cfg is None:
            enc_cfg = infer_config_from_espnet(encoder_conf)
        mvn = load_global_mvn_stats(config_yaml)
    if enc_cfg is None:
        from ..models.conformer import espnet_encoder_config

        enc_cfg = espnet_encoder_config()
    params = convert_espnet_state_dict(sd, enc_cfg)
    if mvn is not None:
        params["normalize"] = mvn
    meta = {
        "flavor": "espnet",
        "enc_cfg": {k: getattr(enc_cfg, k) for k in enc_cfg.__dataclass_fields__},
    }
    if mvn is not None:
        meta["normalize"] = "global_mvn"
    if "predictor" in params and "joint" in params:
        # espnet2 transducer conventions: LSTM predictor, blank id 0 sharing
        # the embedding table, tanh joint (JointNetwork default)
        meta["rnnt_cfg"] = {
            "vocab_size": int(params["predictor"]["embed"]["table"].shape[0]),
            "enc_dim": enc_cfg.d_model,
            "pred_hidden": int(params["predictor"]["lstm"][0]["w_hh"].shape[0]),
            "pred_rnn_layers": len(params["predictor"]["lstm"]),
            "joint_hidden": int(params["joint"]["out"]["w"].shape[0]),
            "joint_activation": "tanh",
            "predictor_kind": "lstm",
            "blank_position": "first",
        }
    if token_list:
        meta["token_list"] = token_list
    save_param_tree(out_path, params, meta)
    return params, enc_cfg
