"""Convert a NeMo EncDecRNNTBPEModel checkpoint (reazonspeech-nemo-v2) into
this framework's FastConformer-RNNT param tree.

A copy of ``reazonspeech_tpu/convert/nemo_fastconformer.py`` with the same
behaviour and output, written by the port's store; the per-block trees are
stacked with ``stack_trees``.

The reference loads this model through NeMo (pkg/nemo-asr/src/transcribe.py:26-28).
Input: a ``.nemo`` tar (model_config.yaml + model_weights.ckpt + tokenizer
.model) or an already-loaded torch state dict with NeMo's module naming:

    encoder.pre_encode.conv.{idx}.{weight,bias}      dw-striding conv stack
    encoder.pre_encode.out.{weight,bias}             flatten projection
    encoder.layers.N.norm_feed_forward1 / feed_forward1.linear{1,2}
    encoder.layers.N.norm_self_att / self_attn.{linear_q,linear_k,linear_v,
        linear_out,linear_pos,pos_bias_u,pos_bias_v}
    encoder.layers.N.norm_conv / conv.{pointwise_conv1,depthwise_conv,
        batch_norm,pointwise_conv2}
    encoder.layers.N.norm_feed_forward2 / feed_forward2.linear{1,2}
    encoder.layers.N.norm_out
    decoder.prediction.embed.weight
    decoder.prediction.dec_rnn.lstm.{weight_ih_l{k},weight_hh_l{k},
        bias_ih_l{k},bias_hh_l{k}}
    joint.enc.weight/bias  joint.pred.weight/bias  joint.joint_net.2.{weight,bias}
"""

import io
import os
import tarfile

import numpy as np

from ..models.fastconformer import FastConformerConfig
from ..models.rnnt import RNNTConfig
from .store import save_param_tree
from .torch_utils import (
    t_batch_norm,
    t_conv1d,
    t_conv2d,
    t_depthwise_conv1d,
    t_flatten_proj,
    t_layer_norm,
    t_linear,
    stack_trees,
    t_lstm_layer,
    to_numpy,
)

__all__ = ["convert_nemo_checkpoint", "convert_nemo_state_dict", "read_nemo_tar"]


def read_nemo_tar(path):
    """Extract (state_dict, config_dict, tokenizer_model_bytes) from a .nemo
    tar archive."""
    import torch
    import yaml

    state, config, tok = None, None, None
    with tarfile.open(path) as tar:
        for member in tar.getmembers():
            name = os.path.basename(member.name)
            if name == "model_weights.ckpt":
                state = torch.load(
                    io.BytesIO(tar.extractfile(member).read()),
                    map_location="cpu",
                    weights_only=True,
                )
            elif name == "model_config.yaml":
                config = yaml.safe_load(tar.extractfile(member))
            elif name.endswith(".model"):
                tok = tar.extractfile(member).read()
    if state is None:
        raise ValueError(f"model_weights.ckpt not found in {path}")
    return state, config, tok


def _ln(sd, prefix):
    return t_layer_norm(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])


def _lin(sd, prefix, bias=True):
    return t_linear(sd[f"{prefix}.weight"], sd.get(f"{prefix}.bias") if bias else None)


def convert_nemo_state_dict(sd, enc_cfg: FastConformerConfig, rnnt_cfg: RNNTConfig):
    """torch state dict (NeMo naming) -> our param tree."""
    sd = {k: to_numpy(v) for k, v in sd.items()}

    # --- subsampling: NeMo dw_striding pre_encode.conv is a Sequential:
    # [0] Conv2d full, [1] ReLU, then per extra stage: [i] depthwise Conv2d,
    # [i+1] pointwise Conv2d, [i+2] ReLU
    sub = {"conv0": t_conv2d(sd["encoder.pre_encode.conv.0.weight"],
                             sd.get("encoder.pre_encode.conv.0.bias"))}
    stages = int(np.log2(enc_cfg.subsampling_factor))
    idx = 2
    for i in range(1, stages):
        sub[f"dw{i}"] = t_conv2d(
            sd[f"encoder.pre_encode.conv.{idx}.weight"],
            sd.get(f"encoder.pre_encode.conv.{idx}.bias"),
        )
        sub[f"pw{i}"] = t_conv2d(
            sd[f"encoder.pre_encode.conv.{idx + 1}.weight"],
            sd.get(f"encoder.pre_encode.conv.{idx + 1}.bias"),
        )
        idx += 3
    channels = sd["encoder.pre_encode.conv.0.weight"].shape[0]
    sub["proj"] = t_flatten_proj(
        sd["encoder.pre_encode.out.weight"], sd.get("encoder.pre_encode.out.bias"),
        channels,
    )

    # --- blocks (stacked over layers)
    blocks = []
    for n in range(enc_cfg.num_layers):
        p = f"encoder.layers.{n}"
        blk = {
            "ffn1_ln": _ln(sd, f"{p}.norm_feed_forward1"),
            "ffn1_in": _lin(sd, f"{p}.feed_forward1.linear1"),
            "ffn1_out": _lin(sd, f"{p}.feed_forward1.linear2"),
            "attn_ln": _ln(sd, f"{p}.norm_self_att"),
            "attn_q": _lin(sd, f"{p}.self_attn.linear_q"),
            "attn_k": _lin(sd, f"{p}.self_attn.linear_k"),
            "attn_v": _lin(sd, f"{p}.self_attn.linear_v"),
            "attn_out": _lin(sd, f"{p}.self_attn.linear_out"),
            "attn_pos": _lin(sd, f"{p}.self_attn.linear_pos", bias=False),
            "attn_bias_u": sd[f"{p}.self_attn.pos_bias_u"],
            "attn_bias_v": sd[f"{p}.self_attn.pos_bias_v"],
            "conv_ln": _ln(sd, f"{p}.norm_conv"),
            "conv_in": t_conv1d(
                sd[f"{p}.conv.pointwise_conv1.weight"],
                sd.get(f"{p}.conv.pointwise_conv1.bias"),
            ),
            "conv_dw": t_depthwise_conv1d(
                sd[f"{p}.conv.depthwise_conv.weight"],
                sd.get(f"{p}.conv.depthwise_conv.bias"),
            ),
            "conv_bn": t_batch_norm(
                sd[f"{p}.conv.batch_norm.weight"],
                sd[f"{p}.conv.batch_norm.bias"],
                sd[f"{p}.conv.batch_norm.running_mean"],
                sd[f"{p}.conv.batch_norm.running_var"],
            ),
            "conv_out": t_conv1d(
                sd[f"{p}.conv.pointwise_conv2.weight"],
                sd.get(f"{p}.conv.pointwise_conv2.bias"),
            ),
            "ffn2_ln": _ln(sd, f"{p}.norm_feed_forward2"),
            "ffn2_in": _lin(sd, f"{p}.feed_forward2.linear1"),
            "ffn2_out": _lin(sd, f"{p}.feed_forward2.linear2"),
            "final_ln": _ln(sd, f"{p}.norm_out"),
        }
        blocks.append(blk)
    stacked = stack_trees(blocks)

    # --- prediction network + joint
    lstm = []
    for k in range(rnnt_cfg.pred_rnn_layers):
        lstm.append(
            t_lstm_layer(
                sd[f"decoder.prediction.dec_rnn.lstm.weight_ih_l{k}"],
                sd[f"decoder.prediction.dec_rnn.lstm.weight_hh_l{k}"],
                sd[f"decoder.prediction.dec_rnn.lstm.bias_ih_l{k}"],
                sd[f"decoder.prediction.dec_rnn.lstm.bias_hh_l{k}"],
            )
        )
    predictor = {
        "embed": {"table": sd["decoder.prediction.embed.weight"]},
        "lstm": lstm,
    }
    joint = {
        "enc": _lin(sd, "joint.enc"),
        "pred": _lin(sd, "joint.pred"),
        "out": _lin(sd, "joint.joint_net.2"),
    }

    return {
        "encoder": {"subsampling": sub, "blocks": stacked},
        "predictor": predictor,
        "joint": joint,
    }


def infer_configs_from_nemo(config):
    """Derive (FastConformerConfig, RNNTConfig) from a NeMo model_config dict."""
    enc = config["encoder"]
    dec = config["decoder"]
    joint = config["joint"]
    enc_cfg = FastConformerConfig(
        feat_in=enc.get("feat_in", 80),
        num_layers=enc["n_layers"],
        d_model=enc["d_model"],
        num_heads=enc["n_heads"],
        ff_expansion=enc.get("ff_expansion_factor", 4),
        conv_kernel=enc.get("conv_kernel_size", 9),
        subsampling_factor=enc.get("subsampling_factor", 8),
        subsampling_channels=enc.get("subsampling_conv_channels", 256),
    )
    num_classes = joint["num_classes"]
    rnnt_cfg = RNNTConfig(
        vocab_size=num_classes,
        enc_dim=enc_cfg.d_model,
        pred_hidden=dec["prednet"]["pred_hidden"],
        pred_rnn_layers=dec["prednet"].get("pred_rnn_layers", 1),
        joint_hidden=joint["jointnet"]["joint_hidden"],
        joint_activation=joint["jointnet"].get("activation", "relu"),
    )
    return enc_cfg, rnnt_cfg


def convert_nemo_checkpoint(nemo_path, out_path, enc_cfg=None, rnnt_cfg=None):
    """Convert a .nemo archive to a native param tree at out_path(.npz/.json).

    Returns (params, enc_cfg, rnnt_cfg)."""
    state, config, tok_bytes = read_nemo_tar(nemo_path)
    if enc_cfg is None or rnnt_cfg is None:
        enc_cfg, rnnt_cfg = infer_configs_from_nemo(config)
    params = convert_nemo_state_dict(state, enc_cfg, rnnt_cfg)

    meta = {
        "flavor": "nemo",
        "enc_cfg": {k: getattr(enc_cfg, k) for k in enc_cfg.__dataclass_fields__},
        "rnnt_cfg": {k: getattr(rnnt_cfg, k) for k in rnnt_cfg.__dataclass_fields__},
    }
    # preserve the checkpoint's own decoding section (strategy/beam size):
    # the published reazonspeech-nemo-v2 serves ALSD beam search
    # (pkg/nemo-asr/src/decode.py:33-40 strips its artifact), and load_model
    # mirrors whatever the archive pins
    decoding = config.get("decoding") or {}
    if decoding:
        beam = decoding.get("beam") or {}
        meta["decoding"] = {
            "strategy": decoding.get("strategy", "alsd"),
            "beam_size": beam.get("beam_size", 4),
            "alsd_max_target_len": beam.get("alsd_max_target_len", 1.0),
            "score_norm": beam.get(
                "score_norm", decoding.get("score_norm", True)),
        }
    if tok_bytes:
        tok_path = out_path + ".tokenizer.model"
        with open(tok_path, "wb") as f:
            f.write(tok_bytes)
        meta["tokenizer_model"] = tok_path
    save_param_tree(out_path, params, meta)
    return params, enc_cfg, rnnt_cfg
