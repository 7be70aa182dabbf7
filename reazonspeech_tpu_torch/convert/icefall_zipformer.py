"""Convert an icefall Zipformer2 checkpoint (.pt state dict) into this
framework's param tree — the canonical weight source for the k2 models
(published next to the sherpa ONNX exports the reference consumes,
pkg/k2-asr/src/huggingface.py:40-59).

A copy of ``reazonspeech_tpu/convert/icefall_zipformer.py`` with the same
behaviour and output, written by the port's store; each stack's per-layer
trees are stacked with ``stack_trees``.

Module-naming assumptions (icefall zipformer2; adjust the patterns below if a
real checkpoint reveals drift — the LAYOUT transforms are the invariant part):

    encoder_embed.conv.{i}.weight/bias       three Conv2d (indices discovered)
    encoder_embed.out.weight/bias            flatten projection
    encoder_embed.out_norm.{bias,log_scale}  BiasNorm
    encoder.encoders.{s}[.encoder].layers.{j}.
        self_attn_weights.in_proj.{weight,bias}   per-head (q,k,p) packed
        self_attn_weights.linear_pos.weight       pos_dim -> h*pos_head_dim
        self_attn{1,2}.in_proj/.out_proj          value attention
        nonlin_attention.in_proj/.out_proj
        feed_forward{1,2,3}.in_proj/.out_proj
        conv_module{1,2}.in_proj/.depthwise_conv/.out_proj
        norm.{bias,log_scale}                     BiasNorm
        bypass.bypass_scale / bypass_mid.bypass_scale
    encoder.encoders.{s}.downsample.bias          SimpleDownsample weights
    encoder.encoders.{s}.bypass.bypass_scale      stack output bypass
    decoder.embedding.weight / decoder.conv.weight (+bias)   stateless pred
    joiner.encoder_proj / joiner.decoder_proj / joiner.output_linear
"""

import re

import numpy as np

from ..models.rnnt import RNNTConfig
from ..models.zipformer import ZipformerConfig
from .store import save_param_tree
from .torch_utils import (
    stack_trees,
    t_conv2d,
    t_depthwise_conv1d,
    t_flatten_proj,
    t_linear,
    to_numpy,
)

__all__ = ["convert_icefall_state_dict", "convert_icefall_checkpoint"]


def _lin(sd, prefix, bias=True):
    return t_linear(sd[f"{prefix}.weight"], sd.get(f"{prefix}.bias") if bias else None)


def _bias_norm(sd, prefix):
    return {
        "bias": sd[f"{prefix}.bias"],
        "log_scale": np.asarray(sd[f"{prefix}.log_scale"]).reshape(()),
    }


def _bypass(sd, prefix):
    return {"scale": sd[f"{prefix}.bypass_scale"]}


def _layer_prefix(sd, s, j):
    for cand in (
        f"encoder.encoders.{s}.encoder.layers.{j}",
        f"encoder.encoders.{s}.layers.{j}",
    ):
        if f"{cand}.norm.bias" in sd:
            return cand
    raise KeyError(f"layer {s}.{j} not found in state dict")


def convert_icefall_state_dict(sd, enc_cfg: ZipformerConfig, rnnt_cfg: RNNTConfig = None):
    sd = {k: to_numpy(v) for k, v in sd.items()}

    # --- encoder embed: discover the Conv2d indices
    conv_keys = sorted(
        (int(m.group(1)) for k in sd if (m := re.fullmatch(r"encoder_embed\.conv\.(\d+)\.weight", k))),
    )
    if len(conv_keys) != 3:
        raise ValueError(f"expected 3 embed convs, found indices {conv_keys}")
    embed = {}
    for out_name, idx in zip(("conv0", "conv1", "conv2"), conv_keys):
        embed[out_name] = t_conv2d(
            sd[f"encoder_embed.conv.{idx}.weight"],
            sd.get(f"encoder_embed.conv.{idx}.bias"),
        )
    embed["proj"] = t_flatten_proj(
        sd["encoder_embed.out.weight"], sd.get("encoder_embed.out.bias"),
        sd[f"encoder_embed.conv.{conv_keys[-1]}.weight"].shape[0],
    )
    embed["norm"] = _bias_norm(sd, "encoder_embed.out_norm")

    # --- stacks
    stacks = []
    for s in range(len(enc_cfg.num_layers)):
        layers = []
        for j in range(enc_cfg.num_layers[s]):
            p = _layer_prefix(sd, s, j)
            layer = {
                "attn_qkp": _lin(sd, f"{p}.self_attn_weights.in_proj"),
                "attn_pos": _lin(sd, f"{p}.self_attn_weights.linear_pos", bias=False),
                "sa1_v": _lin(sd, f"{p}.self_attn1.in_proj"),
                "sa1_out": _lin(sd, f"{p}.self_attn1.out_proj"),
                "sa2_v": _lin(sd, f"{p}.self_attn2.in_proj"),
                "sa2_out": _lin(sd, f"{p}.self_attn2.out_proj"),
                "na_in": _lin(sd, f"{p}.nonlin_attention.in_proj"),
                "na_out": _lin(sd, f"{p}.nonlin_attention.out_proj"),
                "ff1_in": _lin(sd, f"{p}.feed_forward1.in_proj"),
                "ff1_out": _lin(sd, f"{p}.feed_forward1.out_proj"),
                "ff2_in": _lin(sd, f"{p}.feed_forward2.in_proj"),
                "ff2_out": _lin(sd, f"{p}.feed_forward2.out_proj"),
                "ff3_in": _lin(sd, f"{p}.feed_forward3.in_proj"),
                "ff3_out": _lin(sd, f"{p}.feed_forward3.out_proj"),
                "cv1_in": _lin(sd, f"{p}.conv_module1.in_proj"),
                "cv1_dw": t_depthwise_conv1d(
                    sd[f"{p}.conv_module1.depthwise_conv.weight"],
                    sd.get(f"{p}.conv_module1.depthwise_conv.bias"),
                ),
                "cv1_out": _lin(sd, f"{p}.conv_module1.out_proj"),
                "cv2_in": _lin(sd, f"{p}.conv_module2.in_proj"),
                "cv2_dw": t_depthwise_conv1d(
                    sd[f"{p}.conv_module2.depthwise_conv.weight"],
                    sd.get(f"{p}.conv_module2.depthwise_conv.bias"),
                ),
                "cv2_out": _lin(sd, f"{p}.conv_module2.out_proj"),
                "norm": _bias_norm(sd, f"{p}.norm"),
                "bypass_mid": _bypass(sd, f"{p}.bypass_mid"),
                "bypass": _bypass(sd, f"{p}.bypass"),
            }
            layers.append(layer)
        stack = {"layers": stack_trees(layers)}
        if enc_cfg.downsampling[s] > 1:
            stack["ds_weights"] = sd[f"encoder.encoders.{s}.downsample.bias"]
            stack["out_bypass"] = _bypass(sd, f"encoder.encoders.{s}.bypass")
        stacks.append(stack)

    params = {"encoder": {"embed": embed, "stacks": stacks}}

    # --- stateless predictor + joiner
    if rnnt_cfg is not None and "decoder.embedding.weight" in sd:
        ctx = rnnt_cfg.context_size
        conv = sd["decoder.conv.weight"]  # [D, D, ctx]
        d = conv.shape[0]
        params["predictor"] = {
            "embed": {"table": sd["decoder.embedding.weight"]},
            "ctx_proj": {
                "w": np.transpose(conv, (2, 1, 0)).reshape(ctx * d, d),
                "b": sd.get("decoder.conv.bias", np.zeros(d, np.float32)),
            },
        }
        params["joint"] = {
            "enc": _lin(sd, "joiner.encoder_proj"),
            "pred": _lin(sd, "joiner.decoder_proj"),
            "out": _lin(sd, "joiner.output_linear"),
        }
    return params


def convert_icefall_checkpoint(pt_path, out_path, enc_cfg=None, rnnt_cfg=None,
                               token_list=None):
    import torch

    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    enc_cfg = enc_cfg or ZipformerConfig.large()
    if rnnt_cfg is None and "decoder.embedding.weight" in sd:
        # derive the transducer dims from the checkpoint itself
        v, d = sd["decoder.embedding.weight"].shape
        ctx = sd["decoder.conv.weight"].shape[2]
        j = sd["joiner.output_linear.weight"].shape[1]  # torch [out, in]
        rnnt_cfg = RNNTConfig(
            vocab_size=int(v),
            enc_dim=enc_cfg.out_dim,
            pred_hidden=int(d),
            joint_hidden=int(j),
            joint_activation="tanh",
            predictor_kind="stateless",
            context_size=int(ctx),
        )
    params = convert_icefall_state_dict(sd, enc_cfg, rnnt_cfg)
    meta = {
        "flavor": "k2-zipformer",
        "enc_cfg": {k: getattr(enc_cfg, k) for k in enc_cfg.__dataclass_fields__},
    }
    if rnnt_cfg is not None:
        meta["rnnt_cfg"] = {
            k: getattr(rnnt_cfg, k) for k in rnnt_cfg.__dataclass_fields__
        }
    if token_list:
        meta["token_list"] = list(token_list)
    save_param_tree(out_path, params, meta)
    return params, enc_cfg
