"""Convert the HF AVHuBERT checkpoint (reazon-research AVSR, safetensors or
torch .bin) into this framework's AVSR param tree.

A copy of ``reazonspeech_tpu/convert/hf_avhubert.py`` with the same
behaviour and output, written by the port's store; the per-layer trees are
stacked with ``stack_trees``.

The reference registers these models into HF Auto classes
(pkg/avsr/src/__init__.py:25-35); its state dict follows the reference
modules (pkg/avsr/src/avhubert/modeling_avhubert.py, modeling_resnet.py,
decoder.py). Mapping below covers the inference path; training-only heads are
ignored.
"""

import numpy as np

from ..avsr.configuration_avhubert import AVHubertConfig
from .store import save_param_tree
from .torch_utils import (
    stack_trees,
    t_batch_norm,
    t_conv2d,
    t_conv3d,
    t_layer_norm,
    t_linear,
    to_numpy,
)

__all__ = ["convert_avhubert_state_dict", "convert_avhubert_checkpoint"]


def _ln(sd, p):
    return t_layer_norm(sd[f"{p}.weight"], sd[f"{p}.bias"])


def _lin(sd, p, bias=True):
    return t_linear(sd[f"{p}.weight"], sd.get(f"{p}.bias") if bias else None)


def _attn(sd, p):
    return {
        "q": _lin(sd, f"{p}.q_proj"),
        "k": _lin(sd, f"{p}.k_proj"),
        "v": _lin(sd, f"{p}.v_proj"),
        "out": _lin(sd, f"{p}.out_proj"),
    }


def _resnet_block(sd, p):
    blk = {
        "conv1": t_conv2d(sd[f"{p}.conv1.weight"]),
        "bn1": t_batch_norm(
            sd[f"{p}.bn1.weight"], sd[f"{p}.bn1.bias"],
            sd[f"{p}.bn1.running_mean"], sd[f"{p}.bn1.running_var"],
        ),
        "relu1": {"alpha": np.atleast_1d(to_numpy(sd.get(f"{p}.relu1.weight", np.zeros(1))))},
        "conv2": t_conv2d(sd[f"{p}.conv2.weight"]),
        "bn2": t_batch_norm(
            sd[f"{p}.bn2.weight"], sd[f"{p}.bn2.bias"],
            sd[f"{p}.bn2.running_mean"], sd[f"{p}.bn2.running_var"],
        ),
        "relu2": {"alpha": np.atleast_1d(to_numpy(sd.get(f"{p}.relu2.weight", np.zeros(1))))},
    }
    if f"{p}.downsample.0.weight" in sd:
        blk["down_conv"] = t_conv2d(sd[f"{p}.downsample.0.weight"])
        blk["down_bn"] = t_batch_norm(
            sd[f"{p}.downsample.1.weight"], sd[f"{p}.downsample.1.bias"],
            sd[f"{p}.downsample.1.running_mean"], sd[f"{p}.downsample.1.running_var"],
        )
    return blk


def convert_avhubert_state_dict(sd, cfg: AVHubertConfig, prefix="model."):
    """HF state dict -> our avsr param tree. ``prefix`` strips e.g. 'model.'"""
    sd = {
        (k[len(prefix):] if k.startswith(prefix) else k): to_numpy(v)
        for k, v in sd.items()
    }

    p = {
        "audio_proj": _lin(sd, "feature_extractor_audio.proj"),
        "video_proj": _lin(sd, "feature_extractor_video.proj"),
        "fuse_ln": _ln(sd, "layer_norm"),
        "enc_final_ln": _ln(sd, "encoder.layer_norm"),
    }
    if "post_extract_proj.weight" in sd:
        p["post_proj"] = _lin(sd, "post_extract_proj")

    # conv positional embedding: exact grouped weight. HF checkpoints store
    # it weight-normalized (dim=2): w[:, :, k] = g[..., k] · v[:, :, k] / ‖v[:, :, k]‖
    # under either the legacy weight_g/weight_v names or the torch
    # parametrizations names; merged plain weights also occur.
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_v" in sd:
        g, v = sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"]
    elif f"{pc}.parametrizations.weight.original1" in sd:
        g = sd[f"{pc}.parametrizations.weight.original0"]
        v = sd[f"{pc}.parametrizations.weight.original1"]
    else:
        g, v = None, sd[f"{pc}.weight"]
    if g is not None:
        norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
        w = (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
    else:
        w = v
    p["conv_pos"] = {
        "w": np.transpose(w, (2, 1, 0)).copy(),  # torch [out, in/g, K] -> [K, in/g, out]
        "b": sd.get(f"{pc}.bias", np.zeros(w.shape[0], np.float32)),
    }

    rp = "feature_extractor_video.resnet"
    trunk = {
        "front_conv": t_conv3d(sd[f"{rp}.frontend3D.0.weight"]),
        "front_bn": t_batch_norm(
            sd[f"{rp}.frontend3D.1.weight"], sd[f"{rp}.frontend3D.1.bias"],
            sd[f"{rp}.frontend3D.1.running_mean"], sd[f"{rp}.frontend3D.1.running_var"],
        ),
        "front_relu": {
            "alpha": np.atleast_1d(to_numpy(sd.get(f"{rp}.frontend3D.2.weight", np.full(1, 0.25))))
        },
        "stages": [
            [_resnet_block(sd, f"{rp}.trunk.layer{s}.{b}") for b in range(2)]
            for s in (1, 2, 3, 4)
        ],
    }
    p["video_resnet"] = trunk

    enc_layers = []
    for n in range(cfg.num_hidden_layers):
        lp = f"encoder.layers.{n}"
        enc_layers.append(
            {
                "attn_ln": _ln(sd, f"{lp}.layer_norm"),
                "attn": _attn(sd, f"{lp}.attention"),
                "ffn_ln": _ln(sd, f"{lp}.final_layer_norm"),
                "ffn_in": _lin(sd, f"{lp}.feed_forward.intermediate_dense"),
                "ffn_out": _lin(sd, f"{lp}.feed_forward.output_dense"),
            }
        )
    p["enc_layers"] = stack_trees(enc_layers)

    p["embed_tokens"] = {"table": sd["decoder.embed_tokens.weight"]}
    dec_layers = []
    for n in range(cfg.decoder_layers):
        lp = f"decoder.layers.{n}"
        dec_layers.append(
            {
                "self_ln": _ln(sd, f"{lp}.self_attn_layer_norm"),
                "self_attn": _attn(sd, f"{lp}.self_attn"),
                "cross_ln": _ln(sd, f"{lp}.encoder_attn_layer_norm"),
                "cross_attn": _attn(sd, f"{lp}.encoder_attn"),
                "ffn_ln": _ln(sd, f"{lp}.final_layer_norm"),
                "ffn_in": _lin(sd, f"{lp}.fc1"),
                "ffn_out": _lin(sd, f"{lp}.fc2"),
            }
        )
    p["dec_layers"] = stack_trees(dec_layers)
    p["dec_final_ln"] = _ln(sd, "decoder.layer_norm")
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        p["lm_head"] = t_linear(sd["lm_head.weight"])
    return p


def convert_avhubert_checkpoint(model_dir, out_path, cfg=None):
    """Convert an HF checkpoint directory (config.json + safetensors/bin)."""
    import json
    import os

    if cfg is None:
        with open(os.path.join(model_dir, "config.json")) as f:
            raw = json.load(f)
        fields = {
            k: raw[k] for k in AVHubertConfig.__dataclass_fields__ if k in raw
        }
        cfg = AVHubertConfig(**fields)

    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        sd = load_file(st_path)
    else:
        import torch

        sd = torch.load(
            os.path.join(model_dir, "pytorch_model.bin"),
            map_location="cpu",
            weights_only=True,
        )
    params = convert_avhubert_state_dict(sd, cfg)
    save_param_tree(
        out_path,
        params,
        {"flavor": "avhubert", "cfg": {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}},
    )
    return params, cfg
