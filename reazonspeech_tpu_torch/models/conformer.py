"""ESPnet-style Conformer encoder preset + CTC head (PyTorch).

Port of ``reazonspeech_tpu.models.conformer``: the ESPnet
Conformer-Transducer's encoder (``espnet_encoder_config``: 12 blocks,
d=512, 8 heads, conv kernel 31, 4× VALID conv2d subsampling, LayerNorm conv
modules, ``after_norm``) runs on the Conformer blocks of
``models/fastconformer.py``; the CTC head is one fp32 dense layer.

Token conventions follow ESPnet: ``blank_id == 0`` for the CTC head and the
last entry of ``token_list`` is ``<sos/eos>``.
"""

import torch

from .fastconformer import FastConformerConfig
from .layers import dense, dense_init

__all__ = ["espnet_encoder_config", "init_ctc_head", "ctc_logits", "ctc_log_softmax",
           "ctc_softmax"]


def espnet_encoder_config(**overrides) -> FastConformerConfig:
    """~120M-class ESPnet Conformer: 12 layers, d=512, kernel 31, 4× VALID
    conv subsampling, layer-norm conv modules."""
    cfg = dict(
        num_layers=12,
        d_model=512,
        num_heads=8,
        ff_expansion=4,
        conv_kernel=31,
        subsampling_factor=4,
        subsampling_channels=512,
        subsampling_style="conv2d",
        conv_norm="layer_norm",
        final_norm=True,  # ESPnet after_norm (normalize_before)
    )
    cfg.update(overrides)
    return FastConformerConfig(**cfg)


def init_ctc_head(gen, d_model: int, num_tokens: int, device="cpu"):
    """Linear d_model -> num_tokens (token 0 is the CTC blank)."""
    return {"out": dense_init(gen, d_model, num_tokens, device=device)}


def ctc_logits(params, enc):
    """fp32 logits [..., V] (the CTC head runs in fp32 at every compute dtype)."""
    return dense(params["out"], enc, dtype=torch.float32)


def ctc_log_softmax(params, enc):
    return torch.log_softmax(ctc_logits(params, enc), dim=-1)


def ctc_softmax(params, enc):
    """Per-frame token probabilities: the ``lpz`` matrix consumed by blank
    detection and CTC alignment."""
    return torch.softmax(ctc_logits(params, enc), dim=-1)
