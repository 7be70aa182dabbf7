"""AVHuBERT configuration.

A copy of ``reazonspeech_tpu/avsr/configuration_avhubert.py`` with the same
fields, defaults and helpers.

Field parity with the reference config (pkg/avsr/src/avhubert/
configuration_avhubert.py:7-54): 12-layer/768-dim/12-head encoder,
6-layer/4-head decoder, 104-dim stacked fbank audio features at 25 fps,
concat modality fusion, 0.3 CTC auxiliary weight.
"""

from dataclasses import dataclass, field
from typing import Optional

__all__ = ["AVHubertConfig"]


@dataclass
class AVHubertConfig:
    model_type: str = "avhubert"
    vocab_size: Optional[int] = 8000
    # encoder
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = True  # pre-LN encoder (StableLayerNorm)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    # decoder
    decoder_layers: int = 6
    decoder_attention_heads: int = 4
    decoder_ffn_dim: int = 3072
    decoder_hidden_size: int = 768
    decoder_learned_pos: bool = False
    decoder_normalize_before: bool = True
    max_target_positions: int = 2048
    tie_word_embeddings: bool = True
    label_smoothing: float = 0.1
    # audio/video frontend
    audio_feat_dim: int = 104  # 26 fbank x 4 stacked
    modality_fuse: str = "concat"  # concat | add
    sample_rate: int = 25  # fused feature frames per second
    resnet_relu_type: str = "prelu"
    # aux
    ctc_loss_weight: float = 0.3
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2

    @property
    def fused_dim(self) -> int:
        return (
            2 * self.hidden_size if self.modality_fuse == "concat" else self.hidden_size
        )

    @staticmethod
    def tiny(**overrides) -> "AVHubertConfig":
        cfg = dict(
            vocab_size=64,
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=64,
            decoder_layers=2,
            decoder_attention_heads=2,
            decoder_ffn_dim=64,
            decoder_hidden_size=32,
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4,
        )
        cfg.update(overrides)
        return AVHubertConfig(**cfg)

    @classmethod
    def hf_config_class(cls):
        """Build (once; memoized) a transformers.PretrainedConfig subclass
        mirroring this dataclass, for HF Auto-class registration — Auto
        mappings are keyed by class identity, so every caller must see the
        SAME class object."""
        cached = getattr(cls, "_hf_config_class", None)
        if cached is not None:
            return cached
        from transformers import PretrainedConfig

        fields = {f: getattr(cls(), f) for f in cls.__dataclass_fields__}

        class HFAVHubertConfig(PretrainedConfig):
            model_type = "avhubert"

            def __init__(self, **kwargs):
                merged = dict(fields)
                merged.update(kwargs)
                mt = merged.pop("model_type", "avhubert")
                super().__init__(**{})
                for k, v in merged.items():
                    setattr(self, k, v)

        cls._hf_config_class = HFAVHubertConfig
        return HFAVHubertConfig
