"""reazonspeech_tpu_torch.avsr — audio-visual speech recognition (AVHuBERT family).

The port of ``reazonspeech_tpu/avsr`` (a copy of its ``__init__.py`` with the
port's classes): config, feature extractor (host-side audio fbank + video
mouth-ROI pipeline), processor, ResNet3D+transformer encoder, cached
transformer decoder with greedy/beam generation, on the GPU unless the
caller asks for the CPU.

When HF transformers is importable, the config/extractor/processor register
into the Auto classes under model_type "avhubert" for ecosystem parity with
the reference (pkg/avsr/src/__init__.py:25-35).
"""

from .configuration_avhubert import AVHubertConfig
from .feature_extraction import AVHubertFeatureExtractor
from .model import (
    AVHubertModel,
    AVHubertForConditionalGeneration,
)
from .processing import AVHubertProcessor

__all__ = [
    "AVHubertConfig",
    "AVHubertFeatureExtractor",
    "AVHubertProcessor",
    "AVHubertModel",
    "AVHubertForConditionalGeneration",
]


def _native_config(config):
    """HF PretrainedConfig (or None) -> AVHubertConfig dataclass."""
    if config is None or isinstance(config, AVHubertConfig):
        return config
    fields = {
        k: getattr(config, k)
        for k in AVHubertConfig.__dataclass_fields__
        if hasattr(config, k)
    }
    return AVHubertConfig(**fields)


def register_auto_classes():
    """Register the family into ALL five HF Auto classes, mirroring the
    reference (pkg/avsr/src/__init__.py:25-35): AutoConfig, AutoModel,
    AutoModelForSpeechSeq2Seq, AutoFeatureExtractor, AutoProcessor.

    The model entries are thin adapters whose ``from_pretrained`` accepts the
    Auto machinery's calling convention (positional path, ``config=`` as an
    HF PretrainedConfig, hub kwargs) and return the port's models, on
    ``device=`` (default CUDA, which raises without a GPU). The
    reference's ``register_for_auto_class`` calls serialize auto_map entries
    for trust_remote_code checkpoints; our classes are not torch
    PreTrainedModels, so that serialization path is intentionally omitted.

    A repeated registration is harmless; one that conflicts with another
    package's "avhubert" raises ValueError.

    No-op (returns False) when transformers is not importable.
    """
    try:
        from transformers import (
            AutoConfig,
            AutoFeatureExtractor,
            AutoModel,
            AutoModelForSpeechSeq2Seq,
            AutoProcessor,
        )
    except ImportError:
        return False

    hf_cfg = AVHubertConfig.hf_config_class()

    class _AVHubertModelAdapter(AVHubertModel):
        config_class = hf_cfg

        @classmethod
        def from_pretrained(cls, path, *args, config=None, device=None, **kwargs):
            return AVHubertModel.from_pretrained(path, config=_native_config(config),
                                                 device=device)

    class _AVHubertSeq2SeqAdapter(AVHubertForConditionalGeneration):
        config_class = hf_cfg

        @classmethod
        def from_pretrained(cls, path, *args, config=None, device=None, **kwargs):
            return AVHubertForConditionalGeneration.from_pretrained(
                path, config=_native_config(config), device=device
            )

    def _register(fn, check_ours, *args):
        """transformers raises ValueError both for a harmless repeat
        registration and for a genuine conflict (another package claimed
        'avhubert'); suppress only when the existing entry is OURS."""
        try:
            fn(*args)
        except ValueError:
            if not check_ours():
                raise

    from transformers import CONFIG_MAPPING

    # transformers lets a second registration of an added model type replace
    # the first without an error: refuse a name another package holds
    held = CONFIG_MAPPING["avhubert"] if "avhubert" in CONFIG_MAPPING else hf_cfg
    if held is not hf_cfg:
        raise ValueError(f"model_type 'avhubert' is already registered to "
                         f"{held.__module__}.{held.__qualname__}")
    _register(
        AutoConfig.register,
        lambda: CONFIG_MAPPING.get("avhubert") is hf_cfg,
        "avhubert", hf_cfg,
    )
    _register(
        AutoModel.register,
        lambda: AutoModel._model_mapping._extra_content.get(hf_cfg)
        is not None,
        hf_cfg, _AVHubertModelAdapter,
    )
    _register(
        AutoModelForSpeechSeq2Seq.register,
        lambda: AutoModelForSpeechSeq2Seq._model_mapping._extra_content.get(
            hf_cfg
        ) is not None,
        hf_cfg, _AVHubertSeq2SeqAdapter,
    )
    from transformers.models.auto.feature_extraction_auto import (
        FEATURE_EXTRACTOR_MAPPING,
    )
    from transformers.models.auto.processing_auto import PROCESSOR_MAPPING

    _register(
        AutoFeatureExtractor.register,
        lambda: FEATURE_EXTRACTOR_MAPPING._extra_content.get(hf_cfg)
        is AVHubertFeatureExtractor,
        hf_cfg, AVHubertFeatureExtractor,
    )
    _register(
        AutoProcessor.register,
        lambda: PROCESSOR_MAPPING._extra_content.get(hf_cfg) is AVHubertProcessor,
        hf_cfg, AVHubertProcessor,
    )
    return True
