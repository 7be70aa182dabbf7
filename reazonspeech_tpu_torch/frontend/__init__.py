from .features import FrontendConfig, kaldi_frontend_config, log_mel_spectrogram, nemo_frontend_config

__all__ = ["FrontendConfig", "kaldi_frontend_config", "log_mel_spectrogram", "nemo_frontend_config"]
