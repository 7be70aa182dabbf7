from .features import FrontendConfig, log_mel_spectrogram, nemo_frontend_config

__all__ = ["FrontendConfig", "log_mel_spectrogram", "nemo_frontend_config"]
