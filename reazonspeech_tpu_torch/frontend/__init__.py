from .features import FrontendConfig, kaldi_frontend_config, log_mel_spectrogram, nemo_frontend_config
from .resample import resample, resample_ratio

__all__ = ["FrontendConfig", "kaldi_frontend_config", "log_mel_spectrogram", "nemo_frontend_config",
           "resample", "resample_ratio"]
