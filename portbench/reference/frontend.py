"""Plain log-mel features in fp32: NeMo's preprocessor.

Written from the published description, not from the port: the ``nemo``
preset (NeMo ``AudioToMelSpectrogramPreprocessor``) is pre-emphasis 0.97
over the whole signal, ``torch.stft`` centred with reflect padding and a
symmetric hann window of 400 samples in a 512-point FFT, power 2, slaney
mel (slaney area norm), ``log(x + 2**-24)``, then per-feature mean and
(n - 1) standard deviation over the valid frames (+1e-5).

Frames past a waveform's valid length are zero. Nothing here is a product
the configuration runs in bf16, so the control runs the same fp32 code.
"""

import numpy as np
import torch

from .mel import mel_filterbank

__all__ = ["log_mel", "num_frames"]

SR, N_FFT, WIN, HOP = 16000, 512, 400, 160


def num_frames(preset, n_samples):
    _known(preset)
    return n_samples // HOP + 1


def _known(preset):
    if preset != "nemo":
        raise ValueError(f"no reference frontend {preset!r}")


def _mel(n_mels, device):
    m = mel_filterbank(n_mels, N_FFT, SR)
    return torch.from_numpy(np.asarray(m.T, np.float32)).to(device)


def _nemo_power(x):
    x = torch.cat([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1]], dim=1)
    window = torch.hann_window(WIN, periodic=False, dtype=torch.float64, device=x.device)
    spec = torch.stft(x.double(), N_FFT, hop_length=HOP, win_length=WIN, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    return (spec.real.square() + spec.imag.square()).transpose(1, 2)  # [B, T, bins]


def log_mel(waveform, lengths, preset, n_mels=80):
    """waveform [B, N] fp32, lengths [B] valid samples -> (feats [B, T,
    n_mels] fp32, frames [B] int64)."""
    _known(preset)
    x = waveform.to(torch.float32)
    feats = _nemo_power(x).to(torch.float32) @ _mel(n_mels, x.device)
    feats = torch.log(feats + 2.0**-24)
    t = feats.shape[1]
    lengths = lengths.to(x.device).long()
    frames = torch.where(lengths > 0, num_frames(preset, lengths), 0)
    m = (torch.arange(t, device=x.device)[None, :] < frames[:, None])[..., None]
    cnt = torch.clamp(frames[:, None].to(torch.float32), min=2.0)
    mean = torch.where(m, feats, 0.0).sum(dim=1) / cnt
    var = torch.where(m, (feats - mean[:, None]) ** 2, 0.0).sum(dim=1) / (cnt - 1.0)
    feats = (feats - mean[:, None]) / (torch.sqrt(var)[:, None] + 1e-5)
    return torch.where(m, feats, 0.0), frames
