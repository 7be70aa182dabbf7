"""Slaney mel filterbank (host-side, numpy): librosa's defaults, as NeMo's
preprocessor builds it.

The slaney convention of ``reazonspeech_tpu_torch/frontend/mel.py``, copied
for the benchmark's plain reference, which imports nothing of the port:
the mel scale linear below 1 kHz and logarithmic above, triangles in Hz,
each normalised to the area 2 / (f_hi - f_lo). The returned matrix
multiplies a power spectrum of shape [..., n_fft//2 + 1].
"""

import numpy as np

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank"]

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    above = f >= _MIN_LOG_HZ
    return np.where(above, _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    hz = m * _F_SP
    above = m >= _MIN_LOG_MEL
    return np.where(above, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), hz)


def mel_filterbank(n_mels, n_fft, sample_rate, fmin=0.0, fmax=None, dtype=np.float32):
    """An [n_mels, n_fft//2+1] triangular slaney mel filterbank."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    weights = np.zeros((n_mels, n_bins), dtype=np.float64)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])).reshape(-1, 1)
    return weights.astype(dtype)
