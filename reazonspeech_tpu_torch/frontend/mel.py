"""Mel filterbank construction (host-side, numpy).

The reference stack consumes three different mel conventions through its
external backends (SURVEY.md §2.2):

- NeMo's preprocessor: librosa-style slaney mel scale with slaney area
  normalization (pkg/nemo-asr external dep),
- kaldi-native-fbank (sherpa-onnx / k2): HTK mel scale, triangles computed in
  mel space, no normalization (pkg/k2-asr external dep),
- ESPnet: librosa defaults (same as NeMo's slaney/slaney).

All three are produced here; the returned matrix multiplies a power spectrum
of shape [..., n_fft//2 + 1].
"""

import numpy as np

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank"]


def hz_to_mel(f, scale="slaney"):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 1127.0 * np.log(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, logarithmic above
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz(m, scale="slaney"):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (np.exp(m / 1127.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = m * f_sp
    above = m >= min_log_mel
    hz = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)
    return hz


def mel_filterbank(
    n_mels,
    n_fft,
    sample_rate,
    fmin=0.0,
    fmax=None,
    scale="slaney",
    norm="slaney",
    triangle_domain="hz",
    dtype=np.float32,
):
    """Build an [n_mels, n_fft//2+1] triangular mel filterbank.

    Args:
      scale: "slaney" or "htk" mel scale.
      norm: "slaney" (area-normalize each triangle to 2/(f_hi-f_lo)) or None.
      triangle_domain: "hz" computes triangle ramps in Hz (librosa style);
        "mel" computes them in mel space (Kaldi style).
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)

    mel_pts = np.linspace(hz_to_mel(fmin, scale), hz_to_mel(fmax, scale), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, scale)

    weights = np.zeros((n_mels, n_bins), dtype=np.float64)
    if triangle_domain == "hz":
        fdiff = np.diff(hz_pts)
        ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
        for i in range(n_mels):
            lower = -ramps[i] / fdiff[i]
            upper = ramps[i + 2] / fdiff[i + 1]
            weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    elif triangle_domain == "mel":
        bin_mels = hz_to_mel(fft_freqs, scale)
        for i in range(n_mels):
            left, center, right = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
            up = (bin_mels - left) / (center - left)
            down = (right - bin_mels) / (right - center)
            weights[i] = np.maximum(0.0, np.minimum(up, down))
    else:
        raise ValueError(f"unknown triangle_domain: {triangle_domain}")

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm.reshape(-1, 1)
    elif norm is not None:
        raise ValueError(f"unknown mel norm: {norm}")

    return weights.astype(dtype)
