"""Log-mel feature extraction (PyTorch), nemo preset.

Port of ``reazonspeech_tpu.frontend.features`` for NeMo's mel preprocessor:
global pre-emphasis 0.97, symmetric hann window, centered reflect-padded
STFT, power 2, slaney/slaney mel, ``log(x + 2^-24)`` and per-feature
normalization over the valid frames.

The DFT is the reference's block matmul (``_dft_blockmm``): after slicing at
the first frame's start, frame t begins at t·hop, so the signal reshaped to
[B, nblocks, hop] makes frame t the concatenation of blocks t..t+nj-1, and
the windowed DFT is ceil(win/hop) shifted dense matmuls against the cos/sin
bases. Everything is fp32, with TF32 switched off: the spectrum spans ~8
orders of magnitude and feeds a log, and the reference runs it at
``Precision.HIGHEST``.

The kaldi and espnet presets come with their flavors; settings this module
does not implement raise ``ValueError``.
"""

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank

__all__ = ["FrontendConfig", "nemo_frontend_config", "log_mel_spectrogram", "num_frames"]


@dataclass(frozen=True)
class FrontendConfig:
    """Field names and defaults as in ``reazonspeech_tpu.frontend.features``."""

    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 80
    preemph: Optional[float] = 0.97
    preemph_mode: str = "global"
    window: str = "hann"
    framing: str = "center"
    remove_dc: bool = False
    mag_power: float = 2.0
    mel_scale: str = "slaney"
    mel_norm: Optional[str] = "slaney"
    mel_triangle_domain: str = "hz"
    fmin: float = 0.0
    fmax: Optional[float] = None
    log_zero_guard: float = 2.0**-24
    log_zero_guard_type: str = "add"
    normalize: Optional[str] = "per_feature"
    normalize_eps: float = 1e-5


def nemo_frontend_config(**overrides) -> FrontendConfig:
    """NeMo AudioToMelSpectrogramPreprocessor semantics (FastConformer)."""
    return FrontendConfig(**overrides)


def _check_supported(cfg: FrontendConfig):
    if cfg.framing != "center":
        raise ValueError(f"framing={cfg.framing!r} is not ported (nemo preset only)")
    if cfg.remove_dc or (cfg.preemph is not None and cfg.preemph_mode != "global"):
        raise ValueError("per-frame preprocessing is not ported (nemo preset only)")
    if cfg.window != "hann":
        raise ValueError(f"window={cfg.window!r} is not ported (nemo preset only)")
    if cfg.mag_power != 2.0 or cfg.log_zero_guard_type != "add":
        raise ValueError("only power 2 and an additive log guard are ported")
    if cfg.normalize not in ("per_feature", None):
        raise ValueError(f"normalize={cfg.normalize!r} is not ported")


@functools.lru_cache(maxsize=16)
def _constants(cfg: FrontendConfig):
    """Windowed DFT bases [win, 2·n_bins] and the mel matrix [n_bins, n_mels]
    (host numpy, float32), built exactly as the reference builds them."""
    n = cfg.win_length
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    n_bins = cfg.n_fft // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(cfg.n_fft), np.arange(n_bins)) / cfg.n_fft
    pad_left = (cfg.n_fft - n) // 2  # torch.stft centers a short window
    wcos = np.cos(ang)[pad_left : pad_left + n] * window[:, None]
    wsin = -np.sin(ang)[pad_left : pad_left + n] * window[:, None]
    mel = mel_filterbank(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, fmin=cfg.fmin, fmax=cfg.fmax,
        scale=cfg.mel_scale, norm=cfg.mel_norm, triangle_domain=cfg.mel_triangle_domain,
    )
    kernel = np.concatenate(
        [np.asarray(wcos, np.float32), np.asarray(wsin, np.float32)], axis=1)
    return kernel, np.asarray(mel.T, np.float32)


def num_frames(cfg: FrontendConfig, n_samples):
    """Frame count for a waveform of n_samples (int or int tensor)."""
    return n_samples // cfg.hop_length + 1


def _power_spectrum(x, cfg: FrontendConfig, kernel):
    """Centered framing + window + DFT as shifted block matmuls -> power
    spectrum [B, T, n_bins] fp32 (reference ``_dft_blockmm``)."""
    hop, win = cfg.hop_length, cfg.win_length
    t_out = x.shape[-1] // hop + 1
    pad = cfg.n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    first = (cfg.n_fft - win) // 2
    nj = -(-win // hop)  # blocks overlapping one frame
    need = first + (t_out - 1 + nj) * hop
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    blocks = x[:, first:need].reshape(x.shape[0], -1, hop)  # [B, t_out+nj-1, hop]
    out = None
    for j in range(nj):
        wj = kernel[j * hop : min((j + 1) * hop, win)]
        term = blocks[:, j : j + t_out, : wj.shape[0]] @ wj
        out = term if out is None else out + term
    re, im = out.chunk(2, dim=-1)
    return re * re + im * im, t_out


def log_mel_spectrogram(waveform, lengths, cfg: FrontendConfig):
    """Compute log-mel features.

    Args:
      waveform: [B, N] float tensor (16 kHz mono)
      lengths: [B] int tensor of valid sample counts
      cfg: FrontendConfig (nemo preset)

    Returns:
      (features [B, T, n_mels] float32, out_lengths [B] int32). Frames beyond
      out_lengths are zeroed.
    """
    _check_supported(cfg)
    if waveform.is_cuda:
        # fp32 matmuls and convolutions must not drop to TF32 here
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = waveform.device
    x = waveform.to(torch.float32)
    kernel_np, mel_np = _constants(cfg)
    kernel = torch.from_numpy(kernel_np).to(dev)
    mel = torch.from_numpy(mel_np).to(dev)

    if cfg.preemph is not None:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)

    power, t_out = _power_spectrum(x, cfg, kernel)
    feats = torch.log(power @ mel + cfg.log_zero_guard)

    lengths = lengths.to(dev)
    out_lengths = torch.where(lengths > 0, num_frames(cfg, lengths), 0).to(torch.int32)
    mask = torch.arange(t_out, device=dev)[None, :] < out_lengths[:, None]  # [B, T]
    m = mask[..., None]

    if cfg.normalize == "per_feature":
        cnt = torch.clamp(out_lengths[:, None].to(torch.float32), min=2.0)
        mean = torch.where(m, feats, 0.0).sum(dim=1) / cnt  # [B, n_mels]
        var = torch.where(m, (feats - mean[:, None, :]) ** 2, 0.0).sum(dim=1) / (cnt - 1.0)
        feats = (feats - mean[:, None, :]) / (torch.sqrt(var)[:, None, :] + cfg.normalize_eps)

    return torch.where(m, feats, 0.0), out_lengths
