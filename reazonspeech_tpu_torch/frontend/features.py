"""Log-mel feature extraction (PyTorch): the nemo, kaldi and espnet presets.

Port of ``reazonspeech_tpu.frontend.features``.

- **nemo** (NeMo's mel preprocessor): global pre-emphasis 0.97, symmetric
  hann window, centered reflect-padded STFT, power 2, slaney/slaney mel,
  ``log(x + 2^-24)`` and per-feature normalization over the valid frames.
  The DFT is the reference's block matmul (``_dft_blockmm``): after slicing
  at the first frame's start, frame t begins at t·hop, so the signal
  reshaped to [B, nblocks, hop] makes frame t the concatenation of blocks
  t..t+nj-1, and the windowed DFT is ceil(win/hop) shifted dense matmuls
  against the cos/sin bases.
- **kaldi** (kaldi-native-fbank as sherpa configures it for the k2 models):
  ``snip_edges=False`` framing (frame t centred at t·hop + hop/2, symmetric
  padding at the edges), per-frame DC removal and pre-emphasis, povey
  window, HTK mel triangles in mel space, ``log(max(x, eps))``, no
  normalization. Per-frame preprocessing needs the frames themselves, so
  they are cut out (``unfold``) and multiplied by the bases.
- **espnet** (ESPnet's default STFT frontend): no pre-emphasis, periodic
  hann window, centered STFT as nemo's, slaney/slaney mel,
  ``log(max(x, 1e-10))``, no normalization here (the model's GlobalMVN
  layer normalizes).

Everything is fp32, with TF32 switched off: the spectrum spans ~8 orders of
magnitude and feeds a log, and the reference runs it at
``Precision.HIGHEST``. Settings this module does not implement (other
windows, powers and normalizations) raise ``ValueError``.
"""

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank

__all__ = ["FrontendConfig", "espnet_frontend_config", "kaldi_frontend_config",
           "log_mel_spectrogram", "nemo_frontend_config", "num_frames"]


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


def kaldi_frontend_config(**overrides) -> FrontendConfig:
    """kaldi-native-fbank semantics as configured by sherpa for the k2 models:
    per-frame DC removal + preemph, povey window, snip_edges=False framing,
    HTK mel triangles computed in mel space, no norm, log with float-eps clamp,
    no feature normalization."""
    cfg = dict(
        preemph=0.97,
        preemph_mode="frame",
        window="povey",
        framing="kaldi",
        remove_dc=True,
        mel_scale="htk",
        mel_norm=None,
        mel_triangle_domain="mel",
        fmin=20.0,
        log_zero_guard=float(np.finfo(np.float32).eps),
        log_zero_guard_type="clamp",
        normalize=None,
    )
    cfg.update(overrides)
    return FrontendConfig(**cfg)


def espnet_frontend_config(**overrides) -> FrontendConfig:
    """ESPnet default frontend: no preemph, periodic hann, centered STFT,
    librosa mel (slaney/slaney), log with 1e-10 clamp; normalization is done
    by a separate GlobalMVN layer, not here."""
    cfg = dict(
        preemph=None,
        window="hann_periodic",
        log_zero_guard=1e-10,
        log_zero_guard_type="clamp",
        normalize=None,
    )
    cfg.update(overrides)
    return FrontendConfig(**cfg)


def _check_supported(cfg: FrontendConfig):
    if cfg.framing not in ("center", "kaldi"):
        raise ValueError(f"framing={cfg.framing!r} is not ported")
    if cfg.preemph is not None and cfg.preemph_mode not in ("global", "frame"):
        raise ValueError(f"preemph_mode={cfg.preemph_mode!r} is not ported")
    if cfg.window not in ("hann", "hann_periodic", "povey"):
        raise ValueError(f"window={cfg.window!r} is not ported (nemo, kaldi and espnet presets)")
    if cfg.mag_power != 2.0:
        raise ValueError("only power 2 is ported")
    if cfg.log_zero_guard_type not in ("add", "clamp"):
        raise ValueError(f"log_zero_guard_type={cfg.log_zero_guard_type!r} is not ported")
    if cfg.normalize not in ("per_feature", None):
        raise ValueError(f"normalize={cfg.normalize!r} is not ported")


def _make_window(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.win_length
    if cfg.window == "hann_periodic":
        return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return hann**0.85 if cfg.window == "povey" else hann


@functools.lru_cache(maxsize=16)
def _constants(cfg: FrontendConfig):
    """Windowed DFT bases [win, 2·n_bins] and the mel matrix [n_bins, n_mels]
    (host numpy, float32), built exactly as the reference builds them."""
    n = cfg.win_length
    window = _make_window(cfg)
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
    if cfg.framing == "kaldi":
        return (n_samples + cfg.hop_length // 2) // cfg.hop_length
    return n_samples // cfg.hop_length + 1


def _kaldi_frames(x, cfg: FrontendConfig):
    """snip_edges=False framing -> [B, T, win]: frame t covers samples
    [t·hop + hop/2 - win/2, ... + win) of the signal extended symmetrically
    (sample -s-1 on the left, 2n-1-s on the right, period 2n: numpy's
    ``mode="symmetric"``, which the reference pads with)."""
    hop, win = cfg.hop_length, cfg.win_length
    n = x.shape[-1]
    t_out = (n + hop // 2) // hop
    left = max(0, (win - hop) // 2 + 1)
    first = left + hop // 2 - win // 2
    start = first - left  # first sample of frame 0, relative to x
    idx = torch.arange(start, start + (t_out - 1) * hop + win, device=x.device) % (2 * n)
    idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    return x[:, idx].unfold(1, win, hop), t_out


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
      cfg: FrontendConfig (nemo, kaldi or espnet preset)

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

    per_frame = cfg.preemph is not None and cfg.preemph_mode == "frame"
    if cfg.preemph is not None and not per_frame:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)

    if cfg.framing == "center" and not (cfg.remove_dc or per_frame):
        power, t_out = _power_spectrum(x, cfg, kernel)
    else:
        if cfg.framing != "kaldi":
            raise ValueError("per-frame preprocessing is ported with kaldi framing only")
        frames, t_out = _kaldi_frames(x, cfg)  # [B, T, win]
        if cfg.remove_dc:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        if per_frame:
            frames = torch.cat([frames[..., :1] * (1.0 - cfg.preemph),
                                frames[..., 1:] - cfg.preemph * frames[..., :-1]], dim=-1)
        re, im = (frames @ kernel).chunk(2, dim=-1)
        power = re * re + im * im
    feats = power @ mel
    if cfg.log_zero_guard_type == "add":
        feats = torch.log(feats + cfg.log_zero_guard)
    else:
        feats = torch.log(torch.clamp(feats, min=cfg.log_zero_guard))

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
