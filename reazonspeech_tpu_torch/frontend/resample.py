"""On-device polyphase resampling (PyTorch).

Port of ``reazonspeech_tpu/frontend/resample.py`` (which replaces the
librosa/soxr resampling of the reference's norm_audio,
pkg/nemo-asr/src/audio.py:54-68). The FIR is scipy.signal.resample_poly's
default (Kaiser β=5.0, 10·max(up, down) taps per side, gain ``up``), so
this device path and the host path in ``core.audio.norm_audio`` give
near-identical waveforms; the output length is ceil(N·up/down), as
resample_poly's.

The JAX package convolves the zero-stuffed signal (an lhs dilation of
``up``). The port never builds that signal, which at 44.1 → 16 kHz (up =
160) would be 160 times the input: it computes each output only from the
input samples its taps meet (polyphase). Output ``k = m·up + s`` takes the
taps of phase ``s`` against the input from ``m·down + c_s`` on, so every
phase is a dot product with one window of L input samples that starts at
``m·down``. Cut into blocks of ``down`` taps, window m's block q is row
``m + q`` of the padded input viewed as [rows, down] (no copy), so the
whole resampling is ceil(L / down) fp32 products of that view, shifted by
q rows, with the [down, up] blocks of the phases' filters. Its memory is
the padded input and the output.
"""

import functools
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resample", "resample_ratio"]


def resample_ratio(orig_sr: int, target_sr: int):
    g = gcd(int(orig_sr), int(target_sr))
    return target_sr // g, orig_sr // g


@functools.lru_cache(maxsize=32)
def _fir_taps(up: int, down: int):
    """scipy.resample_poly's default low-pass: (fp32 taps, half length)."""
    from scipy import signal as sps

    max_rate = max(up, down)
    f_c = 1.0 / max_rate  # cutoff in Nyquist units
    half_len = 10 * max_rate
    taps = sps.firwin(2 * half_len + 1, f_c, window=("kaiser", 5.0)) * up
    return np.asarray(taps, np.float32), half_len


@functools.lru_cache(maxsize=32)
def _phase_filters(up: int, down: int):
    """(W [up, L] fp32, left pad): output ``m·up + s`` is the window of L
    input samples from ``m·down - pad`` (zero-padded on the left by
    ``pad``) times row s of W.

    With the zero-stuffed signal u (u[n·up] = x[n]) and scipy's group-delay
    offset, output k is Σ_n x[n]·taps[n·up - k·down + half_len] over the n
    where the index lies in the filter. For k = m·up + s its first tap is
    j_s = (half_len - s·down) mod up, met by input n = m·down + c_s with
    c_s = (s·down - half_len + j_s) / up, and every up-th tap after it by
    the next input samples."""
    taps, half_len = _fir_taps(up, down)
    phases = []
    for s in range(up):
        j = (half_len - s * down) % up
        phases.append(((s * down - half_len + j) // up, taps[j::up]))
    pad = max(0, -min(c for c, _ in phases))
    length = max(c + pad + len(h) for c, h in phases)
    w = np.zeros((up, length), np.float32)
    for s, (c, h) in enumerate(phases):
        w[s, c + pad : c + pad + len(h)] = h
    return w, pad


def resample(x, orig_sr: int, target_sr: int):
    """Resample [B, N] (or [N]) float32 waveforms on their device.

    Output length is ceil(N * up / down), matching scipy.resample_poly.
    On CUDA the products run in fp32 (TF32 off).
    """
    if orig_sr == target_sr:
        return x
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    up, down = resample_ratio(orig_sr, target_sr)
    w_np, pad = _phase_filters(up, down)
    blocks = -(-w_np.shape[1] // down)  # blocks of `down` taps per window
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    rows = -(-n_out // up)  # windows: one per `up` outputs
    # window m reads [m·down - pad, m·down - pad + blocks·down): zeros past both ends
    total = (rows + blocks - 1) * down
    xp = F.pad(x.to(torch.float32), (pad, max(0, total - pad - n_in)))[:, :total]
    grid = xp.reshape(x.shape[0], rows + blocks - 1, down)
    w = np.zeros((up, blocks * down), np.float32)
    w[:, : w_np.shape[1]] = w_np
    w = torch.from_numpy(w.reshape(up, blocks, down).transpose(1, 2, 0).copy()).to(x.device)
    if x.is_cuda:
        # an fp32 product must not drop to TF32 here
        torch.backends.cuda.matmul.allow_tf32 = False
    out = grid[:, :rows] @ w[0]  # [B, rows, up]
    for q in range(1, blocks):
        out += grid[:, q:q + rows] @ w[q]
    out = out.reshape(x.shape[0], rows * up)[:, :n_out]
    return out[0] if squeeze else out
