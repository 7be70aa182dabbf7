"""Audio I/O and waveform normalization.

A copy of ``reazonspeech_tpu/core/audio.py`` with the same behaviour: the
port imports nothing of the JAX package.

API parity target: pkg/nemo-asr/src/audio.py:8-83 (== pkg/k2-asr/src/audio.py).
The reference delegates decode/resample to librosa/soundfile (C); here file
decode is first-party (WAV via a small host-side reader, FLAC via
:mod:`.flac`, other containers via an optional ffmpeg subprocess), and
resampling is a host-side polyphase filter (scipy).
"""

import shutil
import struct
import subprocess

import numpy as np

from .interface import AudioData

__all__ = [
    "SAMPLERATE",
    "audio_from_numpy",
    "audio_from_tensor",
    "audio_from_path",
    "audio_to_file",
    "norm_audio",
    "pad_audio",
]

SAMPLERATE = 16000


def audio_from_numpy(array, samplerate):
    """Load audio from a numpy array.

    Args:
      array (numpy.ndarray): audio samples
      samplerate (int): sample rate of the input array

    Returns:
      AudioData
    """
    return AudioData(array, samplerate)


def audio_from_tensor(tensor, samplerate):
    """Load audio from a framework tensor (torch.Tensor / jax.Array / ...).

    Args:
      tensor: audio samples as a tensor with ``.numpy()`` or ``__array__``
      samplerate (int): sample rate of the input tensor

    Returns:
      AudioData
    """
    if hasattr(tensor, "numpy"):
        array = tensor.numpy()
    else:
        array = np.asarray(tensor)
    return audio_from_numpy(array, samplerate)


def _read_wav(path):
    """Minimal RIFF/WAVE reader: PCM 8/16/24/32-bit and IEEE float, any
    channel count. Returns float32 in [-1, 1] shaped [channels, samples]
    (or [samples] for mono)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk in WAVE file: {path}")

    audio_format, channels, samplerate, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 8:
            x = (data_np(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = data_np(data, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = data_np(data, np.int32).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = np.float32 if bits == 32 else np.float64
        x = data_np(data, dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAVE format code: {audio_format}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).T
    return x, samplerate


def data_np(buf, dtype):
    return np.frombuffer(buf, dtype=dtype)


def _ffmpeg_decode(path):
    """Decode any container ffmpeg understands into float32 mono-preserving
    PCM. Used only when an ffmpeg binary is on PATH."""
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "a:0",
         "-show_entries", "stream=sample_rate,channels",
         "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True,
    )
    sr_s, ch_s = probe.stdout.strip().split(",")[:2]
    sr, ch = int(sr_s), int(ch_s)
    raw = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le",
         "-acodec", "pcm_f32le", "-"],
        capture_output=True, check=True,
    ).stdout
    x = np.frombuffer(raw, dtype=np.float32)
    if ch > 1:
        x = x[: (len(x) // ch) * ch].reshape(-1, ch).T
    return x, sr


def audio_from_path(path):
    """Load audio from a file.

    WAV files are decoded first-party; other containers require an ffmpeg
    binary on PATH. Multi-channel audio is downmixed to mono (mean over
    channels), matching librosa.load's default behavior which the reference
    relies on (pkg/nemo-asr/src/audio.py:32-42).

    Args:
      path (str): path to audio file

    Returns:
      AudioData (float32 mono at the file's native sample rate)
    """
    path = str(path)
    try:
        x, sr = _read_wav(path)
    except ValueError:
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == b"fLaC":
            from .flac import decode_flac

            with open(path, "rb") as f:
                pcm, sr = decode_flac(f.read())
            x = pcm.astype(np.float32) / 32768.0
            if x.ndim > 1:
                x = x.T
        elif shutil.which("ffmpeg") and shutil.which("ffprobe"):
            x, sr = _ffmpeg_decode(path)
        else:
            raise
    if x.ndim > 1:
        x = x.mean(axis=0)
    return audio_from_numpy(np.ascontiguousarray(x, dtype=np.float32), sr)


def audio_to_file(fp, audio, format="wav"):
    """Write audio data to a file as 16-bit PCM WAV.

    Args:
      fp: output path or binary file object
      audio (AudioData): audio data to write
      format (str): only "wav" is supported first-party
    """
    if format != "wav":
        raise ValueError(f"unsupported output format: {format}")
    x = np.asarray(audio.waveform, dtype=np.float32)
    if x.ndim > 1:
        x = x.T  # [samples, channels]
        channels = x.shape[1]
    else:
        channels = 1
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2").tobytes()

    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, channels, audio.samplerate,
        audio.samplerate * channels * 2, channels * 2, 16,
    )
    hdr += b"data" + struct.pack("<I", len(pcm))

    if hasattr(fp, "write"):
        fp.write(hdr + pcm)
    else:
        with open(fp, "wb") as f:
            f.write(hdr + pcm)


def norm_audio(audio):
    """Normalize audio into a 16 kHz mono waveform.

    Resampling uses a host-side polyphase low-pass (scipy). Reference
    behavior: pkg/nemo-asr/src/audio.py:54-68.

    Args:
      audio (AudioData): audio data to normalize

    Returns:
      AudioData (16 kHz mono float32)
    """
    waveform = np.asarray(audio.waveform, dtype=np.float32)
    if waveform.ndim > 1:
        waveform = waveform.mean(axis=0)
    if audio.samplerate != SAMPLERATE:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(int(audio.samplerate), SAMPLERATE)
        up, down = SAMPLERATE // g, int(audio.samplerate) // g
        waveform = resample_poly(waveform, up, down).astype(np.float32)
    return AudioData(waveform, SAMPLERATE)


def pad_audio(audio, seconds):
    """Pad audio with N seconds of silence on both sides.

    Reference behavior: pkg/nemo-asr/src/audio.py:70-83.

    Args:
      audio (AudioData): audio data to pad
      seconds (float): padding duration per side

    Returns:
      AudioData
    """
    waveform = np.pad(
        audio.waveform,
        pad_width=int(seconds * audio.samplerate),
        mode="constant",
    )
    return AudioData(waveform, audio.samplerate)
