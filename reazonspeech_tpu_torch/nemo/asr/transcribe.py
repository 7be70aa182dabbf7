"""transcribe(): the nemo-flavor public entry point.

API and output parity with the reference (pkg/nemo-asr/src/transcribe.py:30-60):
pad 0.5 s of silence both sides, decode, run the identical timestamp/segment
math. Port of ``reazonspeech_tpu.nemo.asr.transcribe``; the pipeline behind it
is the PyTorch one in model.py.
"""

import numpy as np

from ...core.audio import norm_audio, pad_audio
from ...core.interface import TranscribeConfig, TranscribeResult
from ...utils.profiling import span
from .decode import PAD_SECONDS, Hypothesis, decode_hypothesis
from .model import BUCKET_SAMPLES, NemoTorchModel, load_model

__all__ = ["transcribe", "transcribe_batch", "load_model"]


def transcribe(model: NemoTorchModel, audio, config=None) -> TranscribeResult:
    """Transcribe audio data with the model.

    Args:
        model (NemoTorchModel): ReazonSpeech model (see load_model)
        audio (AudioData): audio data to transcribe
        config (TranscribeConfig): additional settings

    Returns:
        TranscribeResult
    """
    if config is None:
        config = TranscribeConfig()

    normed = norm_audio(audio)
    if (
        config.chunk_seconds
        and normed.duration_seconds > config.chunk_seconds
    ):
        tokens, frames = _decode_chunked(model, normed, config)
    else:
        padded = pad_audio(normed, PAD_SECONDS)
        tokens, frames = model.decode_single(padded.waveform)

    hyp = Hypothesis.from_greedy(tokens, frames, model.rnnt_cfg.blank_id)

    ret = decode_hypothesis(model, hyp)

    if config.raw_hypothesis:
        ret.hypothesis = hyp

    return ret


def _decode_chunked(model, normed, config):
    """Long-form decode: overlapped chunks as ONE batch, merged by keeping
    each chunk's center region (tokens in the overlap halves belong to the
    neighbor with more context). Emitted frames are re-based to the global
    0.08 s grid of a virtually-whole padded waveform, so decode_hypothesis
    timestamp math is unchanged."""
    sr = normed.samplerate
    wav = normed.waveform
    pad = int(PAD_SECONDS * sr)
    chunk = int(config.chunk_seconds * sr)
    overlap = int(config.chunk_overlap_seconds * sr)
    hop = chunk - overlap
    if hop <= 0:
        raise ValueError("chunk_overlap_seconds must be < chunk_seconds")

    starts = list(range(0, max(len(wav) - overlap, 1), hop))
    n_chunks = len(starts)
    # every chunk gets the 0.5 s silence pad the model expects
    buf = np.zeros((n_chunks, chunk + 2 * pad), np.float32)
    lengths = np.zeros(n_chunks, np.int32)
    for i, s in enumerate(starts):
        piece = wav[s : s + chunk]
        buf[i, pad : pad + len(piece)] = piece
        lengths[i] = len(piece) + 2 * pad

    tokens_b, frames_b, counts_b, _ = model.decode_batch(buf, lengths)

    # encoder frames per second on the 0.08 s grid
    frames_per_sec = 1.0 / 0.08
    all_tokens, all_frames = [], []
    half = overlap / 2 / sr  # seconds of each overlap owned by the neighbor
    for i, s in enumerate(starts):
        c = int(counts_b[i])
        chunk_sec = (lengths[i] - 2 * pad) / sr
        keep_lo = 0.0 if i == 0 else half
        keep_hi = chunk_sec if i == n_chunks - 1 else chunk_sec - half
        for tok, fr in zip(tokens_b[i, :c], frames_b[i, :c]):
            # token time within the chunk, relative to unpadded chunk start
            t_local = fr / frames_per_sec - PAD_SECONDS
            if keep_lo <= t_local < keep_hi:
                t_global = t_local + s / sr
                # re-encode onto the global grid incl. the virtual 0.5 s pad
                all_tokens.append(int(tok))
                all_frames.append(int(round((t_global + PAD_SECONDS) * frames_per_sec)))
    return all_tokens, all_frames


def transcribe_batch(model: NemoTorchModel, audios, config=None):
    """Transcribe a batch of utterances in one padded batch.

    Extension over the reference (which fixes batch_size=1,
    pkg/nemo-asr/src/transcribe.py:48-50): utterances are padded to one
    bucket and decoded together — this is the throughput path the RTFx
    benchmark measures. Records the span ``entry`` (``utils.profiling``;
    attrs ``utterances``, ``audio_s``) over ``entry.prepare``, the model's
    ``entry.forward`` and ``entry.results``.

    Args:
        model (NemoTorchModel)
        audios (list[AudioData])
        config (TranscribeConfig)

    Returns:
        list[TranscribeResult]
    """
    if config is None:
        config = TranscribeConfig()

    with span("entry", utterances=len(audios)) as root:
        with span("entry.prepare"):
            normed = [norm_audio(a) for a in audios]
            root.set(audio_s=sum(a.duration_seconds for a in normed))
            waves = [pad_audio(a, PAD_SECONDS).waveform for a in normed]
            lengths = np.asarray([len(w) for w in waves], np.int32)
            n_max = int(lengths.max())
            padded_n = max(BUCKET_SAMPLES, -(-n_max // BUCKET_SAMPLES) * BUCKET_SAMPLES)
            buf = np.zeros((len(waves), padded_n), np.float32)
            for i, w in enumerate(waves):
                buf[i, : len(w)] = w

        tokens, frames, counts, _ = model.decode_batch(buf, lengths)

        with span("entry.results"):
            results = []
            for i in range(len(waves)):
                c = int(counts[i])
                hyp = Hypothesis.from_greedy(
                    tokens[i, :c].tolist(), frames[i, :c].tolist(), model.rnnt_cfg.blank_id
                )
                ret = decode_hypothesis(model, hyp)
                if config.raw_hypothesis:
                    ret.hypothesis = hyp
                results.append(ret)
    return results
