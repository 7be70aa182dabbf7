"""Corpus I/O: M2TS audio extraction and zip+manifest writing.

A copy of ``reazonspeech_tpu/oneseg/utils.py`` with the same behaviour.

Behavior parity with the reference (pkg/espnet-oneseg/src/utils.py:1-58):
``load_audio`` decodes via an ffmpeg subprocess (16 kHz, right-channel mono —
1seg broadcasts carry the primary audio on FR), ``save_as_zip`` writes
``%04i.<ext>`` entries plus a ``dataset.json`` JSONL manifest with QC fields.
FLAC (the reference's default entry format) is encoded first-party
(core.flac, verbatim subframes); WAV is also first-party; other formats use
soundfile when available.
"""

import io
import json
import shutil
import subprocess
import tempfile
import zipfile

import numpy as np

__all__ = ["load_audio", "save_as_zip"]


def load_audio(path, samplerate):
    """Read audio data from an M2TS file via ffmpeg.

    Args:
        path (str): M2TS file to read from
        samplerate (int): output sample rate

    Returns:
        np.ndarray float64/float32 mono waveform
    """
    if not shutil.which("ffmpeg"):
        raise RuntimeError("ffmpeg binary not found on PATH (required for M2TS)")
    with tempfile.NamedTemporaryFile(suffix=".wav") as fw:
        subprocess.run(
            [
                "ffmpeg", "-y", "-v", "error", "-i", path,
                "-f", "wav", "-ar", str(samplerate), "-af", "pan=mono|c0=FR",
                fw.name,
            ],
            check=True,
            capture_output=True,
        )
        from ..core.audio import audio_from_path

        return audio_from_path(fw.name).waveform


def _encode_wav(utt) -> bytes:
    from ..core.audio import audio_to_file, audio_from_numpy

    bio = io.BytesIO()
    audio_to_file(bio, audio_from_numpy(np.asarray(utt.buffer, np.float32), utt.samplerate))
    return bio.getvalue()


def _encode(utt, format) -> bytes:
    if format == "wav":
        return _encode_wav(utt)
    if format == "flac":
        from ..core.flac import encode_flac

        return encode_flac(np.asarray(utt.buffer), utt.samplerate)
    try:
        import soundfile

        bio = io.BytesIO()
        soundfile.write(bio, utt.buffer, utt.samplerate, format=format)
        return bytes(bio.getbuffer())
    except ImportError:
        raise RuntimeError(
            f"encoding '{format}' requires the soundfile package; "
            "use 'wav' or 'flac' for the first-party encoders"
        )


def save_as_zip(utterances, path, format="flac"):
    """Create a ZIP archive of an audio corpus.

    Args:
        utterances (list[Utterance]): the audio corpus to save
        path (str): zip file path to create
        format (str): audio entry format — "flac" (first-party verbatim
            encoder, reference default) or "wav"; other formats need soundfile
    """
    with zipfile.ZipFile(path, "w") as zipf:
        dataset = []
        for idx, utt in enumerate(utterances):
            name = "%04i.%s" % (idx, format)
            zipf.writestr(name, _encode(utt, format))
            dataset.append(
                json.dumps(
                    {
                        "audio_filepath": name,
                        "text": utt.text,
                        "duration": utt.duration,
                        "ctc": utt.ctc,
                        "asr": utt.asr,
                        "cer": utt.cer,
                    },
                    ensure_ascii=False,
                )
            )
        zipf.writestr("dataset.json", "\n".join(dataset).encode())
