"""USAGE

    python -m reazonspeech_tpu_torch.v1.cli [-h] [--to={vtt,srt,ass,json,tsv}] [-o file] audio

OPTIONS

    audio
        Audio file to transcribe (WAV first-party; other containers when an
        ffmpeg binary is on PATH).

    -h, --help
        Print this help message.

    --to={vtt,srt,ass,json,tsv}
        Output format for transcription

    -o file, --output=file
        File to write transcription

EXAMPLES

    # Transcribe audio file
    $ python -m reazonspeech_tpu_torch.v1.cli sample.wav

    # Output subtitles in VTT format
    $ python -m reazonspeech_tpu_torch.v1.cli -o sample.vtt sample.wav

The model runs on the GPU. CLI parity: pkg/_v1/src/cli.py (v1 writer
protocol: header/caption methods, JSON default, correct extension strip,
progress in seconds). A copy of ``reazonspeech_tpu/v1/cli.py``; tqdm is
imported when the CLI runs, not with the module.
"""

import getopt
import json
import os
import sys
import warnings

from ..core import writers as _w
from .transcribe import TranscribeConfig, load_default_model, transcribe


class _V1Writer:
    """Adapts the shared writer classes to the v1 header/caption protocol."""

    def __init__(self, cls):
        self.cls = cls
        self._writer = None

    @property
    def ext(self):
        return self.cls.ext

    def header(self, file):
        self._writer = self.cls(file)
        self._writer.write_header()

    def caption(self, file, caption):
        if self._writer is None or self._writer.fp is not file:
            self._writer = self.cls(file)
        self._writer.write(caption)


def get_writer(ext):
    for cls in (_w.VTTWriter, _w.SRTWriter, _w.ASSWriter, _w.JSONWriter, _w.TSVWriter):
        if cls.ext == ext:
            return _V1Writer(cls)
    return None


def get_default_writer(file):
    ext = os.path.splitext(getattr(file, "name", ""))[1][1:]
    writer = get_writer(ext)
    if writer is not None:
        return writer
    return _V1Writer(_w.JSONWriter)  # v1 defaults to JSON


def show_usage(file):
    print(__doc__, file=file)


def main():
    outpath = None
    outext = None

    opts, args = getopt.getopt(sys.argv[1:], "ho:", ("help", "output=", "to="))
    for k, v in opts:
        if k in ("-h", "--help"):
            show_usage(sys.stdout)
            return
        elif k in ("-o", "--output"):
            outpath = v
        elif k == "--to":
            outext = v

    if outpath is not None:
        outfile = open(outpath, "w")
    else:
        outfile = sys.stdout

    if outext is not None:
        writer = get_writer(outext)
    else:
        writer = get_default_writer(outfile)

    if not writer:
        print("unknown output format", file=sys.stderr)
        show_usage(sys.stderr)
        return 1

    if not args:
        print("no audio file specified", file=sys.stderr)
        show_usage(sys.stderr)
        return 1

    warnings.simplefilter("ignore")
    import tqdm

    config = TranscribeConfig()
    from ..core.audio import audio_from_path, norm_audio

    audio = norm_audio(audio_from_path(args[0])).waveform
    speech2text = load_default_model()

    pbar = tqdm.tqdm(
        total=int(len(audio) / config.samplerate),
        unit="s",
        desc="Transcribing",
        disable=outfile.isatty(),
    )

    writer.header(outfile)

    for caption in transcribe(audio, speech2text, config):
        writer.caption(outfile, caption)
        pbar.n = round(caption.end_seconds)
        pbar.refresh()

    outfile.close()
    pbar.close()


if __name__ == "__main__":
    sys.exit(main())
