"""USAGE

    python -m reazonspeech_tpu_torch.nemo.asr.cli [-h] [--to={vtt,srt,ass,json,tsv}] [-o file] audio

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
    $ python -m reazonspeech_tpu_torch.nemo.asr.cli sample.wav

    # Output subtitles in VTT format
    $ python -m reazonspeech_tpu_torch.nemo.asr.cli -o sample.vtt sample.wav

Flag/flow parity: pkg/nemo-asr/src/cli.py.
"""

import sys

from ...core.cli import run_transcribe_cli
from .transcribe import load_model, transcribe


def main():
    return run_transcribe_cli(sys.argv[1:], __doc__, load_model, transcribe)


if __name__ == "__main__":
    sys.exit(main())
