"""Shared CLI runner for the transcribe console scripts.

A copy of ``reazonspeech_tpu/core/cli.py`` with the same behaviour.

The reference duplicates a near-identical getopt CLI per package
(pkg/nemo-asr/src/cli.py == pkg/espnet-asr/src/cli.py modulo the import); the
TPU build factors it once (SURVEY.md §1 notes the copy-paste as a thing to
fix). Flags and flow are contract-identical: ``[-h] [--to=ext] [-o file]
audio``, warnings suppressed, header + per-segment writer loop.
"""

import getopt
import sys
import warnings

from .audio import audio_from_path
from .writers import get_writer

__all__ = ["run_transcribe_cli"]


def run_transcribe_cli(argv, usage, load_model, transcribe):
    """Drive load→transcribe→write for one ASR flavor.

    Args:
      argv: sys.argv[1:]-style argument list
      usage: help text
      load_model: () -> model
      transcribe: (model, AudioData) -> result with .segments

    Returns process exit code (None for success, matching the reference).
    """
    outpath = None
    outext = None

    opts, args = getopt.getopt(argv, "ho:", ("help", "output=", "to="))
    for k, v in opts:
        if k in ("-h", "--help"):
            print(usage, file=sys.stderr)
            return
        elif k in ("-o", "--output"):
            outpath = v
        elif k == "--to":
            outext = v

    if not args:
        print("no audio file specified", file=sys.stderr)
        print(usage, file=sys.stderr)
        return 1

    outfile = open(outpath, "w") if outpath is not None else sys.stdout

    warnings.simplefilter("ignore")

    audio = audio_from_path(args[0])
    model = load_model()
    ret = transcribe(model, audio)

    with outfile:
        writer = get_writer(outfile, outext)
        writer.write_header()
        for segment in ret.segments:
            writer.write(segment)
