"""USAGE

    python -m reazonspeech_tpu_torch.k2.asr.cli [-h] [--to={txt,json,tsv}] [-o file] audio

OPTIONS

    audio
        Audio file to transcribe (WAV first-party; other containers when an
        ffmpeg binary is on PATH).

    -h, --help
        Print this help message.

    --to={txt,json,tsv}
        Output format: txt (plain transcript, default), json (one subword
        per line with timestamps), tsv (seconds<TAB>token).

    -o file, --output=file
        File to write transcription

The model runs on the GPU. Flag/flow parity: reazonspeech_tpu.k2.asr.cli
(the reference k2 package ships no CLI; this one follows the nemo/espnet
CLI conventions for the k2 result shape: subwords, no segments).
"""

import getopt
import json
import sys
import warnings

from ...core.audio import audio_from_path
from .huggingface import load_model
from .transcribe import transcribe


def main():
    outpath = None
    outext = "txt"

    opts, args = getopt.getopt(sys.argv[1:], "ho:", ("help", "output=", "to="))
    for k, v in opts:
        if k in ("-h", "--help"):
            print(__doc__, file=sys.stderr)
            return
        elif k in ("-o", "--output"):
            outpath = v
        elif k == "--to":
            outext = v.lstrip(".")

    if not args:
        print("no audio file specified", file=sys.stderr)
        print(__doc__, file=sys.stderr)
        return 1

    outfile = open(outpath, "w") if outpath else sys.stdout

    warnings.simplefilter("ignore")

    audio = audio_from_path(args[0])
    model = load_model()
    ret = transcribe(model, audio)

    with outfile:
        if outext == "json":
            for sw in ret.subwords:
                outfile.write(json.dumps({"seconds": round(sw.seconds, 3), "token": sw.token},
                                         ensure_ascii=False) + "\n")
        elif outext == "tsv":
            outfile.write("seconds\ttoken\n")
            for sw in ret.subwords:
                outfile.write("%.3f\t%s\n" % (sw.seconds, sw.token))
        else:
            outfile.write(ret.text + "\n")


if __name__ == "__main__":
    sys.exit(main())
