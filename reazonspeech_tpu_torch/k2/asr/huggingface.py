"""Model loading for the k2 flavor.

Port of ``reazonspeech_tpu.k2.asr.huggingface``: API parity with the
reference loader (pkg/k2-asr/src/huggingface.py:16-83), the same
device/precision/language signature, language→model table, file-name
tables and validation errors, and the same resolution order: explicit
``checkpoint=`` > $REAZONSPEECH_TPU_K2_CHECKPOINT >
$REAZONSPEECH_TPU_K2_CHECKPOINT_DIR/<language>/<precision> > the
converted-tree cache shared with the JAX package > a locally cached HF
snapshot. ``checkpoint="random"`` opts into a randomly initialized model.

The port never downloads. A locally cached snapshot without a converted
tree is converted on the first load (``convert/onnx_zipformer.py``): the
published ONNX decoder/joiner graphs (fp32 or int8 per ``precision``)
convert directly, the encoder from the icefall .pt next to them (the traced
encoder ONNX is constant-folded).
"""

import glob
import os

from ...convert.onnx_zipformer import convert_sherpa_snapshot
from ...core.hub import CheckpointNotFoundError, resolve_converted
from .model import DEFAULT_CHECKPOINT_ENV, K2TorchModel, load_model_container

__all__ = ["load_model", "LANGUAGE_MODELS", "PRECISIONS", "hf_repo_files"]

# language -> (HF repo the weights originate from, training epoch of the
# published checkpoint). Parity: pkg/k2-asr/src/huggingface.py:28-38.
LANGUAGE_MODELS = {
    "ja": ("reazon-research/reazonspeech-k2-v2", 99),
    "ja-en": ("reazon-research/reazonspeech-k2-v2-ja-en", 35),
    "ja-en-mls-5k": ("reazon-research/reazonspeech-k2-v2-ja-en-mls-5k-corrected", 21),
}

PRECISIONS = ("fp32", "int8", "int8-fp32")

CHECKPOINT_DIR_ENV = "REAZONSPEECH_TPU_K2_CHECKPOINT_DIR"


def hf_repo_files(precision, epochs):
    """Published file names per precision (pkg/k2-asr/src/huggingface.py:40-59)."""
    files = {
        "fp32": {
            "tokens": "tokens.txt",
            "encoder": f"encoder-epoch-{epochs}-avg-1.onnx",
            "decoder": f"decoder-epoch-{epochs}-avg-1.onnx",
            "joiner": f"joiner-epoch-{epochs}-avg-1.onnx",
        },
        "int8": {
            "tokens": "tokens.txt",
            "encoder": f"encoder-epoch-{epochs}-avg-1.int8.onnx",
            "decoder": f"decoder-epoch-{epochs}-avg-1.int8.onnx",
            "joiner": f"joiner-epoch-{epochs}-avg-1.int8.onnx",
        },
        "int8-fp32": {
            "tokens": "tokens.txt",
            "encoder": f"encoder-epoch-{epochs}-avg-1.int8.onnx",
            "decoder": f"decoder-epoch-{epochs}-avg-1.onnx",
            "joiner": f"joiner-epoch-{epochs}-avg-1.int8.onnx",
        },
    }
    return files[precision]


def _make_converter(precision, epochs):
    files = hf_repo_files(precision, epochs)

    def convert(snapshot_dir, out_base):
        def find(name):
            p = os.path.join(snapshot_dir, name)
            if os.path.exists(p):
                return p
            hits = glob.glob(os.path.join(snapshot_dir, "**", name), recursive=True)
            return hits[0] if hits else None

        enc, dec, joi = (find(files[k]) for k in ("encoder", "decoder", "joiner"))
        if not (enc and dec and joi):
            raise CheckpointNotFoundError(
                f"snapshot {snapshot_dir} is missing the {precision} ONNX "
                f"files {sorted(files.values())}")
        tokens = find(files["tokens"])
        if tokens is None:
            raise CheckpointNotFoundError(
                f"snapshot {snapshot_dir} has no {files['tokens']} — the "
                "published repos always ship it; without it decoded ids "
                "cannot be mapped to symbols")
        pts = sorted(
            glob.glob(os.path.join(snapshot_dir, "**", "*.pt"), recursive=True),
            # prefer the averaged/pretrained export over raw epoch files
            key=lambda p: ("pretrained" not in p, "avg" not in p, p),
        )
        convert_sherpa_snapshot(enc, dec, joi, out_base, tokens_txt=tokens,
                                icefall_pt=pts[0] if pts else None)

    return convert


def load_model(device=None, precision="fp32", language="ja", checkpoint=None,
               decoding=None) -> K2TorchModel:
    """Load a ReazonSpeech k2 model.

    Args:
      device: torch device; None means CUDA, which raises without a GPU
        (pass "cpu" for the CPU)
      precision (str): "fp32", "int8" or "int8-fp32"
      language (str): "ja", "ja-en" or "ja-en-mls-5k"
      checkpoint (str): explicit converted-checkpoint path, or "random"
      decoding (str): "greedy" (the reference's pinned strategy, default)
        or "beam" (ALSD beam search, beam 4); None keeps the container default

    Returns:
      K2TorchModel
    """
    if language not in LANGUAGE_MODELS:
        raise ValueError(f"Unknown language: '{language}'")
    if precision not in PRECISIONS:
        raise ValueError("Unknown precision: '%s'" % precision)

    checkpoint = checkpoint or os.environ.get(DEFAULT_CHECKPOINT_ENV)
    if checkpoint is None:
        basedir = os.environ.get(CHECKPOINT_DIR_ENV)
        if basedir:
            cand = os.path.join(basedir, language, precision)
            if not os.path.exists(cand + ".npz"):
                raise CheckpointNotFoundError(
                    f"${CHECKPOINT_DIR_ENV}={basedir} is set but {cand}.npz does not exist")
            checkpoint = cand
    if checkpoint is None:
        repo_id, epochs = LANGUAGE_MODELS[language]
        checkpoint = resolve_converted(repo_id, precision, _make_converter(precision, epochs))
    return load_model_container(checkpoint=checkpoint, decoding=decoding or "greedy",
                                device=device)
