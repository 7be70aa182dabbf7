"""Model loading for the k2 flavor.

Port of ``reazonspeech_tpu.k2.asr.huggingface``: API parity with the
reference loader (pkg/k2-asr/src/huggingface.py:16-83), the same
device/precision/language signature, language→model table, file-name
tables and validation errors, and the same resolution order: explicit
``checkpoint=`` > $REAZONSPEECH_TPU_K2_CHECKPOINT >
$REAZONSPEECH_TPU_K2_CHECKPOINT_DIR/<language>/<precision> > the
converted-tree cache shared with the JAX package. ``checkpoint="random"``
opts into a randomly initialized model.

The port never downloads and converts no ONNX graph: a cached snapshot
without a converted tree raises CheckpointNotFoundError, which names the
JAX package's converter (the tree format is shared by both packages).
"""

import os

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


def _no_converter(snapshot_dir, out_base):
    raise CheckpointNotFoundError(
        f"found a snapshot at {snapshot_dir} but no converted tree at {out_base}.npz; "
        "convert it once with reazonspeech_tpu.convert.onnx_zipformer."
        "convert_sherpa_snapshot (the tree format is shared by both packages)")


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
        repo_id, _ = LANGUAGE_MODELS[language]
        checkpoint = resolve_converted(repo_id, precision, _no_converter)
    return load_model_container(checkpoint=checkpoint, decoding=decoding or "greedy",
                                device=device)
