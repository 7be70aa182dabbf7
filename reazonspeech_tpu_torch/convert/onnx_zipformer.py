"""Convert sherpa-onnx zipformer transducer graphs into native param trees.

A copy of ``reazonspeech_tpu/convert/onnx_zipformer.py`` with the same
behaviour and output, written by the port's store.

The reference's k2 models ship exclusively as ONNX graphs
(pkg/k2-asr/src/huggingface.py:40-59: encoder/decoder/joiner ×
fp32/int8/int8-fp32). The decoder (stateless predictor: embedding + 2-token
context conv + relu) and joiner (3 linears) are small fixed-topology graphs,
converted here by SHAPE-driven tensor identification — robust to exporter
naming differences:

- decoder: the [V, D] tensor is the embedding; the [D, D, ctx] (or transposed)
  tensor is the context conv, folded into our concat-linear layout.
- joiner: [D_enc, J], [D_dec, J], [J, V] linears matched by dimensions.

int8 graphs (DynamicQuantizeLinear exports) carry int8 initializers next to
their scales; both are read (convert.onnx_reader) and dequantized.

The traced encoder graph's weights are heavily fused by the exporter; encoder
conversion targets the icefall .pt checkpoint instead (published alongside
the ONNX files) — see convert_zipformer_torch below for the mapping entry
point.
"""

import numpy as np

from ..models.rnnt import RNNTConfig
from .onnx_reader import read_onnx_initializers
from .store import save_param_tree

__all__ = [
    "convert_decoder_joiner",
    "convert_zipformer_torch",
    "convert_sherpa_snapshot",
    "read_tokens_txt",
    "infer_rnnt_cfg_from_onnx",
]


def read_tokens_txt(path):
    """Parse sherpa/k2 tokens.txt ("<sym> <id>" lines) into an id-indexed
    token list (pkg/k2-asr/src/huggingface.py:42 'tokens' entry)."""
    toks = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            sym, idx = line.rsplit(" ", 1)
            toks[int(idx)] = sym
    missing = [i for i in range(len(toks)) if i not in toks]
    if missing:
        raise ValueError(
            f"{path}: token ids are not contiguous 0..{len(toks) - 1} "
            f"(missing {missing[:5]}{'...' if len(missing) > 5 else ''}); "
            "the decoder embedding is indexed by id, so gaps would "
            "silently misalign symbols"
        )
    return [toks[i] for i in range(len(toks))]


def infer_rnnt_cfg_from_onnx(decoder_onnx, joiner_onnx, enc_dim):
    """Derive an RNNTConfig from the decoder/joiner graph tensor shapes."""
    dec = _dequant_pairs(read_onnx_initializers(decoder_onnx))
    joi = _dequant_pairs(read_onnx_initializers(joiner_onnx))
    embed = conv = None
    for arr in dec.values():
        if arr.ndim == 3:
            conv = arr
        elif arr.ndim == 2:
            embed = arr
    if embed is None or conv is None:
        raise ValueError("decoder graph lacks embedding/conv tensors")
    v, d = embed.shape
    ctx = min(conv.shape)
    j = None
    for arr in joi.values():
        if arr.ndim == 2 and v in arr.shape:
            j = arr.shape[0] if arr.shape[1] == v else arr.shape[1]
    if j is None:
        raise ValueError("joiner graph lacks the [J, V] output linear")
    return RNNTConfig(
        vocab_size=v,
        enc_dim=enc_dim,
        pred_hidden=d,
        joint_hidden=j,
        joint_activation="tanh",
        predictor_kind="stateless",
        context_size=ctx,
    )


def _dequant_pairs(tensors):
    """Join int8 tensors with their per-tensor/channel scales by name stem."""
    out = {}
    for name, arr in tensors.items():
        if arr.dtype == np.int8:
            for suffix in ("_scale", ".scale", "_quantized_scale"):
                cand = name.replace("_quantized", "") + suffix
                if cand in tensors:
                    out[name] = arr.astype(np.float32) * tensors[cand]
                    break
            else:
                out[name] = arr  # keep raw int8; caller may dequant later
        elif arr.dtype in (np.float32, np.float16):
            out[name] = arr.astype(np.float32)
    return out


def convert_decoder_joiner(decoder_onnx, joiner_onnx, rnnt_cfg: RNNTConfig):
    """Build {predictor, joint} subtrees from sherpa decoder/joiner graphs.

    Returns (predictor_params, joint_params).
    """
    dec = _dequant_pairs(read_onnx_initializers(decoder_onnx))
    joi = _dequant_pairs(read_onnx_initializers(joiner_onnx))
    v, d = rnnt_cfg.vocab_size, rnnt_cfg.pred_hidden
    ctx = rnnt_cfg.context_size

    embed = None
    conv = None
    for name, arr in dec.items():
        if arr.ndim == 2 and arr.shape == (v, d):
            embed = arr
        elif arr.ndim == 3 and sorted(arr.shape) == sorted((d, d, ctx)):
            conv = arr
    if embed is None or conv is None:
        raise ValueError(
            f"decoder graph tensors not identified (need embed [{v},{d}] and "
            f"conv [{d},{d},{ctx}]); found shapes: "
            f"{[a.shape for a in dec.values()]}"
        )
    # torch Conv1d weight [out, in, K] applied over the ctx axis is exactly a
    # linear over the concatenated per-step embeddings: w_lin[(k*in)+i, out]
    if conv.shape == (d, d, ctx):
        w = np.transpose(conv, (2, 1, 0)).reshape(ctx * d, d)
    else:
        raise ValueError(f"unexpected decoder conv layout: {conv.shape}")
    bias = next(
        (a for a in dec.values() if a.ndim == 1 and a.shape == (d,)),
        np.zeros(d, np.float32),
    )
    predictor = {
        "embed": {"table": embed},
        "ctx_proj": {"w": w, "b": bias},
    }

    j = rnnt_cfg.joint_hidden
    enc_w = pred_w = out_w = None
    enc_b = pred_b = out_b = None
    for name, arr in joi.items():
        if arr.ndim != 2:
            continue
        shape = arr.shape
        if shape == (j, rnnt_cfg.enc_dim) or shape == (rnnt_cfg.enc_dim, j):
            enc_w = arr.T if shape[0] == j else arr
        elif shape == (j, d) or (shape == (d, j) and d != j):
            pred_w = arr.T if shape[0] == j else arr
        elif shape == (rnnt_cfg.num_classes, j) or shape == (j, rnnt_cfg.num_classes):
            out_w = arr.T if shape[0] == rnnt_cfg.num_classes else arr
    for name, arr in joi.items():
        if arr.ndim == 1:
            if arr.shape == (j,) and enc_b is None:
                enc_b = arr
            elif arr.shape == (j,) and pred_b is None:
                pred_b = arr
            elif arr.shape == (rnnt_cfg.num_classes,):
                out_b = arr
    if enc_w is None or out_w is None:
        raise ValueError(
            f"joiner tensors not identified; found shapes: "
            f"{[a.shape for a in joi.values()]}"
        )
    if pred_w is None and d == j:
        raise ValueError(
            "joiner enc/pred projections are shape-ambiguous (enc_dim == "
            "pred_hidden == joint_hidden); convert from the icefall .pt instead"
        )
    joint = {
        "enc": {"w": enc_w, "b": enc_b if enc_b is not None else np.zeros(j, np.float32)},
        "pred": {"w": pred_w, "b": pred_b if pred_b is not None else np.zeros(j, np.float32)},
        "out": {"w": out_w, "b": out_b if out_b is not None else np.zeros(rnnt_cfg.num_classes, np.float32)},
    }
    return predictor, joint


def convert_zipformer_torch(pt_path, out_path, enc_cfg=None, rnnt_cfg=None):
    """Entry point for icefall .pt zipformer checkpoints (the encoder's
    canonical source; published alongside the ONNX exports) — delegates to
    convert.icefall_zipformer."""
    from .icefall_zipformer import convert_icefall_checkpoint

    return convert_icefall_checkpoint(pt_path, out_path, enc_cfg, rnnt_cfg)


def convert_sherpa_snapshot(
    encoder_onnx,
    decoder_onnx,
    joiner_onnx,
    out_path,
    tokens_txt=None,
    icefall_pt=None,
    enc_cfg=None,
):
    """Convert a sherpa-style published snapshot to a native param tree.

    The decoder/joiner always convert from the ONNX graphs (shape-driven,
    int8-aware). The encoder converts from ``icefall_pt`` when given; the
    traced encoder ONNX graph is constant-folded by the exporter (Linear
    weights lose their module names), so without the .pt the conversion
    raises with that explanation rather than guessing.
    """
    import os

    from ..models.zipformer import ZipformerConfig

    token_list = read_tokens_txt(tokens_txt) if tokens_txt else None
    if enc_cfg is None:
        # sherpa repos carry no encoder config file; the published models are
        # Zipformer-L (README.rst:28). Tests shrink via the size env var.
        tiny = os.environ.get("REAZONSPEECH_TPU_MODEL_SIZE") == "tiny"
        enc_cfg = ZipformerConfig.tiny() if tiny else ZipformerConfig.large()
    rnnt_cfg = infer_rnnt_cfg_from_onnx(decoder_onnx, joiner_onnx, enc_cfg.out_dim)
    if token_list and rnnt_cfg.vocab_size != len(token_list):
        raise ValueError(
            f"tokens.txt has {len(token_list)} entries but the decoder "
            f"embedding has {rnnt_cfg.vocab_size} rows"
        )

    predictor, joint = convert_decoder_joiner(decoder_onnx, joiner_onnx, rnnt_cfg)

    if icefall_pt is None:
        raise FileNotFoundError(
            "sherpa ONNX encoder graphs are constant-folded at export time "
            "(module names are lost), so the Zipformer encoder must convert "
            "from the icefall .pt checkpoint published alongside the ONNX "
            f"files; none was found next to {encoder_onnx}. Download the "
            "repo's exp/pretrained.pt (or epoch-*.pt) and re-run."
        )
    import torch

    sd = torch.load(icefall_pt, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    from .icefall_zipformer import convert_icefall_state_dict

    params = convert_icefall_state_dict(sd, enc_cfg, rnnt_cfg)
    # ONNX decoder/joiner win over the .pt ones: for int8 precisions they
    # carry the published quantization (pkg/k2-asr/src/huggingface.py:47-58)
    params["predictor"] = predictor
    params["joint"] = joint

    meta = {
        "flavor": "k2-zipformer",
        "enc_cfg": {k: getattr(enc_cfg, k) for k in enc_cfg.__dataclass_fields__},
        "rnnt_cfg": {k: getattr(rnnt_cfg, k) for k in rnnt_cfg.__dataclass_fields__},
    }
    if token_list:
        meta["token_list"] = token_list
    save_param_tree(out_path, params, meta)
    return params, enc_cfg, rnnt_cfg
