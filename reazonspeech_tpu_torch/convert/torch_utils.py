"""Weight-layout transforms: torch/ONNX tensors → this framework's layouts.

A copy of ``reazonspeech_tpu/convert/torch_utils.py`` with the same
behaviour, plus ``stack_trees`` (numpy only). Every converter builds on
these. Layout conventions here (see models/layers.py):
dense w [in, out]; conv1d w [K, in, out]; depthwise conv1d w [K, 1, C];
conv2d w [H, W, in, out] (grouped: [H, W, in/g, out]); LSTM torch gate order
(i, f, g, o) packed in w_ih [in, 4H] / w_hh [H, 4H].
"""

import numpy as np

__all__ = [
    "t_linear",
    "t_conv1d",
    "t_depthwise_conv1d",
    "t_conv2d",
    "t_conv3d",
    "t_lstm_layer",
    "t_batch_norm",
    "t_layer_norm",
    "to_numpy",
    "stack_trees",
]


def to_numpy(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def t_linear(weight, bias=None):
    """torch Linear [out, in] -> {w: [in, out], b: [out]}."""
    p = {"w": to_numpy(weight).T.copy()}
    if bias is not None:
        p["b"] = to_numpy(bias)
    return p


def t_flatten_proj(weight, bias, channels):
    """Subsampling flatten projection with layout correction.

    torch conv stacks flatten [B, C, T, F] -> transpose -> [B, T, C*F]
    (channel-major rows); our NHWC models flatten [B, T, F, C] -> [B, T, F*C]
    (freq-major). Reorder the Linear's input rows accordingly so the
    converted weight consumes our layout. Caught by the round-2 parity gate
    (tools/convert_and_gate.py) — structural shape checks can't see it since
    C*F == F*C."""
    p = t_linear(weight, bias)
    rows, d = p["w"].shape
    freq = rows // channels
    p["w"] = np.ascontiguousarray(
        p["w"].reshape(channels, freq, d).transpose(1, 0, 2).reshape(rows, d)
    )
    return p


def t_conv1d(weight, bias=None):
    """torch Conv1d [out, in, K] -> {w: [K, in, out]}."""
    p = {"w": np.transpose(to_numpy(weight), (2, 1, 0)).copy()}
    if bias is not None:
        p["b"] = to_numpy(bias)
    return p


def t_depthwise_conv1d(weight, bias=None):
    """torch depthwise Conv1d (groups=C) [C, 1, K] -> {w: [K, 1, C]}."""
    p = {"w": np.transpose(to_numpy(weight), (2, 1, 0)).copy()}
    if bias is not None:
        p["b"] = to_numpy(bias)
    return p


def t_conv2d(weight, bias=None):
    """torch Conv2d [out, in/g, H, W] -> {w: [H, W, in/g, out]}."""
    p = {"w": np.transpose(to_numpy(weight), (2, 3, 1, 0)).copy()}
    if bias is not None:
        p["b"] = to_numpy(bias)
    return p


def t_conv3d(weight, bias=None):
    """torch Conv3d [out, in, D, H, W] -> {w: [D, H, W, in, out]}."""
    p = {"w": np.transpose(to_numpy(weight), (2, 3, 4, 1, 0)).copy()}
    if bias is not None:
        p["b"] = to_numpy(bias)
    return p


def t_lstm_layer(w_ih, w_hh, b_ih, b_hh):
    """torch LSTM per-layer weights [4H, in]/[4H, H]/[4H] -> our layout
    (same i,f,g,o gate packing, transposed matrices)."""
    return {
        "w_ih": to_numpy(w_ih).T.copy(),
        "w_hh": to_numpy(w_hh).T.copy(),
        "b_ih": to_numpy(b_ih),
        "b_hh": to_numpy(b_hh),
    }


def t_batch_norm(weight, bias, running_mean, running_var):
    return {
        "scale": to_numpy(weight),
        "bias": to_numpy(bias),
        "mean": to_numpy(running_mean),
        "var": to_numpy(running_var),
    }


def t_layer_norm(weight, bias):
    return {"scale": to_numpy(weight), "bias": to_numpy(bias)}


def stack_trees(trees):
    """Same-structured dict/list trees -> one tree whose leaves are the
    inputs' leaves stacked on a new leading axis (the encoder's per-block
    trees -> its ``[L, ...]`` leaves)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees]) for i in range(len(first)))
    return np.stack(trees)
