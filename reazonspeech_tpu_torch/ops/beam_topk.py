"""Fused log-softmax + blank split + exact top-m for transducer beam search.

``topm_logsoftmax`` is the port of
``reazonspeech_tpu.ops.beam_topk.topm_logsoftmax``: per row of [R, V]
logits, the fp32 log-sum-exp, the blank log-prob, and the top-m label
log-probs with blank excluded, ties going to the LOWEST index (the order of
``jax.lax.top_k``; ``torch.topk`` promises no order among equal values on
CUDA, and bf16 joint logits tie often). On a CUDA tensor it launches the
hand-written kernel in ``csrc/beam_topk.cu`` (one launch at any V; the
logits need not be 16-byte aligned); on a CPU tensor it runs
:func:`topm_logsoftmax_plain`.

``joint_topm`` is the port of ``reazonspeech_tpu.ops.beam_topk.joint_topm``:
the joint's prediction projection, activation and output projection before
the same top-m, the beam decoders' whole per-step tail when
``joint_impl="pallas"``, in fp32. On a CUDA tensor it launches the kernel in
``csrc/joint_topm.cu`` (two launches, the merge inside the second; fp32
only: a bf16 ``compute_dtype`` raises); on a CPU tensor it runs
:func:`joint_topm_plain`, which takes both dtypes.

A row split over blocks (``topm_logsoftmax`` past 4,096 columns, and every
``joint_topm`` call) is merged by the last of its blocks to finish, found by
an atomic ticket. The tickets and the partials live in a workspace kept per
(kernel, device, stream) and sized by the C code, so no call allocates one
once it is large enough and two streams never share one; the tickets are
zeroed when allocated and the kernels alone change them from then on.
"""

import torch

from ._kernels import (
    as_dtype, check_cuda, launch_on, refuse_grad, stream_of, workspace_words,
)

__all__ = ["joint_topm", "joint_topm_plain", "take_workspaces", "topm_logsoftmax",
           "topm_logsoftmax_plain"]

_NEG = -1.0e30  # value of an excluded column (blank, already picked)
_ACTIVATIONS = ("relu", "tanh", "sigmoid")  # their codes in csrc/joint_topm.cu

_workspaces = {}  # (kernel, device index, stream) -> [tickets, scratch]


def _workspace(kernel, dev, stream, *sizes):
    """(scratch, tickets) addresses of ``kernel``'s workspace for the calling
    stream and a call of these sizes (None, None where it needs none). A
    buffer is replaced only to grow (the old one is freed in stream order);
    tickets are int32 zeros when allocated."""
    counters, words = workspace_words(kernel, *sizes)
    if counters == 0:
        return None, None
    ws = _workspaces.setdefault((kernel, dev.index, stream), [None, None])
    if ws[0] is None or ws[0].numel() < counters:
        ws[0] = torch.zeros((counters,), dtype=torch.int32, device=dev)
    if ws[1] is None or ws[1].numel() < words:
        ws[1] = torch.empty((words,), dtype=torch.int32, device=dev)
    return ws[1].data_ptr(), ws[0].data_ptr()


def take_workspaces(dev, stream):
    """Remove the workspaces held for ``stream`` on ``dev`` and return their
    buffers: a captured CUDA graph keeps the buffers its kernels read, and
    the stream's next call gets new ones."""
    taken = [k for k in list(_workspaces) if k[1:] == (dev.index, stream)]
    return [buf for k in taken for buf in _workspaces.pop(k) if buf is not None]


def topm_logsoftmax_plain(logits, m, blank):
    """Plain PyTorch twin: m masked argmax passes, lowest index among ties.

    Returns (lp_blank [R] f32, top_lp [R, m] f32, top_tok [R, m] int32)."""
    x = logits.to(torch.float32)
    v = x.shape[-1]
    col = torch.arange(v, device=x.device)
    xm = x.max(dim=-1, keepdim=True).values
    lse = xm + torch.log(torch.exp(x - xm).sum(dim=-1, keepdim=True))
    lp_blank = (x[:, blank : blank + 1] - lse)[:, 0]
    x = torch.where(col == blank, _NEG, x)
    vals, idxs = [], []
    for _ in range(m):
        vmax = x.max(dim=-1, keepdim=True).values
        am = torch.where(x == vmax, col, v).min(dim=-1, keepdim=True).values
        vals.append(vmax)
        idxs.append(am)
        x = torch.where(col == am, _NEG, x)
    return lp_blank, torch.cat(vals, dim=-1) - lse, torch.cat(idxs, dim=-1).to(torch.int32)


def topm_logsoftmax(logits, m, blank):
    """Blank log-prob and exact top-m label log-probs of each row.

    Args:
      logits: [R, V] float32 or bfloat16 (compute is fp32)
      m: label expansions per row
      blank: blank column

    Returns (lp_blank [R] f32, top_lp [R, m] f32, top_tok [R, m] int32).
    """
    if logits.device.type == "cpu":
        return topm_logsoftmax_plain(logits, m, blank)
    refuse_grad("topm_logsoftmax", logits)
    r, v = logits.shape
    if m < 1 or not 0 <= blank < v:
        raise ValueError(f"topm_logsoftmax: m={m}, blank={blank}, V={v} out of range")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"topm_logsoftmax: dtype {logits.dtype} not supported")
    check_cuda("logits", logits, logits.dtype, (r, v), aligned=False)
    dev, f32 = logits.device, torch.float32
    lp_blank = torch.empty((r,), dtype=f32, device=dev)
    top_lp = torch.empty((r, m), dtype=f32, device=dev)
    top_tok = torch.empty((r, m), dtype=torch.int32, device=dev)
    stream = stream_of(logits)
    scratch, tickets = _workspace("topm", dev, stream, r, v, m)
    launch_on(dev, "rs_topm_logsoftmax", logits.data_ptr(), lp_blank.data_ptr(),
              top_lp.data_ptr(), top_tok.data_ptr(), scratch, tickets, r, v, m, blank,
              int(logits.dtype == torch.bfloat16), stream)
    return lp_blank, top_lp, top_tok


def _activate(z, activation):
    if activation == "relu":
        return torch.relu(z)
    if activation == "tanh":
        return torch.tanh(z)
    if activation == "sigmoid":
        return torch.sigmoid(z)
    raise ValueError(f"unknown activation {activation!r}")


def joint_topm_plain(w_pred, b_pred, w_out, b_out, enc_proj_row, dec_out, m, blank, *,
                     activation="relu", compute_dtype="bfloat16"):
    """Plain PyTorch twin, the JAX ``joint_topm_xla``: the joint in
    ``compute_dtype``, then :func:`topm_logsoftmax_plain` on fp32 logits."""
    cdt = as_dtype(compute_dtype)
    z = enc_proj_row.to(cdt) + (dec_out.to(cdt) @ w_pred.to(cdt) + b_pred.to(cdt))
    logits = (_activate(z, activation) @ w_out.to(cdt) + b_out.to(cdt)).to(torch.float32)
    return topm_logsoftmax_plain(logits, m, blank)


def joint_topm(w_pred, b_pred, w_out, b_out, enc_proj_row, dec_out, m, blank, *,
               activation="relu", compute_dtype="bfloat16"):
    """Joint projection + activation + output projection + log-softmax +
    blank split + exact top-m of each row.

    Args:
      w_pred: [H, J]; b_pred: [J]; w_out: [J, V]; b_out: [V]
      enc_proj_row: [R, J] the encoder side of the joint at each row's frame
      dec_out: [R, H] the prediction network's output
      m: label expansions per row; blank: its column
      activation: "relu", "tanh" or "sigmoid"
      compute_dtype: the joint's dtype; the CUDA kernel takes "float32" only

    Returns (lp_blank [R] f32, top_lp [R, m] f32, top_tok [R, m] int32), as
    :func:`topm_logsoftmax`.
    """
    if enc_proj_row.device.type == "cpu":
        return joint_topm_plain(w_pred, b_pred, w_out, b_out, enc_proj_row, dec_out, m, blank,
                                activation=activation, compute_dtype=compute_dtype)
    refuse_grad("joint_topm", w_pred, b_pred, w_out, b_out, enc_proj_row, dec_out)
    if as_dtype(compute_dtype) != torch.float32:
        raise ValueError(f"joint_topm: compute_dtype {compute_dtype} on CUDA; the beam decoders "
                         "pass float32 only, the kernel takes nothing else")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    r, j = enc_proj_row.shape
    hid, v = dec_out.shape[-1], w_out.shape[-1]
    if m < 1 or not 0 <= blank < v:
        raise ValueError(f"joint_topm: m={m}, blank={blank}, V={v} out of range")
    f32, dev = torch.float32, enc_proj_row.device
    for name, t, shape in (("w_pred", w_pred, (hid, j)), ("b_pred", b_pred, (j,)),
                           ("w_out", w_out, (j, v)), ("b_out", b_out, (v,)),
                           ("enc_proj_row", enc_proj_row, (r, j)), ("dec_out", dec_out, (r, hid))):
        check_cuda(name, t, f32, shape, dev)
    stream = stream_of(enc_proj_row)
    scratch, tickets = _workspace("joint", dev, stream, r, j, v, m)
    lp_blank = torch.empty((r,), dtype=f32, device=dev)
    top_lp = torch.empty((r, m), dtype=f32, device=dev)
    top_tok = torch.empty((r, m), dtype=torch.int32, device=dev)
    launch_on(dev, "rs_joint_topm", w_pred.data_ptr(), b_pred.data_ptr(), w_out.data_ptr(),
              b_out.data_ptr(), enc_proj_row.data_ptr(), dec_out.data_ptr(), scratch, tickets,
              lp_blank.data_ptr(), top_lp.data_ptr(), top_tok.data_ptr(), r, hid, j, v, m, blank,
              _ACTIVATIONS.index(activation), stream)
    return lp_blank, top_lp, top_tok
