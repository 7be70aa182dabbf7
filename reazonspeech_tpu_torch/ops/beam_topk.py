"""Fused log-softmax + blank split + exact top-m for transducer beam search.

``topm_logsoftmax`` is the port of
``reazonspeech_tpu.ops.beam_topk.topm_logsoftmax``: per row of [R, V]
logits, the fp32 log-sum-exp, the blank log-prob, and the top-m label
log-probs with blank excluded, ties going to the LOWEST index (the order of
``jax.lax.top_k``; ``torch.topk`` promises no order among equal values on
CUDA, and bf16 joint logits tie often). On a CUDA tensor it launches the
hand-written kernel in ``csrc/beam_topk.cu``; on a CPU tensor it runs
:func:`topm_logsoftmax_plain`.
"""

import torch

from ._kernels import check_cuda, launch, stream_of

__all__ = ["topm_logsoftmax", "topm_logsoftmax_plain"]

_NEG = -1.0e30  # value of an excluded column (blank, already picked)
_MAX_M = 32  # the CUDA kernel keeps the picked indices in a fixed array
_MAX_V = 48 * 1024  # the CUDA kernel holds a row in shared memory as fp32


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
      m: label expansions per row (m ≤ 32 and V ≤ 49152 on CUDA)
      blank: blank column

    Returns (lp_blank [R] f32, top_lp [R, m] f32, top_tok [R, m] int32).
    """
    if logits.device.type == "cpu":
        return topm_logsoftmax_plain(logits, m, blank)
    r, v = logits.shape
    if not 1 <= m <= min(_MAX_M, v) or not 0 <= blank < v or v > _MAX_V:
        raise ValueError(f"topm_logsoftmax: m={m}, blank={blank}, V={v} out of range")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"topm_logsoftmax: dtype {logits.dtype} not supported")
    check_cuda("logits", logits, logits.dtype, (r, v))
    dev = logits.device
    lp_blank = torch.empty((r,), dtype=torch.float32, device=dev)
    top_lp = torch.empty((r, m), dtype=torch.float32, device=dev)
    top_tok = torch.empty((r, m), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch("rs_topm_logsoftmax", logits.data_ptr(), lp_blank.data_ptr(),
               top_lp.data_ptr(), top_tok.data_ptr(), r, v, m, blank,
               int(logits.dtype == torch.bfloat16), stream_of(logits))
    return lp_blank, top_lp, top_tok

