"""One fused LSTM cell step for the transducer prediction network.

``lstm_cell_step`` is the port of ``reazonspeech_tpu.ops.lstm_step.
lstm_cell_step``: gates = x·W_ih + h·W_hh + b, split (i, f, g, o), then
c' = σ(f)·c + σ(i)·tanh(g) and h' = σ(o)·tanh(c'). The beam decoders advance
their LSTM predictor one token a step with it when ``lstm_impl="pallas"``,
in fp32. On a CUDA tensor it launches the hand-written kernel in
``csrc/lstm_step.cu`` (fp32 only: a bf16 ``compute_dtype`` raises); on a CPU
tensor it runs :func:`lstm_cell_step_plain`, which takes both dtypes.

The kernel splits the gate columns over clusters of blocks and the depth
H_in + H over a cluster's blocks; it picks the split itself, from the widths
and the shared memory a block may hold.
"""

import torch

from ._kernels import as_dtype, check_cuda, launch_on, stream_of

__all__ = ["lstm_cell_step", "lstm_cell_step_plain"]


def lstm_cell_step_plain(w_ih, w_hh, bias, x, h, c, *, compute_dtype="bfloat16"):
    """Plain PyTorch twin, the JAX ``lstm_cell_step_xla``: the gate products
    and the bias summed in ``compute_dtype``, the cell in fp32.

    Returns (h_new [R, H] f32, c_new [R, H] f32)."""
    cdt = as_dtype(compute_dtype)
    gates = (x.to(cdt) @ w_ih.to(cdt) + h.to(cdt) @ w_hh.to(cdt) + bias.to(cdt)).to(torch.float32)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell_step(w_ih, w_hh, bias, x, h, c, *, compute_dtype="bfloat16"):
    """One LSTM cell step over R rows.

    Args:
      w_ih: [H_in, 4H]; w_hh: [H, 4H]; bias: [4H] (b_ih + b_hh, summed)
      x: [R, H_in]; h, c: [R, H] the previous state
      compute_dtype: the products' dtype; the CUDA kernel takes "float32" only

    Returns (h_new [R, H] f32, c_new [R, H] f32); h_new is also the output.
    """
    if x.device.type == "cpu":
        return lstm_cell_step_plain(w_ih, w_hh, bias, x, h, c, compute_dtype=compute_dtype)
    if as_dtype(compute_dtype) != torch.float32:
        raise ValueError(f"lstm_cell_step: compute_dtype {compute_dtype} on CUDA; the beam "
                         "decoders pass float32 only, the kernel takes nothing else")
    r, h_in = x.shape
    hid = h.shape[-1]
    f32, dev = torch.float32, x.device
    for name, t, shape in (("x", x, (r, h_in)), ("h", h, (r, hid)), ("c", c, (r, hid)),
                           ("w_ih", w_ih, (h_in, 4 * hid)), ("w_hh", w_hh, (hid, 4 * hid)),
                           ("bias", bias, (4 * hid,))):
        check_cuda(name, t, f32, shape, dev)
    h_new = torch.empty((r, hid), dtype=f32, device=dev)
    c_new = torch.empty((r, hid), dtype=f32, device=dev)
    launch_on(dev, "rs_lstm_cell_step", x.data_ptr(), h.data_ptr(), c.data_ptr(),
              w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), h_new.data_ptr(),
              c_new.data_ptr(), r, h_in, hid, stream_of(x))
    return h_new, c_new
