"""Frozen copies of ``chip_smoke.py``'s roofline arithmetic and seeded
input, kept here so that later changes to the smoke do not move the
benchmark's yardstick. Each names the lines it was copied from. (The
smoke's ``cuda_ms`` and ``device_items`` are not copied: the harness times
with CUDA events and reads the profiler itself, in ``runners/`` and
``trace.py``.)
"""

import numpy as np

__all__ = ["HBM_BYTES", "PEAK_FLOPS", "SR", "bound_ms", "flops_ln_dense", "speech_like"]

SR = 16000
# copied from chip_smoke.py:333-334: one H100 SXM's published peaks (dense
# bf16, fp32 outside the tensor cores, exponentials) and HBM rate
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "exp": 132 * 16 * 1.98e9}
HBM_BYTES = 3.35e12


def speech_like(seconds, seed):
    """Amplitude-modulated noise (as bench.py makes its inputs). Copied from
    chip_smoke.py:454-460; ``seed`` is anything numpy's default_rng takes."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / SR))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


def _tensors(xs):
    """The tensors in a nest of tuples/lists. Copied from chip_smoke.py:465-474."""
    import torch

    if isinstance(xs, torch.Tensor):
        return [xs]
    if isinstance(xs, (tuple, list)):
        return [t for x in xs for t in _tensors(x)]
    return []


def bound_ms(flops, args, out):
    """(ms, "bytes" | "operations"): the least time the card could take for
    the call, the larger of its bytes (inputs ``args`` read once, outputs
    ``out`` written once) over the HBM rate and its operations of each type
    (``flops``, {type: count}) over that type's peak rate. Copied from
    chip_smoke.py:476-484."""
    moved = sum(t.numel() * t.element_size() for t in _tensors(args) + _tensors(out))
    t_mem = moved / HBM_BYTES
    t_ops = max(n / PEAK_FLOPS[kind] for kind, n in flops.items())
    return max(t_mem, t_ops) * 1e3, ("operations" if t_ops > t_mem else "bytes")


def flops_ln_dense(args, out, w_at=3):
    """The projection of ``ln_dense`` (the LN is bytes). Copied from
    chip_smoke.py:514-517."""
    x, w = args[0], args[w_at]
    n = sum(t.shape[1] for t in _tensors(w))
    return {"bf16": 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * n}

