"""Kernel forward, plain-twin backward: the port of the JAX package's
custom-VJP pattern (``ops/ln_dense.py`` and ``ops/relpos_attention.py``'s
``*_diff`` functions: a Pallas forward, the XLA formula's VJP backward).

:func:`kernel_forward` runs ``kernel`` (the CUDA kernel on CUDA tensors,
its twin on CPU tensors) with autograd off, keeps the inputs, and in the
backward recomputes ``twin`` on them under ``torch.enable_grad()`` and
returns ``torch.autograd.grad`` of it. No backward kernel is written: the
JAX package has none either.
"""

import torch

__all__ = ["kernel_forward"]


class _KernelForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, twin, upcast, *inputs):
        ctx.twin, ctx.upcast = twin, upcast
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        leaves = []
        with torch.enable_grad():
            for x, n in zip(inputs, need):
                if x is None:
                    leaves.append(None)
                    continue
                x = x.detach()
                if ctx.upcast and x.is_floating_point():
                    x = x.to(torch.float32)
                leaves.append(x.requires_grad_(n))
            outs = ctx.twin(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g.to(o.dtype) for o, g in pairs], allow_unused=True))
        out = [None, None, None]
        for x, n in zip(inputs, need):
            g = next(got) if n else None
            out.append(None if g is None else g.to(x.dtype))
        return tuple(out)


def kernel_forward(kernel, twin, *inputs, upcast=False):
    """``kernel(*inputs)``, differentiable through ``twin``.

    ``inputs`` are tensors or None (pass every other argument through the
    two callables). The backward recomputes ``twin(*inputs)``, at the
    inputs' dtypes, or with ``upcast`` on fp32 copies of the floating ones
    (the attention's XLA formula is fp32 in the JAX package), and casts each
    gradient to its input's dtype."""
    return _KernelForward.apply(kernel, twin, upcast, *inputs)
