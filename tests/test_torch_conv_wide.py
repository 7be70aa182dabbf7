"""The conv module (row 2) at the widths its CUDA wrapper takes since its two
products run on the TMA + wgmma GEMM: any D that is a multiple of 8, and
norm="layer" past the former D <= 2,048. The plain twin against the JAX
kernel in interpret mode there, and the wrapper's refusals on meta tensors
(which never reach the plain twin)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.ops import conformer_conv as jcc
from reazonspeech_tpu_torch.ops import fused_conv_module, fused_conv_module_plain


def _inputs(b, t, d, k, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = r(b, t, d) + 0.5
    lens = np.array([t, t // 2, 0][:b], np.int32)
    weights = [r(d, 2 * d, scale=d ** -0.5), r(2 * d, scale=0.1), r(k, 1, d, scale=k ** -0.5),
               r(d, scale=0.1), 1.0 + r(d, scale=0.2), r(d, scale=0.1), r(d, d, scale=d ** -0.5),
               r(d, scale=0.1)]
    ln = (1.0 + r(d, scale=0.1), r(d, scale=0.1))
    return x, lens, weights, ln


# (b, t, d, k, norm): D = 200 (a multiple of 8, not of 64) with both norms,
# nemo's and espnet's kernel widths; norm="layer" at D = 2,560 on a short T
CASES = [(3, 24, 200, 9, "folded"), (2, 24, 200, 31, "layer"), (2, 6, 2560, 9, "layer")]


@pytest.mark.parametrize("in_ln", [False, True])
@pytest.mark.parametrize("b,t,d,k,norm", CASES)
def test_conv_twin_matches_jax_at_the_new_widths(b, t, d, k, norm, in_ln):
    """fp32, with the pre-module LayerNorm by the caller and inside: the twin
    within 1e-5 max abs of the JAX kernel (both sum in fp32, in other
    orders), and the public op on CPU tensors is the twin."""
    x, lens, weights, (g, beta) = _inputs(b, t, d, k, seed=d + k + int(in_ln))
    kw = dict(ln_scale=g, ln_bias=beta) if in_ln else {}
    want = np.asarray(jcc.fused_conv_module(
        jnp.asarray(x), jnp.asarray(lens), *map(jnp.asarray, weights), norm=norm,
        interpret=True, **{n: jnp.asarray(v) for n, v in kw.items()}))
    args = (torch.from_numpy(x), torch.from_numpy(lens), *map(torch.from_numpy, weights))
    tkw = {n: torch.from_numpy(v) for n, v in kw.items()}
    got = fused_conv_module_plain(*args, norm=norm, **tkw)
    assert got.shape == (b, t, d)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    np.testing.assert_array_equal(fused_conv_module(*args, norm=norm, **tkw).numpy(),
                                  got.numpy())


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_args(d, dtype=torch.bfloat16):
    return (_meta(1, 4, d, dtype=dtype), _meta(1, dtype=torch.int32), _meta(d, 2 * d),
            _meta(2 * d), _meta(9, d), _meta(d), _meta(d), _meta(d), _meta(d, d), _meta(d))


@pytest.mark.parametrize("case,err,match", [
    ("D=100", ValueError, "multiple of 8"),
    ("D=100, layer", ValueError, "multiple of 8"),
    ("D=60,000, layer", ValueError, "CUDA"),
    ("fp32 compute", TypeError, "bf16"),
    ("fp32 compute, in-kernel LN", TypeError, "bf16"),
    ("D=200", ValueError, "CUDA"),
    ("D=2,560, layer", ValueError, "CUDA"),
])
def test_conv_wrapper_refusals(case, err, match):
    """On tensors off the CPU the wrapper goes to the kernel or raises: D not
    a multiple of 8, a compute dtype other than bf16. D = 200 and a
    norm="layer" D = 2,560 pass the shape rule and stop only at the check
    that the tensors are on a CUDA device (the kernel takes them there); so
    does a norm="layer" D = 60,000, which the kernel itself refuses on the
    card (one row of fp32 sums wider than a block's shared memory)."""
    f32 = torch.float32
    with pytest.raises(err, match=match):
        if case == "D=100":
            fused_conv_module(*_meta_args(100))
        elif case == "D=100, layer":
            fused_conv_module(*_meta_args(100), norm="layer")
        elif case == "D=60,000, layer":
            fused_conv_module(*_meta_args(60000), norm="layer")
        elif case == "fp32 compute":
            fused_conv_module(*_meta_args(64, f32), compute_dtype=f32)
        elif case == "fp32 compute, in-kernel LN":
            fused_conv_module(*_meta_args(64, f32), ln_scale=_meta(64), ln_bias=_meta(64))
        elif case == "D=200":
            fused_conv_module(*_meta_args(200))
        else:
            fused_conv_module(*_meta_args(2560, f32), norm="layer", ln_scale=_meta(2560),
                              ln_bias=_meta(2560), compute_dtype=torch.bfloat16)
