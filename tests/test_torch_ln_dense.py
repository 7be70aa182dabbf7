"""The port's LayerNorm-fused ops, packed attention and in-kernel-LN conv
module on the CPU: each plain twin against the JAX Pallas kernel it replaces
(run in interpret mode) or, where the JAX kernel needs an aligned T, its XLA
reference. Tolerances: fp32 outputs to 1e-5; bf16 outputs within 2 bf16
ulps of the JAX value (the twins and the kernels round at the same points;
only the fp32 summation order differs). The ulp is taken at the larger of
|value| and the output's mean magnitude: when the two orders put one
normalized input on either side of a bf16 rounding boundary, every output
of its row moves by about |w|·ulp(input), which is far below an ulp of a
typical output but can be several ulps of an output near zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.ops import conformer_conv as jcc
from reazonspeech_tpu.ops import ln_dense as jlnd
from reazonspeech_tpu.ops import relpos_attention as jra
from reazonspeech_tpu_torch.ops import (
    add_ln, add_ln_plain, fold_batch_norm, fused_conv_module, fused_conv_module_plain,
    ln_dense, ln_dense_add, ln_dense_add_plain, ln_dense_plain,
    relpos_attention_fused_packed, relpos_attention_fused_packed_plain,
)

T = torch.from_numpy
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps at max(|want|, mean |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    exp = np.floor(np.log2(np.maximum(np.abs(want), np.abs(want).mean())))
    return float(np.max(np.abs(got - want) / np.exp2(exp - 7)))


def _assert_close(got, want, dtype):
    want = np.asarray(want.astype(jnp.float32) if hasattr(want, "astype") else want)
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert _bf16_ulps(got, want) <= 2.0


def _ln_inputs(t, d, widths, dtype, seed):
    """x [2, t, d] (a large mean, so the centring matters), LN affine, and
    one (w, c) per segment; weights in the compute dtype."""
    rng = np.random.default_rng(seed)
    x = _f32(rng, 2, t, d) + 3.0
    g, b = 1.0 + _f32(rng, d, scale=0.1), _f32(rng, d, scale=0.1)
    ws = [_f32(rng, d, n, scale=d ** -0.5) for n in widths]
    cs = [_f32(rng, n, scale=0.1) for n in widths]
    tdt, jdt = DTYPES[dtype]
    tw = tuple(T(w).to(tdt) for w in ws)
    jw = tuple(jnp.asarray(w).astype(jdt) for w in ws)
    return x, g, b, (tw, tuple(map(T, cs))), (jw, tuple(map(jnp.asarray, cs)))


SEGMENTS = {"one": (256,), "qkv": (64, 64, 64)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", [None, "swish"])
@pytest.mark.parametrize("segments", ["one", "qkv"])
def test_ln_dense_plain_matches_jax_kernel(segments, activation, dtype):
    """T=45 (not 128-aligned): the twin against the JAX kernel, one weight
    or three segments written side by side."""
    x, g, b, (tw, tc), (jw, jc) = _ln_inputs(45, 64, SEGMENTS[segments], dtype, seed=1)
    want = jlnd.ln_dense(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                         jw if segments == "qkv" else jw[0], jc if segments == "qkv" else jc[0],
                         activation=activation, interpret=True)
    w, c = (tw, tc) if segments == "qkv" else (tw[0], tc[0])
    got = ln_dense_plain(T(x), T(g), T(b), w, c, activation)
    assert got.dtype == tw[0].dtype and got.shape == (2, 45, sum(SEGMENTS[segments]))
    _assert_close(got, want, dtype)
    torch.testing.assert_close(ln_dense(T(x), T(g), T(b), w, c, activation=activation), got,
                               atol=0.0, rtol=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", [None, "swish"])
@pytest.mark.parametrize("segments", ["one", "qkv"])
def test_ln_dense_add_plain_matches_jax_kernel(segments, activation, dtype):
    """r + 0.5·delta in fp32 (the stream equal to 1e-6), then as ln_dense;
    delta in the compute dtype, as the encoder gives it."""
    x, g, b, (tw, tc), (jw, jc) = _ln_inputs(45, 64, SEGMENTS[segments], dtype, seed=2)
    delta = _f32(np.random.default_rng(3), *x.shape)
    tdt, jdt = DTYPES[dtype]
    w, c = (tw, tc) if segments == "qkv" else (tw[0], tc[0])
    want, want_stream = jlnd.ln_dense_add(
        jnp.asarray(x), jnp.asarray(delta).astype(jdt), jnp.asarray(g), jnp.asarray(b),
        jw if segments == "qkv" else jw[0], jc if segments == "qkv" else jc[0], scale=0.5,
        activation=activation, interpret=True)
    got, got_stream = ln_dense_add_plain(T(x), T(delta).to(tdt), T(g), T(b), w, c, 0.5,
                                         activation)
    assert got_stream.dtype == torch.float32
    np.testing.assert_allclose(got_stream.numpy(), np.asarray(want_stream), atol=1e-6, rtol=0)
    _assert_close(got, want, dtype)
    pub = ln_dense_add(T(x), T(delta).to(tdt), T(g), T(b), w, c, scale=0.5,
                       activation=activation)
    torch.testing.assert_close(pub[0], got, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("y_dtype", ["float32", "bfloat16"])
def test_add_ln_plain_matches_jax_kernel(y_dtype):
    """Ragged lengths: valid rows to 1e-5, rows at or past the length exactly 0."""
    rng = np.random.default_rng(4)
    r, y = _f32(rng, 3, 45, 64) + 1.0, _f32(rng, 3, 45, 64)
    g, b = 1.0 + _f32(rng, 64, scale=0.1), _f32(rng, 64, scale=0.1)
    lengths = np.array([45, 30, 1], np.int32)
    tdt, jdt = DTYPES[y_dtype]
    want = np.asarray(jlnd.add_ln(jnp.asarray(r), jnp.asarray(y).astype(jdt),
                                  jnp.asarray(lengths), jnp.asarray(g), jnp.asarray(b),
                                  scale=0.5, interpret=True))
    got = add_ln_plain(T(r), T(y).to(tdt), T(lengths), T(g), T(b), 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    pad = np.arange(45)[None, :] >= lengths[:, None]
    assert not np.any(got.numpy()[pad]) and pad.sum() > 0
    torch.testing.assert_close(add_ln(T(r), T(y).to(tdt), T(lengths), T(g), T(b), scale=0.5),
                               got, atol=0.0, rtol=0.0)


def _packed_inputs(b, t, h, dh, seed):
    rng = np.random.default_rng(seed)
    return (_f32(rng, b, t, 3 * h * dh), _f32(rng, 2 * t - 1, h, dh), _f32(rng, h, dh, scale=0.1),
            _f32(rng, h, dh, scale=0.1))


@pytest.mark.parametrize("h,dh", [(8, 16), (2, 64)])
def test_packed_attention_plain_matches_jax_kernel(h, dh):
    """T=128 (the JAX kernel's aligned layout): fp32, every row, to 1e-5."""
    qkv, pos, bu, bv = _packed_inputs(3, 128, h, dh, seed=h)
    lengths = np.array([128, 100, 7], np.int32)
    want = np.asarray(jra.relpos_attention_fused_packed(
        jnp.asarray(qkv), jnp.asarray(pos), jnp.asarray(bu), jnp.asarray(bv),
        jnp.asarray(lengths), heads=h, interpret=True))
    got = relpos_attention_fused_packed_plain(T(qkv), T(pos), T(bu), T(bv), T(lengths), h)
    assert got.shape == (3, 128, h * dh)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        relpos_attention_fused_packed(T(qkv), T(pos), T(bu), T(bv), T(lengths), h), got,
        atol=0.0, rtol=0.0)


def test_packed_attention_plain_matches_jax_reference_unaligned():
    """T=45: against the JAX packed kernel's XLA reference, to 1e-5."""
    h, dh = 4, 16
    qkv, pos, bu, bv = _packed_inputs(2, 45, h, dh, seed=9)
    lengths = np.array([45, 20], np.int32)
    want = np.asarray(jra._fused_packed_xla_reference(
        jnp.asarray(qkv), jnp.asarray(pos), jnp.asarray(bu), jnp.asarray(bv),
        jnp.asarray(lengths)))
    got = relpos_attention_fused_packed_plain(T(qkv), T(pos), T(bu), T(bv), T(lengths), h)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_module_ln_plain_matches_jax_kernel(dtype):
    """The in-kernel LayerNorm branch: the raw fp32 stream in, normalized in
    fp32 and rounded to the compute dtype; valid rows compared."""
    rng = np.random.default_rng(12)
    b, t, d, k = 3, 40, 64, 9
    x = _f32(rng, b, t, d) + 2.0
    g, beta = 1.0 + _f32(rng, d, scale=0.1), _f32(rng, d, scale=0.1)
    bn = {"scale": 1.0 + _f32(rng, d, scale=0.2), "bias": _f32(rng, d, scale=0.1),
          "mean": _f32(rng, d, scale=0.1), "var": rng.uniform(0.5, 2.0, d).astype(np.float32)}
    w = dict(w_in=_f32(rng, d, 2 * d, scale=d ** -0.5), b_in=_f32(rng, 2 * d, scale=0.1),
             dw=_f32(rng, k, 1, d, scale=k ** -0.5), b_dw=_f32(rng, d, scale=0.1),
             w_out=_f32(rng, d, d, scale=d ** -0.5), b_out=_f32(rng, d, scale=0.1))
    lengths = np.array([40, 25, 3], np.int32)
    tdt, jdt = DTYPES[dtype]
    names = ("w_in", "b_in", "dw", "b_dw")
    js, jb = jcc.fold_batch_norm({n: jnp.asarray(v) for n, v in bn.items()})
    want = jcc.fused_conv_module(
        jnp.asarray(x), jnp.asarray(lengths), *(jnp.asarray(w[n]) for n in names), js, jb,
        jnp.asarray(w["w_out"]), jnp.asarray(w["b_out"]), ln_scale=jnp.asarray(g),
        ln_bias=jnp.asarray(beta), compute_dtype=jdt, interpret=True)
    ts, tb = fold_batch_norm({n: T(v) for n, v in bn.items()})
    args = (T(x), T(lengths), *(T(w[n]) for n in names), ts, tb, T(w["w_out"]), T(w["b_out"]))
    kw = dict(ln_scale=T(g), ln_bias=T(beta), compute_dtype=tdt)
    got = fused_conv_module_plain(*args, **kw)
    assert got.dtype == tdt
    valid = np.arange(t)[None, :] < lengths[:, None]
    want = np.asarray(want.astype(jnp.float32))[valid]
    _assert_close(got.to(torch.float32)[T(valid)], want, dtype)
    torch.testing.assert_close(fused_conv_module(*args, **kw), got, atol=0.0, rtol=0.0)
