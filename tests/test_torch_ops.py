"""The port's kernel modules on the CPU: each plain twin against the JAX
Pallas kernel it replaces (run in interpret mode) and, where the JAX package
has one, its XLA reference. The wrappers take the plain twin only for CPU
tensors; on any other device they go to the kernel or raise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.ops import beam_topk as jbt
from reazonspeech_tpu.ops import conformer_conv as jcc
from reazonspeech_tpu.ops import relpos_attention as jra
from reazonspeech_tpu_torch.ops import (
    add_ln, fold_batch_norm, fused_conv_module, fused_conv_module_plain, ln_dense,
    ln_dense_add, relpos_attention_fused, relpos_attention_fused_packed,
    relpos_attention_fused_plain, topm_logsoftmax, topm_logsoftmax_plain,
)

T = torch.from_numpy


def _attn_inputs(b, h, t, dh, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (mk(b, t, h * dh), mk(b, t, h * dh), mk(b, t, h * dh), mk(2 * t - 1, h, dh),
            mk(h, dh), mk(h, dh))


@pytest.mark.parametrize("h,dh", [(8, 16), (2, 64)])
@pytest.mark.parametrize("t", [40, 128, 200])
def test_relpos_attention_plain_matches_jax_kernel(h, dh, t):
    """fp32: the plain twin equals the JAX fused kernel to 1e-5 (abs and rel)
    on every row, ragged lengths included."""
    q, k, v, pos, bu, bv = _attn_inputs(3, h, t, dh, seed=t + h)
    lengths = np.array([t, t - 13, 7], np.int32)
    want = np.asarray(jra.relpos_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(bu), jnp.asarray(bv), jnp.asarray(lengths), heads=h, interpret=True))
    got = relpos_attention_fused_plain(T(q), T(k), T(v), T(pos), T(bu), T(bv),
                                       T(lengths), h)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # on CPU tensors the public op is the plain twin
    np.testing.assert_array_equal(
        relpos_attention_fused(T(q), T(k), T(v), T(pos), T(bu), T(bv), T(lengths), h).numpy(),
        got.numpy())


def test_relpos_attention_plain_masks_keys():
    """Keys and values past the valid length do not change any output."""
    b, h, t, dh = 2, 2, 24, 16
    q, k, v, pos, bu, bv = map(T, _attn_inputs(b, h, t, dh, seed=5))
    lengths = torch.tensor([24, 10], dtype=torch.int32)
    out1 = relpos_attention_fused_plain(q, k, v, pos, bu, bv, lengths, h)
    k2, v2 = k.clone(), v.clone()
    k2[1, 10:] = 99.0
    v2[1, 10:] = -99.0
    out2 = relpos_attention_fused_plain(q, k2, v2, pos, bu, bv, lengths, h)
    torch.testing.assert_close(out1, out2, atol=0.0, rtol=0.0)


def _conv_inputs(b, t, d, k, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    bn = {"scale": 1.0 + f(d, sc=0.2), "bias": f(d, sc=0.1), "mean": f(d, sc=0.1),
          "var": rng.uniform(0.5, 2.0, d).astype(np.float32)}
    return dict(x=f(b, t, d), w_in=f(d, 2 * d, sc=d ** -0.5), b_in=f(2 * d, sc=0.1),
                dw=f(k, 1, d, sc=k ** -0.5), b_dw=f(d, sc=0.1), bn=bn,
                w_out=f(d, d, sc=d ** -0.5), b_out=f(d, sc=0.1))


def _conv_args(p, lengths, lib):
    """Positional args of fused_conv_module for either package."""
    if lib == "jax":
        scale, bias = jcc.fold_batch_norm({k: jnp.asarray(v) for k, v in p["bn"].items()})
        a = jnp.asarray
    else:
        scale, bias = fold_batch_norm({k: T(v) for k, v in p["bn"].items()})
        a = T
    return (a(p["x"]), a(lengths), a(p["w_in"]), a(p["b_in"]), a(p["dw"]), a(p["b_dw"]),
            scale, bias, a(p["w_out"]), a(p["b_out"]))


@pytest.mark.parametrize("k", [3, 9])
def test_conv_module_plain_matches_jax_kernel(k):
    """fp32: the plain twin equals the JAX fused conv kernel to 1e-5 on the
    valid rows (padded rows are garbage in both, masked downstream)."""
    b, t, d = 3, 48, 64
    p = _conv_inputs(b, t, d, k, seed=k)
    lengths = np.array([48, 30, 5], np.int32)
    want = np.asarray(jcc.fused_conv_module(*_conv_args(p, lengths, "jax"), interpret=True))
    got = fused_conv_module_plain(*_conv_args(p, lengths, "torch")).numpy()
    valid = (np.arange(t)[None, :] < lengths[:, None])[..., None]
    np.testing.assert_allclose(got * valid, want * valid, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(fused_conv_module(*_conv_args(p, lengths, "torch")).numpy(),
                                  got)


def test_conv_module_plain_padding_isolation():
    """Valid frames do not change when the padding's content does."""
    p = _conv_inputs(1, 32, 64, 9, seed=11)
    lengths = np.array([20], np.int32)
    y1 = fused_conv_module_plain(*_conv_args(p, lengths, "torch"))[:, :20]
    p["x"] = p["x"].copy()
    p["x"][:, 20:] = 99.0
    y2 = fused_conv_module_plain(*_conv_args(p, lengths, "torch"))[:, :20]
    torch.testing.assert_close(y1, y2, atol=0.0, rtol=0.0)


def test_fold_batch_norm_matches_jax():
    p = _conv_inputs(1, 4, 64, 3, seed=2)["bn"]
    want = jcc.fold_batch_norm({k: jnp.asarray(v) for k, v in p.items()})
    got = fold_batch_norm({k: T(v) for k, v in p.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("r,v,m,blank", [(6, 11, 4, 10), (6, 11, 4, 0), (300, 257, 20, 0),
                                         (16, 3001, 4, 3000), (4, 5, 4, 0)])
def test_topm_plain_matches_jax(r, v, m, blank):
    """Log-probs to 1e-5 and the same indices as the JAX kernel and its XLA
    reference."""
    x = (np.random.default_rng(r + v).standard_normal((r, v)) * 3.0).astype(np.float32)
    got = topm_logsoftmax_plain(T(x), m, blank)
    for want in (jbt.topm_logsoftmax(jnp.asarray(x), m, blank, interpret=True),
                 jbt.topm_logsoftmax_xla(jnp.asarray(x), m, blank)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(topm_logsoftmax(T(x), m, blank)[2].numpy(), got[2].numpy())


def test_topm_plain_integer_ties():
    """Integer-valued logits tie everywhere: indices equal the JAX kernel's
    (lowest index first), values exactly."""
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, size=(16, 301)).astype(np.float32)
    x[1] = 2.0  # a row of all ties
    got = topm_logsoftmax_plain(T(x), 4, 300)
    want = jbt.topm_logsoftmax(jnp.asarray(x), 4, 300, interpret=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[2][1].numpy(), [0, 1, 2, 3])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)


def test_topm_plain_bf16_logits():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 33)).astype(np.float32))
    x = (x * 2).to(torch.bfloat16)
    got = topm_logsoftmax_plain(x, 3, 0)
    want = jbt.topm_logsoftmax_xla(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), 3, 0)
    assert got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("op", ["attention", "conv", "topm", "ln_dense", "ln_dense_add",
                                "add_ln", "packed", "conv_ln"])
def test_non_cpu_tensors_never_take_the_plain_twin(op):
    """A tensor that is not on the CPU goes to the kernel path, whose checks
    refuse anything but CUDA: there is no fallback."""
    f32 = torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        if op == "attention":
            relpos_attention_fused(_meta(1, 4, 32), _meta(1, 4, 32), _meta(1, 4, 32),
                                   _meta(7, 2, 16), _meta(2, 16), _meta(2, 16),
                                   _meta(1, dtype=torch.int32), 2)
        elif op == "conv":
            fused_conv_module(_meta(1, 4, 64), _meta(1, dtype=torch.int32),
                              _meta(64, 128), _meta(128), _meta(9, 64), _meta(64),
                              _meta(64), _meta(64), _meta(64, 64), _meta(64))
        elif op == "topm":
            topm_logsoftmax(_meta(2, 11, dtype=f32), 4, 10)
        elif op == "ln_dense":
            ln_dense(_meta(1, 4, 64, dtype=f32), _meta(64, dtype=f32), _meta(64, dtype=f32),
                     _meta(64, 64), _meta(64, dtype=f32))
        elif op == "ln_dense_add":
            ln_dense_add(_meta(1, 4, 64, dtype=f32), _meta(1, 4, 64), _meta(64, dtype=f32),
                         _meta(64, dtype=f32), _meta(64, 64), _meta(64, dtype=f32))
        elif op == "add_ln":
            add_ln(_meta(1, 4, 64, dtype=f32), _meta(1, 4, 64), _meta(1, dtype=torch.int32),
                   _meta(64, dtype=f32), _meta(64, dtype=f32))
        elif op == "packed":
            relpos_attention_fused_packed(_meta(1, 4, 96), _meta(7, 2, 16), _meta(2, 16),
                                          _meta(2, 16), _meta(1, dtype=torch.int32), 2)
        else:
            fused_conv_module(_meta(1, 4, 64, dtype=f32), _meta(1, dtype=torch.int32),
                              _meta(64, 128), _meta(128), _meta(9, 64), _meta(64), _meta(64),
                              _meta(64), _meta(64, 64), _meta(64), ln_scale=_meta(64),
                              ln_bias=_meta(64), compute_dtype=torch.bfloat16)
