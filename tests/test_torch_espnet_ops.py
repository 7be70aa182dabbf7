"""The espnet path's kernels in the port against the JAX kernels on the CPU:
the [B, H, T, dh] rel-pos attention (single-pass and streamed twins against
``relpos_attention`` / ``relpos_attention_blockwise`` in interpret mode),
the conv module's ``norm="layer"`` twin against ``fused_conv_module``, and
the encoder's attention route against the JAX gates it mirrors."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.models import fastconformer as jfc
from reazonspeech_tpu.ops import conformer_conv as jcc
from reazonspeech_tpu.ops import ln_dense as jlnd
from reazonspeech_tpu.ops import relpos_attention as jra
from reazonspeech_tpu_torch.models import fastconformer as tfc
from reazonspeech_tpu_torch.ops.conformer_conv import fused_conv_module, fused_conv_module_plain
from reazonspeech_tpu_torch.ops.relpos_attention import (
    relpos_attention, relpos_attention_blockwise, relpos_attention_blockwise_plain,
    relpos_attention_plain,
)

H, DH = 2, 16


def _attn_inputs(t, seed):
    rng = np.random.default_rng(seed)
    qu, qv, k, v = (rng.standard_normal((2, H, t, DH)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((2 * t - 1, H, DH)).astype(np.float32)
    lens = np.array([t, max(1, t - 11)], np.int32)
    return qu, qv, k, v, pos, lens


def _jax_args(arrays, dtype):
    *xs, lens = arrays
    return [jnp.asarray(x).astype(dtype) for x in xs] + [jnp.asarray(lens)]


def _port_args(arrays, dtype):
    *xs, lens = arrays
    return [torch.from_numpy(x).to(dtype) for x in xs] + [torch.from_numpy(lens)]


# fp32: the same sums in another order (1e-5). bf16 inputs: both round the
# probabilities to bf16 at the same points; an fp32 sum order or an exp ulp
# can move one across a bf16 rounding boundary: one bf16 ulp of a
# probability times |v| <= ~4 on a few keys, 2e-3 abs.
TOLS = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [7, 70, 130])
def test_relpos_attention_twin_matches_jax(t, dtype):
    """The single-pass twin (and the wrapper on CPU tensors) against the
    JAX kernel in interpret mode, ragged lengths, fp32 output."""
    arrays = _attn_inputs(t, seed=t)
    want = np.asarray(jra.relpos_attention(*_jax_args(arrays, dtype), interpret=True))
    got = relpos_attention_plain(*_port_args(arrays, getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (2, H, t, DH)
    assert np.abs(got.numpy() - want).max() <= TOLS[dtype]
    wrapped = relpos_attention(*_port_args(arrays, getattr(torch, dtype)))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,block,round_lanes", [
    (7, 256, False), (7, 256, True), (70, 32, False), (70, 32, True), (130, 32, False),
    (130, 32, True), (130, 256, False), (130, 256, True)])
def test_relpos_attention_blockwise_twin_matches_jax(t, block, round_lanes, dtype):
    """The streamed twin runs the JAX block loop at the same geometry (block
    rounded up to 64 with ``round_lanes``, the hardware's), so its online
    rescaling rounds where the JAX kernel's does."""
    arrays = _attn_inputs(t, seed=t + block)
    want = np.asarray(jra.relpos_attention_blockwise(
        *_jax_args(arrays, dtype), block=block, interpret=True, round_lanes=round_lanes))
    got = relpos_attention_blockwise_plain(*_port_args(arrays, getattr(torch, dtype)),
                                           block=block, round_lanes=round_lanes)
    assert got.dtype == torch.float32 and got.shape == (2, H, t, DH)
    assert np.abs(got.numpy() - want).max() <= TOLS[dtype]


def test_relpos_attention_blockwise_wrapper_on_cpu():
    """On CPU tensors the streamed wrapper is its twin at the JAX kernel's
    default block (256)."""
    arrays = _port_args(_attn_inputs(300, seed=3), torch.float32)
    np.testing.assert_array_equal(relpos_attention_blockwise(*arrays).numpy(),
                                  relpos_attention_blockwise_plain(*arrays, block=256).numpy())


def _conv_inputs(seed, b=2, t=37, d=64, k=31):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = r(b, t, d) + 0.5
    lens = np.array([t, t // 2], np.int32)
    weights = [r(d, 2 * d, scale=d ** -0.5), r(2 * d, scale=0.1), r(k, 1, d, scale=k ** -0.5),
               r(d, scale=0.1), 1.0 + r(d, scale=0.2), r(d, scale=0.1), r(d, d, scale=d ** -0.5),
               r(d, scale=0.1)]
    ln = (1.0 + r(d, scale=0.1), r(d, scale=0.1))
    return x, lens, weights, ln


@pytest.mark.parametrize("in_ln", [False, True])
def test_conv_module_layer_norm_twin_matches_jax(in_ln):
    """norm="layer" (espnet's per-frame LayerNorm after the depthwise conv,
    K=31), with the pre-module LayerNorm by the caller and inside, fp32,
    against the JAX kernel in interpret mode: 1e-5 max abs."""
    x, lens, weights, (g, b) = _conv_inputs(seed=int(in_ln))
    kw = dict(ln_scale=g, ln_bias=b) if in_ln else {}
    want = np.asarray(jcc.fused_conv_module(
        jnp.asarray(x), jnp.asarray(lens), *map(jnp.asarray, weights), norm="layer",
        interpret=True, **{n: jnp.asarray(v) for n, v in kw.items()}))
    args = (torch.from_numpy(x), torch.from_numpy(lens), *map(torch.from_numpy, weights))
    tkw = {n: torch.from_numpy(v) for n, v in kw.items()}
    got = fused_conv_module_plain(*args, norm="layer", **tkw)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    np.testing.assert_array_equal(fused_conv_module(*args, norm="layer", **tkw).numpy(),
                                  got.numpy())


def test_conv_module_unknown_norm_raises():
    x, lens, weights, _ = _conv_inputs(seed=0)
    with pytest.raises(ValueError, match="norm"):
        fused_conv_module(torch.from_numpy(x), torch.from_numpy(lens),
                          *map(torch.from_numpy, weights), norm="batch")


# (heads, dh) over head sizes that pack 128 lanes and some that do not
HEAD_SHAPES = [(h, dh) for h in (1, 2, 4, 8, 16) for dh in (16, 32, 48, 64, 80, 128, 256)]
T_GRID = (1, 7, 127, 128, 129, 376, 401, 499, 511, 512, 513, 549, 640, 1024, 1149)


@pytest.mark.parametrize("heads,dh", HEAD_SHAPES)
def test_attention_route_mirrors_jax(heads, dh):
    """The port's route against the JAX gates over a grid of T: "packed"
    where ``_packed_attn_ok`` holds, "fused" where ``fused_supported`` does
    (lnd_impl="xla"), "generic" otherwise, "xla" without the kernels. The
    weight budget of ``ln_dense_supported`` is not mirrored, so the packed
    comparison is made where the q/k/v weight fits it."""
    d = heads * dh
    for lnd in ("pallas", "xla"):
        jcfg = jfc.FastConformerConfig(d_model=d, num_heads=heads, attn_impl="pallas",
                                       lnd_impl=lnd)
        tcfg = tfc.FastConformerConfig(d_model=d, num_heads=heads, attn_impl="pallas",
                                       lnd_impl=lnd)
        for t in T_GRID:
            fused = jra.fused_supported(t, heads, dh)
            if lnd == "pallas" and jlnd.ln_dense_supported(d, 3 * d, 2):
                want = "packed" if jfc._packed_attn_ok(jcfg, t) else "generic"
            elif lnd == "pallas":
                want = "packed" if fused else "generic"
            else:
                want = "fused" if fused else "generic"
            assert tfc.attention_route(tcfg, t) == want, (t, lnd)
        assert tfc.attention_route(replace(tcfg, attn_impl="xla"), 100) == "xla"


def test_attention_route_at_the_espnet_window():
    """espnet's 20 s window (T=549) and 45 s input (T=1149) take the
    [B, H, T, dh] route, single-pass and streamed; its 20 s find_blank pass
    (T=499) the packed one; nemo's 32 s bucket (T=401) the packed one."""
    from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config

    cfg = espnet_encoder_config(attn_impl="pallas", lnd_impl="pallas")
    assert [tfc.attention_route(cfg, t) for t in (549, 1149, 499)] == \
        ["generic", "generic", "packed"]
    assert tfc._generic_attn_kernel(549) is tfc.relpos_attention
    assert tfc._generic_attn_kernel(1149) is tfc.relpos_attention_blockwise
    nemo = tfc.FastConformerConfig.xlarge(attn_impl="pallas", lnd_impl="pallas")
    assert tfc.attention_route(nemo, 401) == "packed"
