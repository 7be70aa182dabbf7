"""The Zipformer shared-attention twins and the Zipformer encoder of the
port against the JAX package, at fp32 on the CPU: the JAX kernels run in
interpret mode, the port's wrappers their plain twins (CPU tensors). Inputs
come from numpy seeds; one tree from the JAX ``init_zipformer`` feeds both
encoders."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.models import zipformer as jzf
from reazonspeech_tpu.ops import zipformer_attention as jza
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.models import zipformer as tzf
from reazonspeech_tpu_torch.ops import zipformer_attention as tza


def _inputs(seed, g, t, qd, pd, dv, heads):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(g, t, qd), mk(g, t, qd), mk(g, t, pd), mk(heads, 2 * t - 1, pd), mk(g, t, dv)


def _both(arrays, lengths):
    j = [jnp.asarray(a) for a in arrays] + [jnp.asarray(np.asarray(lengths, np.int32))]
    t = [torch.from_numpy(a) for a in arrays] + [torch.tensor(lengths, dtype=torch.int32)]
    return j, t


# (g, t, qd, pd, dv, heads, lengths): row g reads table g % heads; lengths 1
# and T; T not a multiple of the block (16); dv = 4 and wide value sets
ATTN_CASES = [
    (4, 50, 8, 2, 4, 2, [50, 41, 17, 1]),
    (6, 37, 32, 4, 12, 3, [37, 1, 20, 36, 5, 37]),
    (3, 29, 32, 4, 96, 1, [29, 1, 13]),
]


@pytest.mark.parametrize("g,t,qd,pd,dv,heads,lengths", ATTN_CASES)
def test_single_pass_twin_matches_jax(g, t, qd, pd, dv, heads, lengths):
    """Every query row (rows past a length included: both compute them)."""
    j, tt = _both(_inputs(t, g, t, qd, pd, dv, heads), lengths)
    want = np.asarray(jza.shared_rel_attention(*j, heads=heads, block_q=16, interpret=True))
    got = tza.shared_rel_attention(*tt, heads=heads)
    assert got.dtype == torch.float32 and got.shape == (g, t, dv)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("g,t,qd,pd,dv,heads,lengths", ATTN_CASES)
def test_blockwise_twin_matches_jax(g, t, qd, pd, dv, heads, lengths):
    j, tt = _both(_inputs(t + 1, g, t, qd, pd, dv, heads), lengths)
    want = np.asarray(jza.shared_rel_attention_blockwise(*j, heads=heads, block=16,
                                                         interpret=True))
    got = tza.shared_rel_attention_blockwise_plain(*tt, heads=heads, block=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("t", [23, 130])
def test_blockwise_twin_rounded_lanes_matches_jax(t):
    """The JAX kernel's hardware geometry (block rounded up to 64, blk > T
    when T < 64) in both."""
    lengths = [t, max(t - 9, 1), min(17, t), 1]
    j, tt = _both(_inputs(2 * t, 4, t, 8, 2, 4, 2), lengths)
    want = np.asarray(jza.shared_rel_attention_blockwise(*j, heads=2, block=64, interpret=True,
                                                         round_lanes=True))
    got = tza.shared_rel_attention_blockwise_plain(*tt, heads=2, block=64, round_lanes=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_wrappers_refuse_cuda_layouts_they_do_not_take():
    """The CUDA path checks its inputs before any launch; nothing falls back
    to a twin. (No GPU here: a meta tensor stands for a non-CPU one.)"""
    q = torch.empty((2, 8, 129), device="meta", dtype=torch.bfloat16)  # qd past 128
    with pytest.raises(ValueError, match="qd=129"):
        tza.shared_rel_attention(q, q, q[..., :4], None, q, None, heads=1)
    with pytest.raises(ValueError, match="pd=33"):  # pd past 32
        tza.shared_rel_attention_blockwise(q[..., :8], q[..., :8], q[..., :33], None, q, None)


def random_zipformer_tree(seed, cfg):
    """JAX ``init_zipformer`` as numpy, with the leaves random init leaves
    at identity (BiasNorm, bypass scales, pooling weights) made non-trivial;
    bypass scales cover both sides of the [0, 1] clip."""
    init = jax.jit(jzf.init_zipformer, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def rnd(a, lo, hi):
        return rng.uniform(lo, hi, np.shape(a)).astype(np.float32)

    tree["embed"]["norm"]["bias"] = rnd(tree["embed"]["norm"]["bias"], -0.2, 0.2)
    for stack in tree["stacks"]:
        layers = stack["layers"]
        layers["norm"]["bias"] = rnd(layers["norm"]["bias"], -0.2, 0.2)
        layers["norm"]["log_scale"] = rnd(layers["norm"]["log_scale"], -0.3, 0.3)
        for name in ("bypass_mid", "bypass"):
            layers[name]["scale"] = rnd(layers[name]["scale"], -0.2, 1.2)
        if "ds_weights" in stack:
            stack["ds_weights"] = rnd(stack["ds_weights"], -1.0, 1.0)
            stack["out_bypass"]["scale"] = rnd(stack["out_bypass"]["scale"], 0.0, 1.0)
    return tree


@pytest.fixture(scope="module")
def encoder_pair():
    jcfg = jzf.ZipformerConfig.tiny(compute_dtype="float32")
    tcfg = tzf.ZipformerConfig.tiny(compute_dtype="float32")
    tree = random_zipformer_tree(0, jcfg)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 90, jcfg.feat_in)).astype(np.float32)
    lens = np.array([90, 61], np.int32)
    return jcfg, tcfg, tree, feats, lens


def _encode_both(encoder_pair, attn_impl):
    jcfg, tcfg, tree, feats, lens = encoder_pair
    want, wl = jzf.zipformer_encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats),
                                    jnp.asarray(lens), replace(jcfg, attn_impl=attn_impl))
    got, gl = tzf.zipformer_encode(params_from_numpy(tree), torch.from_numpy(feats),
                                   torch.from_numpy(lens), replace(tcfg, attn_impl=attn_impl))
    return np.asarray(want), np.asarray(wl), got.numpy(), gl.numpy()


def _assert_close_to_max(got, want, tol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_encoder_matches_jax(encoder_pair, monkeypatch, attn_impl):
    """The tiny encoder at fp32, both attention implementations: lengths
    equal, outputs within 5e-5 of max |out| (padded frames are zero in both)."""
    monkeypatch.setattr(jza, "shared_rel_attention", _interpret(jza.shared_rel_attention))
    want, wl, got, gl = _encode_both(encoder_pair, attn_impl)
    np.testing.assert_array_equal(gl, wl)
    assert got.shape == want.shape
    _assert_close_to_max(got, want, 5e-5)
    assert np.abs(want).max() > 0.1


def _interpret(fn):
    return lambda *a, **kw: fn(*a, **{**kw, "interpret": True})


def test_encoder_streamed_entry_matches_jax(encoder_pair, monkeypatch):
    """The streamed entry forced at every stack in both packages (the T <=
    2048 dispatch is a module-level function in each)."""
    blockwise = _interpret(jza.shared_rel_attention_blockwise)
    monkeypatch.setattr(jzf, "_shared_attn_kernel", lambda t: blockwise)
    monkeypatch.setattr(tzf, "_shared_attn_kernel", lambda t: tza.shared_rel_attention_blockwise)
    want, wl, got, gl = _encode_both(encoder_pair, "pallas")
    np.testing.assert_array_equal(gl, wl)
    _assert_close_to_max(got, want, 5e-5)


def test_dispatch_switches_at_2048():
    assert tzf._shared_attn_kernel(2048) is tza.shared_rel_attention
    assert tzf._shared_attn_kernel(2049) is tza.shared_rel_attention_blockwise


@pytest.mark.parametrize("n", [0, 7, 8, 100, 3203])
def test_output_length_matches_jax(n):
    assert tzf.zipformer_output_length(n, tzf.ZipformerConfig()) == \
        jzf.zipformer_output_length(n, jzf.ZipformerConfig())


def test_init_tree_matches_jax_structure():
    """``init_zipformer`` from a torch.Generator: the JAX tree's keys, list
    of stacks and leaf shapes, at the large configuration's first stacks."""
    jcfg = jzf.ZipformerConfig.large(num_layers=(1, 1, 1, 1, 1, 1))
    tcfg = tzf.ZipformerConfig.large(num_layers=(1, 1, 1, 1, 1, 1))
    want = jax.eval_shape(lambda: jzf.init_zipformer(jax.random.PRNGKey(0), jcfg))
    got = tzf.init_zipformer(torch.Generator().manual_seed(0), tcfg)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(got) == shapes(want)
