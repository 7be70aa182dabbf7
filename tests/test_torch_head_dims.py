"""Head widths past the CUDA kernels' former limits, on the CPU: the port's
rel-pos attention twins against the JAX kernels (interpret mode) at dh =
36, 44 and 256 and the fused contract at dh = 8 with 16 heads, the
shared-attention twins at (qd, pd) = (64, 4), (12, 9) and (48, 16), and a
tiny FastConformer of 2 heads of dh = 36 (the generic route) against the
JAX encoder on a tree the JAX store wrote. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.models import fastconformer as jfc
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu.nemo.asr.model import init_params
from reazonspeech_tpu.ops import relpos_attention as jra
from reazonspeech_tpu.ops import zipformer_attention as jza
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.convert.store import load_param_tree
from reazonspeech_tpu_torch.models import fastconformer as tfc
from reazonspeech_tpu_torch.ops import relpos_attention as tra
from reazonspeech_tpu_torch.ops import zipformer_attention as tza

from test_torch_parity import randomize_norm_stats

# as tests/test_torch_espnet_ops.py: fp32, the same sums in another order
# (1e-5); bf16 inputs, one bf16 ulp of a probability times |v| on a few keys
TOLS = {"float32": 1e-5, "bfloat16": 2e-3}


def _both(arrays, dtype):
    """numpy arrays (the last one int32 lengths) as JAX and torch inputs."""
    *xs, lens = arrays
    j = [jnp.asarray(x).astype(dtype) for x in xs] + [jnp.asarray(lens)]
    t = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs] + [torch.from_numpy(lens)]
    return j, t


def _bhtd(t, dh, seed):
    rng = np.random.default_rng(seed)
    qu, qv, k, v = (rng.standard_normal((3, 2, t, dh)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((2 * t - 1, 2, dh)).astype(np.float32)
    return qu, qv, k, v, pos, np.array([t, 0, max(1, t - 28)], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [36, 44, 256])
def test_relpos_attention_twin_matches_jax_at_head_widths(dh, dtype):
    """The single-pass twin (and the wrapper on CPU tensors) against the JAX
    kernel: ragged lengths, a length of 0 (a uniform row in both)."""
    j, t = _both(_bhtd(37, dh, seed=dh), dtype)
    want = np.asarray(jra.relpos_attention(*j, interpret=True))
    got = tra.relpos_attention(*t)
    assert got.dtype == torch.float32 and got.shape == (3, 2, 37, dh)
    assert np.abs(got.numpy() - want).max() <= TOLS[dtype]


@pytest.mark.parametrize("dh,block,round_lanes", [
    (36, 16, False), (44, 64, True), (256, 16, False), (256, 64, True)])
def test_relpos_attention_blockwise_twin_matches_jax_at_head_widths(dh, block, round_lanes):
    """The streamed twin at the JAX kernel's block geometry, bf16 inputs."""
    j, t = _both(_bhtd(37, dh, seed=dh + block), "bfloat16")
    want = np.asarray(jra.relpos_attention_blockwise(*j, block=block, interpret=True,
                                                     round_lanes=round_lanes))
    got = tra.relpos_attention_blockwise_plain(*t, block=block, round_lanes=round_lanes)
    assert np.abs(got.numpy() - want).max() <= TOLS["bfloat16"]


def test_relpos_attention_fused_twin_matches_jax_at_dh_8():
    """16 heads of dh = 8 pack the JAX kernel's 128 lanes (fused_supported),
    fp32, ragged lengths. (A length of 0 is left out: the JAX kernel's
    padded keys join that uniform row, whose every row the caller masks.)"""
    t, h, dh = 37, 16, 8
    assert jra.fused_supported(t, h, dh)
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((3, t, h * dh)).astype(np.float32) for _ in range(3))
    pos = rng.standard_normal((2 * t - 1, h, dh)).astype(np.float32)
    bu, bv = (0.1 * rng.standard_normal((h, dh)).astype(np.float32) for _ in range(2))
    lens = np.array([t, 1, 9], np.int32)
    j, tt = _both((q, k, v, pos, bu, bv, lens), "float32")
    want = np.asarray(jra.relpos_attention_fused(*j, h, interpret=True))
    got = tra.relpos_attention_fused(*tt, h)
    assert got.shape == (3, t, h * dh)
    assert np.abs(got.numpy() - want).max() <= TOLS["float32"]


@pytest.mark.parametrize("qd,pd", [(64, 4), (12, 9), (48, 16)])
def test_shared_attention_twins_match_jax_at_widths(qd, pd):
    """Both shared-attention twins against the JAX kernels, fp32, lengths
    T, 0, 9 and 1; tolerance as tests/test_torch_zipformer.py."""
    g, t, heads, dv = 4, 37, 2, 12
    rng = np.random.default_rng(qd * pd)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((g, t, qd), (g, t, qd), (g, t, pd), (heads, 2 * t - 1, pd), (g, t, dv))]
    j, tt = _both(arrays + [np.array([t, 0, 9, 1], np.int32)], "float32")
    want = np.asarray(jza.shared_rel_attention(*j, heads=heads, block_q=16, interpret=True))
    got = tza.shared_rel_attention(*tt, heads=heads)
    assert got.shape == (g, t, dv)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    want = np.asarray(jza.shared_rel_attention_blockwise(*j, heads=heads, block=16,
                                                         interpret=True))
    got = tza.shared_rel_attention_blockwise_plain(*tt, heads=heads, block=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_encoder_at_head_dim_36_matches_jax(tmp_path, monkeypatch):
    """A tiny FastConformer (2 blocks, d_model = 72, 2 heads of dh = 36: the
    generic [B, H, T, dh] route in both packages) with every kernel on, fp32,
    a ragged batch, on one tree the JAX store wrote and the port's store
    read: equal to the JAX encoder (its kernels in interpret mode) to 5e-5
    max abs on valid frames, as tests/test_torch_espnet.py holds its
    encoder."""
    patch_interpret(monkeypatch)
    cfg = dict(d_model=72, num_heads=2, compute_dtype="float32", attn_impl="pallas",
               conv_impl="pallas", lnd_impl="pallas")
    jcfg, tcfg = jfc.FastConformerConfig.tiny(**cfg), tfc.FastConformerConfig.tiny(**cfg)
    jr = jrnnt.RNNTConfig.tiny(enc_dim=72, compute_dtype="float32")
    tree = randomize_norm_stats(jax.tree.map(np.asarray, init_params(0, jcfg, jr)), seed=1)
    save_param_tree(str(tmp_path / "tree"), tree, {})
    saved, _ = load_param_tree(str(tmp_path / "tree"))
    frames = 203
    rng = np.random.default_rng(frames)
    feats = rng.standard_normal((3, frames, jcfg.feat_in)).astype(np.float32)
    lens = np.array([frames, 150, 40], np.int32)
    want, wl = jfc.fastconformer_encode(jax.tree.map(jnp.asarray, tree["encoder"]),
                                        jnp.asarray(feats), jnp.asarray(lens), jcfg)
    got, gl = tfc.fastconformer_encode(params_from_numpy(saved["encoder"]),
                                       torch.from_numpy(feats), torch.from_numpy(lens), tcfg)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    want = np.asarray(want)
    t = got.shape[1]
    assert tfc.attention_route(tcfg, t) == "generic"
    assert got.shape == want.shape == (3, t, 72)
    valid = (np.arange(t)[None, :] < np.asarray(wl)[:, None])[..., None]
    assert np.abs((got.numpy() - want) * valid).max() <= 5e-5
