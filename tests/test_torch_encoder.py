"""Port encoder and transducer networks against the JAX package on the same
weights (carried over by the bridge), at the slice's tiny configuration."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.models import fastconformer as jfc
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.models import fastconformer as tfc
from reazonspeech_tpu_torch.models import rnnt as trnnt

from test_torch_parity import jax_params_numpy, randomize_norm_stats, tiny_configs


@pytest.fixture(scope="module")
def setup():
    jenc, jr, tenc, tr = tiny_configs()
    tree = randomize_norm_stats(jax_params_numpy(0, jenc, jr), seed=1)
    return jenc, jr, tenc, tr, tree


def _feats(b, t, f, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, f)).astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encoder_matches_jax(setup, monkeypatch, impl):
    """fp32 compute: the port's encoder equals the JAX encoder to 1e-4 max
    abs on valid frames, through the kernel branch (the JAX kernels in
    interpret mode, the port's plain twins) and through the plain branch."""
    patch_interpret(monkeypatch)
    jenc, _, tenc, _, tree = setup
    jenc = replace(jenc, attn_impl=impl, conv_impl=impl)
    tenc = replace(tenc, attn_impl=impl, conv_impl=impl)
    feats = _feats(3, 203, jenc.feat_in)
    lens = np.array([203, 150, 40], np.int32)
    want, want_len = jfc.fastconformer_encode(
        _jax_tree(tree["encoder"]), jnp.asarray(feats), jnp.asarray(lens), jenc)
    got, got_len = tfc.fastconformer_encode(
        params_from_numpy(tree["encoder"]), torch.from_numpy(feats), torch.from_numpy(lens),
        tenc)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    valid = (np.arange(want.shape[1])[None, :] < np.asarray(want_len)[:, None])[..., None]
    assert np.abs((got.numpy() - want) * valid).max() <= 1e-4


@pytest.mark.parametrize("impl,frames", [("pallas", 203), ("pallas", 1024), ("xla", 203)])
def test_encoder_lnd_pallas_matches_jax(setup, monkeypatch, impl, frames):
    """lnd_impl="pallas", fp32 compute, a ragged batch: the port's encoder
    equals the JAX encoder (its kernels in interpret mode) to 5e-5 max abs
    on valid frames, and frames past each length are exactly 0. With the
    attention and conv kernels (impl="pallas") both run the fused block tail
    (ln_dense_add, add_ln); 1024 feature frames give T=128 encoder frames,
    which JAX runs unpadded, 203 give T=26, which JAX pads to 128 and the
    port does not. With impl="xla" only the FFN-in LayerNorms are fused."""
    patch_interpret(monkeypatch)
    jenc, _, tenc, _, tree = setup
    jenc = replace(jenc, attn_impl=impl, conv_impl=impl, lnd_impl="pallas")
    tenc = replace(tenc, attn_impl=impl, conv_impl=impl, lnd_impl="pallas")
    feats = _feats(3, frames, jenc.feat_in, seed=frames)
    lens = np.array([frames, frames * 3 // 4, 40], np.int32)
    want, want_len = jfc.fastconformer_encode(
        _jax_tree(tree["encoder"]), jnp.asarray(feats), jnp.asarray(lens), jenc)
    got, got_len = tfc.fastconformer_encode(
        params_from_numpy(tree["encoder"]), torch.from_numpy(feats), torch.from_numpy(lens),
        tenc)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape
    valid = (np.arange(want.shape[1])[None, :] < np.asarray(want_len)[:, None])[..., None]
    assert np.abs((got - want) * valid).max() <= 5e-5
    assert not np.any(got * ~valid) and not valid.all()


def test_mhsa_packed_matches_jax(setup, monkeypatch):
    """The packed attention sub-block with the ffn1 residual add fused in
    (ln_dense_add on the packed q/k/v, then the packed attention kernel)
    against the JAX packed path, fp32, to 1e-5 on every row, both the
    attention output and the summed stream (at T=128, the JAX packed
    kernel's layout)."""
    jenc, _, tenc, _, tree = setup
    jenc = replace(jenc, lnd_impl="pallas")
    tenc = replace(tenc, lnd_impl="pallas")
    rng = np.random.default_rng(6)
    t = 128
    x, delta = (rng.standard_normal((2, t, jenc.d_model)).astype(np.float32) for _ in range(2))
    lens = np.array([t, 90], np.int32)
    mask = np.arange(t)[None, :] < lens[:, None]
    jp = _jax_tree(_first(tree["encoder"]["blocks"]))
    tp = tfc._layer(params_from_numpy(tree["encoder"]["blocks"]), 0)
    patch_interpret(monkeypatch)
    want = jfc._mhsa_relpos(jp, jnp.asarray(x), jfc._sinusoid_rel_pos(t, jenc.d_model),
                            jnp.asarray(mask), jenc, delta=jnp.asarray(delta))
    got = tfc._mhsa_packed(tp, torch.from_numpy(x), torch.from_numpy(delta),
                           tfc._sinusoid_rel_pos(t, tenc.d_model, "cpu"), torch.from_numpy(lens),
                           tenc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def _jax_tree(tree):
    import jax

    return jax.tree.map(jnp.asarray, tree)


def test_subsample_and_pos_table_match_jax(setup):
    jenc, _, tenc, _, tree = setup
    feats = _feats(2, 64, jenc.feat_in, seed=3)
    lens = np.array([64, 33], np.int32)
    want, wl = jfc._subsample(_jax_tree(tree["encoder"]["subsampling"]), jnp.asarray(feats),
                              jnp.asarray(lens), jenc)
    got, gl = tfc._subsample(params_from_numpy(tree["encoder"]["subsampling"]),
                             torch.from_numpy(feats), torch.from_numpy(lens), tenc)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tfc._sinusoid_rel_pos(9, 16, "cpu").numpy(),
                                  np.asarray(jfc._sinusoid_rel_pos(9, 16)))


def test_predictor_and_joint_match_jax(setup):
    """One LSTM step and the joint logits, fp32, to 1e-5."""
    _, jr, _, tr, tree = setup
    tokens = np.array([jr.blank_id, 0, 5, 63], np.int32)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((1, 4, jr.pred_hidden)).astype(np.float32)
    c = rng.standard_normal((1, 4, jr.pred_hidden)).astype(np.float32)
    enc = rng.standard_normal((4, 7, jr.enc_dim)).astype(np.float32)

    jp, tp = _jax_tree(tree["predictor"]), params_from_numpy(tree["predictor"])
    jg, (jh, jc) = jrnnt.predictor_step(jp, jnp.asarray(tokens), (jnp.asarray(h),
                                        jnp.asarray(c)), jr)
    tg, (th, tc) = trnnt.predictor_step(tp, torch.from_numpy(tokens),
                                        (torch.from_numpy(h), torch.from_numpy(c)), tr)
    for g, w in ((tg, jg), (th, jh), (tc, jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)

    jj, tj = _jax_tree(tree["joint"]), params_from_numpy(tree["joint"])
    jproj = jrnnt.joint_precompute_enc(jj, jnp.asarray(enc), jr)
    tproj = trnnt.joint_precompute_enc(tj, torch.from_numpy(enc), tr)
    np.testing.assert_allclose(tproj.numpy(), np.asarray(jproj), atol=1e-5, rtol=1e-5)
    want = jrnnt.joint_step_from_enc_proj(jj, jproj[:, 2], jg, jr)
    got = trnnt.joint_step_from_enc_proj(tj, tproj[:, 2], tg, tr)
    assert got.shape == (4, jr.num_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_unported_settings_raise(setup):
    _, _, tenc, tr, tree = setup
    p = params_from_numpy(tree["encoder"])
    feats, lens = torch.zeros(1, 16, tenc.feat_in), torch.tensor([16])
    for bad in (dict(lnd_impl="triton"), dict(subsampling_style="conv2d"),
                dict(conv_norm="layer_norm")):
        with pytest.raises(ValueError):
            tfc.fastconformer_encode(p, feats, lens, replace(tenc, **bad))
    # the stateless predictor is ported (k2); greedy blank-run skipping is not
    from reazonspeech_tpu_torch.decoding import rnnt_greedy as tgreedy

    with pytest.raises(ValueError):
        tgreedy.rnnt_greedy_decode({}, {}, torch.zeros(1, 4, tr.enc_dim), torch.tensor([4]), tr,
                                   tgreedy.GreedyDecodeConfig(frame_window=4))
