"""The port's sequence-parallel encode (``reazonspeech_tpu_torch.parallel.sequence``)
against the JAX package's on the same tree (JAX's time axis sharded over its
8 emulated devices, the port's over a mesh of 8 ``cpu`` entries), fp32, after
``tests/test_parallel.py``: the encode within 1e-5 of JAX and of the port's
unsplit encode with the plain impls (nemo's batch-norm and espnet's
layer-norm conv modules, ``final_norm``, shards of one frame whose conv
halo spans four neighbours, shards of unequal length), each shard's stream
holding only its own rows, the refusals with JAX's messages, and
``seq_axis`` in the encoder config (accepted with the plain impls, refused
with a kernel impl)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.models.fastconformer import FastConformerConfig as JEnc
from reazonspeech_tpu.models.fastconformer import fastconformer_encode as j_encode
from reazonspeech_tpu.models.fastconformer import init_fastconformer as j_init
from reazonspeech_tpu.parallel import mesh as jmesh
from reazonspeech_tpu.parallel import sequence as jseq
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig as TEnc
from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode
from reazonspeech_tpu_torch.parallel import mesh as tmesh
from reazonspeech_tpu_torch.parallel import sequence as tseq

SMALL = dict(num_layers=2, d_model=64, num_heads=4, ff_expansion=2, subsampling_channels=16,
             compute_dtype="float32")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(jcfg, seed):
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name in ("attn_bias_u", "attn_bias_v"):  # zeros at init: make them count
        tree["blocks"][name] = (0.1 * rng.standard_normal(
            tree["blocks"][name].shape)).astype(np.float32)
    return tree


CASES = {  # name: (config overrides, n shards, feature frames, lengths)
    "nemo_8x1_frame": ({}, 8, 64, (64, 41)),
    "nemo_8_long": ({}, 8, 256, (256, 219)),
    "espnet_layer_norm_final_norm": (
        dict(subsampling_style="conv2d", subsampling_factor=4, conv_norm="layer_norm",
             final_norm=True, conv_kernel=15), 4, 192, (192, 150)),
    "unequal_shards": ({}, 3, 96, (96, 70)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_matches_jax_and_unsplit(case):
    kw, n, t, lens = CASES[case]
    jcfg, tcfg = JEnc(**SMALL, **kw), TEnc(**SMALL, **kw)
    tree = _tree(jcfg, 7)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, t, 80)).astype(np.float32)
    flens = np.asarray(lens, np.int32)
    mesh = tmesh.make_mesh(n_data=1, n_model=n, devices=[CPU] * n)
    params = params_from_numpy(tree)
    got, got_lens = tseq.sequence_parallel_encode(params, torch.from_numpy(feats),
                                                  torch.from_numpy(flens), tcfg, mesh)
    local, local_lens = fastconformer_encode(params, torch.from_numpy(feats),
                                             torch.from_numpy(flens), tcfg)
    assert got.shape == local.shape and torch.equal(got_lens, local_lens)
    assert (got - local).abs().max().item() < 1e-5
    want, want_lens = jseq.sequence_parallel_encode(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(feats), jnp.asarray(flens), jcfg,
        jmesh.make_mesh(n_data=1, n_model=n, devices=jax.devices()[:n]))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    # each shard holds only its own rows of T'
    shards, _ = tseq.sequence_parallel_shards(params, torch.from_numpy(feats),
                                              torch.from_numpy(flens), tcfg, mesh)
    rows = [s.shape[1] for s in shards]
    assert len(shards) == n and sum(rows) == local.shape[1]
    assert max(rows) - min(rows) <= 1
    assert torch.equal(torch.cat(shards, 1), got)


def test_sequence_parallel_refuses_as_jax():
    jcfg, tcfg = JEnc(**SMALL), TEnc(**SMALL)
    tree = _tree(jcfg, 0)
    feats = np.zeros((2, 101, 80), np.float32)
    flens = np.array([101, 90], np.int32)
    with pytest.raises(ValueError) as want:
        jseq.sequence_parallel_encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats),
                                      jnp.asarray(flens), jcfg, jmesh.make_mesh(1, 8))
    with pytest.raises(ValueError) as got:
        tseq.sequence_parallel_encode(params_from_numpy(tree), torch.from_numpy(feats),
                                      torch.from_numpy(flens), tcfg,
                                      tmesh.make_mesh(1, 8, devices=[CPU] * 8))
    assert str(got.value) == str(want.value)
    # the config: the axis on, the plain impls
    assert tseq.sequence_parallel_config(TEnc(attn_impl="pallas", lnd_impl="pallas")) == \
        TEnc(seq_axis="model")


@pytest.mark.parametrize("impl", ["attn_impl", "conv_impl", "lnd_impl"])
def test_seq_axis_with_a_kernel_impl_raises_as_jax(impl):
    jcfg = replace(JEnc.tiny(compute_dtype="float32"), seq_axis="model", **{impl: "pallas"})
    tcfg = replace(TEnc.tiny(compute_dtype="float32"), seq_axis="model", **{impl: "pallas"})
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    feats = np.zeros((1, 64, 80), np.float32)
    with pytest.raises(ValueError) as want:
        j_encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats), jnp.array([64]), jcfg)
    with pytest.raises(ValueError) as got:
        fastconformer_encode(params_from_numpy(tree), torch.from_numpy(feats),
                             torch.tensor([64]), tcfg)
    assert str(got.value) == str(want.value)
    # with the plain impls seq_axis is accepted: the unsplit encode
    plain = replace(tcfg, **{impl: "xla"})
    got, _ = fastconformer_encode(params_from_numpy(tree), torch.from_numpy(feats),
                                  torch.tensor([64]), plain)
    want, _ = fastconformer_encode(params_from_numpy(tree), torch.from_numpy(feats),
                                   torch.tensor([64]), replace(plain, seq_axis=None))
    assert torch.equal(got, want)
