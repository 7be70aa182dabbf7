"""The parity harness of the PyTorch port: the same tiny model in both
packages, the port's weights carried over from the JAX ``init_params``
through the shared store format and the weight bridge (helpers used by the
other ``test_torch_*`` files), and the tests of that store and bridge."""

import numpy as np
import pytest
import torch

TINY_ENC = dict(d_model=128, num_heads=8, compute_dtype="float32",
                attn_impl="pallas", conv_impl="pallas")
TINY_RNNT = dict(enc_dim=128, compute_dtype="float32")


def tiny_configs():
    """(jax enc, jax rnnt, torch enc, torch rnnt) at the slice's tiny size.
    8 heads of dh=16 keep the JAX encoder on its fused attention kernel."""
    from reazonspeech_tpu.models.fastconformer import FastConformerConfig as JEnc
    from reazonspeech_tpu.models.rnnt import RNNTConfig as JRnnt
    from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig as TEnc
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig as TRnnt

    return (JEnc.tiny(**TINY_ENC), JRnnt.tiny(**TINY_RNNT),
            TEnc.tiny(**TINY_ENC), TRnnt.tiny(**TINY_RNNT))


def jax_params_numpy(seed, enc_cfg, rnnt_cfg):
    """JAX init_params as a numpy tree."""
    import jax

    from reazonspeech_tpu.nemo.asr.model import init_params

    return jax.tree.map(np.asarray, init_params(seed, enc_cfg, rnnt_cfg))


def randomize_norm_stats(tree, seed):
    """Non-trivial batch-norm statistics, LN affines and attention biases
    (random init leaves them at identity/zero), and a blank logit raised so
    that the random model advances through the frames instead of emitting
    every label at frame 0."""
    rng = np.random.default_rng(seed)
    blocks = tree["encoder"]["blocks"]
    for name in ("ffn1_ln", "attn_ln", "conv_ln", "ffn2_ln", "final_ln"):
        blocks[name]["scale"] = (1.0 + 0.1 * rng.standard_normal(
            blocks[name]["scale"].shape)).astype(np.float32)
        blocks[name]["bias"] = (0.1 * rng.standard_normal(
            blocks[name]["bias"].shape)).astype(np.float32)
    bn = blocks["conv_bn"]
    bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    bn["scale"] = (1.0 + 0.2 * rng.standard_normal(bn["scale"].shape)).astype(np.float32)
    for name in ("attn_bias_u", "attn_bias_v"):
        blocks[name] = (0.1 * rng.standard_normal(blocks[name].shape)).astype(np.float32)
    tree["joint"]["out"]["b"] = tree["joint"]["out"]["b"].copy()
    tree["joint"]["out"]["b"][-1] += 1.0  # blank is the last class (NeMo)
    return tree


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_round_trip_between_packages(tmp_path, writer):
    """A tree written by either package loads in the other, leaf for leaf."""
    from reazonspeech_tpu.convert import store as jstore
    from reazonspeech_tpu_torch.convert import store as tstore
    from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy

    rng = np.random.default_rng(0)
    tree = {
        "encoder": {"blocks": {"w": rng.standard_normal((2, 3, 4)).astype(np.float32)}},
        "predictor": {"lstm": [{"b": rng.standard_normal(5).astype(np.float32)}]},
    }
    meta = {"enc_cfg": {"d_model": 4}}
    path = str(tmp_path / "tree")
    if writer == "jax":
        jstore.save_param_tree(path, tree, meta)
        got, got_meta = tstore.load_param_tree(path)
    else:
        tstore.save_param_tree(path, params_from_numpy(tree), meta)
        got, got_meta = jstore.load_param_tree(path)
    assert got_meta == meta
    np.testing.assert_array_equal(np.asarray(got["encoder"]["blocks"]["w"]),
                                  tree["encoder"]["blocks"]["w"])
    np.testing.assert_array_equal(np.asarray(got["predictor"]["lstm"][0]["b"]),
                                  tree["predictor"]["lstm"][0]["b"])


def test_bridge_keeps_layouts():
    """The bridge changes no shape or value: JAX layouts are the port's."""
    from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy

    jenc, jrnnt, _, _ = tiny_configs()
    tree = jax_params_numpy(0, jenc, jrnnt)
    port = params_from_numpy(tree)
    blocks = port["encoder"]["blocks"]
    assert tuple(blocks["conv_in"]["w"].shape) == (jenc.num_layers, 1, 128, 256)
    assert tuple(blocks["conv_dw"]["w"].shape) == (jenc.num_layers, 9, 1, 128)
    assert tuple(blocks["attn_q"]["w"].shape) == (jenc.num_layers, 128, 128)
    assert blocks["attn_q"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(port["joint"]["out"]["w"].numpy(), tree["joint"]["out"]["w"])
    np.testing.assert_array_equal(port["predictor"]["lstm"][0]["w_hh"].numpy(),
                                  tree["predictor"]["lstm"][0]["w_hh"])
