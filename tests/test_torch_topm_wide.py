"""The top-m and step kernels' contract past their former size caps, on the
CPU: the plain twins of ``topm_logsoftmax``, ``joint_topm`` and
``lstm_cell_step`` against the JAX kernels in interpret mode at m = 40 (and
m past V), V = 50,000 and a depth of 3,072, and ALSD at beam 40 (m = 40
label expansions a hypothesis) against the JAX decoder on the same weights.
The CUDA kernels are held to these twins at the same sizes on the card
(``tests/test_torch_cuda.py``). Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.decoding import rnnt_beam as jbeam
from reazonspeech_tpu.ops import beam_topk as jtopk
from reazonspeech_tpu.ops import lstm_step as jlstm
from reazonspeech_tpu_torch.decoding import rnnt_beam as tbeam
from reazonspeech_tpu_torch.ops.beam_topk import joint_topm_plain, topm_logsoftmax_plain
from reazonspeech_tpu_torch.ops.lstm_step import lstm_cell_step_plain

from test_torch_decode_step import _beam_setup, _decode_both


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (r, v, m, blank): m = 40 and 64; V = 50,000; m past V (the -1e30 pool)
@pytest.mark.parametrize("r,v,m,blank", [(6, 301, 40, 300), (3, 50000, 4, 0),
                                         (2, 50000, 40, 49999), (3, 30, 40, 5)])
def test_topm_plain_matches_jax_wide(r, v, m, blank):
    """Indices equal, log-probs within 1e-5 (fp32 sums in another order)."""
    x = _randn(np.random.default_rng(v + m), r, v, scale=3.0)
    want = jtopk.topm_logsoftmax(jnp.asarray(x), m, blank, interpret=True)
    got = topm_logsoftmax_plain(torch.from_numpy(x), m, blank)
    assert got[1].shape == (r, m)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_topm_plain_excluded_pool_matches_jax():
    """-inf, exactly -1e30 and below-(-1e30) logits, m past the finite
    labels: the rounds then take the pool's lowest column, as in JAX."""
    x = np.full((3, 64), -np.inf, np.float32)
    x[:, 7::13] = _randn(np.random.default_rng(5), 3, 5)
    x[0, 3] = x[1, 62] = -1e30
    x[2, 1::2] = -1e31
    want = jtopk.topm_logsoftmax(jnp.asarray(x), 12, 5, interpret=True)
    got = topm_logsoftmax_plain(torch.from_numpy(x), 12, 5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[2][0, 5:].numpy(), [3] * 7)  # after the 5 finite labels
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)


# (r, h, j, v, m, blank): m = 40, V = 50,000, and both at once
@pytest.mark.parametrize("r,h,j,v,m,blank", [(5, 64, 96, 301, 40, 0),
                                             (3, 32, 64, 50000, 4, 49999),
                                             (2, 32, 64, 50000, 40, 0)])
def test_joint_topm_plain_matches_jax_wide(r, h, j, v, m, blank):
    """fp32: indices equal, log-probs within 5e-6."""
    rng = np.random.default_rng(r * v + m)
    args = (_randn(rng, h, j, scale=0.1), _randn(rng, j, scale=0.1), _randn(rng, j, v, scale=0.1),
            _randn(rng, v, scale=0.1), _randn(rng, r, j), _randn(rng, r, h))
    want = jtopk.joint_topm(*map(jnp.asarray, args), m, blank, activation="tanh",
                            compute_dtype="float32", block_r=8, interpret=True)
    got = joint_topm_plain(*map(torch.from_numpy, args), m, blank, activation="tanh",
                           compute_dtype="float32")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-6, rtol=0)


def test_lstm_cell_plain_matches_jax_deep():
    """H_in = H = 1,536 (a depth of 3,072) in fp32: within 1e-5."""
    rng = np.random.default_rng(1536)
    h = 1536
    args = (_randn(rng, h, 4 * h, scale=0.02), _randn(rng, h, 4 * h, scale=0.02),
            _randn(rng, 4 * h, scale=0.1), _randn(rng, 4, h), _randn(rng, 4, h), _randn(rng, 4, h))
    want = jlstm.lstm_cell_step(*map(jnp.asarray, args), compute_dtype="float32", interpret=True)
    got = lstm_cell_step_plain(*map(torch.from_numpy, args), compute_dtype="float32")
    for g, w in zip(got, want):
        assert g.shape == (4, h)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_alsd_beam_40_matches_jax(monkeypatch):
    """ALSD beam 40 (m = 40 label expansions a hypothesis: past the former
    cap of 32) with the top-m op, 60 tokens, fp32: tokens, frames and counts
    equal to the JAX decoder's with its Pallas kernel, scores within 1e-5."""
    jcfg, tcfg, tree, enc, lens = _beam_setup(seed=4, vocab_size=60, compute_dtype="float32")
    got, want = _decode_both(monkeypatch, jbeam.rnnt_beam_decode, tbeam.rnnt_beam_decode,
                             jcfg, tcfg, tree, enc, lens,
                             jbeam.BeamDecodeConfig(beam_size=40, topk_impl="pallas"),
                             tbeam.BeamDecodeConfig(beam_size=40, topk_impl="pallas"))
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=0)
    assert got[2].min() > 0
