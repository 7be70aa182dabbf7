"""espnet ``decode_batch`` of the port against the JAX package on one tree
written by the JAX store (``test_torch_espnet.py``'s fixture), at Graves
beam 4 and 20: a ragged batch through the frontend, GlobalMVN, the encoder
and the search. fp32 compute; the JAX kernels run in interpret mode."""

import numpy as np
import pytest
import torch

from reazonspeech_tpu.espnet.asr import model as jmodel
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.espnet.asr import model as tmodel

from test_torch_espnet import SR, _wav, tree_path  # noqa: F401  (tree_path: a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: the Graves searches issue thousands of
    tiny ops, and a team of threads each under a loaded xdist run took a
    beam-20 case from 3.5 s alone to 590 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("beam", [4, 20])
def test_decode_batch_matches_jax(tree_path, monkeypatch, beam):
    """A ragged batch through the whole pass (frontend, GlobalMVN, encoder,
    Graves): tokens, frames, counts and encoder lengths equal."""
    patch_interpret(monkeypatch)
    jm = jmodel.load_model_container(checkpoint=tree_path, beam_size=beam)
    tm = tmodel.load_model_container(checkpoint=tree_path, beam_size=beam, device="cpu")
    wav = np.zeros((2, 4 * SR), np.float32)
    wav[0], wav[1, :3 * SR] = _wav(4.0, seed=21), _wav(3.0, seed=22)
    lens = np.array([4 * SR, 3 * SR], np.int32)
    got, want = tm.decode_batch(wav, lens), jm.decode_batch(wav, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[2].min() > 0
    tokens, frames = tm.decode_single(wav[0])
    assert tokens == got[0][0, :got[2][0]].tolist() and frames == got[1][0, :got[2][0]].tolist()
