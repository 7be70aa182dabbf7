"""Greedy decoding's blank-run skipping (``GreedyDecodeConfig.frame_window``)
in the port (``decoding/rnnt_greedy.py``) against the JAX package's at the
same window and against the port's window 1, on the CPU, fp32, on the same
weights: the one-shot decode over both predictor kinds (nemo's LSTM with
blank last, k2's stateless with blank first) and the segment API with a
lane reset mid-pool. The joint leans on the encoder output (its weights
x8) with blank raised by 1.6, and a frame emits two tokens at most, so runs
of blank frames (what a window jumps) alternate with emissions in every
lane. Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.decoding import rnnt_greedy as jgreedy
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.decoding import rnnt_greedy as tgreedy
from reazonspeech_tpu_torch.models import rnnt as trnnt

LENS = (30, 21, 9)
WINDOWS = (2, 4, 8)
SYMBOLS = 2  # emissions a frame at most


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its ops are small, and at
    torch's default (one thread a core) each test worker's team
    oversubscribes the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rnnt(kind):
    return dict(vocab_size=30, enc_dim=32, pred_hidden=32, joint_hidden=64,
                joint_activation="tanh", compute_dtype="float32",
                predictor_kind=kind, blank_position="auto")


def _setup(kind, seed=3):
    cfg = jrnnt.RNNTConfig(**_rnnt(kind))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, {"predictor": jrnnt.init_predictor(k1, cfg),
                                   "joint": jrnnt.init_joint(k2, cfg)})
    tree["joint"]["enc"]["w"] *= 8.0
    tree["joint"]["out"]["b"][cfg.blank_id] += 1.6
    enc = np.random.default_rng(seed).standard_normal((3, 30, 32)).astype(np.float32)
    return tree, enc


def _decode(tree, enc, lens, kind, **cfg):
    pp, jp = params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"])
    out = tgreedy.rnnt_greedy_decode(pp, jp, torch.from_numpy(enc), torch.tensor(lens),
                                     trnnt.RNNTConfig(**_rnnt(kind)),
                                     tgreedy.GreedyDecodeConfig(max_symbols_per_step=SYMBOLS,
                                                                **cfg))
    return [x.numpy() for x in out]


def _jax_decode(tree, enc, lens, kind, **cfg):
    out = jgreedy.rnnt_greedy_decode(
        *(jax.tree.map(jnp.asarray, tree[n]) for n in ("predictor", "joint")),
        jnp.asarray(enc), jnp.asarray(np.asarray(lens, np.int32)),
        jrnnt.RNNTConfig(**_rnnt(kind)),
        jgreedy.GreedyDecodeConfig(max_symbols_per_step=SYMBOLS, **cfg))
    return [np.asarray(x) for x in out]


def _equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: output {i}")


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kind", ["lstm", "stateless"])
def test_frame_window_matches_jax_and_window_one(kind, window):
    """Tokens, frames and counts equal JAX's at the same window and the
    port's at window 1; every lane emits several tokens and most frames
    are blank, so the window jumps runs; fewer loop iterations than at
    window 1."""
    tree, enc = _setup(kind)
    got = _decode(tree, enc, LENS, kind, frame_window=window)
    _equal(got, _jax_decode(tree, enc, LENS, kind, frame_window=window), "vs JAX")
    _equal(got, _decode(tree, enc, LENS, kind), "vs window 1")
    assert got[2].min() > 1 and (got[2] < np.array(LENS)).all()

    iters = {}
    for w in (1, window):
        pp, jp = params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"])
        rcfg = trnnt.RNNTConfig(**_rnnt(kind))
        cfg = tgreedy.GreedyDecodeConfig(frame_window=w, max_tokens=30,
                                         max_symbols_per_step=SYMBOLS)
        ring = trnnt.joint_precompute_enc(jp, torch.from_numpy(enc), rcfg)
        lens = torch.tensor(LENS, dtype=torch.int32)
        state = tgreedy.greedy_state_init(pp, 3, rcfg, cfg)
        n = 0
        while True:
            state, done = tgreedy.greedy_segment(pp, jp, ring, lens, torch.zeros(3, dtype=bool),
                                                 state, rcfg, cfg, 1)
            n += 1
            if bool(done.all()):
                break
        iters[w] = n
    assert iters[window] < iters[1]


@pytest.mark.parametrize("window", WINDOWS)
def test_frame_window_segments_match_one_shot_and_jax(window):
    """The segment API at the window (3 iterations a segment, 30 slots):
    the lanes end as JAX's segments driven the same way; lanes 0 and 2 as
    their one-shot decodes, and lane 1, reset after the first segment with
    another utterance, as that one's."""
    kind = "lstm"
    tree, enc = _setup(kind)
    other = np.random.default_rng(17).standard_normal((1, 30, 32)).astype(np.float32)
    kw = dict(frame_window=window, max_tokens=30)

    def drive(mod, rnnt_mod, asarray, tree_of):
        rcfg = rnnt_mod.RNNTConfig(**_rnnt(kind))
        cfg = mod.GreedyDecodeConfig(max_symbols_per_step=SYMBOLS, **kw)
        pp, jp = tree_of(tree["predictor"]), tree_of(tree["joint"])
        ring = np.asarray(rnnt_mod.joint_precompute_enc(jp, asarray(enc), rcfg)).copy()
        lens = np.array(LENS, np.int32)
        state = mod.greedy_state_init(pp, 3, rcfg, cfg)
        reset = np.zeros(3, bool)
        for i in range(40):
            if i == 1:  # lane 1 takes another utterance
                ring[1] = np.asarray(rnnt_mod.joint_precompute_enc(jp, asarray(other), rcfg))[0]
                lens[1], reset[1] = 27, True
            # fresh copies: JAX may alias a host array and read it after
            # the call returns, and these three change in place
            inputs = (asarray(x.copy()) for x in (ring, lens, reset))
            state, done = mod.greedy_segment(pp, jp, *inputs, state, rcfg, cfg, 3)
            reset[:] = False
            if i >= 1 and bool(np.asarray(done).all()):
                break
        return [np.asarray(x) for x in mod.greedy_finalize(state, asarray(lens))]

    got = drive(tgreedy, trnnt, torch.as_tensor, params_from_numpy)
    want = drive(jgreedy, jrnnt, jnp.asarray, lambda t: jax.tree.map(jnp.asarray, t))
    _equal(got, want, "vs JAX segments")
    whole = _decode(tree, enc, LENS, kind, **kw)
    alone = _decode(tree, other, (27,), kind, **kw)
    for lane in (0, 2):
        _equal([x[lane] for x in got], [x[lane] for x in whole], f"lane {lane}")
    _equal([x[1] for x in got], [x[0] for x in alone], "reset lane")
    assert got[2].min() > 1
