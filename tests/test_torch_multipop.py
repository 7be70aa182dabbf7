"""Graves beam search's ``multipop`` rounds in the port
(``decoding/transducer_graves.py``) against the JAX package's at the same
``multipop`` and against the port's serial pops (``multipop=1``), on the
CPU, fp32, on the same weights: the one-shot decode, a segment API run,
and arena exhaustion. Two joints: a sharp one (encoder weights x3, output
weights x8, blank +2) whose lanes emit several tokens and run every frame
to the pop cap, and a blank-biased one (output x8, blank +6) whose frames
mostly end by ESPnet's test. Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.decoding import transducer_graves as jgraves
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.decoding import transducer_graves as tgraves
from reazonspeech_tpu_torch.models import rnnt as trnnt

RNNT = dict(vocab_size=42, enc_dim=32, pred_hidden=24, joint_hidden=32, joint_activation="tanh",
            blank_position="first", compute_dtype="float32")
LENS = (24, 17, 9)
# (encoder weight scale, output weight scale, blank logit bias)
JOINTS = {"sharp": (3.0, 8.0, 2.0), "blank-biased": (1.0, 8.0, 6.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its ops are small, and at
    torch's default (one thread a core) each test worker's team
    oversubscribes the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(joint, pred_hidden=24, seed=0):
    emul, wmul, blank = JOINTS[joint]
    cfg = jrnnt.RNNTConfig(**dict(RNNT, pred_hidden=pred_hidden))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, {"predictor": jrnnt.init_predictor(k1, cfg),
                                   "joint": jrnnt.init_joint(k2, cfg)})
    tree["joint"]["enc"]["w"] *= emul
    tree["joint"]["out"]["w"] *= wmul
    tree["joint"]["out"]["b"][0] += blank
    return tree


def _enc(b=3, t=24, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, 32)).astype(np.float32)


def _port(tree, enc, lens, rnnt=RNNT, **cfg):
    return tgraves.graves_beam_decode_stats(
        params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"]),
        torch.from_numpy(enc), torch.tensor(lens), trnnt.RNNTConfig(**rnnt),
        tgraves.GravesBeamConfig(**cfg))


def _jax(tree, enc, lens, **cfg):
    out = jgraves.graves_beam_decode(
        *(jax.tree.map(jnp.asarray, tree[n]) for n in ("predictor", "joint")),
        jnp.asarray(enc), jnp.asarray(np.asarray(lens, np.int32)), jrnnt.RNNTConfig(**RNNT),
        jgraves.GravesBeamConfig(**cfg))
    return [np.asarray(x) for x in out]


def _assert_same(got, want, what):
    """Tokens, frames, counts and the saturated flags equal; scores within
    1e-5."""
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]),
                                      err_msg=f"{what}: output {i}")
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(want[3]), atol=1e-5, rtol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("multipop", [4, 8])
@pytest.mark.parametrize("joint", list(JOINTS))
def test_multipop_matches_jax_and_serial_pops(joint, multipop):
    """Three ragged lanes at beam 4: the port at ``multipop`` equals JAX's
    at the same ``multipop`` and the port's ``multipop=1``, in fewer host
    iterations a frame (pops per lane no more than the serial pops': a
    frame whose arena runs out ends early, saturated as it was)."""
    tree, enc = _tree(joint), _enc()
    *got, pmax, ptot, host = _port(tree, enc, LENS, beam_size=4, multipop=multipop)
    *serial, pmax1, ptot1, host1 = _port(tree, enc, LENS, beam_size=4)
    _assert_same(got, _jax(tree, enc, LENS, beam_size=4, multipop=multipop), "vs JAX")
    _assert_same([x.numpy() for x in got], [x.numpy() for x in serial], "vs multipop=1")
    assert bool((ptot <= ptot1).all()) and bool((pmax <= pmax1).all())
    assert host["frames"] == host1["frames"] == max(LENS)
    assert host["pops_issued"] * 2 < host1["pops_issued"]
    assert got[2].max() > 1
    if joint == "sharp":  # the two longer lanes emit several tokens; every frame saturates
        assert got[2][:2].min() > 1 and bool(got[4].all())
    else:  # ESPnet's test ends every frame of some lane
        assert not bool(got[4].all())


@pytest.mark.parametrize("multipop", [4, 8])
def test_multipop_with_step_kernel_twins(multipop):
    """``joint_impl`` and ``lstm_impl="pallas"`` (a predictor of 128 passes
    the LSTM kernel's guard; on CPU tensors the kernels' plain twins run at
    R = lanes x multipop rows): the same search as the serial pops with the
    same switches."""
    rnnt = dict(RNNT, pred_hidden=128)
    tree, enc = _tree("sharp", pred_hidden=128, seed=2), _enc(seed=2)
    switches = dict(beam_size=4, joint_impl="pallas", lstm_impl="pallas")
    got = _port(tree, enc, LENS, rnnt, multipop=multipop, **switches)[:5]
    want = _port(tree, enc, LENS, rnnt, **switches)[:5]
    _assert_same([x.numpy() for x in got], [x.numpy() for x in want], "switches")
    assert got[2].max() > 1


def test_multipop_segments_match_whole_decode():
    """The segment API at multipop 4 (segments of 5 frames): the whole
    decode's tokens, frames, counts, scores and flags, bit for bit."""
    tree, enc = _tree("blank-biased"), _enc(seed=4)
    pp, jp = params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"])
    rcfg = trnnt.RNNTConfig(**RNNT)
    cfg = tgraves.GravesBeamConfig(beam_size=4, multipop=4, max_tokens=24)
    whole = tgraves.graves_beam_decode(pp, jp, torch.from_numpy(enc), torch.tensor(LENS),
                                       rcfg, cfg)
    ring = trnnt.joint_precompute_enc(jp, torch.from_numpy(enc), rcfg)
    lens = torch.tensor(LENS, dtype=torch.int32)
    state = tgraves.graves_state_init(3, rcfg, cfg, "cpu")
    reset = torch.zeros(3, dtype=torch.bool)
    for _ in range(5):
        state = tgraves.graves_beam_segment(pp, jp, ring, lens, reset, state, rcfg, cfg, 5)
    seg = tgraves.graves_finalize(state, lens, rcfg, cfg)
    for a, b in zip(seg, whole):
        assert torch.equal(a, b)
    assert int(seg[2].max()) > 1


@pytest.mark.parametrize("blank,seed,pops", [(5.0, 2, 16), (6.0, 1, 24)])
def test_arena_exhaustion_saturates_as_jax(blank, seed, pops):
    """Six lanes, multipop 8, ``multipop_arena_factor=1.0``: acceptance
    skewed across the lanes spends the node arena before a lane's frame
    ends, which ends it saturated; the flags (and everything else) equal
    JAX's, and differ from the serial pops' where the arena ran out."""
    tree = _tree("blank-biased")
    tree["joint"]["out"]["b"][0] += blank - JOINTS["blank-biased"][2]
    enc, lens = _enc(b=6, t=12, seed=seed), (12, 11, 10, 9, 8, 7)
    cfg = dict(beam_size=4, max_pops_per_frame=pops, multipop_arena_factor=1.0)
    got = _port(tree, enc, lens, multipop=8, **cfg)[:5]
    _assert_same(got, _jax(tree, enc, lens, multipop=8, **cfg), "vs JAX")
    serial = _port(tree, enc, lens, **cfg)[:5]
    assert bool((got[4] & ~serial[4]).any())  # exhaustion, not ESPnet's test or the cap
    assert torch.equal(got[0], serial[0])
