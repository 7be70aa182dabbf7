"""The port's segmented decodes (greedy, ALSD beam 4, Graves beam 4) on the
CPU: a pool of three lanes serves five requests of mixed lengths, a lane
that finishes is reset and refilled while its neighbours are mid-utterance,
and each request's finalized tokens, frames and counts must equal the port's
one-shot decode of it alone under the same ``max_tokens`` and the JAX
package's segment API driven the same way on the same weights (fp32, the
same formulas: tokens and frames exactly, the beam searches' scores, which
every frame moves, within 1e-5). Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.decoding import rnnt_beam as jbeam
from reazonspeech_tpu.decoding import rnnt_greedy as jgreedy
from reazonspeech_tpu.decoding import transducer_graves as jgraves
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.decoding import rnnt_beam as tbeam
from reazonspeech_tpu_torch.decoding import rnnt_greedy as tgreedy
from reazonspeech_tpu_torch.decoding import transducer_graves as tgraves
from reazonspeech_tpu_torch.models import rnnt as trnnt

T_BUF = 16
N_LANES = 3
REQ_LENS = (14, 6, 9, 11, 3)
KINDS = ("greedy", "alsd", "graves")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: every executor, batcher
    and server thread starts an OpenMP team of its own, and at torch's
    default (one thread a core) those teams oversubscribe the cores that
    the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rnnt(kind):
    """Blank last (nemo) for greedy and ALSD, blank first (espnet) for
    Graves; a tanh joint, fp32."""
    return dict(vocab_size=30, enc_dim=32, pred_hidden=32, joint_hidden=64,
                joint_activation="tanh", compute_dtype="float32",
                blank_position="first" if kind == "graves" else "last")


def _cfgs(kind):
    """(JAX config, port config) with the pool's emission buffer."""
    if kind == "greedy":  # two emissions a frame at most: the cap binds on some frames
        kw = dict(max_tokens=T_BUF, max_symbols_per_step=2)
        return jgreedy.GreedyDecodeConfig(**kw), tgreedy.GreedyDecodeConfig(**kw)
    if kind == "alsd":
        kw = dict(beam_size=4, max_tokens=tbeam.alsd_step_bound(
            T_BUF, tbeam.BeamDecodeConfig()))
        return jbeam.BeamDecodeConfig(**kw), tbeam.BeamDecodeConfig(**kw)
    kw = dict(beam_size=4, max_tokens=T_BUF)
    return jgraves.GravesBeamConfig(**kw), tgraves.GravesBeamConfig(**kw)


@pytest.fixture(scope="module", params=KINDS)
def setup(request):
    """(kind, numpy tree, requests): JAX-initialised predictor and joint,
    the joint leaning on the encoder output with blank raised, so that
    emissions and blank advances both occur (the emission cap binds on the
    longest greedy request), and on the predictor, whose recurrent weights
    are raised: a lane reset that kept any of its predictor state would
    change the results."""
    kind = request.param
    cfg = jrnnt.RNNTConfig(**_rnnt(kind))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.array, {"predictor": jrnnt.init_predictor(k1, cfg),
                                   "joint": jrnnt.init_joint(k2, cfg)})
    tree["joint"]["enc"]["w"] *= 3.0
    tree["joint"]["pred"]["w"] *= 6.0
    tree["joint"]["out"]["w"] *= 3.0
    tree["joint"]["out"]["b"][cfg.blank_id] += 3.0
    for layer in tree["predictor"]["lstm"]:
        layer["w_hh"] *= 3.0
    rng = np.random.default_rng(11)
    reqs = [rng.standard_normal((n, cfg.enc_dim)).astype(np.float32) for n in REQ_LENS]
    return kind, tree, reqs


def _port(kind, tree):
    """The port's segment API as (init, segment, done, finalize, project)."""
    rcfg = trnnt.RNNTConfig(**_rnnt(kind))
    cfg = _cfgs(kind)[1]
    pp, jp = params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"])
    if kind == "graves":
        init = lambda: tgraves.graves_state_init(N_LANES, rcfg, cfg, "cpu")  # noqa: E731
        seg = lambda ring, ll, rs, st, n: (  # noqa: E731
            tgraves.graves_beam_segment(pp, jp, ring, ll, rs, st, rcfg, cfg, n), None)
        fin = lambda st, ll: tgraves.graves_finalize(st, ll, rcfg, cfg)[:4]  # noqa: E731
    elif kind == "alsd":
        init = lambda: tbeam.alsd_state_init(pp, N_LANES, rcfg, cfg)  # noqa: E731
        seg = lambda ring, ll, rs, st, n: tbeam.alsd_segment(  # noqa: E731
            pp, jp, ring, ll, rs, st, rcfg, cfg, n)
        fin = lambda st, ll: tbeam.alsd_finalize(st, ll, rcfg, cfg)  # noqa: E731
    else:
        init = lambda: tgreedy.greedy_state_init(pp, N_LANES, rcfg, cfg)  # noqa: E731
        seg = lambda ring, ll, rs, st, n: tgreedy.greedy_segment(  # noqa: E731
            pp, jp, ring, ll, rs, st, rcfg, cfg, n)
        fin = tgreedy.greedy_finalize
    return dict(init=init, segment=seg, finalize=fin, asarray=torch.as_tensor,
                project=lambda enc: trnnt.joint_precompute_enc(
                    jp, torch.from_numpy(enc)[None], rcfg)[0].numpy())


def _jax(kind, tree):
    rcfg = jrnnt.RNNTConfig(**_rnnt(kind))
    cfg = _cfgs(kind)[0]
    pp, jp = (jax.tree.map(jnp.asarray, tree[n]) for n in ("predictor", "joint"))
    if kind == "graves":
        init = lambda: jgraves.graves_state_init(N_LANES, rcfg, cfg)  # noqa: E731
        seg = lambda ring, ll, rs, st, n: (  # noqa: E731
            jgraves.graves_beam_segment(pp, jp, ring, ll, rs, st, rcfg, cfg, n), None)
        fin = lambda st, ll: jgraves.graves_finalize(st, ll, rcfg, cfg)[:4]  # noqa: E731
    elif kind == "alsd":
        init = lambda: jbeam.alsd_state_init(pp, N_LANES, rcfg, cfg)  # noqa: E731
        seg = lambda ring, ll, rs, st, n: jbeam.alsd_segment(  # noqa: E731
            pp, jp, ring, ll, rs, st, rcfg, cfg, n)
        fin = lambda st, ll: jbeam.alsd_finalize(st, ll, rcfg, cfg)  # noqa: E731
    else:
        init = lambda: jgreedy.greedy_state_init(pp, N_LANES, rcfg, cfg)  # noqa: E731
        seg = lambda ring, ll, rs, st, n: jgreedy.greedy_segment(  # noqa: E731
            pp, jp, ring, ll, rs, st, rcfg, cfg, n)
        fin = jgreedy.greedy_finalize
    return dict(init=init, segment=seg, finalize=fin, asarray=jnp.asarray,
                project=lambda enc: np.asarray(jrnnt.joint_precompute_enc(
                    jp, jnp.asarray(enc)[None], rcfg)[0]))


def _drive(api, reqs, n_steps):
    """Serve ``reqs`` through the lane pool: before each segment, finished
    lanes are finalized and freed, and free lanes take the next request
    (flagged in reset). Returns each request's (tokens, frames, score or
    None) and the number of resets that happened while another lane was
    mid-utterance."""
    j = api["project"](reqs[0]).shape[-1]
    ring = np.zeros((N_LANES, T_BUF, j), np.float32)
    lane_len = np.zeros(N_LANES, np.int32)
    lane_req = [-1] * N_LANES
    done = np.zeros(N_LANES, bool)
    state, got, nxt, mid_pool_resets = api["init"](), [None] * len(reqs), 0, 0
    for _ in range(200):
        reset = np.zeros(N_LANES, bool)
        finished = [lane for lane in range(N_LANES) if lane_req[lane] >= 0 and done[lane]]
        if finished:
            tokens, frames, counts, *score = (np.asarray(x) for x in api["finalize"](
                state, api["asarray"](lane_len)))
            for lane in finished:
                c = int(counts[lane])
                got[lane_req[lane]] = (tokens[lane, :c].tolist(), frames[lane, :c].tolist(),
                                       float(score[0][lane]) if score else None)
                lane_req[lane], lane_len[lane] = -1, 0
        for lane in range(N_LANES):
            if lane_req[lane] < 0 and nxt < len(reqs):
                proj = api["project"](reqs[nxt])
                ring = ring.copy()
                ring[lane] = 0.0
                ring[lane, :len(proj)] = proj
                lane_len[lane], lane_req[lane], reset[lane] = len(proj), nxt, True
                mid_pool_resets += any(r >= 0 for i, r in enumerate(lane_req) if i != lane
                                       and not reset[i])
                nxt += 1
        if all(r < 0 for r in lane_req):
            break
        state, flag = api["segment"](api["asarray"](ring), api["asarray"](lane_len),
                                     api["asarray"](reset), state, n_steps)
        done = np.asarray(state.fidx >= api["asarray"](lane_len)) if flag is None \
            else np.asarray(flag)
    assert all(g is not None for g in got), "the pool did not serve every request"
    return got, mid_pool_resets


def _one_shot(kind, tree, enc):
    """The port's dedicated decode of one request."""
    rcfg, cfg = trnnt.RNNTConfig(**_rnnt(kind)), _cfgs(kind)[1]
    pp, jp = params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"])
    fn = {"greedy": tgreedy.rnnt_greedy_decode, "alsd": tbeam.rnnt_beam_decode,
          "graves": tgraves.graves_beam_decode}[kind]
    out = fn(pp, jp, torch.from_numpy(enc)[None], torch.tensor([len(enc)]), rcfg, cfg)
    c = int(out[2][0])
    return out[0][0, :c].tolist(), out[1][0, :c].tolist(), \
        float(out[3][0]) if len(out) > 3 else None


_JAX_RESULTS = {}


@pytest.mark.parametrize("n_steps", [3, 7])
def test_segments_match_one_shot_and_jax(setup, n_steps):
    """Every request's tokens and frames (hence counts) equal its one-shot
    decode's and the JAX segment API's, the beam scores within 1e-5; some
    lane is reset mid-pool, and the requests emit."""
    kind, tree, reqs = setup
    got, mid_pool = _drive(_port(kind, tree), reqs, n_steps)
    assert mid_pool >= 1
    if kind not in _JAX_RESULTS:  # the reference's result does not depend on n_steps
        _JAX_RESULTS[kind] = _drive(_jax(kind, tree), reqs, 7)[0]
    for i, enc in enumerate(reqs):
        for want in (_one_shot(kind, tree, enc), _JAX_RESULTS[kind][i]):
            assert got[i][:2] == want[:2], (kind, i)
            if kind != "greedy":
                assert abs(got[i][2] - want[2]) <= 1e-5, (kind, i)
    assert sum(len(g[0]) for g in got) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_state_init_requires_max_tokens(kind):
    rcfg = trnnt.RNNTConfig(**_rnnt(kind))
    pp = trnnt.init_predictor(torch.Generator().manual_seed(0), rcfg)
    with pytest.raises(ValueError, match="max_tokens"):
        if kind == "greedy":
            tgreedy.greedy_state_init(pp, 2, rcfg, tgreedy.GreedyDecodeConfig())
        elif kind == "alsd":
            tbeam.alsd_state_init(pp, 2, rcfg, tbeam.BeamDecodeConfig())
        else:
            tgraves.graves_state_init(2, rcfg, tgraves.GravesBeamConfig(beam_size=4), "cpu")


def test_alsd_clock_matches_jax():
    """A segment in which the whole pool goes idle: the reference leaves its
    loop there and its step stops, the port's runs on to n_steps; every
    other field of the state, the done flags, and each lane's result after
    a reset and a second segment equal the reference's."""
    kind = "alsd"
    cfg = jrnnt.RNNTConfig(**_rnnt(kind))
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    tree = jax.tree.map(np.array, {"predictor": jrnnt.init_predictor(k1, cfg),
                                   "joint": jrnnt.init_joint(k2, cfg)})
    rng = np.random.default_rng(5)
    ring = rng.standard_normal((N_LANES, T_BUF, 64)).astype(np.float32)
    lens = np.array([4, 0, 2], np.int32)
    reset = np.ones(N_LANES, bool)
    port, ref = _port(kind, tree), _jax(kind, tree)
    ps, pd = port["segment"](torch.from_numpy(ring), torch.from_numpy(lens),
                             torch.from_numpy(reset), port["init"](), 20)
    js, jd = ref["segment"](jnp.asarray(ring), jnp.asarray(lens), jnp.asarray(reset),
                            ref["init"](), 20)
    assert ps.step.tolist() == [20] * N_LANES
    assert int(js.step[0]) < 20  # the pool went idle inside the segment
    assert pd.tolist() == np.asarray(jd).tolist() == [True] * N_LANES
    for name in ps._fields:
        if name != "step":
            _assert_field_equal(getattr(ps, name), getattr(js, name), name)
    # lane 1 takes a request; its neighbours, already done, must not move
    lens2 = np.array([4, 5, 2], np.int32)
    reset2 = np.array([False, True, False])
    ps, pd = port["segment"](torch.from_numpy(ring), torch.from_numpy(lens2),
                             torch.from_numpy(reset2), ps, 20)
    js, jd = ref["segment"](jnp.asarray(ring), jnp.asarray(lens2), jnp.asarray(reset2), js, 20)
    assert pd.tolist() == np.asarray(jd).tolist()
    got = port["finalize"](ps, torch.from_numpy(lens2))
    want = ref["finalize"](js, jnp.asarray(lens2))
    for g, w, name in zip(got, want, ("tokens", "frames", "counts", "scores")):
        _assert_field_equal(g, w, name)


def _assert_field_equal(got, want, name):
    """Integer and boolean fields exactly, scores within 1e-5; predictor
    states field by field."""
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _assert_field_equal(g, w, name)
        return
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(got.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)
