"""The port's mAES beam search (``decoding/transducer_maes.py``) against the
JAX package's on the CPU, fp32, on the same weights: the one-shot decode
over a grid of its options, its segments with a lane reset mid-pool, the
espnet container's ``decoding="maes"`` on one JAX-saved tree, and the
continuous executor and the HTTP front (``--decoding maes``) serving it. The joint's output weights are scaled by
8 and its blank logit raised by 1, so that every lane emits several tokens
(the init's near-uniform joint emits one a lane and tests nothing).
Inputs come from numpy with a seed."""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.decoding import transducer_maes as jmaes
from reazonspeech_tpu.espnet.asr import model as jmodel
from reazonspeech_tpu.models import conformer as jconf
from reazonspeech_tpu.models import fastconformer as jfc
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.decoding import transducer_maes as tmaes
from reazonspeech_tpu_torch.espnet.asr import model as tmodel
from reazonspeech_tpu_torch.models import rnnt as trnnt
from reazonspeech_tpu_torch.serving import ContinuousBatcher

SR = 16000
RNNT = dict(vocab_size=42, enc_dim=32, pred_hidden=24, joint_hidden=32, joint_activation="tanh",
            blank_position="first", compute_dtype="float32")
LENS = (24, 17, 9)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: the executor's thread
    starts an OpenMP team of its own, and at torch's default (one thread a
    core) those teams oversubscribe the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharpen(tree):
    """The joint made decisive: output weights x8, blank logit +1."""
    tree["joint"]["out"]["w"] *= 8.0
    tree["joint"]["out"]["b"][0] += 1.0
    return tree


@pytest.fixture(scope="module")
def decoder():
    """(numpy tree, encoder output [3, 24, 32]) of a JAX-initialised
    predictor and joint."""
    cfg = jrnnt.RNNTConfig(**RNNT)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tree = _sharpen(jax.tree.map(np.array, {"predictor": jrnnt.init_predictor(k1, cfg),
                                            "joint": jrnnt.init_joint(k2, cfg)}))
    enc = np.random.default_rng(0).standard_normal((3, 24, 32)).astype(np.float32)
    return tree, enc


def _jax_decode(tree, enc, lens, cfg):
    out = jmaes.maes_beam_decode(
        *(jax.tree.map(jnp.asarray, tree[n]) for n in ("predictor", "joint")),
        jnp.asarray(enc), jnp.asarray(np.asarray(lens, np.int32)), jrnnt.RNNTConfig(**RNNT),
        jmaes.MAESBeamConfig(**cfg))
    return [np.asarray(x) for x in out]


def _port_decode(tree, enc, lens, cfg):
    return tmaes.maes_beam_decode(params_from_numpy(tree["predictor"]),
                                  params_from_numpy(tree["joint"]), torch.from_numpy(enc),
                                  torch.tensor(lens), trnnt.RNNTConfig(**RNNT),
                                  tmaes.MAESBeamConfig(**cfg))


def _assert_equal(got, want, what):
    """Tokens, frames and counts equal; scores within 1e-5 relative (every
    frame's log-sum-exps move them by rounding)."""
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), want[i], err_msg=f"{what}: output {i}")
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("beam", [4, 8])
@pytest.mark.parametrize("nstep", [1, 2])
@pytest.mark.parametrize("prefix_alpha", [0, 1])
@pytest.mark.parametrize("score_norm", [True, False])
def test_maes_matches_jax(decoder, beam, nstep, prefix_alpha, score_norm):
    """Three ragged lanes: tokens, frames and counts equal, scores within
    1e-5; the port with ``topk_impl="pallas"``, which runs the top-m
    kernel's plain twin on CPU tensors; every lane emits several tokens."""
    tree, enc = decoder
    cfg = dict(beam_size=beam, nstep=nstep, prefix_alpha=prefix_alpha, score_norm=score_norm)
    want = _jax_decode(tree, enc, LENS, cfg)
    got = _port_decode(tree, enc, LENS, dict(cfg, topk_impl="pallas"))
    _assert_equal(got, want, str(cfg))
    assert got[2].min() > 1
    frames = got[1].numpy()
    for i, n in enumerate(LENS):
        c = int(got[2][i])
        assert (np.diff(frames[i, :c]) >= 0).all() and frames[i, :c].max() < n


def test_maes_zero_length_lane_and_refusals(decoder):
    """A lane of length 0 counts 0 and leaves its neighbours as JAX's; the
    refused settings are the reference's."""
    tree, enc = decoder
    lens = (24, 0, 9)
    _assert_equal(_port_decode(tree, enc, lens, dict(beam_size=4)),
                  _jax_decode(tree, enc, lens, dict(beam_size=4)), "zero-length lane")
    pp = params_from_numpy(tree["predictor"])
    cfg = trnnt.RNNTConfig(**RNNT)
    for bad, err in ((dict(nstep=0), ValueError), (dict(prefix_alpha=2), NotImplementedError),
                     (dict(topk_impl="triton"), ValueError)):
        with pytest.raises(err):
            tmaes.maes_state_init(pp, 2, cfg, tmaes.MAESBeamConfig(max_tokens=8, **bad))
    with pytest.raises(ValueError, match="max_tokens"):
        tmaes.maes_state_init(pp, 2, cfg, tmaes.MAESBeamConfig())
    with pytest.raises(NotImplementedError, match="blank id 0"):
        tmaes.maes_state_init(pp, 2, replace(cfg, blank_position="last"),
                              tmaes.MAESBeamConfig(max_tokens=8))


@pytest.mark.parametrize("n_frames", [5, 7])
def test_segments_match_whole_decode_with_a_reset(decoder, n_frames):
    """Segments of ``n_frames`` over a ring of three lanes: lanes 0 and 2
    end as the whole decode (port and JAX) of their utterances; lane 1 is
    reset after its first segment with another utterance written into its
    ring rows, and ends as that utterance's own decode."""
    tree, enc = decoder
    pp, jp = params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"])
    rcfg = trnnt.RNNTConfig(**RNNT)
    cfg = tmaes.MAESBeamConfig(beam_size=6, max_tokens=24)
    other = np.random.default_rng(9).standard_normal((1, 24, 32)).astype(np.float32)
    enc_t = torch.from_numpy(enc)
    ring = trnnt.joint_precompute_enc(jp, enc_t, rcfg)
    lens = torch.tensor(LENS, dtype=torch.int32)
    state = tmaes.maes_state_init(pp, 3, rcfg, cfg)
    no_reset = torch.zeros(3, dtype=torch.bool)
    state = tmaes.maes_beam_segment(pp, jp, ring, lens, no_reset, state, rcfg, cfg, n_frames)
    ring[1] = trnnt.joint_precompute_enc(jp, torch.from_numpy(other), rcfg)[0]
    lens[1] = 20
    state = tmaes.maes_beam_segment(pp, jp, ring, lens, torch.tensor([False, True, False]),
                                    state, rcfg, cfg, n_frames)
    while int((state.fidx < lens).sum()):
        state = tmaes.maes_beam_segment(pp, jp, ring, lens, no_reset, state, rcfg, cfg,
                                        n_frames)
    seg = tmaes.maes_finalize(state, lens, rcfg, cfg)

    whole = dict(beam_size=6, max_tokens=24)
    want = _jax_decode(tree, enc, LENS, whole)
    want_other = _jax_decode(tree, other, (20,), whole)
    got_other = _port_decode(tree, other, (20,), whole)
    for lane in (0, 2):
        _assert_equal([x[lane:lane + 1] for x in seg], [x[lane:lane + 1] for x in want],
                      f"lane {lane}")
    _assert_equal([x[1:2] for x in seg], want_other, "reset lane")
    for a, b in zip(seg, got_other):  # the port's own decode: bit-equal
        assert torch.equal(a[1:2], b)


ENC = dict(num_layers=2, d_model=32, num_heads=4, subsampling_channels=32,
           compute_dtype="float32")
TOKENS = jmodel.default_token_list([chr(c) for c in range(0x3041, 0x3041 + 40)])


@pytest.fixture(scope="module")
def tree_path(tmp_path_factory):
    """One JAX-saved espnet tree: a tiny Conformer, the CTC head and the
    sharpened transducer heads."""
    enc_cfg = jconf.espnet_encoder_config(**ENC)
    rnnt_cfg = jrnnt.RNNTConfig(**dict(RNNT, vocab_size=len(TOKENS), enc_dim=32))
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(1), 4)
    tree = _sharpen(jax.tree.map(np.array, {
        "encoder": jfc.init_fastconformer(k1, enc_cfg),
        "ctc": jconf.init_ctc_head(k2, enc_cfg.d_model, rnnt_cfg.vocab_size),
        "predictor": jrnnt.init_predictor(k3, rnnt_cfg),
        "joint": jrnnt.init_joint(k4, rnnt_cfg)}))
    path = str(tmp_path_factory.mktemp("espnet_maes") / "model")
    save_param_tree(path, tree, {"flavor": "espnet", "token_list": TOKENS,
                                 "enc_cfg": asdict(enc_cfg), "rnnt_cfg": asdict(rnnt_cfg)})
    return path


def _wavs(seconds, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]


def test_container_maes_matches_jax(tree_path):
    """``load_model_container(decoding="maes")`` on one JAX-saved tree:
    the configuration, and decode_batch of two ragged waveforms equal to
    the JAX container's (tokens, frames, counts, encoder lengths)."""
    jm = jmodel.load_model_container(checkpoint=tree_path, decoding="maes", beam_size=4)
    tm = tmodel.load_model_container(checkpoint=tree_path, decoding="maes", beam_size=4,
                                     device="cpu")
    assert tm.decode_cfg == tmaes.MAESBeamConfig(beam_size=4)
    assert asdict(tm.decode_cfg) == asdict(jm.decode_cfg)
    wavs = _wavs((2.3, 1.4), seed=2)
    buf = np.zeros((2, 4 * SR), np.float32)
    for i, w in enumerate(wavs):
        buf[i, :len(w)] = w
    lens = np.array([len(w) for w in wavs], np.int32)
    got = tm.decode_batch(buf, lens)
    want = jm.decode_batch(buf, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[2].min() > 1


def test_continuous_batcher_serves_maes(tree_path):
    """The executor over an mAES container (2 lanes, 4 frames a segment,
    5 requests): each answer equals decode_single's under the pool's
    emission cap."""
    model = tmodel.load_model_container(checkpoint=tree_path, decoding="maes", beam_size=4,
                                        device="cpu")
    pool = ContinuousBatcher(model, n_lanes=2, frames_per_segment=4, max_seconds=4.0,
                             max_encode_batch=2)
    assert type(pool._ad).__name__ == "_MAESAdapter"
    wavs = _wavs((0.6, 1.9, 1.1, 2.7, 0.9), seed=4)
    try:
        got = [f.result(timeout=300) for f in [pool.submit(w) for w in wavs]]
    finally:
        pool.close()
    capped = replace(model, decode_cfg=replace(model.decode_cfg,
                                               max_tokens=pool.cfg.max_tokens))
    for i, (w, g) in enumerate(zip(wavs, got)):
        assert g == capped.decode_single(w), i
    assert pool.busy_lanes() == 0 and pool.segments > 0
    assert min(len(t) for t, _ in got) > 1


def test_http_front_takes_decoding_maes(tree_path, monkeypatch):
    """``--flavor espnet --decoding maes --continuous``: the HTTP front
    loads the mAES container (here from the tree on the CPU) and serves it
    through the executor; a real server answers one request with it."""
    import http.client
    import json
    import threading
    from http.server import ThreadingHTTPServer

    from reazonspeech_tpu_torch.serving import http as port_http

    load = tmodel.load_model_container
    monkeypatch.setattr(tmodel, "load_model_container",
                        lambda **kw: load(device="cpu", **dict(kw, checkpoint=tree_path)))
    served = []
    monkeypatch.setattr(port_http, "serve", lambda model, *a, **kw: served.append((model, kw)))
    port_http.main(["--flavor", "espnet", "--decoding", "maes", "--checkpoint", "random",
                    "--continuous", "--lanes", "2", "--max-seconds", "4"])
    (model, kw), = served
    assert model.decode_cfg == tmaes.MAESBeamConfig(beam_size=20)
    assert kw["executor"] == "continuous" and kw["n_lanes"] == 2

    model = replace(model, decode_cfg=tmaes.MAESBeamConfig(beam_size=4))
    handler, pool = port_http.make_app(model, 0.04, executor="continuous", n_lanes=2,
                                       frames_per_segment=4, max_seconds=4.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        wav = _wavs((1.3,), seed=8)[0]
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.request("POST", "/transcribe", body=wav.tobytes(),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        pool.close()
    assert resp.status == 200
    capped = replace(model, decode_cfg=replace(model.decode_cfg, max_tokens=pool.cfg.max_tokens))
    tokens, _ = capped.decode_single(wav)
    assert body["text"] == model.ids_to_text(tokens) and len(tokens) > 1
