"""The espnet slice of the port against the JAX package on the CPU: the
espnet frontend preset, GlobalMVN and conv2d subsampling, the tiny
Conformer encoder on both attention routes, the CTC blank scan and Viterbi
alignment, Graves beam search; then the loader's errors and the device
default. ``transcribe`` / ``ctc_probs`` / the CLI are in
``test_torch_espnet_transcribe.py`` and ``decode_batch`` in
``test_torch_espnet_decode.py``, on the tree this module's fixtures write
with the JAX store. fp32 compute throughout; the JAX kernels run in
interpret mode."""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.decoding import ctc as jctc
from reazonspeech_tpu.decoding import transducer_graves as jgraves
from reazonspeech_tpu.espnet.asr import model as jmodel
from reazonspeech_tpu.frontend import features as jfeat
from reazonspeech_tpu.models import conformer as jconf
from reazonspeech_tpu.models import fastconformer as jfc
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.core.hub import CheckpointNotFoundError
from reazonspeech_tpu_torch.decoding import ctc as tctc
from reazonspeech_tpu_torch.decoding import transducer_graves as tgraves
from reazonspeech_tpu_torch.decoding.transducer_maes import MAESBeamConfig
from reazonspeech_tpu_torch.espnet.asr import load_model
from reazonspeech_tpu_torch.espnet.asr import model as tmodel
from reazonspeech_tpu_torch.frontend import features as tfeat
from reazonspeech_tpu_torch.models import conformer as tconf
from reazonspeech_tpu_torch.models import fastconformer as tfc
from reazonspeech_tpu_torch.models import rnnt as trnnt

SR = 16000
TOKENS = jmodel.default_token_list(["。", "、", "?", "!"]
                                   + [chr(c) for c in range(0x3041, 0x307D)])
KERNELS = dict(attn_impl="pallas", conv_impl="pallas", lnd_impl="pallas")
# 4 heads of dh=16 (d=64): the [B, H, T, dh] route at every T
ENC = dict(num_layers=2, d_model=64, num_heads=4, subsampling_channels=32,
           compute_dtype="float32", **KERNELS)
RNNT = dict(vocab_size=len(TOKENS), enc_dim=64, pred_hidden=64, joint_hidden=64,
            joint_activation="tanh", blank_position="first", compute_dtype="float32")
# the random heads made to favour blank, as a trained model does: the CTC
# blank so that the 20 s blank scan finds runs to cut at, the transducer
# blank so that the beam search ends frames by ESPnet's test
CTC_BLANK_BIAS, JOINT_BLANK_BIAS = 8.0, 2.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: the Graves searches issue thousands of
    tiny ops, and a team of threads each under a loaded xdist run took a
    beam-20 case from 3.5 s alone to 590 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / SR))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _espnet_tree(enc_cfg, rnnt_cfg, seed):
    """A JAX-initialized espnet tree (numpy) with non-trivial LayerNorm
    affines, attention biases and GlobalMVN statistics, and the blank biases
    raised."""
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    init = jax.jit(jfc.init_fastconformer, static_argnums=1)
    tree = _np_tree({
        "encoder": init(k1, enc_cfg),
        "ctc": jconf.init_ctc_head(k2, enc_cfg.d_model, rnnt_cfg.vocab_size),
        "predictor": jrnnt.init_predictor(k3, rnnt_cfg),
        "joint": jrnnt.init_joint(k4, rnnt_cfg),
    })
    rng = np.random.default_rng(seed)
    blocks = tree["encoder"]["blocks"]
    for name in ("ffn1_ln", "attn_ln", "conv_ln", "conv_bn", "ffn2_ln", "final_ln"):
        blocks[name]["scale"] = (1.0 + 0.1 * rng.standard_normal(
            blocks[name]["scale"].shape)).astype(np.float32)
        blocks[name]["bias"] = (0.1 * rng.standard_normal(
            blocks[name]["bias"].shape)).astype(np.float32)
    for name in ("attn_bias_u", "attn_bias_v"):
        blocks[name] = (0.1 * rng.standard_normal(blocks[name].shape)).astype(np.float32)
    tree["normalize"] = {
        "mean": (2.0 * rng.standard_normal(enc_cfg.feat_in) - 8.0).astype(np.float32),
        "std": rng.uniform(1.5, 3.0, enc_cfg.feat_in).astype(np.float32)}
    tree["ctc"]["out"]["b"][0] += CTC_BLANK_BIAS
    tree["joint"]["out"]["b"][0] += JOINT_BLANK_BIAS
    return tree


@pytest.fixture(scope="module")
def tree_path(tmp_path_factory):
    enc_cfg = jconf.espnet_encoder_config(**ENC)
    rnnt_cfg = jrnnt.RNNTConfig(**RNNT)
    path = str(tmp_path_factory.mktemp("espnet") / "model")
    save_param_tree(path, _espnet_tree(enc_cfg, rnnt_cfg, seed=0),
                    {"flavor": "espnet", "token_list": TOKENS, "enc_cfg": asdict(enc_cfg),
                     "rnnt_cfg": asdict(rnnt_cfg)})
    return path


@pytest.fixture(scope="module")
def models(tree_path):
    """(jax container, port container) at beam 4, both from the one tree."""
    jm = jmodel.load_model_container(checkpoint=tree_path, beam_size=4)
    tm = tmodel.load_model_container(checkpoint=tree_path, beam_size=4, device="cpu")
    assert tm.enc_cfg == tconf.espnet_encoder_config(**ENC)
    assert tm.token_list == TOKENS and tm.rnnt_cfg == trnnt.RNNTConfig(**RNNT)
    assert tm.decode_cfg == tgraves.GravesBeamConfig(beam_size=4)
    return jm, tm


# --- (d) frontend, GlobalMVN, conv2d subsampling ------------------------------


def test_espnet_frontend_matches_jax():
    """The espnet preset (periodic hann, no preemph, 1e-10 log clamp, no
    normalization) on a ragged batch: lengths equal, values within 2e-5 of
    the features' range (the fp32 DFT's sum order in low-energy bins)."""
    assert asdict(tfeat.espnet_frontend_config()) == asdict(jfeat.espnet_frontend_config())
    wav = np.stack([_wav(2.0, 0), _wav(2.0, 1)])
    lens = np.array([32000, 17777], np.int32)
    wav[1, lens[1]:] = 0.0
    want, wl = jfeat.log_mel_spectrogram(jnp.asarray(wav), jnp.asarray(lens),
                                         jfeat.espnet_frontend_config())
    got, gl = tfeat.log_mel_spectrogram(torch.from_numpy(wav), torch.from_numpy(lens),
                                        tfeat.espnet_frontend_config())
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()


def test_global_mvn_and_conv2d_subsampling_match_jax():
    """GlobalMVN with the padded frames zeroed again, then the VALID conv2d
    subsampling (lengths (n-1)//2 twice), fp32, to 1e-5."""
    enc_cfg = jconf.espnet_encoder_config(**ENC)
    tree = _espnet_tree(enc_cfg, jrnnt.RNNTConfig(**RNNT), seed=1)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 203, 80)).astype(np.float32) - 8.0
    lens = np.array([203, 150], np.int32)
    want = jmodel._apply_mvn(_jax_tree(tree), jnp.asarray(feats), jnp.asarray(lens))
    got = tmodel._apply_mvn(params_from_numpy(tree), torch.from_numpy(feats),
                            torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not got[1, 150:].any()
    wx, wl = jfc._subsample(_jax_tree(tree["encoder"]["subsampling"]), want, jnp.asarray(lens),
                            enc_cfg)
    tcfg = tconf.espnet_encoder_config(**ENC)
    gx, gl = tfc._subsample(params_from_numpy(tree["encoder"]["subsampling"]), got,
                            torch.from_numpy(lens), tcfg)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert tuple(gl.tolist()) == (50, 36)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-5, rtol=1e-5)


# --- (e) the tiny encoder on both attention routes -----------------------------


@pytest.mark.parametrize("heads,d_model,frames,route", [
    (8, 128, 403, "packed"),    # T=99: 8 heads of dh=16 pack 128 lanes
    (4, 64, 403, "generic"),    # 4 heads of dh=16 do not
    (8, 128, 2201, "generic"),  # T=549: past the fused kernels' 512 rows
])
def test_encoder_matches_jax(monkeypatch, heads, d_model, frames, route):
    """The tiny espnet encoder (2 blocks, conv kernel 31, LayerNorm conv
    modules, after_norm) with every kernel on, fp32, a ragged batch: equal
    to JAX (its kernels in interpret mode) to 5e-5 max abs on valid frames."""
    patch_interpret(monkeypatch)
    cfg = dict(ENC, num_heads=heads, d_model=d_model)
    jcfg, tcfg = jconf.espnet_encoder_config(**cfg), tconf.espnet_encoder_config(**cfg)
    tree = _espnet_tree(jcfg, jrnnt.RNNTConfig(**dict(RNNT, enc_dim=d_model)), seed=frames)
    t = ((frames - 1) // 2 - 1) // 2  # two VALID k3/s2 convs
    assert tfc.attention_route(tcfg, t) == route
    rng = np.random.default_rng(frames)
    feats = rng.standard_normal((2, frames, 80)).astype(np.float32)
    lens = np.array([frames, frames * 2 // 3], np.int32)
    want, wl = jfc.fastconformer_encode(_jax_tree(tree["encoder"]), jnp.asarray(feats),
                                        jnp.asarray(lens), jcfg)
    got, gl = tfc.fastconformer_encode(params_from_numpy(tree["encoder"]),
                                       torch.from_numpy(feats), torch.from_numpy(lens), tcfg)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    want = np.asarray(want)
    assert got.shape == want.shape == (2, t, d_model)
    valid = (np.arange(t)[None, :] < np.asarray(wl)[:, None])[..., None]
    assert np.abs((got.numpy() - want) * valid).max() <= 5e-5


# --- (f) CTC blank scan and alignment ------------------------------------------


def _lpz(t, v, seed):
    """Softmax rows with blank-dominant stretches (runs above 0.98, one at
    frame 0 and one still open at the end)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, v)).astype(np.float32)
    for a, b in ((0, 4), (10, 19), (25, 27), (t - 6, t)):
        logits[a:b, 0] += 12.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_find_blank_matches_jax():
    lpz = _lpz(40, 12, seed=0)
    for n in (16000, 320000):
        assert tuple(tctc.find_blank(lpz, n)) == tuple(jctc.find_blank(lpz, n))
        assert tuple(tctc.find_blank(torch.from_numpy(lpz), n)) == tuple(jctc.find_blank(lpz, n))
    assert tctc.find_blank_runs(lpz) == jctc.find_blank_runs(lpz)
    flat = np.full((9, 5), 0.2, np.float32)  # nothing above the threshold: the sentinel
    assert tuple(tctc.find_blank(flat, 777)) == tuple(jctc.find_blank(flat, 777)) == (777, 777)


@pytest.mark.parametrize("ids", [[3, 5, 5, 7], [2], [4, 4, 4], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]])
def test_viterbi_alignment_and_timings_match_jax(ids):
    """Frames of the Viterbi path and sample timings equal, repeated labels
    (no skip between them) included."""
    lpz_log = np.log(_lpz(30, 12, seed=len(ids)))
    want = jctc.ctc_viterbi_align(lpz_log, ids)
    got = tctc.ctc_viterbi_align(lpz_log, ids)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tctc.ctc_viterbi_align(torch.from_numpy(lpz_log), ids), want)
    np.testing.assert_array_equal(tctc.get_timings(lpz_log, ids, 48000),
                                  jctc.get_timings(lpz_log, ids, 48000))


def test_viterbi_alignment_edge_cases():
    lpz_log = np.log(_lpz(5, 8, seed=1))
    for ids in ([], [1, 2, 3, 4, 5, 6]):  # no tokens; more tokens than frames
        assert len(tctc.ctc_viterbi_align(lpz_log, ids)) == 0
        assert len(jctc.ctc_viterbi_align(lpz_log, ids)) == 0


# --- (g) Graves beam search ------------------------------------------------------


def _decoder(seed):
    rnnt_cfg = jrnnt.RNNTConfig(**RNNT)
    k3, k4 = jax.random.split(jax.random.PRNGKey(seed))
    tree = _np_tree({"predictor": jrnnt.init_predictor(k3, rnnt_cfg),
                     "joint": jrnnt.init_joint(k4, rnnt_cfg)})
    tree["joint"]["enc"]["w"] *= 3.0  # the joint leans on the encoder output
    tree["joint"]["out"]["b"][0] += JOINT_BLANK_BIAS
    return tree


@pytest.mark.parametrize("cfg", [
    dict(beam_size=4), dict(beam_size=20), dict(beam_size=4, score_norm=False),
    dict(beam_size=8, max_pops_per_frame=4, kept_capacity=4),  # every frame saturates
], ids=["beam4", "beam20", "beam4-raw", "saturating"])
def test_graves_matches_jax(cfg):
    """On one random encoder output, fp32: tokens, frames, counts and the
    saturated flags equal, scores to 1e-5; emissions present."""
    tree = _decoder(seed=5)
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((3, 24, 64)).astype(np.float32)
    lens = np.array([24, 17, 1], np.int32)
    want = jgraves.graves_beam_decode(tree["predictor"], tree["joint"], jnp.asarray(enc),
                                      jnp.asarray(lens), jrnnt.RNNTConfig(**RNNT),
                                      jgraves.GravesBeamConfig(**cfg))
    got = tgraves.graves_beam_decode(params_from_numpy(tree["predictor"]),
                                     params_from_numpy(tree["joint"]), torch.from_numpy(enc),
                                     torch.from_numpy(lens), trnnt.RNNTConfig(**RNNT),
                                     tgraves.GravesBeamConfig(**cfg))
    for i in (0, 1, 2, 4):  # tokens, frames, counts, saturated
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=1e-5)
    if cfg.get("score_norm", True):  # raw scores favour the shortest hypothesis
        assert got[2][0] > 0
    assert bool(got[4].any()) == ("max_pops_per_frame" in cfg)


def test_graves_stats_and_unported_knobs():
    tree = _decoder(seed=6)
    pp, jp = params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"])
    enc, lens = torch.randn(2, 9, 64), torch.tensor([9, 4])
    rcfg = trnnt.RNNTConfig(**RNNT)
    *_, pmax, ptot, host = tgraves.graves_beam_decode_stats(pp, jp, enc, lens, rcfg,
                                                            tgraves.GravesBeamConfig(beam_size=4))
    assert host["frames"] == 9 and host["pops_issued"] >= 9 * 4
    assert int(pmax.min()) >= 4 and int(ptot[0]) >= int(ptot[1]) >= 4 * 4
    want = tgraves.graves_beam_decode(pp, jp, enc, lens, rcfg,
                                      tgraves.GravesBeamConfig(beam_size=4))
    for knob in (dict(multipop=4), dict(unroll=2), dict(joint_impl="pallas"),
                 dict(lstm_impl="pallas")):
        cfg = tgraves.GravesBeamConfig(beam_size=4, **knob)
        # unroll and multipop are exact (the same search, multipop in fewer
        # rounds); the step kernels' fp32 twins on this fp32 config give the
        # same search; pred_hidden=64 leaves lstm_impl to the guard (no
        # kernel), as in the reference
        got = tgraves.graves_beam_decode(pp, jp, enc, lens, rcfg, cfg)
        for i in (0, 1, 2, 4):
            assert torch.equal(got[i], want[i]), knob
        torch.testing.assert_close(got[3], want[3], atol=1e-5, rtol=0)


# --- (h) the entry points on one JAX-saved tree: test_torch_espnet_transcribe.py
# (ctc_probs, transcribe, the CLI) and test_torch_espnet_decode.py (decode_batch)


def jmodel_config(**kw):
    from reazonspeech_tpu.espnet.asr import TranscribeConfig as JConfig

    return JConfig(**kw)


# --- (i) the loader -------------------------------------------------------------


@pytest.fixture
def empty_caches(tmp_path, monkeypatch):
    monkeypatch.delenv(tmodel.DEFAULT_CHECKPOINT_ENV, raising=False)
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    return tmp_path


def test_load_model_errors(empty_caches):
    """No checkpoint anywhere: CheckpointNotFoundError offering
    checkpoint="random", never random weights; a snapshot whose .pth is
    empty reaches the converter, whose error propagates as the JAX loader's
    does on the same snapshot (no tree cached); maes loads as mAES at the
    beam size asked for, an unknown decoding raises ValueError."""
    with pytest.raises(CheckpointNotFoundError, match="random"):
        load_model("cpu")
    snap = (empty_caches / "hub" / "models--reazon-research--reazonspeech-espnet-v2"
            / "snapshots" / "abc" / "exp")
    snap.mkdir(parents=True)
    (snap / "valid.acc.ave.pth").write_bytes(b"")
    errors = []
    for load in (lambda: load_model("cpu"), jmodel.load_model_container):
        with pytest.raises(Exception) as err:
            load()
        errors.append(err.value)
    assert type(errors[0]) is type(errors[1]) and str(errors[0]) == str(errors[1])
    assert not isinstance(errors[0], CheckpointNotFoundError)
    assert not list((empty_caches / "cache").rglob("*.npz"))
    maes = load_model("cpu", checkpoint="random", decoding="maes", beam_size=6,
                      enc_cfg=tconf.espnet_encoder_config(**ENC))
    assert maes.decode_cfg == MAESBeamConfig(beam_size=6)
    with pytest.raises(ValueError, match="Unknown decoding"):
        load_model("cpu", checkpoint="random", decoding="viterbi")


def test_load_model_default_device_is_cuda(monkeypatch):
    """No device given means CUDA: without a GPU that raises, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(checkpoint="random")


def test_random_model_and_serving_config():
    """checkpoint="random" at a tiny width: every head initialized, the
    decodings selectable; the CUDA serving configuration is the reference's
    TPU one at espnet's full width."""
    m = load_model("cpu", checkpoint="random", enc_cfg=tconf.espnet_encoder_config(**ENC),
                   decoding="alsd", beam_size=3)
    assert set(m.params) == {"encoder", "ctc", "predictor", "joint"}
    assert m.decode_cfg.beam_size == 3 and m.rnnt_cfg.blank_id == 0
    assert m.token_list == tmodel.default_token_list() and len(m.token_list) == 2182
    wav = _wav(2.0, seed=1)
    assert m.ctc_probs(wav).shape == (49, 2182)
    greedy = replace(m, decode_cfg=tmodel.GreedyDecodeConfig())
    assert len(greedy.decode_single(wav)) == 2
    cfg = tmodel._cuda_serving_config(tconf.espnet_encoder_config())
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.conv_kernel) == (12, 512, 8, 31)
    assert (cfg.attn_impl, cfg.conv_impl, cfg.lnd_impl, cfg.compute_dtype,
            cfg.residual_dtype) == ("pallas", "pallas", "pallas", "bfloat16", "float32")
