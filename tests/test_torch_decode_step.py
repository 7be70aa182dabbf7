"""The beam decoders' step kernels of the port against the JAX package on the
CPU: the plain twins of ``joint_topm`` (fused joint + top-m) and
``lstm_cell_step`` (fused LSTM cell) against the JAX kernels in interpret
mode; ALSD and Graves with ``joint_impl``/``lstm_impl="pallas"`` against the
JAX decoders on the same weights; ALSD over the stateless (k2) predictor;
and k2 ``decoding="beam"`` end to end on one tree written by the JAX store.
Inputs come from numpy with a seed."""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.decoding import rnnt_beam as jbeam
from reazonspeech_tpu.decoding import transducer_graves as jgraves
from reazonspeech_tpu.k2.asr import model as jk2model
from reazonspeech_tpu.k2.asr.transcribe import transcribe as jax_transcribe
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu.models import zipformer as jzf
from reazonspeech_tpu.ops import beam_topk as jtopk
from reazonspeech_tpu.ops import lstm_step as jlstm
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.decoding import rnnt_beam as tbeam
from reazonspeech_tpu_torch.decoding import transducer_graves as tgraves
from reazonspeech_tpu_torch.k2.asr import audio_from_numpy, transcribe
from reazonspeech_tpu_torch.k2.asr import model as tk2model
from reazonspeech_tpu_torch.models import rnnt as trnnt
from reazonspeech_tpu_torch.ops import launch_counts, reset_launch_counts
from reazonspeech_tpu_torch.ops.beam_topk import joint_topm, joint_topm_plain
from reazonspeech_tpu_torch.ops.lstm_step import lstm_cell_step, lstm_cell_step_plain

KERNEL_NAMES = ("joint_topm", "lstm_cell_step", "topm_logsoftmax")


def _joint_inputs(seed, v, r=48, hdim=128, j=256):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    return (f(hdim, j, s=0.1), f(j, s=0.1), f(j, v, s=0.1), f(v, s=0.1), f(r, j), f(r, hdim))


# every activation with each blank position and each m across the six
@pytest.mark.parametrize("act,blank_first,m", [
    ("relu", False, 4), ("relu", True, 20), ("tanh", True, 4), ("tanh", False, 20),
    ("sigmoid", True, 20), ("sigmoid", False, 4)])
def test_joint_topm_plain_matches_jax_fp32(act, blank_first, m):
    """fp32: indices equal, log-probs within 5e-6 (fp32 sums in another order)."""
    v = 301
    blank = 0 if blank_first else v - 1
    args = _joint_inputs(seed=m + len(act), v=v)
    want = jtopk.joint_topm(*map(jnp.asarray, args), m, blank, activation=act,
                            compute_dtype="float32", block_r=16, interpret=True)
    got = joint_topm_plain(*map(torch.from_numpy, args), m, blank, activation=act,
                           compute_dtype="float32")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-6, rtol=0)


@pytest.mark.parametrize("act,blank,m", [("relu", 300, 4), ("tanh", 0, 20)])
def test_joint_topm_plain_matches_jax_bf16(act, blank, m):
    """bf16: the two frameworks round the products at the same points but
    sum in other orders, so values within 2e-2 (a few bf16 ulps); bf16
    logits tie, so indices are not compared."""
    args = _joint_inputs(seed=7, v=301)
    want = jtopk.joint_topm(*map(jnp.asarray, args), m, blank, activation=act,
                            compute_dtype="bfloat16", interpret=True)
    got = joint_topm_plain(*map(torch.from_numpy, args), m, blank, activation=act,
                           compute_dtype="bfloat16")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("r,h_in,h", [(6, 128, 128), (16, 64, 256)])
def test_lstm_cell_plain_matches_jax(dtype, atol, r, h_in, h):
    rng = np.random.default_rng(r + h)
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    args = (f(h_in, 4 * h, s=0.1), f(h, 4 * h, s=0.1), f(4 * h, s=0.1), f(r, h_in), f(r, h),
            f(r, h))
    want = jlstm.lstm_cell_step(*map(jnp.asarray, args), compute_dtype=dtype, interpret=True)
    got = lstm_cell_step_plain(*map(torch.from_numpy, args), compute_dtype=dtype)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (r, h)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def test_cpu_wrappers_run_the_twins():
    """On CPU tensors the wrappers run their plain twins (both dtypes) and
    launch nothing."""
    joint = tuple(map(torch.from_numpy, _joint_inputs(seed=3, v=64, r=5, hdim=32, j=32)))
    rng = np.random.default_rng(3)
    cell = tuple(torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
                 for s in ((32, 128), (32, 128), (128,), (5, 32), (5, 32), (5, 32)))
    reset_launch_counts()
    for cdt in ("float32", "bfloat16"):
        kw = dict(activation="tanh", compute_dtype=cdt)
        for g, w in zip(joint_topm(*joint, 4, 0, **kw), joint_topm_plain(*joint, 4, 0, **kw)):
            assert torch.equal(g, w)
        for g, w in zip(lstm_cell_step(*cell, compute_dtype=cdt),
                        lstm_cell_step_plain(*cell, compute_dtype=cdt)):
            assert torch.equal(g, w)
    assert launch_counts()["joint_topm"] == launch_counts()["lstm_cell_step"] == 0


# --- the decoders with the step kernels -----------------------------------------


def _beam_setup(seed=0, blank_position="last", **overrides):
    """As the JAX package's own gate of these switches: an LSTM predictor of
    128 (so the kernel guard admits it), 40 tokens, three ragged lanes.

    The encoder output takes the values 0 and ±1/2, the joint's encoder
    weights and bias sit on grids of 1/16 and 1/32, so the encoder
    projection's sums have at most 8 significant bits: exact in bf16. At a
    bf16 ``compute_dtype`` that projection (the one bf16 step left with both
    switches on) then has the same value however it rounds; the JAX
    decoder's jitted bf16 projection rounds at other points than eager
    code (by up to 5e-3 on normal inputs)."""
    rnnt = dict(vocab_size=40, enc_dim=32, pred_hidden=128, joint_hidden=64,
                blank_position=blank_position,
                joint_activation="tanh" if blank_position == "first" else "relu")
    rnnt.update(overrides)
    jcfg, tcfg = jrnnt.RNNTConfig(**rnnt), trnnt.RNNTConfig(**rnnt)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, {"predictor": jrnnt.init_predictor(k1, jcfg),
                                   "joint": jrnnt.init_joint(k2, jcfg)})
    proj = tree["joint"]["enc"]
    proj["w"] = np.round(proj["w"] * 16.0) / 16.0
    proj["b"] = np.round(proj["b"] * 32.0) / 32.0
    enc = np.random.default_rng(seed).standard_normal((3, 12, 32))
    enc = (0.5 * np.clip(np.round(enc), -1, 1)).astype(np.float32)
    lens = np.array([12, 9, 5], np.int32)
    return jcfg, tcfg, tree, enc, lens


def _decode_both(monkeypatch, jax_fn, torch_fn, jcfg, tcfg, tree, enc, lens, jdec, tdec):
    patch_interpret(monkeypatch, names=KERNEL_NAMES)
    want = jax_fn(*(jax.tree.map(jnp.asarray, tree[n]) for n in ("predictor", "joint")),
                  jnp.asarray(enc), jnp.asarray(lens), jcfg, jdec)
    got = torch_fn(params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"]),
                   torch.from_numpy(enc), torch.from_numpy(lens), tcfg, tdec)
    return got, want


SWITCHES = dict(joint_impl="pallas", lstm_impl="pallas")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_alsd_step_kernels_match_jax(monkeypatch, compute_dtype):
    """ALSD beam 3 with both switches: tokens, frames and counts equal,
    scores within 1e-5 (the step kernels run in fp32 in both packages)."""
    jcfg, tcfg, tree, enc, lens = _beam_setup(compute_dtype=compute_dtype)
    got, want = _decode_both(monkeypatch, jbeam.rnnt_beam_decode, tbeam.rnnt_beam_decode,
                             jcfg, tcfg, tree, enc, lens,
                             jbeam.BeamDecodeConfig(beam_size=3, **SWITCHES),
                             tbeam.BeamDecodeConfig(beam_size=3, **SWITCHES))
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=0)
    assert got[2].min() > 0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_graves_step_kernels_match_jax(monkeypatch, compute_dtype):
    """Graves beam 4 with both switches (blank first, tanh joint): tokens,
    frames, counts and the saturated flags equal, scores within 1e-5."""
    jcfg, tcfg, tree, enc, lens = _beam_setup(blank_position="first",
                                              compute_dtype=compute_dtype)
    got, want = _decode_both(monkeypatch, jgraves.graves_beam_decode,
                             tgraves.graves_beam_decode, jcfg, tcfg, tree, enc, lens,
                             jgraves.GravesBeamConfig(beam_size=4, **SWITCHES),
                             tgraves.GravesBeamConfig(beam_size=4, **SWITCHES))
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=0)
    assert got[2].min() > 0


@pytest.mark.parametrize("switches", [{}, dict(joint_impl="pallas"), dict(lstm_impl="pallas")],
                         ids=["plain", "joint_impl", "lstm_impl-ignored"])
def test_stateless_alsd_matches_jax(monkeypatch, switches):
    """ALSD over the k2 stateless predictor (context 2, blank 0), beam 2, fp32:
    tokens, frames and counts equal, scores within 1e-5; ``lstm_impl`` has no
    LSTM to act on and changes nothing."""
    jcfg, tcfg, tree, enc, lens = _beam_setup(seed=3, predictor_kind="stateless",
                                              joint_activation="tanh", compute_dtype="float32")
    tree["joint"]["enc"]["w"] *= 3.0  # the joint leans on the encoder output: both
    tree["joint"]["out"]["b"][0] += 1.0  # emissions and blank advances occur
    got, want = _decode_both(monkeypatch, jbeam.rnnt_beam_decode, tbeam.rnnt_beam_decode,
                             jcfg, tcfg, tree, enc, lens,
                             jbeam.BeamDecodeConfig(beam_size=2, **switches),
                             tbeam.BeamDecodeConfig(beam_size=2, **switches))
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=0)
    assert got[2].min() > 0
    if switches.get("lstm_impl"):  # the same decode as without the switch
        plain = tbeam.rnnt_beam_decode(
            params_from_numpy(tree["predictor"]), params_from_numpy(tree["joint"]),
            torch.from_numpy(enc), torch.from_numpy(lens), tcfg,
            tbeam.BeamDecodeConfig(beam_size=2))
        for g, p in zip(got, plain):
            assert torch.equal(g, p)


# --- k2 decoding="beam" end to end ------------------------------------------------

K2_TOKENS = ["<blk>", "<sos/eos>", "<unk>"] + [chr(c) for c in range(0x3041, 0x3041 + 61)]


@pytest.fixture(scope="module")
def k2_tree_path(tmp_path_factory):
    """A tiny fp32 Zipformer, the stateless predictor and the tanh joint,
    JAX-initialised, the joint leaning on the encoder and favouring blank."""
    rnnt_cfg = jrnnt.RNNTConfig(vocab_size=len(K2_TOKENS), enc_dim=64, pred_hidden=32,
                                joint_hidden=32, joint_activation="tanh",
                                predictor_kind="stateless", context_size=2,
                                compute_dtype="float32")
    enc_cfg = jzf.ZipformerConfig.tiny(compute_dtype="float32")
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    init = jax.jit(jzf.init_zipformer, static_argnums=1)
    tree = jax.tree.map(np.array, {"encoder": init(k1, enc_cfg),
                                   "predictor": jrnnt.init_predictor(k2, rnnt_cfg),
                                   "joint": jrnnt.init_joint(k3, rnnt_cfg)})
    tree["joint"]["enc"]["w"] *= 4.0
    tree["joint"]["out"]["b"][0] += 1.2
    path = str(tmp_path_factory.mktemp("k2beam") / "model")
    save_param_tree(path, tree, {"flavor": "k2", "token_list": K2_TOKENS,
                                 "enc_cfg": asdict(enc_cfg), "rnnt_cfg": asdict(rnnt_cfg)})
    return path


def test_k2_beam_transcribe_matches_jax(k2_tree_path):
    """load_model_container(decoding="beam"): ALSD beam 4 over the stateless
    predictor, as the JAX loader builds it; every TranscribeResult field
    equal to the JAX package's."""
    jm = jk2model.load_model_container(checkpoint=k2_tree_path, decoding="beam")
    tm = tk2model.load_model_container(checkpoint=k2_tree_path, decoding="beam", device="cpu")
    assert tm.decode_cfg == tbeam.BeamDecodeConfig(beam_size=4)
    assert asdict(tm.decode_cfg) == asdict(jm.decode_cfg)
    rng = np.random.default_rng(7)
    n = 3 * 16000
    wav = (rng.standard_normal(n) * 0.1 * (1 + np.sin(np.arange(n) / 800.0))).astype(np.float32)
    audio = audio_from_numpy(wav, 16000)
    got, want = transcribe(tm, audio), jax_transcribe(jm, audio)
    assert asdict(got) == asdict(want)
    assert len(got.subwords) > 0
    switched = replace(tm, decode_cfg=replace(tm.decode_cfg, joint_impl="pallas"))
    assert asdict(transcribe(switched, audio)) == asdict(got)
