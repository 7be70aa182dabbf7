"""The k2 slice of the port against the JAX package on the CPU: the kaldi
fbank, the stateless predictor, greedy decode, and ``transcribe`` /
``transcribe_batch`` on one converted tree written by the JAX store (a tiny
fp32 Zipformer, the stateless predictor and the tanh joint); then the
loader's errors, the int8 tree path, the device default and the CLI."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.convert.quantize import quantize_tree
from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.decoding import rnnt_greedy as jgreedy
from reazonspeech_tpu.frontend import features as jfeat
from reazonspeech_tpu.k2.asr import huggingface as jhf
from reazonspeech_tpu.k2.asr import model as jk2model
from reazonspeech_tpu.k2.asr.transcribe import transcribe as jax_transcribe
from reazonspeech_tpu.k2.asr.transcribe import transcribe_batch as jax_transcribe_batch
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu.models import zipformer as jzf
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.core.hub import CheckpointNotFoundError
from reazonspeech_tpu_torch.decoding import rnnt_greedy as tgreedy
from reazonspeech_tpu_torch.frontend import features as tfeat
from reazonspeech_tpu_torch.k2.asr import (
    audio_from_numpy, load_model, transcribe, transcribe_batch,
)
from reazonspeech_tpu_torch.k2.asr import huggingface as thf
from reazonspeech_tpu_torch.k2.asr import model as tk2model
from reazonspeech_tpu_torch.models import rnnt as trnnt

TOKENS = ["<blk>", "<sos/eos>", "<unk>"] + [chr(c) for c in range(0x3041, 0x3041 + 61)]
RNNT = dict(vocab_size=len(TOKENS), enc_dim=64, pred_hidden=32, joint_hidden=32,
            joint_activation="tanh", predictor_kind="stateless", context_size=2,
            compute_dtype="float32")
# the random joint made to depend more on the encoder output (its encoder
# projection scaled up) and to favour blank, so that greedy decoding both
# emits and advances through frames
ENC_SCALE, BLANK_BIAS = 4.0, 1.2


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / 16000.0))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


def _jax_decoder(seed):
    """JAX inits of the stateless predictor and the joint, numpy."""
    rnnt_cfg = jrnnt.RNNTConfig(**RNNT)
    k2, k3 = jax.random.split(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, {"predictor": jrnnt.init_predictor(k2, rnnt_cfg),
                                   "joint": jrnnt.init_joint(k3, rnnt_cfg)})
    tree["joint"]["enc"]["w"] *= ENC_SCALE
    tree["joint"]["out"]["b"][0] += BLANK_BIAS  # blank is id 0 (k2)
    return tree, rnnt_cfg


@pytest.fixture(scope="module")
def jax_tree():
    """The tiny encoder (JAX init) with the decoder of :func:`_jax_decoder`."""
    enc_cfg = jzf.ZipformerConfig.tiny(compute_dtype="float32")
    tree, rnnt_cfg = _jax_decoder(0)
    init = jax.jit(jzf.init_zipformer, static_argnums=1)
    tree["encoder"] = jax.tree.map(np.array, init(jax.random.PRNGKey(1), enc_cfg))
    return tree, enc_cfg, rnnt_cfg


@pytest.fixture(scope="module")
def tree_path(tmp_path_factory, jax_tree):
    tree, enc_cfg, rnnt_cfg = jax_tree
    path = str(tmp_path_factory.mktemp("k2") / "model")
    save_param_tree(path, tree, {"flavor": "k2", "token_list": TOKENS,
                                 "enc_cfg": asdict(enc_cfg), "rnnt_cfg": asdict(rnnt_cfg)})
    return path


@pytest.fixture(scope="module")
def models(tree_path):
    """(jax container, port container), both from the one tree and its meta."""
    jm = jk2model.load_model_container(checkpoint=tree_path)
    tm = tk2model.load_model_container(checkpoint=tree_path, device="cpu")
    assert tm.enc_cfg == tk2model.ZipformerConfig.tiny(compute_dtype="float32")
    assert tm.rnnt_cfg.predictor_kind == "stateless" and tm.token_list == TOKENS
    return jm, tm


def test_kaldi_features_match_jax():
    """log-mel at the kaldi preset on a ragged batch: lengths equal, values
    within 2e-5 of the features' range (the log of low-energy bins after
    per-frame pre-emphasis carries the fp32 DFT's sum order: ~1e-4 there)."""
    wav = np.stack([_wav(2.0, 0), _wav(2.0, 1), _wav(2.0, 2)])
    lens = np.array([32000, 20001, 777], np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    want, wl = jfeat.log_mel_spectrogram(jnp.asarray(wav), jnp.asarray(lens),
                                         jfeat.kaldi_frontend_config())
    got, gl = tfeat.log_mel_spectrogram(torch.from_numpy(wav), torch.from_numpy(lens),
                                        tfeat.kaldi_frontend_config())
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()


def test_kaldi_config_matches_jax():
    assert asdict(tfeat.kaldi_frontend_config()) == asdict(jfeat.kaldi_frontend_config())


def test_stateless_predictor_step_matches_jax():
    """Two steps from the blank context: outputs to 1e-6, contexts equal."""
    tree, jcfg = _jax_decoder(seed=3)
    tcfg = trnnt.RNNTConfig(**RNNT)
    pred = tree["predictor"]
    tokens = [np.array([0, 5, 63], np.int32), np.array([7, 0, 2], np.int32)]
    jstate = jrnnt.predictor_zero_state(3, jcfg)
    tstate = trnnt.predictor_zero_state(3, tcfg)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
    for tok in tokens:
        jg, jstate = jrnnt.predictor_step(jax.tree.map(jnp.asarray, pred), jnp.asarray(tok),
                                          jstate, jcfg)
        tg, tstate = trnnt.predictor_step(params_from_numpy(pred), torch.from_numpy(tok),
                                          tstate, tcfg)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))


def test_greedy_stateless_matches_jax():
    """Label-looping greedy on one random encoder output: tokens, frames and
    counts equal, with emissions and blank advances both present."""
    tree, jcfg = _jax_decoder(seed=4)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((3, 40, RNNT["enc_dim"])).astype(np.float32)
    lens = np.array([40, 23, 1], np.int32)
    want = jgreedy.rnnt_greedy_decode(tree["predictor"], tree["joint"], jnp.asarray(enc),
                                      jnp.asarray(lens), jcfg)
    got = tgreedy.rnnt_greedy_decode(params_from_numpy(tree["predictor"]),
                                     params_from_numpy(tree["joint"]), torch.from_numpy(enc),
                                     torch.from_numpy(lens), trnnt.RNNTConfig(**RNNT))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts, frames = got[2].numpy(), got[1].numpy()
    assert counts[0] > 0 and frames[0, counts[0] - 1] > 0


def test_transcribe_matches_jax(models):
    """Every field of the TranscribeResult equal (the port's classes are its
    own, so they compare as dicts), subwords on the 0.04 s grid."""
    jm, tm = models
    audio = audio_from_numpy(_wav(3.0, seed=7), 16000)
    got, want = transcribe(tm, audio), jax_transcribe(jm, audio)
    assert asdict(got) == asdict(want)
    assert len(got.subwords) > 0
    assert all(abs(s.seconds / 0.04 - round(s.seconds / 0.04)) < 1e-6 for s in got.subwords)


def test_transcribe_batch_matches_jax(models):
    jm, tm = models
    audios = [audio_from_numpy(_wav(s, seed=10 + i), 16000) for i, s in enumerate((2.0, 3.3))]
    got, want = transcribe_batch(tm, audios), jax_transcribe_batch(jm, audios)
    assert [asdict(r) for r in got] == [asdict(r) for r in want]
    assert all(len(r.subwords) > 0 for r in got)


def test_transcribe_warns_on_long_audio(models):
    wav = np.zeros(31 * 16000, np.float32)
    with pytest.warns(UserWarning, match="long audio input"):
        transcribe(models[1], audio_from_numpy(wav, 16000))


def test_int8_tree_loads_dequantized(jax_tree, tmp_path):
    """An int8 tree (the JAX quantizer's format) loads as its dequantized
    weights, as the JAX loader does."""
    tree, enc_cfg, rnnt_cfg = jax_tree
    path = str(tmp_path / "int8")
    save_param_tree(path, quantize_tree(tree), {"token_list": TOKENS, "enc_cfg": asdict(enc_cfg),
                                                "rnnt_cfg": asdict(rnnt_cfg)})
    jm = jk2model.load_model_container(checkpoint=path)
    tm = tk2model.load_model_container(checkpoint=path, device="cpu")
    w_j = np.asarray(jm.params["encoder"]["embed"]["proj"]["w"])  # 272 x 32: quantized
    w_t = tm.params["encoder"]["embed"]["proj"]["w"].numpy()
    np.testing.assert_array_equal(w_t, w_j)
    assert not np.array_equal(w_t, tree["encoder"]["embed"]["proj"]["w"])


def test_load_model_validation_errors():
    with pytest.raises(ValueError, match="Unknown language: 'de'"):
        load_model(language="de")
    with pytest.raises(ValueError, match="Unknown precision"):
        load_model(precision="fp16")
    with pytest.raises(ValueError, match="Unknown decoding: 'maes'"):
        load_model("cpu", checkpoint="random", decoding="maes")


@pytest.fixture
def empty_caches(tmp_path, monkeypatch):
    for name in (tk2model.DEFAULT_CHECKPOINT_ENV, thf.CHECKPOINT_DIR_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    return tmp_path


def test_load_model_requires_a_checkpoint(empty_caches, monkeypatch):
    """Nothing anywhere: CheckpointNotFoundError, never random weights; a
    checkpoint directory without the tree names the path."""
    with pytest.raises(CheckpointNotFoundError):
        load_model("cpu")
    monkeypatch.setenv(thf.CHECKPOINT_DIR_ENV, str(empty_caches / "trees"))
    with pytest.raises(CheckpointNotFoundError, match="ja-en/int8.npz"):
        load_model("cpu", precision="int8", language="ja-en")


def test_snapshot_without_tree_names_the_converter(empty_caches):
    """A snapshot without the ONNX files reaches the converter, which raises
    what the JAX loader raises on the same snapshot: the missing files."""
    snap = (empty_caches / "hub" / "models--reazon-research--reazonspeech-k2-v2" / "snapshots"
            / "abc")
    snap.mkdir(parents=True)
    (snap / "tokens.txt").write_text("<blk> 0\n")
    with pytest.raises(CheckpointNotFoundError, match="missing the fp32 ONNX files") as got:
        load_model("cpu")
    with pytest.raises(FileNotFoundError) as want:
        jhf.load_model()
    assert str(got.value) == str(want.value)


def test_load_model_resolves_the_checkpoint_dir(tree_path, monkeypatch, tmp_path):
    """$REAZONSPEECH_TPU_K2_CHECKPOINT_DIR/<language>/<precision>.npz loads."""
    import shutil

    base = tmp_path / "trees" / "ja"
    base.mkdir(parents=True)
    for ext in (".npz", ".json"):
        shutil.copy(tree_path + ext, base / ("fp32" + ext))
    monkeypatch.delenv(tk2model.DEFAULT_CHECKPOINT_ENV, raising=False)
    monkeypatch.setenv(thf.CHECKPOINT_DIR_ENV, str(tmp_path / "trees"))
    m = load_model("cpu")
    assert m.token_list == TOKENS and m.device.type == "cpu"


def test_load_model_default_device_is_cuda(monkeypatch):
    """No device given means CUDA: without a GPU that raises, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(checkpoint="random")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(checkpoint="random", decoding="beam")


def test_cuda_serving_config_is_the_slice():
    cfg = tk2model._cuda_serving_config(tk2model.ZipformerConfig.large())
    assert (cfg.attn_impl, cfg.compute_dtype, cfg.residual_dtype) == \
        ("pallas", "bfloat16", "float32")
    assert cfg.num_layers == (2, 2, 4, 5, 4, 2) and cfg.encoder_dim[3] == 768


@pytest.mark.parametrize("fmt,head", [("txt", None), ("json", '{"seconds": '),
                                      ("tsv", "seconds\ttoken")], ids=["txt", "json", "tsv"])
def test_cli_runs(models, tmp_path, monkeypatch, fmt, head):
    import sys

    from reazonspeech_tpu_torch.core.audio import audio_to_file
    from reazonspeech_tpu_torch.k2.asr import cli

    wav = tmp_path / "in.wav"
    audio_to_file(str(wav), audio_from_numpy(_wav(3.0, seed=7), 16000))
    out = tmp_path / f"out.{fmt}"
    monkeypatch.setattr(cli, "load_model", lambda: models[1])
    monkeypatch.setattr(sys, "argv", ["k2-asr", f"--to={fmt}", "-o", str(out), str(wav)])
    assert cli.main() is None
    text = out.read_text()
    want = transcribe(models[1], cli.audio_from_path(str(wav)))
    assert len(want.subwords) > 0
    if head is None:
        assert text == want.text + "\n"
    else:
        assert text.startswith(head)
