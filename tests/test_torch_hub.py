"""The port's loaders on offline HF-hub snapshots of the published layouts
(``fixture_checkpoints.py``): a plain ``load_model()`` finds the snapshot,
converts it with the port's converter, caches the tree and serves it; the
configs and the decoding section come from the checkpoint; a second load
with the hub deleted reads the cached tree and runs no converter; and at
fp32 on the CPU each flavor's result on the port's converted tree equals the
JAX package's on its own converted tree of the same snapshot."""

import os
import shutil
from dataclasses import asdict, replace

import numpy as np
import pytest

from reazonspeech_tpu.espnet.asr import model as j_espnet
from reazonspeech_tpu.k2.asr import huggingface as j_k2hf
from reazonspeech_tpu.k2.asr import model as j_k2
from reazonspeech_tpu.k2.asr.transcribe import transcribe_batch as j_k2_transcribe_batch
from reazonspeech_tpu.models import conformer as j_conformer
from reazonspeech_tpu.models import fastconformer as j_fc
from reazonspeech_tpu.models import rnnt as j_rnnt
from reazonspeech_tpu.models import zipformer as j_zf
from reazonspeech_tpu.nemo.asr import model as j_nemo
from reazonspeech_tpu.nemo.asr.transcribe import transcribe_batch as j_nemo_transcribe_batch
from reazonspeech_tpu_torch.convert.store import load_param_tree
from reazonspeech_tpu_torch.core.hub import CheckpointNotFoundError, converted_path
from reazonspeech_tpu_torch.decoding.rnnt_beam import BeamDecodeConfig
from reazonspeech_tpu_torch.decoding.rnnt_greedy import GreedyDecodeConfig
from reazonspeech_tpu_torch.decoding.transducer_graves import GravesBeamConfig
from reazonspeech_tpu_torch.espnet.asr import model as t_espnet
from reazonspeech_tpu_torch.k2.asr import huggingface as t_k2hf
from reazonspeech_tpu_torch.k2.asr import model as t_k2
from reazonspeech_tpu_torch.k2.asr import audio_from_numpy
from reazonspeech_tpu_torch.k2.asr.transcribe import transcribe_batch as t_k2_transcribe_batch
from reazonspeech_tpu_torch.nemo.asr import model as t_nemo
from reazonspeech_tpu_torch.nemo.asr.transcribe import transcribe_batch as t_nemo_transcribe_batch

from fixture_checkpoints import (
    write_espnet_zoo,
    write_hf_snapshot,
    write_k2_repo,
    write_nemo_archive,
)
from test_torch_convert import assert_same_tree


@pytest.fixture
def offline_env(tmp_path, monkeypatch):
    """Isolated hub and converted caches, no ambient checkpoints; returns
    (hub, the port's cache, a second cache for the JAX package)."""
    hub = tmp_path / "hub"
    hub.mkdir()
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", str(tmp_path / "port_cache"))
    for var in ("REAZONSPEECH_TPU_NEMO_CHECKPOINT", "REAZONSPEECH_TPU_ESPNET_CHECKPOINT",
                "REAZONSPEECH_TPU_K2_CHECKPOINT", "REAZONSPEECH_TPU_K2_CHECKPOINT_DIR",
                "REAZONSPEECH_TPU_MODEL_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return hub, str(tmp_path / "port_cache"), str(tmp_path / "jax_cache")


def _no_converter(*_):
    raise AssertionError("a converter ran although the converted tree is cached")


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / 16000.0))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


def _fp32(cfg):
    return replace(cfg, compute_dtype="float32")


def test_nemo_snapshot_converts_caches_and_serves(offline_env, monkeypatch):
    hub, port_cache, jax_cache = offline_env
    enc_cfg = j_fc.FastConformerConfig.tiny()
    rnnt_cfg = j_rnnt.RNNTConfig.tiny(enc_dim=enc_cfg.d_model)
    write_hf_snapshot(str(hub), t_nemo.HF_REPO_ID, lambda snap: write_nemo_archive(
        os.path.join(snap, "reazonspeech-nemo-v2.nemo"), enc_cfg, rnnt_cfg))

    model = t_nemo.load_model("cpu")
    # the configs came from the archive's model_config.yaml
    assert (model.enc_cfg.num_layers, model.enc_cfg.d_model, model.enc_cfg.num_heads) == (
        enc_cfg.num_layers, enc_cfg.d_model, enc_cfg.num_heads)
    assert model.rnnt_cfg.vocab_size == rnnt_cfg.vocab_size
    # its decoding section drives the serving decode: ALSD beam 4
    assert isinstance(model.decode_cfg, BeamDecodeConfig) and model.decode_cfg.beam_size == 4
    assert isinstance(t_nemo.load_model("cpu", decoding="greedy").decode_cfg, GreedyDecodeConfig)
    path = converted_path(t_nemo.HF_REPO_ID, "model")
    assert path.startswith(port_cache) and os.path.exists(path + ".npz")

    # the JAX package converts the same snapshot into its own cache
    fp32 = dict(enc_cfg=_fp32(model.enc_cfg), rnnt_cfg=_fp32(model.rnnt_cfg))
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", jax_cache)
    jm = j_nemo.load_model(enc_cfg=j_fc.FastConformerConfig(**asdict(fp32["enc_cfg"])),
                           rnnt_cfg=j_rnnt.RNNTConfig(**asdict(fp32["rnnt_cfg"])))
    assert os.path.exists(converted_path(t_nemo.HF_REPO_ID, "model") + ".npz")
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", port_cache)

    # the second load reads the cached tree with the hub gone, no converter
    shutil.rmtree(hub)
    monkeypatch.setattr(t_nemo, "_convert_snapshot", _no_converter)
    tm = t_nemo.load_model("cpu", **fp32)
    np.testing.assert_array_equal(tm.params["joint"]["enc"]["w"].numpy(),
                                  model.params["joint"]["enc"]["w"].numpy())
    assert tm.decode_cfg.beam_size == 4 and jm.decode_cfg.beam_size == 4

    audios = [audio_from_numpy(_wav(s, seed=i), 16000) for i, s in enumerate((2.0, 3.3))]
    got, want = t_nemo_transcribe_batch(tm, audios), j_nemo_transcribe_batch(jm, audios)
    assert [asdict(r) for r in got] == [asdict(r) for r in want]
    # the raw emissions too: the fixture's random joint emits its labels
    # (the tokenizer's "▁" among them, which the text drops)
    lengths = np.array([32000, 52800], np.int32)
    wav = np.zeros((2, 64000), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = _wav(n / 16000, seed=i)
    got, want = tm.decode_batch(wav, lengths), jm.decode_batch(wav, lengths)
    for name, g, w in zip(("tokens", "frames", "counts", "enc_lengths"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].min() > 0


ESPNET_TOKENS = ["<blank>"] + list("あいうえおかきくけこ") + ["<sos/eos>"]


def test_espnet_snapshot_converts_caches_and_serves(offline_env, monkeypatch):
    hub, port_cache, jax_cache = offline_env
    enc_cfg = j_conformer.espnet_encoder_config(num_layers=2, d_model=32, num_heads=4,
                                                subsampling_channels=32)
    rnnt_cfg = j_rnnt.RNNTConfig(vocab_size=len(ESPNET_TOKENS), enc_dim=32, pred_hidden=16,
                                 joint_hidden=24, joint_activation="tanh",
                                 blank_position="first")
    write_hf_snapshot(str(hub), t_espnet.HF_REPO_ID,
                      lambda snap: write_espnet_zoo(snap, enc_cfg, ESPNET_TOKENS, rnnt_cfg))

    model = t_espnet.load_model_container(device="cpu")
    # the token list came from config.yaml, the encoder dims from encoder_conf
    assert model.tokenizer.pieces == ESPNET_TOKENS
    assert (model.enc_cfg.d_model, model.enc_cfg.num_layers) == (32, 2)
    assert model.enc_cfg.final_norm  # espnet after_norm
    assert model.rnnt_cfg.blank_first and model.rnnt_cfg.joint_activation == "tanh"
    assert model.decode_cfg == GravesBeamConfig(beam_size=20)
    assert "normalize" in model.params  # GlobalMVN from feats_stats.npz
    assert os.path.exists(converted_path(t_espnet.HF_REPO_ID, "model") + ".npz")

    # the results at fp32 with ALSD beam 4: Graves beam 20 on the fixture's
    # random joint runs every frame to its pop cap (minutes on a loaded
    # host; its parity is tests/test_torch_espnet.py's), greedy emits nothing
    fp32 = dict(enc_cfg=_fp32(model.enc_cfg), rnnt_cfg=_fp32(model.rnnt_cfg),
                decoding="alsd", beam_size=4)
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", jax_cache)
    jm = j_espnet.load_model_container(
        enc_cfg=j_fc.FastConformerConfig(**asdict(fp32["enc_cfg"])),
        rnnt_cfg=j_rnnt.RNNTConfig(**asdict(fp32["rnnt_cfg"])), decoding="alsd",
        beam_size=4)
    assert os.path.exists(converted_path(t_espnet.HF_REPO_ID, "model") + ".npz")
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", port_cache)

    shutil.rmtree(hub)
    monkeypatch.setattr(t_espnet, "_convert_snapshot", _no_converter)
    tm = t_espnet.load_model_container(device="cpu", **fp32)
    lengths = np.array([3 * 16000, 2 * 16000], np.int32)
    wav = np.zeros((2, 4 * 16000), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = _wav(n / 16000, seed=20 + i)
    got, want = tm.decode_batch(wav, lengths), jm.decode_batch(wav, lengths)
    for name, g, w in zip(("tokens", "frames", "counts", "enc_lengths"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].min() > 0


K2_TOKENS = ["<blk>", "<sos/eos>", "<unk>"] + list("あいうえおかきくけこ")


def _k2_snapshot(hub, with_pt=True):
    enc_cfg = j_zf.ZipformerConfig.tiny()
    rnnt_cfg = j_rnnt.RNNTConfig(vocab_size=len(K2_TOKENS), enc_dim=enc_cfg.out_dim,
                                 pred_hidden=16, joint_hidden=24, joint_activation="tanh",
                                 predictor_kind="stateless", context_size=2)
    repo_id, epochs = t_k2hf.LANGUAGE_MODELS["ja"]
    sd = {}

    def build(snap):
        sd.update(write_k2_repo(snap, enc_cfg, rnnt_cfg, K2_TOKENS, epochs, with_pt=with_pt))
        write_k2_repo(snap, enc_cfg, rnnt_cfg, K2_TOKENS, epochs, int8=True, with_pt=False,
                      sd=sd)

    write_hf_snapshot(str(hub), repo_id, build)
    return repo_id


def test_k2_snapshot_converts_caches_and_serves(offline_env, monkeypatch):
    hub, port_cache, jax_cache = offline_env
    monkeypatch.setenv("REAZONSPEECH_TPU_MODEL_SIZE", "tiny")  # sherpa repos carry no config
    repo_id = _k2_snapshot(hub)

    model = t_k2hf.load_model("cpu")
    assert model.token_list == K2_TOKENS and model.rnnt_cfg.vocab_size == len(K2_TOKENS)
    assert model.rnnt_cfg.predictor_kind == "stateless"
    assert isinstance(model.decode_cfg, GreedyDecodeConfig)
    model8 = t_k2hf.load_model("cpu", precision="int8")
    for precision in ("fp32", "int8"):
        assert os.path.exists(converted_path(repo_id, precision) + ".npz")
    # the published int8 decoder/joiner graphs, dequantized: close to fp32
    w32 = model.params["joint"]["out"]["w"].numpy()
    w8 = model8.params["joint"]["out"]["w"].numpy()
    assert not np.array_equal(w32, w8) and np.abs(w32 - w8).max() <= np.abs(w32).max() / 100

    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", jax_cache)
    for precision in ("fp32", "int8"):
        j_k2hf.load_model(precision=precision)
        tree_t, meta_t = load_param_tree(os.path.join(
            port_cache, os.path.relpath(converted_path(repo_id, precision), jax_cache)))
        tree_j, meta_j = load_param_tree(converted_path(repo_id, precision))
        assert_same_tree(tree_t, tree_j)
        assert meta_t == meta_j
    jax_fp32 = converted_path(repo_id, "fp32")
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", port_cache)

    shutil.rmtree(hub)
    monkeypatch.setattr(t_k2hf, "_make_converter", lambda *_: _no_converter)
    again = t_k2hf.load_model("cpu")
    np.testing.assert_array_equal(again.params["joint"]["out"]["w"].numpy(), w32)

    fp32 = dict(enc_cfg=_fp32(model.enc_cfg), rnnt_cfg=_fp32(model.rnnt_cfg))
    tm = t_k2.load_model_container(checkpoint=converted_path(repo_id, "fp32"), device="cpu",
                                   **fp32)
    jm = j_k2.load_model_container(
        checkpoint=jax_fp32, rnnt_cfg=j_rnnt.RNNTConfig(**asdict(fp32["rnnt_cfg"])),
        enc_cfg=j_zf.ZipformerConfig(**asdict(fp32["enc_cfg"])))
    audios = [audio_from_numpy(_wav(s, seed=30 + i), 16000) for i, s in enumerate((2.0, 3.3))]
    got, want = t_k2_transcribe_batch(tm, audios), j_k2_transcribe_batch(jm, audios)
    assert [asdict(r) for r in got] == [asdict(r) for r in want]
    assert sum(len(r.subwords) for r in got) > 0


def test_k2_onnx_only_snapshot_raises_as_jax(offline_env, monkeypatch):
    """Without the icefall .pt the encoder cannot convert from the
    constant-folded ONNX graph: both loaders raise the same explanation."""
    hub, _, _ = offline_env
    monkeypatch.setenv("REAZONSPEECH_TPU_MODEL_SIZE", "tiny")
    _k2_snapshot(hub, with_pt=False)
    errors = []
    for load in (lambda: t_k2hf.load_model("cpu"), j_k2hf.load_model):
        with pytest.raises(FileNotFoundError, match="icefall") as err:
            load()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "JAX" not in errors[0] and "reazonspeech_tpu" not in errors[0]


@pytest.mark.parametrize("flavor", ["nemo", "espnet", "k2"])
def test_nothing_resolvable_raises(offline_env, flavor):
    """No snapshot and no tree: CheckpointNotFoundError that offers
    checkpoint="random" and names no other package."""
    load = {"nemo": lambda: t_nemo.load_model("cpu"),
            "espnet": lambda: t_espnet.load_model_container(device="cpu"),
            "k2": lambda: t_k2hf.load_model("cpu")}[flavor]
    with pytest.raises(CheckpointNotFoundError, match="random") as err:
        load()
    assert "reazonspeech_tpu." not in str(err.value)


def test_nemo_converter_error_propagates(offline_env):
    """A snapshot whose .nemo is not an archive: the converter's own error,
    as the JAX loader raises it, never random weights and no tree cached
    (espnet's empty .pth: ``tests/test_torch_espnet.py``)."""
    hub, _, _ = offline_env

    def build(snap):
        with open(os.path.join(snap, "reazonspeech-nemo-v2.nemo"), "wb") as f:
            f.write(b"not a checkpoint")

    write_hf_snapshot(str(hub), t_nemo.HF_REPO_ID, build)
    errors = []
    for load in (lambda: t_nemo.load_model("cpu"), j_nemo.load_model):
        with pytest.raises(Exception) as err:
            load()
        errors.append(err.value)
    assert type(errors[0]) is type(errors[1]) and str(errors[0]) == str(errors[1])
    assert not isinstance(errors[0], CheckpointNotFoundError)
    assert not os.path.exists(converted_path(t_nemo.HF_REPO_ID, "model") + ".npz")
