"""The nemo-v2 slice end to end: the port against the JAX package on the same
converted tree, at the slice's tiny configuration (fp32 compute, the kernel
branches, ALSD beam 4 with the top-m kernel), with the LayerNorms done apart
(lnd_impl="xla") and, for the batch and chunked entry points, fused into
the kernels (lnd_impl="pallas", the GPU serving default). Tokens, frames,
counts and the TranscribeResult must be equal."""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.decoding import rnnt_beam as jbeam
from reazonspeech_tpu.decoding import rnnt_greedy as jgreedy
from reazonspeech_tpu.nemo.asr import model as jmodel
from reazonspeech_tpu.nemo.asr.transcribe import transcribe as jax_transcribe
from reazonspeech_tpu.nemo.asr.transcribe import transcribe_batch as jax_transcribe_batch
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.decoding import rnnt_beam as tbeam
from reazonspeech_tpu_torch.decoding import rnnt_greedy as tgreedy
from reazonspeech_tpu_torch.nemo.asr import model as tmodel
from reazonspeech_tpu_torch.nemo.asr import (
    TranscribeConfig, audio_from_numpy, transcribe, transcribe_batch,
)

from test_torch_parity import jax_params_numpy, randomize_norm_stats, tiny_configs


@pytest.fixture(scope="module")
def tree_path(tmp_path_factory):
    jenc, jr, _, _ = tiny_configs()
    tree = randomize_norm_stats(jax_params_numpy(0, jenc, jr), seed=2)
    path = str(tmp_path_factory.mktemp("tree") / "model")
    save_param_tree(path, tree, {"flavor": "nemo"})
    return path


def _load_pair(path, lnd_impl):
    """(jax model, port model): both load one tree written by the JAX store."""
    jenc, jr, tenc, tr = tiny_configs()
    jm = jmodel.load_model(checkpoint=path, enc_cfg=replace(jenc, lnd_impl=lnd_impl),
                           rnnt_cfg=jr, decode_cfg=jbeam.BeamDecodeConfig(topk_impl="pallas"))
    tm = tmodel.load_model("cpu", checkpoint=path, enc_cfg=replace(tenc, lnd_impl=lnd_impl),
                           rnnt_cfg=tr, decode_cfg=tbeam.BeamDecodeConfig(topk_impl="pallas"))
    return jm, tm


@pytest.fixture(scope="module")
def models(tree_path):
    return _load_pair(tree_path, "xla")


@pytest.fixture(scope="module")
def models_lnd(tree_path):
    return _load_pair(tree_path, "pallas")


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / 16000.0))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


def _same_result(a, b):
    """Every field equal (the port's result classes are its own, so the
    dataclasses compare as dicts)."""
    assert asdict(a) == asdict(b)


def test_asr_forward_matches_jax(models, monkeypatch):
    """A ragged batch: tokens, frames, counts and encoder lengths equal."""
    patch_interpret(monkeypatch)
    _check_forward(*models)


def test_asr_forward_lnd_pallas_matches_jax(models_lnd, monkeypatch):
    """The same at lnd_impl="pallas" (every encoder kernel, the GPU default)."""
    patch_interpret(monkeypatch)
    _check_forward(*models_lnd)


def _check_forward(jm, tm):
    lengths = np.array([64000, 41000, 12000], np.int32)
    wav = np.zeros((3, 64000), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = _wav(n / 16000, seed=i)[:n]
    want = jm.decode_batch(wav, lengths)
    got = tm.decode_batch(wav, lengths)
    names = ("tokens", "frames", "counts", "enc_lengths")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].min() > 0  # the random model emits: the comparison is not vacuous


@pytest.mark.parametrize("seconds,chunk", [(3.0, None), (23.0, 10.0)])
def test_transcribe_matches_jax(models, monkeypatch, seconds, chunk):
    """One short input and one chunked long-form input (3 overlapped chunks
    decoded as one batch): identical TranscribeResult."""
    patch_interpret(monkeypatch)
    _check_transcribe(*models, seconds, chunk)


def test_chunked_transcribe_lnd_pallas_matches_jax(models_lnd, monkeypatch):
    patch_interpret(monkeypatch)
    _check_transcribe(*models_lnd, 23.0, 10.0)


def _check_transcribe(jm, tm, seconds, chunk):
    audio = audio_from_numpy(_wav(seconds, seed=7), 16000)
    cfg = TranscribeConfig(chunk_seconds=chunk, chunk_overlap_seconds=2.0)
    want = jax_transcribe(jm, audio, cfg)
    got = transcribe(tm, audio, cfg)
    _same_result(got, want)
    assert len(got.subwords) > 0


def test_transcribe_batch_matches_jax(models, monkeypatch):
    patch_interpret(monkeypatch)
    jm, tm = models
    audios = [audio_from_numpy(_wav(s, seed=10 + i), 16000) for i, s in enumerate((2.0, 3.3))]
    for g, w in zip(transcribe_batch(tm, audios), jax_transcribe_batch(jm, audios)):
        _same_result(g, w)


def _jax_encode(jm, seconds=(3.2, 2.1)):
    import jax

    from reazonspeech_tpu.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu.models.fastconformer import fastconformer_encode

    n = int(max(seconds) * 16000)
    wav = np.zeros((len(seconds), n), np.float32)
    lens = np.array([int(s * 16000) for s in seconds], np.int32)
    for i, m in enumerate(lens):
        wav[i, :m] = _wav(seconds[i], seed=20 + i)[:m]
    feats, fl = log_mel_spectrogram(jnp.asarray(wav), jnp.asarray(lens), jm.fe_cfg)
    enc, el = fastconformer_encode(jax.tree.map(jnp.asarray, jm.params["encoder"]), feats,
                                   fl, jm.enc_cfg)
    return np.array(enc), np.array(el)  # writable copies for torch.from_numpy


@pytest.mark.parametrize("dedup", [False, True])
def test_alsd_matches_jax_on_same_encoder_output(models, monkeypatch, dedup):
    """The decoder alone, both recombination modes: equal best hypotheses.

    Random weights make permutations of one label multiset score within
    ~1e-5 of each other, so fp32 reassociation (XLA's exp/log against
    PyTorch's) can reorder such near-ties; the input here has none."""
    patch_interpret(monkeypatch)
    jm, tm = models
    enc, el = _jax_encode(jm)
    jcfg = jbeam.BeamDecodeConfig(topk_impl="pallas", recombine_dedup=dedup)
    tcfg = tbeam.BeamDecodeConfig(topk_impl="pallas", recombine_dedup=dedup)
    want = jbeam.rnnt_beam_decode(jm.params["predictor"], jm.params["joint"],
                                  jnp.asarray(enc), jnp.asarray(el), jm.rnnt_cfg, jcfg)
    got = tbeam.rnnt_beam_decode(tm.params["predictor"], tm.params["joint"],
                                 torch.from_numpy(enc), torch.from_numpy(el), tm.rnnt_cfg,
                                 tcfg)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5)


def test_greedy_matches_jax(models, monkeypatch):
    """Label-looping greedy on the same encoder output: equal emissions.
    The blank logit goes back down by the 1.0 the fixture added, or greedy
    emits nothing on this random model."""
    patch_interpret(monkeypatch)
    jm, tm = models
    enc, el = _jax_encode(jm)
    jjoint = dict(jm.params["joint"], out={"w": jm.params["joint"]["out"]["w"],
                                          "b": jm.params["joint"]["out"]["b"].at[-1].add(-1.0)})
    tjoint = dict(tm.params["joint"], out={"w": tm.params["joint"]["out"]["w"],
                                          "b": tm.params["joint"]["out"]["b"].clone()})
    tjoint["out"]["b"][-1] -= 1.0
    want = jgreedy.rnnt_greedy_decode(jm.params["predictor"], jjoint, jnp.asarray(enc),
                                      jnp.asarray(el), jm.rnnt_cfg)
    got = tgreedy.rnnt_greedy_decode(tm.params["predictor"], tjoint, torch.from_numpy(enc),
                                     torch.from_numpy(el), tm.rnnt_cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].max()) > 0


def test_load_model_requires_a_checkpoint(tmp_path, monkeypatch):
    """No checkpoint anywhere: CheckpointNotFoundError, never random weights."""
    from reazonspeech_tpu_torch.core.hub import CheckpointNotFoundError

    monkeypatch.delenv(tmodel.DEFAULT_CHECKPOINT_ENV, raising=False)
    monkeypatch.setenv("REAZONSPEECH_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(CheckpointNotFoundError):
        tmodel.load_model("cpu")


def test_load_model_devices_and_defaults():
    _, _, tenc, tr = tiny_configs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.load_model("cuda", checkpoint="random", enc_cfg=tenc, rnnt_cfg=tr)
    m = tmodel.load_model("cpu", checkpoint="random", enc_cfg=replace(tenc, num_layers=1),
                          rnnt_cfg=tr)
    assert m.device.type == "cpu"
    assert isinstance(m.decode_cfg, tbeam.BeamDecodeConfig) and m.decode_cfg.beam_size == 4
    assert m.decode_cfg.topk_impl == "xla"  # plain formulas off the GPU
    greedy = tmodel.load_model("cpu", checkpoint="random", enc_cfg=tenc, rnnt_cfg=tr,
                               decoding="greedy")
    assert isinstance(greedy.decode_cfg, tgreedy.GreedyDecodeConfig)


def test_load_model_default_device_is_cuda(monkeypatch):
    """No device given means CUDA: without a GPU that raises, never the CPU."""
    _, _, tenc, tr = tiny_configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.load_model(checkpoint="random", enc_cfg=tenc, rnnt_cfg=tr)


def test_cuda_serving_config_is_the_slice():
    cfg = tmodel._cuda_serving_config(tiny_configs()[2])
    assert (cfg.attn_impl, cfg.conv_impl, cfg.lnd_impl) == ("pallas", "pallas", "pallas")
    assert (cfg.compute_dtype, cfg.residual_dtype) == ("bfloat16", "float32")


def test_cli_runs(models, tmp_path, monkeypatch):
    import sys

    from reazonspeech_tpu.core.audio import audio_to_file
    from reazonspeech_tpu_torch.nemo.asr import cli

    wav = tmp_path / "in.wav"
    audio_to_file(str(wav), audio_from_numpy(_wav(1.0, seed=3), 16000))
    out = tmp_path / "out.vtt"
    monkeypatch.setattr(cli, "load_model", lambda: models[1])
    monkeypatch.setattr(sys, "argv", ["reazonspeech-nemo-asr", "--to=vtt", "-o", str(out),
                                      str(wav)])
    assert cli.main() is None
    assert out.read_text().startswith("WEBVTT")
