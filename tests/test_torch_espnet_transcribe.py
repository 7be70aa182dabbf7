"""The espnet entry points of the port against the JAX package on one tree
written by the JAX store (``test_torch_espnet.py``'s fixtures):
``ctc_probs``, ``transcribe`` (one window, the long form cut at a CTC blank
run, the packed attention route) and the CLI. fp32 compute; the JAX
kernels run in interpret mode."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.espnet.asr import model as jmodel
from reazonspeech_tpu.espnet.asr.transcribe import transcribe as jax_transcribe
from reazonspeech_tpu.models import conformer as jconf
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.espnet.asr import TranscribeConfig, audio_from_numpy, transcribe
from reazonspeech_tpu_torch.espnet.asr import model as tmodel
from reazonspeech_tpu_torch.models import fastconformer as tfc

from test_torch_espnet import (  # noqa: F401  (models, tree_path: fixtures)
    ENC, RNNT, SR, TOKENS, _espnet_tree, _wav, jmodel_config, models, tree_path,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: the Graves searches issue thousands of
    tiny ops, and a team of threads each under a loaded xdist run took a
    beam-20 case from 3.5 s alone to 590 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ctc_probs_matches_jax(models, monkeypatch):
    patch_interpret(monkeypatch)
    jm, tm = models
    wav = _wav(3.0, seed=3)
    want, got = jm.ctc_probs(wav), tm.ctc_probs(wav)
    assert got.shape == want.shape == (74, len(TOKENS))
    assert np.abs(got - want).max() <= 1e-5


def test_transcribe_short_matches_jax(models, monkeypatch):
    """One window: every field of the TranscribeResult equal (the port's
    classes are its own, so they compare as dicts)."""
    patch_interpret(monkeypatch)
    jm, tm = models
    audio = audio_from_numpy(_wav(3.0, seed=7), SR)
    got = transcribe(tm, audio, TranscribeConfig(verbose=False))
    want = jax_transcribe(jm, audio, jmodel_config(verbose=False))
    assert asdict(got) == asdict(want)
    assert len(got.text) > 0 and len(got.segments) > 0


def test_transcribe_long_form_matches_jax(models, monkeypatch):
    """24 s: the 20 s window is cut at the longest CTC blank run's midpoint
    and the rest decoded as a second window; results equal."""
    patch_interpret(monkeypatch)
    jm, tm = models
    wav = _wav(24.0, seed=11)
    wav[14 * SR:15 * SR] *= 0.01  # a pause for the blank scan
    audio = audio_from_numpy(wav, SR)
    got = transcribe(tm, audio, TranscribeConfig(verbose=False))
    want = jax_transcribe(jm, audio, jmodel_config(verbose=False))
    assert asdict(got) == asdict(want)
    assert len(got.segments) >= 2 and got.segments[-1].end_seconds > 15.0


def test_transcribe_packed_route_matches_jax(tmp_path, monkeypatch):
    """The same on a tree with 8 heads of dh=16 (d=128), whose short windows
    take the packed attention route and the fused block tail."""
    patch_interpret(monkeypatch)
    cfg = dict(ENC, num_heads=8, d_model=128)
    enc_cfg, rnnt_cfg = jconf.espnet_encoder_config(**cfg), jrnnt.RNNTConfig(**dict(RNNT,
                                                                                    enc_dim=128))
    path = str(tmp_path / "packed")
    save_param_tree(path, _espnet_tree(enc_cfg, rnnt_cfg, seed=4),
                    {"token_list": TOKENS, "enc_cfg": asdict(enc_cfg),
                     "rnnt_cfg": asdict(rnnt_cfg)})
    jm = jmodel.load_model_container(checkpoint=path, beam_size=4)
    tm = tmodel.load_model_container(checkpoint=path, beam_size=4, device="cpu")
    assert tfc.attention_route(tm.enc_cfg, 74) == "packed"
    audio = audio_from_numpy(_wav(3.0, seed=8), SR)
    got = transcribe(tm, audio, TranscribeConfig(verbose=False))
    want = jax_transcribe(jm, audio, jmodel_config(verbose=False))
    assert asdict(got) == asdict(want) and len(got.text) > 0


def test_cli_matches_jax(models, tmp_path, monkeypatch):
    """The CLI writes the same VTT as the JAX package's on one wav."""
    import sys

    from reazonspeech_tpu.espnet.asr import cli as jcli
    from reazonspeech_tpu_torch.core.audio import audio_to_file
    from reazonspeech_tpu_torch.espnet.asr import cli as tcli

    patch_interpret(monkeypatch)
    jm, tm = models
    wav = tmp_path / "in.wav"
    audio_to_file(str(wav), audio_from_numpy(_wav(3.0, seed=7), SR))
    outs = []
    for cli, model, name in ((tcli, tm, "port"), (jcli, jm, "jax")):
        out = tmp_path / f"{name}.vtt"
        monkeypatch.setattr(cli, "load_model", lambda model=model: model)
        monkeypatch.setattr(sys, "argv", ["espnet-asr", "--to=vtt", "-o", str(out), str(wav)])
        assert cli.main() is None
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[0].startswith("WEBVTT")
