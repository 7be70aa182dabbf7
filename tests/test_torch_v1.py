"""The port's v1 API (``reazonspeech_tpu_torch.v1``) against the JAX
package's on one tiny JAX-saved espnet tree, on the CPU, fp32: the
streaming ``transcribe`` generator (one window, and a long input cut at
its longest CTC blank run), the dynamic text split, the CLI's JSON and VTT
output, and ``load_default_model`` through $REAZONSPEECH_TPU_V1_CHECKPOINT.
Both containers decode greedily (the v1 flow is the subject, not the beam
search); the CTC blank is raised so that the blank scan finds runs, and the
joint made decisive so that captions carry text. Inputs come from numpy
with a seed."""

import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax

from reazonspeech_tpu import v1 as jv1
from reazonspeech_tpu.convert.store import save_param_tree
from reazonspeech_tpu.espnet.asr import model as jmodel
from reazonspeech_tpu.models import conformer as jconf
from reazonspeech_tpu.models import fastconformer as jfc
from reazonspeech_tpu.models import rnnt as jrnnt
from reazonspeech_tpu.v1 import cli as jcli
from reazonspeech_tpu.v1.transcribe import _split_text as jsplit
from reazonspeech_tpu_torch import v1 as tv1
from reazonspeech_tpu_torch.core.audio import audio_from_numpy, audio_to_file
from reazonspeech_tpu_torch.espnet.asr import model as tmodel
from reazonspeech_tpu_torch.v1 import cli as tcli
from reazonspeech_tpu_torch.v1.transcribe import _split_text as tsplit

SR = 16000
TOKENS = jmodel.default_token_list(["。", "、", "?", "!"] + [chr(c) for c in range(0x3041, 0x3097)])
ENC = dict(num_layers=2, d_model=32, num_heads=4, subsampling_channels=32,
           compute_dtype="float32")
RNNT = dict(vocab_size=len(TOKENS), enc_dim=32, pred_hidden=24, joint_hidden=32,
            joint_activation="tanh", blank_position="first", compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its ops are small, and at
    torch's default (one thread a core) each test worker's team
    oversubscribes the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def espnet_tree_path(tmp_path_factory, name):
    """A JAX-saved espnet tree: tiny Conformer, CTC blank +4, the joint's
    output weights x8 and its blank +1."""
    enc_cfg, rnnt_cfg = jconf.espnet_encoder_config(**ENC), jrnnt.RNNTConfig(**RNNT)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(5), 4)
    tree = jax.tree.map(np.array, {
        "encoder": jfc.init_fastconformer(k1, enc_cfg),
        "ctc": jconf.init_ctc_head(k2, enc_cfg.d_model, rnnt_cfg.vocab_size),
        "predictor": jrnnt.init_predictor(k3, rnnt_cfg),
        "joint": jrnnt.init_joint(k4, rnnt_cfg)})
    tree["ctc"]["out"]["b"][0] += 4.0
    tree["joint"]["out"]["w"] *= 8.0
    tree["joint"]["out"]["b"][0] += 1.0
    path = str(tmp_path_factory.mktemp(name) / "model")
    save_param_tree(path, tree, {"flavor": "espnet", "token_list": TOKENS,
                                 "enc_cfg": asdict(enc_cfg), "rnnt_cfg": asdict(rnnt_cfg)})
    return path


@pytest.fixture(scope="module")
def tree_path(tmp_path_factory):
    return espnet_tree_path(tmp_path_factory, "v1")


@pytest.fixture(scope="module")
def models(tree_path):
    """(JAX container, port container), greedy, from the one tree."""
    return (jmodel.load_model_container(checkpoint=tree_path, decoding="greedy"),
            tmodel.load_model_container(checkpoint=tree_path, decoding="greedy", device="cpu"))


def wav(seconds, seed, silence=None):
    """Noise at 0.1 with a 3 Hz envelope; ``silence`` = (start s, end s)
    zeroed."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / SR))
    w = (rng.standard_normal(n) * 0.1 * env).astype(np.float32)
    if silence:
        w[int(silence[0] * SR):int(silence[1] * SR)] = 0.0
    return w


def _captions(caps):
    return [asdict(c) for c in caps]


@pytest.mark.parametrize("seconds,window,silence", [(3.0, 320000, None),
                                                   (30.0, 20 * SR, (10.0, 12.0))],
                         ids=["one-window", "long"])
def test_transcribe_matches_jax(models, seconds, window, silence):
    """The generator's captions equal JAX's field by field; they carry text
    and lie inside the input, in order."""
    jm, tm = models
    audio = wav(seconds, seed=1, silence=silence)
    got = list(tv1.transcribe(audio, tm, tv1.TranscribeConfig(window=window)))
    want = list(jv1.transcribe(audio, jm, jv1.TranscribeConfig(window=window)))
    assert _captions(got) == _captions(want)
    assert "".join(c.text for c in got)
    ends = [(c.start_seconds, c.end_seconds) for c in got]
    assert all(0 <= a <= b <= seconds + 1e-6 for a, b in ends)
    assert [a for a, _ in ends] == sorted(a for a, _ in ends)


def test_split_text_matches_jax(models):
    """The dynamic split on a decoded window, and its fallbacks (one
    character, a text out of the vocabulary), equal JAX's."""
    jm, tm = models
    audio = np.pad(wav(4.0, seed=2), (16000, 8000))
    ids, lpz_log = tm.decode_with_ctc(audio)
    text = tm.ids_to_text(ids)
    assert len(text) > 1
    assert tsplit(text, audio, tm, lpz_log=lpz_log) == jsplit(text, audio, jm)
    assert tsplit(text, audio, tm) == jsplit(text, audio, jm)
    for text in ("あ", "XYZ💥"):
        assert tsplit(text, audio, tm) == jsplit(text, audio, jm) == [(0, len(audio), text)]


@pytest.mark.parametrize("ext,flag", [("vtt", []), ("unknownext", []), ("srt", ["--to=srt"])])
def test_cli_matches_jax(models, tmp_path, monkeypatch, ext, flag):
    """``python -m reazonspeech_tpu_torch.v1.cli`` writes the same file as
    the JAX package's v1 CLI: VTT by extension, JSON by default, SRT by
    flag."""
    jm, tm = models
    path = tmp_path / "in.wav"
    audio_to_file(str(path), audio_from_numpy(wav(2.5, seed=3), SR))
    outs = []
    for cli, model, name in ((tcli, tm, "port"), (jcli, jm, "jax")):
        out = tmp_path / f"{name}.{ext}"
        monkeypatch.setattr(cli, "load_default_model", lambda model=model: model)
        monkeypatch.setattr(sys, "argv", ["v1", *flag, "-o", str(out), str(path)])
        assert cli.main() is None
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[0].strip()
    monkeypatch.setattr(sys, "argv", ["v1", "--to=doc", str(path)])
    assert tcli.main() == 1


def test_load_default_model(tree_path, monkeypatch):
    """$REAZONSPEECH_TPU_V1_CHECKPOINT names the tree: the port's default
    v1 model on the CPU is the espnet container on it (Graves beam 20, as
    the JAX package's), its CTC probabilities the JAX one's; with no
    device it asks for CUDA, which raises without a GPU."""
    monkeypatch.setenv("REAZONSPEECH_TPU_V1_CHECKPOINT", tree_path)
    tm = tv1.load_default_model(device="cpu")
    jm = jv1.load_default_model()
    assert tm.token_list == TOKENS and tm.decode_cfg.beam_size == 20
    assert asdict(tm.decode_cfg) == {k: v for k, v in asdict(jm.decode_cfg).items()
                                     if k in asdict(tm.decode_cfg)}
    audio = wav(1.5, seed=4)
    np.testing.assert_allclose(tm.ctc_probs(audio), jm.ctc_probs(audio), atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv1.load_default_model()
