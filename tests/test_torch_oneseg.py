"""The port's 1seg corpus pipeline (``reazonspeech_tpu_torch.oneseg`` and its
``espnet.oneseg`` alias) and its text utilities (``core/text.py``) against
the JAX package's on the same inputs: caption extraction from a synthetic
MPEG-TS stream, the ARIB c-profile decoder, sentence rebuilding, the
corpus and evaluation normalizers and CERs, the zip writer, and the CTC
aligner and ``get_utterances`` on one tiny JAX-saved espnet tree (CPU,
fp32; the audio from numpy with a seed)."""

import io
import sys
import zipfile
from dataclasses import asdict

import numpy as np
import pytest
import torch

from reazonspeech_tpu import oneseg as joneseg
from reazonspeech_tpu.core import text as jtext
from reazonspeech_tpu.espnet.asr import model as jmodel
from reazonspeech_tpu.oneseg import align as jalign
from reazonspeech_tpu.oneseg import sentence as jsentence
from reazonspeech_tpu.oneseg.encoding import decode_cprofile as jdecode
from reazonspeech_tpu_torch import oneseg as toneseg
from reazonspeech_tpu_torch.core import fs as tfs
from reazonspeech_tpu_torch.core import text as ttext
from reazonspeech_tpu_torch.espnet import oneseg as talias
from reazonspeech_tpu_torch.espnet.asr import model as tmodel
from reazonspeech_tpu_torch.oneseg import align as talign
from reazonspeech_tpu_torch.oneseg import sentence as tsentence
from reazonspeech_tpu_torch.oneseg.caption import TransportStreamError
from reazonspeech_tpu_torch.oneseg.encoding import decode_cprofile as tdecode

sys.path.insert(0, "tests")
from test_oneseg import build_stream  # noqa: E402
from test_torch_v1 import espnet_tree_path, wav  # noqa: E402

SR = 16000
CAPTIONS = [(1.0, "こんにちは。今日は"), (3.5, "いい天気ですね！"), (6.0, "≫（拍手）はい。"),
            (8.0, "ＡＢＣ１２３です。")]
TEXTS = ["こんにちは、世界。", "ＡＢＣ abc 123", "「はい」！？", "", "１０時３０分に2.5倍",
         "10000000000000000000000000000000000000000000000000000000000000000000000000000"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its ops are small, and at
    torch's default (one thread a core) each test worker's team
    oversubscribes the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(tmp_path):
    p = tmp_path / "t.m2ts"
    p.write_bytes(build_stream([(s, t.encode("euc-jp")) for s, t in CAPTIONS]))
    return str(p)


def _dicts(xs):
    return [asdict(x) for x in xs]


def test_captions_and_sentences_match_jax(tmp_path):
    """get_captions, build_sentences, split_sentences and _cleanup on one
    stream: the same captions, sentences and timings; a bad sync byte
    raises."""
    path = _stream(tmp_path)
    got, want = toneseg.get_captions(path), joneseg.get_captions(path)
    assert _dicts(got) == _dicts(want) and len(got) == len(CAPTIONS)
    assert _dicts(toneseg.build_sentences(got)) == _dicts(joneseg.build_sentences(want))
    for text in [t for _, t in CAPTIONS] + TEXTS:
        assert tsentence._cleanup(text) == jsentence._cleanup(text)
        assert tsentence.split_sentences(text) == jsentence.split_sentences(text)
    bad = tmp_path / "bad.m2ts"
    bad.write_bytes(b"\x00" * 188)
    with pytest.raises(TransportStreamError):
        toneseg.get_captions(str(bad))


def test_cprofile_decoder_matches_jax():
    """EUC-JP pairs, control bytes, broadcaster gaiji (the port's own copy
    of the table) and a truncated tail decode as in the JAX package."""
    cases = ["こんにちは".encode("euc-jp"), b"\x89" + "テスト".encode("euc-jp") + b"\x0d",
             bytes([0xFA, 0xA1, 0xFA, 0xA2, 0xA4]), bytes([0xF5, 0xD0, 0xA4, 0xA2])]
    for buf in cases:
        assert tdecode(buf) == jdecode(buf)
    assert tdecode(cases[0]) == "こんにちは"


def test_text_utilities_match_jax():
    """normalize, cer, normalize_eval, calculate_cer, num_to_ja and the
    edit distance (pure Python in the port) against the JAX package's."""
    for a in TEXTS:
        assert ttext.normalize(a) == jtext.normalize(a)
        assert ttext.normalize_eval(a) == jtext.normalize_eval(a)
        for b in TEXTS:
            assert ttext.edit_distance(a, b) == jtext.edit_distance(a, b)
            if ttext.normalize(a):
                assert ttext.cer(a, b) == jtext.cer(a, b)
            if ttext.normalize_eval(a):
                assert ttext.calculate_cer(a, b) == jtext.calculate_cer(a, b)
    for n in ("0", "1", "10", "1111", "10000", "123456789", "3.14"):
        assert ttext.num_to_ja(n) == jtext.num_to_ja(n)
    assert toneseg.cer is ttext.cer and talias.CTCSegmentationAligner is talign.CTCSegmentationAligner
    with tfs.create_tempfile() as f:
        assert f.name


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_save_as_zip_matches_jax(tmp_path, fmt):
    """The corpus zip: the same entries, bytes and manifest."""
    rng = np.random.default_rng(0)
    utts = []
    for i, mod in enumerate((toneseg, joneseg)):
        u = mod.Utterance(buffer=(rng.standard_normal(4000) * 0.1).astype(np.float32)
                          if i == 0 else utts[0].buffer, samplerate=SR, duration=0.25,
                          start_seconds=1.0, end_seconds=1.25, text="はい", ctc=-0.5,
                          asr="はい", cer=0.0)
        utts.append(u)
    out = []
    for mod, u in zip((toneseg, joneseg), utts):
        path = tmp_path / f"{mod.__name__}.zip"
        mod.save_as_zip([u, u], str(path), format=fmt)
        with zipfile.ZipFile(path) as z:
            out.append({n: z.read(n) for n in z.namelist()})
    assert out[0] == out[1] and f"0001.{fmt}" in out[0]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = espnet_tree_path(tmp_path_factory, "oneseg")
    return (jmodel.load_model_container(checkpoint=path, decoding="greedy"),
            tmodel.load_model_container(checkpoint=path, decoding="greedy", device="cpu"))


def test_aligner_matches_jax(models):
    """CTCSegmentationAligner over the port's container: the segment of a
    vocabulary text within 1e-5 s and its score within 1e-4 of the JAX
    aligner's; out-of-vocabulary text raises ValueError as there."""
    jm, tm = models
    audio = wav(6.0, seed=5)
    got = toneseg.CTCSegmentationAligner(tm)(audio, "こんにちは")
    want = joneseg.CTCSegmentationAligner(jm)(audio, "こんにちは")
    assert len(got.segments) == 1
    np.testing.assert_allclose(got.segments[0][:2], want.segments[0][:2], atol=1e-5)
    assert abs(got.segments[0][2] - want.segments[0][2]) < 1e-4
    assert 0 <= got.segments[0][0] < got.segments[0][1] <= 6.0
    with pytest.raises(ValueError, match="out-of-vocabulary"):
        toneseg.CTCSegmentationAligner(tm)(audio, "XYZ")


@pytest.mark.parametrize("strategy", ["optim", "lax"])
def test_get_utterances_matches_jax(models, tmp_path, monkeypatch, strategy):
    """The whole corpus path on the synthetic stream with the audio
    replaced: the same utterances (timings, texts, CTC scores within 1e-4,
    the re-ASR and its CER), each with its audio."""
    jm, tm = models
    path = _stream(tmp_path)
    audio = wav(12.0, seed=6)
    monkeypatch.setattr(talign, "load_audio", lambda p, sr: audio)
    monkeypatch.setattr(jalign, "load_audio", lambda p, sr: audio)
    got = toneseg.get_utterances(path, toneseg.CTCSegmentationAligner(tm), speech2text=tm,
                                 strategy=strategy)
    want = joneseg.get_utterances(path, joneseg.CTCSegmentationAligner(jm), speech2text=jm,
                                  strategy=strategy)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = asdict(g), asdict(w)
        np.testing.assert_array_equal(g.pop("buffer"), w.pop("buffer"))
        assert abs(g.pop("ctc") - w.pop("ctc")) < 1e-4
        for k in ("start_seconds", "end_seconds", "duration"):
            assert abs(g.pop(k) - w.pop(k)) < 1e-5
        assert g == w and g["asr"] is not None
    buf = io.BytesIO()
    toneseg.save_as_zip(got, buf, format="wav")
    assert len(zipfile.ZipFile(buf).namelist()) == len(got) + 1
