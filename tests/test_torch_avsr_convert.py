"""The port's AVSR converter, loaders, host-side feature pipeline and HF
Auto classes against the JAX package's.

- ``convert/hf_avhubert.py`` on HF checkpoint directories written by
  ``tests/fixture_checkpoints.py`` (tied and untied heads): the tree and its
  metadata equal the JAX converter's leaf by leaf;
- ``from_pretrained`` from such a directory computes what the JAX package
  computes on it (a native tree the JAX package saved: in
  ``test_torch_avsr_model.py``);
- the feature extractor, the processor and the mouth-crop arithmetic equal
  the JAX package's;
- ``register_auto_classes()`` in a subprocess that imports only the port.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fixture_checkpoints import write_avhubert_hf_dir

from reazonspeech_tpu.avsr import AVHubertFeatureExtractor as JaxExtractor
from reazonspeech_tpu.avsr import AVHubertForConditionalGeneration as JaxGen
from reazonspeech_tpu.avsr import AVHubertProcessor as JaxProcessor
from reazonspeech_tpu.avsr import feature_extraction as jax_fe
from reazonspeech_tpu.convert import hf_avhubert as jax_conv
from reazonspeech_tpu_torch.avsr import (
    AVHubertConfig,
    AVHubertFeatureExtractor,
    AVHubertForConditionalGeneration,
    AVHubertProcessor,
)
from reazonspeech_tpu_torch.avsr import feature_extraction as port_fe
from reazonspeech_tpu_torch.convert import hf_avhubert as port_conv
from reazonspeech_tpu_torch.convert.store import load_param_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: at torch's default (one
    thread a core) each test worker's OpenMP team oversubscribes the cores
    that the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def hf_dir(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("avhubert_hf"))
    cfg = AVHubertConfig.tiny(audio_feat_dim=104, tie_word_embeddings=request.param)
    write_avhubert_hf_dir(d, cfg)
    return d, request.param


def test_converter_matches_jax(hf_dir, tmp_path):
    d, _ = hf_dir
    want, want_cfg = jax_conv.convert_avhubert_checkpoint(d, str(tmp_path / "jax"))
    got, cfg = port_conv.convert_avhubert_checkpoint(d, str(tmp_path / "port"))
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(want_cfg, f) for f in want_cfg.__dataclass_fields__}
    fw, fg = _flat(want), _flat(got)
    assert fg.keys() == fw.keys()
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and fg[k].shape == fw[k].shape, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    # the written trees and their sidecars (spec and meta) match too
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(f) == json.load(g)
    saved, meta = load_param_tree(str(tmp_path / "port"))
    assert meta["flavor"] == "avhubert"
    assert _flat(saved).keys() == fw.keys()


def _inputs(seed=4):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((2, 12, 104)).astype(np.float32)
    video = rng.standard_normal((2, 12, 88, 88)).astype(np.float32) * 0.5
    return audio, video, np.array([12, 8], np.int32)


def _same_model(port, jm):
    audio, video, lengths = _inputs()
    want, _ = jm.encoder(audio=audio, video=video, lengths=jnp.asarray(lengths))
    got, _ = port.encoder(audio=audio, video=video, lengths=lengths)
    assert rel(got, want) < RTOL
    for beams in (1, 5):
        want = np.asarray(jm.generate(audio=audio, video=video, lengths=jnp.asarray(lengths),
                                      num_beams=beams, max_length=8))
        got = port.generate(audio=audio, video=video, lengths=lengths, num_beams=beams,
                            max_length=8)
        np.testing.assert_array_equal(got.numpy(), want)


def test_from_pretrained_hf_dir(hf_dir):
    d, tied = hf_dir
    port = AVHubertForConditionalGeneration.from_pretrained(d, device="cpu")
    assert port.config.tie_word_embeddings == tied
    assert ("lm_head" in port.params) == (not tied)
    _same_model(port, JaxGen.from_pretrained(d))


def _wavs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(16000).astype(np.float32) * 0.1,
            rng.standard_normal(9000).astype(np.float32) * 0.1]


def _same_features(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_feature_extractor_audio_matches_jax():
    wavs = _wavs()
    _same_features(AVHubertFeatureExtractor()(audios=wavs), JaxExtractor()(audios=wavs))
    np.testing.assert_array_equal(port_fe.logfbank(wavs[1]), jax_fe.logfbank(wavs[1]))


@pytest.mark.parametrize("extract_mouth", [True, False])
def test_feature_extractor_av_matches_jax(extract_mouth):
    """Video frames ([T, H, W] and [T, H, W, C]) aligned to the audio steps;
    with ``extract_mouth`` the mouth ROI (the centre crop without mediapipe)."""
    rng = np.random.default_rng(1)
    wavs = _wavs(1)
    side = 96 if extract_mouth else 88  # without the crop, frames come at the model's 88
    videos = [rng.integers(0, 255, (12, side, side)).astype(np.float32),
              rng.integers(0, 255, (7, side, side, 3)).astype(np.float32)]
    if extract_mouth:
        pytest.importorskip("cv2")
    got = AVHubertFeatureExtractor()(audios=wavs, videos=videos, extract_mouth=extract_mouth)
    want = JaxExtractor()(audios=wavs, videos=videos, extract_mouth=extract_mouth)
    _same_features(got, want)
    assert got["video_frames"].shape[1] == got["audio_feats"].shape[1]


def test_mouth_crop_box_matches_jax():
    rng = np.random.default_rng(2)
    # float extents truncated to int in the reference's order: 0.6 - 0.4 is
    # 0.19999..., so the half side is 19 and the centres 59 and 99
    assert port_fe.mouth_crop_box([0.4, 0.6, 0.5, 0.45], [0.5, 0.55, 0.7, 0.6], 100, 200) == \
        (40, 78, 80, 118)
    for _ in range(50):
        xs, ys = rng.uniform(-0.1, 1.1, 4).tolist(), rng.uniform(-0.1, 1.1, 4).tolist()
        h, w = rng.integers(8, 400, 2).tolist()
        assert port_fe.mouth_crop_box(xs, ys, h, w) == jax_fe.mouth_crop_box(xs, ys, h, w)


class _Tokenizer:
    """A character tokenizer with <s>/</s> (ids 0, 1) and HF's encode/decode."""

    pad_token_id = 0
    vocab = ["<s>", "</s>", "あ", "い", "う"]

    def encode(self, text, add_special_tokens=False):
        ids, i = [], 0
        while i < len(text):
            for j, piece in enumerate(self.vocab):
                if text.startswith(piece, i):
                    ids.append(j)
                    i += len(piece)
                    break
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return "".join(self.vocab[i] for i in ids if not (skip_special_tokens and i < 2))


def test_processor_matches_jax():
    wavs = _wavs(3)
    got = AVHubertProcessor(tokenizer=_Tokenizer())(audios=wavs, text=["あいう", "<s>い</s>"])
    want = JaxProcessor(tokenizer=_Tokenizer())(audios=wavs, text=["あいう", "<s>い</s>"])
    _same_features(got, want)
    np.testing.assert_array_equal(got["decoder_input_ids"][0], [0, 2, 3, 4])
    np.testing.assert_array_equal(got["labels"][0], [2, 3, 4, 1])
    proc = AVHubertProcessor(tokenizer=_Tokenizer())
    assert proc.batch_decode([[0, 2, 3, 1]]) == ["あい"]
    with pytest.raises(ValueError, match="tokenizer"):
        AVHubertProcessor()(audios=wavs, text="あ")


_AUTO = """
import sys
sys.path.insert(0, "tests")
import numpy as np, torch
from fixture_checkpoints import write_avhubert_hf_dir
from reazonspeech_tpu_torch.avsr import (AVHubertConfig, AVHubertFeatureExtractor,
    AVHubertForConditionalGeneration, AVHubertModel, AVHubertProcessor, register_auto_classes)
from transformers import (CONFIG_MAPPING, AutoConfig, AutoModel, AutoModelForSpeechSeq2Seq,
    PretrainedConfig)
# another package's "avhubert" config registered first: the port's
# registration raises instead of taking the name over
class OtherConfig(PretrainedConfig):
    model_type = "avhubert"
AutoConfig.register("avhubert", OtherConfig)
try:
    register_auto_classes()
    raise SystemExit("registered over another package's avhubert")
except ValueError as e:
    assert "already registered" in str(e), e
CONFIG_MAPPING._extra_content.pop("avhubert")
d = sys.argv[1]
cfg = AVHubertConfig.tiny(audio_feat_dim=104)
write_avhubert_hf_dir(d, cfg)
assert register_auto_classes() is True
assert register_auto_classes() is True  # a repeat is harmless
hf_cfg = AutoConfig.from_pretrained(d)
assert hf_cfg.model_type == "avhubert" and hf_cfg.hidden_size == cfg.hidden_size
model = AutoModelForSpeechSeq2Seq.from_pretrained(d, device="cpu")
assert isinstance(model, AVHubertForConditionalGeneration), type(model)
direct = AVHubertForConditionalGeneration.from_pretrained(d, device="cpu")
audio = np.random.default_rng(0).standard_normal((1, 12, 104)).astype(np.float32)
a = model.generate(audio=audio, num_beams=5, max_length=8)
assert torch.equal(a, direct.generate(audio=audio, num_beams=5, max_length=8))
enc = AutoModel.from_pretrained(d, device="cpu")
assert isinstance(enc, AVHubertModel), type(enc)
hidden, mask = enc(audio=audio)
assert hidden.shape == (1, 12, cfg.hidden_size) and torch.isfinite(hidden).all()
try:
    AutoModel.from_pretrained(d)  # no device: CUDA, which raises without a GPU
    raise SystemExit("loaded without a device on a machine without a GPU")
except RuntimeError as e:
    assert torch.cuda.is_available() or "no CUDA device" in str(e), e
from transformers.models.auto.feature_extraction_auto import FEATURE_EXTRACTOR_MAPPING
from transformers.models.auto.processing_auto import PROCESSOR_MAPPING
hf = AVHubertConfig.hf_config_class()
assert FEATURE_EXTRACTOR_MAPPING._extra_content.get(hf) is AVHubertFeatureExtractor
assert PROCESSOR_MAPPING._extra_content.get(hf) is AVHubertProcessor
print("loaded:" + ",".join(sorted(m for m in sys.modules if m == "reazonspeech_tpu"
                                  or m.startswith("reazonspeech_tpu."))))
"""


def test_register_auto_classes_in_a_subprocess(tmp_path):
    """The five Auto classes in a process that imports only the port: a name
    held by another package refused, a repeat harmless, the models loaded
    through the Auto machinery equal to the direct loads."""
    pytest.importorskip("transformers")
    # transformers' torch side only: neither its TensorFlow nor its Flax one
    env = dict(os.environ, PYTHONPATH=REPO, USE_TF="0", USE_FLAX="0", USE_TORCH="1")
    out = subprocess.run([sys.executable, "-c", _AUTO, str(tmp_path)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"
