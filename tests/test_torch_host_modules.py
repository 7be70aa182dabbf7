"""The port's host-side modules against the JAX package's: ``native/`` (the
g++-built library and its ctypes bindings), ``core.text``'s and
``training.data``'s use of it, the ``evaluation`` harness, the on-device
``frontend.resample`` (here on CPU tensors), ``utils.profiling`` and
``utils.compile_cache``."""

import json
import os
import subprocess
import sys
from math import gcd
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu import native as jnative
from reazonspeech_tpu.evaluation import BaseEvaluator as JaxEvaluator
from reazonspeech_tpu.frontend.resample import resample as jax_resample
from reazonspeech_tpu_torch import native
from reazonspeech_tpu_torch.core import text
from reazonspeech_tpu_torch.core.audio import audio_from_numpy, audio_to_file
from reazonspeech_tpu_torch.evaluation import (
    BaseEvaluator, calculate_cer, mesh_model, normalize,
)
from reazonspeech_tpu_torch.frontend import resample
from reazonspeech_tpu_torch.ops import _kernels
from reazonspeech_tpu_torch.training import data
from reazonspeech_tpu_torch.utils import ENV_VAR, RTFxMeter, enable_compile_cache, trace

REPO = Path(__file__).resolve().parent.parent

needs_native = pytest.mark.skipif(
    not native._compiler(), reason="no C++ compiler: native.available() is False by contract")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavs(tmp_path, n=8, seed=0):
    """n 16 kHz PCM16 WAVs of 0.1-1.0 s written by the port's audio_to_file
    (the last one stereo)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        x = (0.3 * rng.standard_normal(int(16000 * rng.uniform(0.1, 1.0)))).astype(np.float32)
        if i == n - 1:
            x = np.stack([x, 0.5 * x])
        p = tmp_path / f"a{i}.wav"
        audio_to_file(str(p), audio_from_numpy(x, 16000))
        paths.append(str(p))
    return paths


# --- native/ -------------------------------------------------------------------


@needs_native
def test_native_builds_into_its_build_dir(tmp_path, monkeypatch):
    """The first use builds with g++ into BUILD_DIR under a hash of the
    source and flags; a second process finds it there ("(cached)")."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    built = sorted((tmp_path / "torch_native").iterdir())
    assert [p.name for p in built] == [Path(native.build_info()["path"]).name]
    assert built[0].name.startswith("librs_native_") and built[0].suffix == ".so"
    assert not (REPO / "reazonspeech_tpu_torch" / "native" / built[0].name).exists()
    monkeypatch.setattr(native, "_lib", None)
    assert native.available() and native.build_info()["log"] == "(cached)"


_FIRST_BUILD = """
import sys
from reazonspeech_tpu_torch import native
from reazonspeech_tpu_torch.utils import enable_compile_cache
enable_compile_cache(sys.argv[1])
assert native.available()
print(native.edit_distance("kitten", "sitting"), native.build_info()["path"])
"""


@needs_native
def test_native_concurrent_first_builds(tmp_path):
    """Two processes building into one empty directory at once both load a
    whole library, and one file is left (the atomic publish)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_BUILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert all(o.split()[0] == "3" for o, _ in outs)
    files = list((tmp_path / "torch_native").iterdir())
    assert len(files) == 1 and files[0].suffix == ".so", files


@needs_native
def test_native_bindings_match_jax(tmp_path):
    """Every binding against the JAX package's on the same inputs."""
    assert native.available() and jnative.available()
    rng = np.random.default_rng(0)
    for a, b in [("", ""), ("a", ""), ("kitten", "sitting"), ("こんにちは世界", "こんばんは、世界"),
                 ("𝔘ni", "uni")]:
        assert native.edit_distance(a, b) == jnative.edit_distance(a, b)
    pcm = rng.integers(-32768, 32768, 1000).astype(np.int16)
    np.testing.assert_array_equal(native.pcm16_to_f32(pcm), jnative.pcm16_to_f32(pcm))
    x = rng.standard_normal((501, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.downmix_mean(x), jnative.downmix_mean(x))

    sys.path.insert(0, str(REPO / "tests"))
    from test_oneseg import build_stream

    stream = build_stream([(1.0, "あ".encode("euc-jp")), (2.0, "い".encode("euc-jp"))],
                          caption_pid=0x130)
    for pusi in (True, False):
        np.testing.assert_array_equal(native.ts_scan_pid(stream, 0x130, pusi),
                                      jnative.ts_scan_pid(stream, 0x130, pusi))

    paths = _wavs(tmp_path)
    assert [native.wav_info(p) for p in paths] == [jnative.wav_info(p) for p in paths]
    stride = max(native.wav_info(p)[1] for p in paths)
    got, want = native.wav_batch_load(paths, stride), jnative.wav_batch_load(paths, stride)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(OSError):
        native.wav_info(tmp_path / "missing.wav")


@needs_native
def test_core_text_takes_native_edit_distance(monkeypatch):
    """core.text.edit_distance is the native one where available and equals
    the pure-Python Wagner-Fischer on 200 seeded pairs; without a compiler
    it is the Python one."""
    monkeypatch.setattr(text, "_native_edit_distance", None)
    assert text._load_native() is native.edit_distance
    rng = np.random.default_rng(0)
    alphabet = list("あいうえおかきくけこabc、。 ")
    for _ in range(200):
        a, b = ("".join(rng.choice(alphabet, rng.integers(0, 30))) for _ in range(2))
        assert text.edit_distance(a, b) == text._edit_distance_python(a, b)
    monkeypatch.setattr(text, "_native_edit_distance", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert not native.available()
    assert text._load_native() is False
    assert text.edit_distance("kitten", "sitting") == 3
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
        native.edit_distance("a", "b")


class _Tok:
    def text_to_ids(self, s):
        return [1 + ord(ch) % 7 for ch in s]


@needs_native
def test_training_batches_equal_with_and_without_native(tmp_path, monkeypatch):
    """_load_wavs through native.wav_batch_load equals the per-file Python
    decode, and so do whole manifest batches; a file whose header the
    native reader refuses sends the list to Python."""
    paths = _wavs(tmp_path)
    rows = [{"audio": p, "transcription": "あいう"[: 1 + i % 3]} for i, p in enumerate(paths)]
    assert native.available()
    fast = data._load_wavs(paths)
    fast_batches = list(data.manifest_batches(rows, _Tok(), 4, shuffle=False))
    monkeypatch.setattr(native, "_lib", False)  # as where no compiler exists
    slow = data._load_wavs(paths)
    slow_batches = list(data.manifest_batches(rows, _Tok(), 4, shuffle=False))
    assert len(fast) == len(slow) == 8
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a, b)
    assert len(fast_batches) == len(slow_batches) == 2
    for a, b in zip(fast_batches, slow_batches):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.undo()

    def not_a_wav(path):
        raise OSError(f"not a readable PCM WAV: {path}")

    calls = []
    monkeypatch.setattr(native, "wav_info", not_a_wav)
    monkeypatch.setattr(native, "wav_batch_load", lambda *a: calls.append(a))
    for a, b in zip(data._load_wavs(paths), slow):
        np.testing.assert_array_equal(a, b)
    assert calls == []


# --- evaluation/ ------------------------------------------------------------------


def _echo(base):
    class Echo(base):
        def __init__(self, mapping, **kwargs):
            super().__init__(**kwargs)
            self.mapping = mapping

        def _evaluate(self, example, **kwargs):
            return {"prediction": self.mapping[example["id"]]}

        def _evaluate_batch(self, batch, **kwargs):
            return {"predictions": [self.mapping[i] for i in batch["id"]]}

    return Echo


DATASET = {"id": [0, 1, 2], "text": ["こんにちは", "ありがとう", "さようなら"]}
EVAL_CASES = {
    "dict": ({0: "こんにちは", 1: "ありがとう", 2: "さようなら"}, {}),
    "counts": ({0: "こんにちは", 1: "ありがとお", 2: "さようなら"}, {}),
    "batched": ({0: "こんにちは", 1: "ありがとう", 2: "さようなら"}, {"batch_size": 2}),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_matches_jax_harness(case, capsys):
    """The port's BaseEvaluator and the JAX harness give the same columns
    and print the same CER on tests/test_evaluation.py's cases."""
    mapping, kw = EVAL_CASES[case]
    results = []
    for base in (BaseEvaluator, JaxEvaluator):
        out = _echo(base)(mapping, **kw).evaluate(dataset=dict(DATASET))
        printed = [x for x in capsys.readouterr().out.splitlines() if x.startswith("CER:")]
        results.append(({k: list(out[k]) for k in ("prediction", "distance", "length")},
                        printed))
    assert results[0] == results[1]
    want = {"dict": "CER: 0.00%", "counts": "CER: 6.67%", "batched": "CER: 0.00%"}[case]
    assert results[0][1] == [want]


def test_evaluate_jsonl_round_trip_matches_jax(tmp_path, capsys):
    p = tmp_path / "data.jsonl"
    with open(p, "w") as f:
        for i, t in enumerate(["こんにちは", "ありがとう"]):
            f.write(json.dumps({"id": i, "text": t}, ensure_ascii=False) + "\n")
    lines = []
    for name, base in (("port", BaseEvaluator), ("jax", JaxEvaluator)):
        out_file = tmp_path / f"{name}.jsonl"
        _echo(base)({0: "こんにちは", 1: "ありがとお"}, output_file=str(out_file)).evaluate(
            dataset=str(p))
        lines.append([json.loads(x) for x in out_file.read_text().strip().split("\n")])
    assert lines[0] == lines[1]
    assert [r["distance"] for r in lines[0]] == [0, 1]
    assert "CER: 10.00%" in capsys.readouterr().out


def test_evaluate_requires_dataset_and_normalizes():
    with pytest.raises(ValueError, match="No dataset"):
        _echo(BaseEvaluator)({}).evaluate()
    assert calculate_cer("25日です。", "２５日です")["distance"] == 0
    assert normalize("２５日です。") == "二十五日です"


def test_mesh_model_is_not_ported_yet():
    """mesh_model is ported (tests/test_torch_parallel_serving.py decodes
    through it): with no devices it takes the visible CUDA devices and
    refuses where there are fewer than n_data (none here), never the CPU."""
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        mesh_model(object(), 2)
    with pytest.raises(ValueError, match="pass devices= explicitly"):
        mesh_model(object(), 2, devices=[torch.device("cpu")])


# --- frontend/resample.py --------------------------------------------------------


def _chirp(sr, seconds, f0=100.0):
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * (f0 + 2000.0 * t) * t)).astype(np.float32)


@pytest.mark.parametrize("orig_sr", [48000, 44100, 22050, 8000])
def test_resample_matches_jax_and_scipy(orig_sr):
    """Within 5e-4 of scipy's resample_poly in float64 (the JAX test's
    tolerance) and within 1e-5 of the JAX resample, with scipy's length."""
    from scipy.signal import resample_poly

    x = _chirp(orig_sr, 0.5)
    got = resample(torch.from_numpy(x), orig_sr, 16000)
    assert got.dtype == torch.float32
    g = gcd(orig_sr, 16000)
    want = resample_poly(x.astype(np.float64), 16000 // g, orig_sr // g)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)
    jax_out = np.asarray(jax_resample(jnp.asarray(x), orig_sr, 16000))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-5)


def test_resample_noop_and_batched():
    x = _chirp(16000, 0.1)
    np.testing.assert_array_equal(resample(torch.from_numpy(x), 16000, 16000).numpy(), x)
    xb = np.stack([_chirp(48000, 0.2), _chirp(48000, 0.2, f0=200.0)])
    out = resample(torch.from_numpy(xb), 48000, 16000)
    assert tuple(out.shape) == (2, 3200)
    np.testing.assert_allclose(out[1].numpy(), resample(torch.from_numpy(xb[1]), 48000,
                                                        16000).numpy(), atol=1e-6)


# --- utils/ -------------------------------------------------------------------------


def test_rtfx_meter():
    meter = RTFxMeter()
    assert meter.rtfx == 0.0 and meter.rtf == float("inf")
    with meter.measure(audio_seconds=30.0):
        pass
    meter.wall_seconds = 0.5  # the block's wall, fixed for the arithmetic
    assert meter.rtfx == 60.0 and meter.rtf == pytest.approx(1 / 60)
    assert meter.summary() == {"rtfx": 60.0, "audio_seconds": 30.0, "wall_seconds": 0.5,
                               "batches": 1}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == str(tmp_path / "tr")
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_enable_compile_cache(tmp_path, monkeypatch):
    """Unset: None and the build dirs stay; the variable's fallback and an
    explicit path: the directory is made and both libraries' build dirs
    move under it."""
    monkeypatch.delenv(ENV_VAR, raising=False)
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    before = (_kernels.BUILD_DIR, native.BUILD_DIR)
    assert enable_compile_cache() is None
    assert (_kernels.BUILD_DIR, native.BUILD_DIR) == before
    d = tmp_path / "cc_env"
    monkeypatch.setenv(ENV_VAR, str(d))
    assert enable_compile_cache() == str(d) and d.is_dir()
    assert _kernels.BUILD_DIR == d / "torch_kernels" and native.BUILD_DIR == d / "torch_native"
    e = tmp_path / "cc"
    assert enable_compile_cache(str(e), min_compile_secs=0.0) == str(e)
    assert _kernels.BUILD_DIR == e / "torch_kernels"
