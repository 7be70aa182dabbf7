"""The port's AVSR serving (``serving/avsr.py``'s AVSRBatcher and
``serving/http.py``'s ``make_avsr_app``) on the CPU, on a tiny random model.

A batched beam generate equals a dedicated generate of each request
(batching and time/batch padding are invisible: padding rows are masked,
padded frames sit past each row's length mask); warm-up covers the bucket
set; greedy mode and the errors; the HTTP route with WAV and npz bodies,
/healthz and /metrics; ``_load_flavor("avsr")`` and ``main --flavor avsr``,
which load on the GPU (here: raise) and refuse ``--continuous``.
"""

import http.client
import io
import json
import threading
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from reazonspeech_tpu_torch.avsr import AVHubertConfig, AVHubertForConditionalGeneration
from reazonspeech_tpu_torch.serving import AVSRBatcher
from reazonspeech_tpu_torch.serving import http as port_http

CFG = AVHubertConfig.tiny(audio_feat_dim=104)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: every batcher and server
    thread starts an OpenMP team of its own, and at torch's default (one
    thread a core) those teams oversubscribe the cores that the other test
    workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return AVHubertForConditionalGeneration.init(torch.Generator().manual_seed(0), CFG,
                                                 device="cpu")


def _req(rng, t, audio=True, video=True):
    a = rng.standard_normal((t, 104)).astype(np.float32) * 0.1 if audio else None
    v = rng.standard_normal((t, 88, 88)).astype(np.float32) * 0.1 if video else None
    return a, v


def _dedicated(model, a, v, num_beams, max_length):
    """The request alone: one generate at its own length, a missing modality
    zero-filled as the batcher fills it, trimmed at the first EOS."""
    t = len(a) if a is not None else len(v)
    audio = np.zeros((1, t, CFG.audio_feat_dim), np.float32)
    video = np.zeros((1, t, 88, 88), np.float32)
    if a is not None:
        audio[0] = a
    if v is not None:
        video[0] = v
    toks = model.generate(audio=audio, video=video, lengths=np.array([t]),
                          num_beams=num_beams, max_length=max_length)[0].numpy()
    hits = np.nonzero(toks == CFG.eos_token_id)[0]
    return toks[: int(hits[0]) if hits.size else len(toks)].tolist()


def test_batched_matches_dedicated(model):
    """Mixed lengths and modalities in one pool; per-request parity."""
    rng = np.random.default_rng(0)
    reqs = [_req(rng, 12), _req(rng, 30), _req(rng, 7, video=False),
            _req(rng, 21, audio=False), _req(rng, 30)]
    batcher = AVSRBatcher(model, max_batch=8, max_wait_ms=200.0, bucket_frames=16,
                          num_beams=3, max_length=16)
    try:
        futs = [batcher.submit(a, v) for a, v in reqs]
        got = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
    for (a, v), tokens in zip(reqs, got):
        assert tokens == _dedicated(model, a, v, 3, 16)
    # all requests coalesced into a bounded set of batch shapes
    assert all(b in (1, 2, 4, 8) for b, _ in batcher.batch_shapes)
    assert all(t % 16 == 0 for _, t in batcher.batch_shapes)


def test_warmup_covers_bucket_set(model):
    """warmup() runs the exact (b_pad, t_pad) set _loop dispatches; traffic
    afterwards reuses those shapes."""
    batcher = AVSRBatcher(model, max_batch=4, max_wait_ms=50.0, bucket_frames=16,
                          num_beams=3, max_length=16)
    try:
        warmed = batcher.warmup(seconds=16 / 25)  # one bucket_frames step
        assert warmed == [(1, 16), (2, 16), (4, 16)]
        a, v = _req(np.random.default_rng(3), 12)
        assert batcher.generate(a, v) == _dedicated(model, a, v, 3, 16)
        assert batcher.ticks == 1 and batcher.batch_shapes <= set(warmed)
    finally:
        batcher.close()


def test_greedy_mode_and_errors(model):
    batcher = AVSRBatcher(model, max_batch=4, num_beams=1, bucket_frames=16, max_length=12)
    try:
        a, v = _req(np.random.default_rng(3), 10)
        assert batcher.generate(a, v) == _dedicated(model, a, v, 1, 12)
        with pytest.raises(ValueError, match="audio and/or video"):
            batcher.submit(None, None).result(timeout=10)
        with pytest.raises(ValueError, match="frame counts differ"):
            batcher.submit(a[:5], v).result(timeout=10)
    finally:
        batcher.close()


def _wav_bytes(x):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _post(conn, body, ctype):
    conn.request("POST", "/transcribe", body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


class _Tokenizer:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


def test_avsr_http_route(model):
    """The HTTP route: a WAV body (audio-only, features extracted
    server-side) and npz bodies (pre-extracted audio, video or both), each
    answer equal to a dedicated generate; /healthz, /metrics and 404."""
    from reazonspeech_tpu_torch.avsr.feature_extraction import AVHubertFeatureExtractor

    handler, batcher = port_http.make_avsr_app(
        model, tokenizer=_Tokenizer(), max_batch=4, max_wait_ms=5.0, bucket_frames=16,
        num_beams=3, max_length=12)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        rng = np.random.default_rng(0)
        wav = (rng.standard_normal(16000) * 0.1).astype(np.float32)
        status, payload = _post(conn, _wav_bytes(wav), "audio/wav")
        assert status == 200, payload
        # the server's features are those of the waveform the WAV stores
        stored = np.frombuffer(_wav_bytes(wav)[44:], np.int16).astype(np.float32) / 32768.0
        feats = AVHubertFeatureExtractor()._extract_audio(stored)
        assert payload["token_ids"] == _dedicated(model, feats, None, 3, 12)
        assert payload["text"] == " ".join(map(str, payload["token_ids"]))

        for keep in (("audio", "video"), ("audio",), ("video",)):
            a, v = _req(rng, 10)
            arrs = {k: x for k, x in (("audio", a), ("video", v)) if k in keep}
            buf = io.BytesIO()
            np.savez(buf, **arrs)
            status, payload = _post(conn, buf.getvalue(), "application/x-npz")
            assert status == 200, payload
            assert payload["token_ids"] == _dedicated(model, arrs.get("audio"),
                                                      arrs.get("video"), 3, 12)

        status, payload = _post(conn, io.BytesIO().getvalue(), "application/x-npz")
        assert status == 500 and "error" in payload
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["flavor"] == "avsr" and health["ticks"] >= 4
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
        assert "reazonspeech_ticks" in metrics and 'flavor="avsr"' in metrics
        conn.request("GET", "/nowhere")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


def test_load_flavor_avsr(monkeypatch):
    """--checkpoint random (or none) is AVHubertConfig() from seed 0 on the
    GPU (here: raises, no CPU fallback); a path goes to from_pretrained; a
    decoding strategy is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ckpt in (None, "random"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_http._load_flavor("avsr", ckpt)
    with pytest.raises(ValueError, match="does not apply to the avsr"):
        port_http._load_flavor("avsr", "random", decoding="beam")

    calls = []
    monkeypatch.setattr(AVHubertForConditionalGeneration, "init",
                        classmethod(lambda cls, gen, cfg: calls.append((gen.initial_seed(), cfg))))
    monkeypatch.setattr(AVHubertForConditionalGeneration, "from_pretrained",
                        classmethod(lambda cls, path: calls.append(path)))
    port_http._load_flavor("avsr", "random")
    port_http._load_flavor("avsr", "/some/hf_dir")
    assert calls == [(0, AVHubertConfig()), "/some/hf_dir"]


def test_main_serves_avsr(monkeypatch):
    """main --flavor avsr serves make_avsr_app's handler through the drain
    lifecycle, with the batch flags and the warm-up."""
    served = []
    model = AVHubertForConditionalGeneration(config=CFG, params={"w": torch.zeros(1)})
    monkeypatch.setattr(port_http, "_load_flavor", lambda *a: model)
    monkeypatch.setattr(port_http, "make_avsr_app",
                        lambda model, **kw: served.append((model, kw)) or ("handler", _Warm()))
    monkeypatch.setattr(port_http, "_serve_until_shutdown",
                        lambda handler, batcher, host, port: served.append((handler, port)))
    port_http.main(["--flavor", "avsr", "--checkpoint", "random", "--port", "0",
                    "--max-batch", "8", "--warmup", "2"])
    assert served == [(model, {"max_batch": 8, "max_wait_ms": 20.0}), ("handler", 0)]
    assert _Warm.seconds == [2.0]


class _Warm:
    seconds = []

    def warmup(self, seconds):
        self.seconds.append(seconds)
        return [(1, 50)]


def test_main_refuses_avsr_continuous(monkeypatch, capsys):
    """--flavor avsr --continuous exits with an argparse error before any
    model is loaded: seq2seq generate has no lane-recycling executor."""
    monkeypatch.setattr(port_http, "_load_flavor",
                        lambda *a, **k: pytest.fail("a model was loaded"))
    with pytest.raises(SystemExit) as e:
        port_http.main(["--flavor", "avsr", "--continuous"])
    assert e.value.code == 2
    assert "not supported for --flavor avsr" in capsys.readouterr().err
