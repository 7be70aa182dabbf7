"""The port's HTTP front (``reazonspeech_tpu_torch.serving.http``) on the
CPU: ``_prometheus_text`` against the JAX package's on the same stats; a
``make_app`` server on 127.0.0.1 over a tiny random-weight nemo model (WAV
and raw float32 bodies, /transcribe_stream NDJSON, /healthz, /metrics, 404,
500 and 503 with Retry-After) for both executors; the SIGTERM drain of the
real ``serve()`` in a subprocess; and ``main()``, which loads on the GPU
(here: raises, no CPU fallback) and refuses the flags whose parts are not
ported."""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from reazonspeech_tpu.serving.http import _prometheus_text as jax_prometheus_text
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
from reazonspeech_tpu_torch.nemo.asr.model import load_model
from reazonspeech_tpu_torch.serving import http as port_http

SR = 16000
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: every executor, batcher
    and server thread starts an OpenMP team of its own, and at torch's
    default (one thread a core) those teams oversubscribe the cores that
    the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_model():
    enc = FastConformerConfig.tiny(compute_dtype="float32")
    rnnt = RNNTConfig.tiny(enc_dim=enc.d_model, compute_dtype="float32")
    return load_model("cpu", checkpoint="random", enc_cfg=enc, rnnt_cfg=rnnt)


def _wav(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(SR * seconds)) * 0.1).astype(np.float32)


def _wav_bytes(x):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _pcm16(x):
    """The waveform as a WAV file stores it (16-bit), back in float32."""
    return (np.clip(x, -1, 1) * 32767).astype(np.int16).astype(np.float32) / 32768.0


@pytest.mark.parametrize("stats", [
    {"ok": True, "executor": "continuous", "requests_done": 7, "lane_occupancy": 0.42,
     "latency_s": {"p50": 0.01, "p95": 0.05, "p99": None}, "queue_depth": 0},
    {"ok": False, "executor": "micro", "batches": 3, "mean_batch": 2.5},
])
def test_prometheus_text_matches_jax(stats):
    text = port_http._prometheus_text(stats)
    assert text == jax_prometheus_text(stats)
    assert text.endswith("\n") and "reazonspeech_" in text


class _Server:
    """A make_app server on 127.0.0.1 at port 0, served from a thread."""

    def __init__(self, model, **kw):
        self.handler, self.batcher = port_http.make_app(model, **kw)
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), self.handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, ctype=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
        conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp, data

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.close()


def test_continuous_server_end_to_end(tiny_model):
    """--continuous: WAV and raw float32 bodies give the executor's results
    as JSON; a 10 s stream's NDJSON lines equal submit_long; /healthz and
    /metrics report the executor's stats; 404 and 500 leave it serving."""
    srv = _Server(tiny_model, executor="continuous", seconds_per_frame=0.08, n_lanes=2,
                  frames_per_segment=8, max_seconds=4.0)
    try:
        short, long_w = _wav(1.2, seed=1), _wav(10.0, seed=2)
        resp, data = srv.request("POST", "/transcribe", _wav_bytes(short), "audio/wav")
        assert resp.status == 200, data
        payload = json.loads(data)
        toks, frames = srv.batcher.transcribe(_pcm16(short))
        assert payload == port_http._result_json(tiny_model, toks, frames, 0.08)
        resp, data = srv.request("POST", "/transcribe", short.tobytes(),
                                 "application/octet-stream")
        toks, frames = srv.batcher.transcribe(short)
        assert json.loads(data) == port_http._result_json(tiny_model, toks, frames, 0.08)

        resp, data = srv.request("POST", "/transcribe_stream", long_w.tobytes(),
                                 "application/octet-stream")
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        lines = [json.loads(x) for x in data.decode().splitlines()]
        assert len(lines) > 1
        toks, frames = srv.batcher.submit_long(long_w).result(timeout=300)
        want = port_http._result_json(tiny_model, toks, frames, 0.08)
        assert sum((x["subwords"] for x in lines), []) == want["subwords"]
        assert "".join(x["text"] for x in lines) == want["text"]
        resp, data = srv.request("POST", "/transcribe", long_w.tobytes(),
                                 "application/octet-stream")  # windowed by submit_long
        assert json.loads(data) == want

        resp, data = srv.request("GET", "/healthz")
        health = json.loads(data)
        assert health["ok"] and health["executor"] == "continuous"
        assert health["requests_done"] >= 4 and health["lanes"] == 2
        resp, data = srv.request("GET", "/metrics")
        assert resp.getheader("Content-Type").startswith("text/plain")
        assert port_http._prometheus_text(health).splitlines()[0] in data.decode()
        assert "reazonspeech_lane_occupancy" in data.decode()

        assert srv.request("GET", "/nope")[0].status == 404
        assert srv.request("POST", "/nope", b"x")[0].status == 404
        resp, data = srv.request("POST", "/transcribe", b"not a wav at all", "audio/wav")
        assert resp.status == 500 and "error" in json.loads(data)
        assert srv.request("POST", "/transcribe", short.tobytes(),
                           "application/octet-stream")[0].status == 200
    finally:
        srv.close()


def test_backpressure_answers_503(tiny_model):
    """A pool whose backlog bound is reached sheds /transcribe and
    /transcribe_stream with 503 and Retry-After."""
    srv = _Server(tiny_model, executor="continuous", n_lanes=1, max_seconds=2.0,
                  max_pending=0)
    try:
        for path in ("/transcribe", "/transcribe_stream"):
            resp, data = srv.request("POST", path, _wav(0.5).tobytes(),
                                     "application/octet-stream")
            assert resp.status == 503 and resp.getheader("Retry-After") == "1"
            assert "max_pending" in json.loads(data)["error"]
    finally:
        srv.close()


def test_micro_server_end_to_end(tiny_model):
    """The default MicroBatcher app: results equal decode_single; /healthz
    counts batches; streaming needs the continuous executor (400)."""
    srv = _Server(tiny_model, max_batch=4, max_wait_ms=5.0)
    try:
        w = _wav(0.8, seed=3)
        resp, data = srv.request("POST", "/transcribe", _wav_bytes(w), "audio/wav")
        assert resp.status == 200
        toks, frames = tiny_model.decode_single(_pcm16(w))
        assert json.loads(data) == port_http._result_json(tiny_model, toks, frames, 0.08)
        health = json.loads(srv.request("GET", "/healthz")[1])
        assert health["ok"] and health["executor"] == "micro" and health["batches"] >= 1
        resp, data = srv.request("POST", "/transcribe_stream", w.tobytes(),
                                 "application/octet-stream")
        assert resp.status == 400
    finally:
        srv.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sigterm_drains_in_flight_requests():
    """SIGTERM mid-request stops accepting but completes the queued request
    and exits 0 (serve() installs the handler; the batcher drains on
    close())."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_tiny_torch_server.py"),
                             str(port), "1000"], env=env)  # a 1 s batching window
    try:
        deadline = time.time() + 120
        while time.time() < deadline:  # wait for the bind
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/healthz")
                conn.getresponse().read()
                break
            except OSError:
                time.sleep(0.5)
        else:
            raise AssertionError("server never came up")
        result = {}

        def post():
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            c.request("POST", "/transcribe", _wav_bytes(_wav(0.6)), {"Content-Type": "audio/wav"})
            r = c.getresponse()
            result["status"], result["body"] = r.status, r.read()

        t = threading.Thread(target=post)
        t.start()
        time.sleep(0.3)  # the request waits inside the 1 s batching window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=120)
        assert result.get("status") == 200, result
        assert "text" in json.loads(result["body"])
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_main_loads_on_the_gpu_only(monkeypatch):
    """main() loads the flavor on CUDA: without a GPU it raises before
    binding, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    served = []
    monkeypatch.setattr(port_http, "serve", lambda *a, **k: served.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_http.main(["--flavor", "nemo", "--checkpoint", "random", "--continuous"])
    assert served == []


@pytest.mark.parametrize("argv,item", [
    (["--flavor", "avsr", "--continuous"], "not supported for --flavor avsr"),
    (["--mesh-data", "2", "--continuous"], "pass devices= explicitly"),  # no CUDA device
    (["--mesh-data", "2"], "add --continuous"),
])
def test_main_refuses_unported_flags(monkeypatch, capsys, argv, item):
    """Each refused flag exits with an argparse error saying why (AVSR's
    --continuous does not apply; --mesh-data needs the continuous executor
    and as many CUDA devices as its entries), before any model is loaded."""
    monkeypatch.setattr(port_http, "_load_flavor",
                        lambda *a, **k: pytest.fail("a model was loaded"))
    with pytest.raises(SystemExit) as e:
        port_http.main(["--checkpoint", "random"] + argv)
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_main_compile_cache_enables_cache(monkeypatch, capsys, tmp_path):
    """--compile-cache DIR points the kernel and native build directories
    under DIR and prints it before the flavor loads."""
    from reazonspeech_tpu_torch import native
    from reazonspeech_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    seen = []

    def load(*a, **k):
        seen.append((_kernels.BUILD_DIR, native.BUILD_DIR, capsys.readouterr().out))
        raise SystemExit(0)

    monkeypatch.setattr(port_http, "_load_flavor", load)
    cache = tmp_path / "cc"
    with pytest.raises(SystemExit):
        port_http.main(["--checkpoint", "random", "--compile-cache", str(cache)])
    assert seen == [(cache / "torch_kernels", cache / "torch_native",
                     f"compile cache: {cache}\n")]
    assert cache.is_dir()
