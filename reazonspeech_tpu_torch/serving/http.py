"""Minimal HTTP front for the serving executors (stdlib only).

The port of ``reazonspeech_tpu/serving/http.py``.

POST /transcribe with a WAV body (or raw float32 PCM16k with
Content-Type: application/octet-stream) returns JSON:

    {"text": ..., "subwords": [{"token": ..., "seconds": ...}, ...]}

POST /transcribe_stream (continuous executor only) answers with
application/x-ndjson: one JSON object of the same shape per decoded
window, flushed as soon as it completes — read lines until EOF. When the
lane pool's ``--max-pending`` backlog bound is hit, requests are shed with
503 + Retry-After. GET /healthz reports readiness and batching stats and
the program's counters (``utils.profiling``: kernel launches
``launch.<kernel>``, ALSD ``decode.steps`` and ``decode.checks``), GET
/metrics the same in Prometheus text, the counters as
``reazonspeech_count_total{name="..."}``. One process serves one card;
scale-out is one process per card behind any load balancer.

``--flavor avsr`` serves the seq2seq AVSR family through its own static
micro-batcher (:func:`make_avsr_app`); the transducer-only continuous
executor does not apply there.

Run: ``python -m reazonspeech_tpu_torch.serving.http --flavor nemo``
(the model loads on the GPU; without one it raises).
"""

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils import profiling
from ..utils.compile_cache import enable_compile_cache
from .batcher import MicroBatcher

__all__ = ["serve", "make_app", "make_avsr_app", "main"]


def _load_flavor(flavor, checkpoint=None, decoding=None):
    """The flavor's model on the GPU (the port's loaders raise without one)."""
    if flavor == "nemo":
        from ..nemo.asr.model import load_model

        return load_model(checkpoint=checkpoint, decoding=decoding)
    if flavor == "espnet":
        from ..espnet.asr.model import load_model_container

        if decoding is None:
            return load_model_container(checkpoint=checkpoint)
        return load_model_container(checkpoint=checkpoint, decoding=decoding)
    if flavor == "k2":
        from ..k2.asr.huggingface import load_model

        return load_model(checkpoint=checkpoint, decoding=decoding)
    if flavor == "avsr":
        if decoding is not None:
            raise ValueError("decoding strategy does not apply to the avsr "
                             "flavor (seq2seq generate; beam width is a "
                             "generate-time argument)")
        import torch

        from ..avsr.configuration_avhubert import AVHubertConfig
        from ..avsr.model import AVHubertForConditionalGeneration

        if checkpoint in (None, "random"):
            return AVHubertForConditionalGeneration.init(
                torch.Generator().manual_seed(0), AVHubertConfig())
        return AVHubertForConditionalGeneration.from_pretrained(checkpoint)
    raise ValueError(f"unknown flavor: {flavor}")


def _decode_audio_body(body, content_type):
    if content_type.startswith("application/octet-stream"):
        return np.frombuffer(body, np.float32)
    import tempfile

    from ..core.audio import audio_from_path

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(body)
        f.flush()
        audio = audio_from_path(f.name)
    return np.asarray(audio.waveform, np.float32)


def _prometheus_text(stats, prefix="reazonspeech"):
    """Render a flat stats dict (the /healthz payload) in Prometheus text
    exposition format: numbers become gauges, bools 0/1, one-level dicts
    of the ``{"p50": ...}`` shape become quantile-labelled samples, and
    string values become labels on a ``<prefix>_info 1`` sample."""
    lines = []
    info = []
    for k, v in stats.items():
        if isinstance(v, bool):
            lines.append(f"{prefix}_{k} {int(v)}")
        elif isinstance(v, (int, float)):
            lines.append(f"{prefix}_{k} {v}")
        elif isinstance(v, str):
            info.append(f'{k}="{v}"')
        elif isinstance(v, dict):
            for q, val in v.items():
                if not isinstance(val, (int, float)):
                    continue
                quant = ("0." + q[1:]) if (q.startswith("p")
                                           and q[1:].isdigit()) else q
                lines.append(f'{prefix}_{k}{{quantile="{quant}"}} {val}')
    if info:
        lines.append(f"{prefix}_info{{{','.join(info)}}} 1")
    return "\n".join(lines) + "\n"


def _counters_text(counters, prefix="reazonspeech"):
    """The program's counters as one Prometheus counter family, a sample
    labelled by each counter's name."""
    return "".join(f'{prefix}_count_total{{name="{k}"}} {v}\n'
                   for k, v in sorted(counters.items()))


def _result_json(model, token_ids, frames, seconds_per_frame):
    toks = model.tokenizer
    text = toks.ids_to_text(token_ids)
    subwords = [
        {
            "token": toks.ids_to_tokens([tid])[0]
            if hasattr(toks, "ids_to_tokens")
            else toks.ids_to_text([tid]),
            "seconds": f * seconds_per_frame,
        }
        for tid, f in zip(token_ids, frames)
    ]
    return {"text": text, "subwords": subwords}


def make_app(model, seconds_per_frame=0.08, executor="micro", **batcher_kw):
    """Build (handler_class, batcher) for an HTTP server over an already
    loaded ``model``.

    ``executor="continuous"`` serves through the lane-recycling
    :class:`~reazonspeech_tpu_torch.serving.ContinuousBatcher`; the default
    is the static :class:`MicroBatcher`."""
    if executor == "continuous":
        from .continuous import ContinuousBatcher

        batcher = ContinuousBatcher(model, **batcher_kw)
    else:
        batcher = MicroBatcher(model, **batcher_kw)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code, payload):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stats(self):
            stats = {"ok": True, "executor": executor}
            if isinstance(batcher, MicroBatcher):
                stats["batches"] = batcher.ticks
                stats["mean_batch"] = (
                    batcher.requests / batcher.ticks if batcher.ticks else 0.0)
            else:  # continuous executor
                stats.update(batcher.stats())
            stats["counters"] = profiling.counters()
            return stats

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, self._stats())
            elif self.path == "/metrics":  # Prometheus scrape target
                stats = self._stats()
                counters = stats.pop("counters")
                body = (_prometheus_text(stats) + _counters_text(counters)).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/transcribe", "/transcribe_stream"):
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                wav = _decode_audio_body(
                    body, self.headers.get("Content-Type", "")
                )
                if self.path == "/transcribe_stream":
                    self._stream(wav)
                    return
                # the continuous executor serves arbitrarily long audio by
                # windowing it over the lane pool (submit_long); the static
                # MicroBatcher buckets whole utterances
                submit = getattr(batcher, "submit_long", batcher.submit)
                tokens, frames = submit(wav).result(timeout=600)
                self._send(200, _result_json(model, tokens, frames,
                                             seconds_per_frame))
            except queue.Full as e:  # lane-pool backpressure: shed load
                self.send_response(503)
                self.send_header("Retry-After", "1")
                payload = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            except Exception as e:
                self._send(500, {"error": str(e)})

        def _stream(self, wav):
            """Incremental results: one JSON line per decoded window as it
            completes (continuous executor only), client reads to EOF —
            the serving analogue of the v1 flavor's streaming generator."""
            stream = getattr(batcher, "stream", None)
            if stream is None:
                self._send(400, {"error": "streaming requires the "
                                          "continuous executor"})
                return
            # stream() submits eagerly, so backpressure (queue.Full -> 503
            # via do_POST) and validation errors (-> 500) surface HERE,
            # before the 200 status line is committed
            gen = stream(wav)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            try:
                for tokens, frames in gen:
                    line = json.dumps(
                        _result_json(model, tokens, frames,
                                     seconds_per_frame),
                        ensure_ascii=False)
                    self.wfile.write(line.encode() + b"\n")
                    self.wfile.flush()
            except Exception:
                # the 200 is already on the wire — a fresh status line would
                # corrupt the reply; signal failure by truncating the body
                # (no Content-Length on NDJSON, so the client sees the cut)
                self.close_connection = True

    return Handler, batcher


def make_avsr_app(model, tokenizer=None, **batcher_kw):
    """HTTP handler over the AVSR micro-batcher (:mod:`.avsr`).

    The AVSR flavor serves through its OWN static micro-batcher: seq2seq
    beam generate carries no per-frame survivor state, so it does not fit
    the transducer lane-recycling model the continuous executor is built on
    (the loop it batches is the reference's per-utterance ``generate``,
    pkg/avsr/src/avhubert/modeling_avhubert.py:330-391).

    POST /transcribe body formats:
      - WAV or raw float32 PCM16k (``application/octet-stream``):
        audio-only AVSR — log-fbank 26×4 features extracted server-side;
      - ``application/x-npz``: ``np.savez`` archive with ``audio``
        ([T, 104] stacked features) and/or ``video`` ([T, 88, 88]
        normalized mouth ROIs) — pre-extracted, since mouth-ROI cropping
        needs client-side landmarks.

    Returns ``{"token_ids": [...], "text": "..."}`` (text only when a
    tokenizer is available).
    """
    import io

    from ..avsr.feature_extraction import AVHubertFeatureExtractor
    from .avsr import AVSRBatcher

    fe = AVHubertFeatureExtractor()
    batcher = AVSRBatcher(model, **batcher_kw)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code, payload):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            stats = {"ok": True, "flavor": "avsr", "executor": "avsr-micro",
                     "ticks": batcher.ticks}
            if self.path == "/healthz":
                self._send(200, stats)
            elif self.path == "/metrics":  # Prometheus scrape target
                body = _prometheus_text(stats).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/transcribe":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                audio = video = None
                if ctype.startswith("application/x-npz"):
                    arrs = np.load(io.BytesIO(body))
                    audio = arrs["audio"] if "audio" in arrs else None
                    video = arrs["video"] if "video" in arrs else None
                else:
                    audio = fe._extract_audio(_decode_audio_body(body, ctype))
                tokens = batcher.submit(audio=audio, video=video).result(timeout=600)
                payload = {"token_ids": list(map(int, tokens))}
                if tokenizer is not None:
                    payload["text"] = tokenizer.decode(tokens, skip_special_tokens=True)
                self._send(200, payload)
            except Exception as e:
                self._send(500, {"error": str(e)})

    return Handler, batcher


def _serve_until_shutdown(handler, batcher, host, port):
    """Run the server with a graceful-drain lifecycle: SIGTERM/SIGINT stop
    accepting, in-flight and queued requests complete (both batchers drain
    their queues on close()), then exit 0."""
    server = ThreadingHTTPServer((host, port), handler)
    # handler threads must be joinable (not daemons) so server_close()
    # waits for in-flight responses before the batcher dies
    server.daemon_threads = False

    # shutdown() must come from another thread or it deadlocks serve_forever
    import signal
    import threading

    def _drain(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    except ValueError:
        pass  # not the main thread (embedded/test use): caller owns signals
    try:
        server.serve_forever()
    finally:
        server.server_close()  # joins in-flight handler threads
        batcher.close()


def serve(model, host="0.0.0.0", port=8080, seconds_per_frame=0.08,
          executor="micro", warmup_seconds=None, **batcher_kw):
    """Serve ``model`` until interrupted (graceful drain on SIGTERM)."""
    handler, batcher = make_app(model, seconds_per_frame, executor,
                                **batcher_kw)
    if warmup_seconds and hasattr(batcher, "warmup"):
        shapes = batcher.warmup(warmup_seconds)
        print(f"warmed {len(shapes)} serving shapes: {shapes}", flush=True)
    _serve_until_shutdown(handler, batcher, host, port)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--flavor", default="nemo", choices=("nemo", "espnet", "k2", "avsr"))
    ap.add_argument("--checkpoint", default=None,
                    help="converted checkpoint, or \"random\" for random weights (default: "
                         "the flavor's resolution order)")
    ap.add_argument("--decoding", default=None,
                    help="decode strategy override (flavor default when omitted): nemo "
                         "alsd|greedy, espnet beam|maes|alsd|greedy, k2 greedy|beam")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--continuous", action="store_true",
                    help="lane-recycling continuous batching (higher goodput under "
                         "mixed-length load)")
    ap.add_argument("--lanes", type=int, default=32,
                    help="continuous executor lane-pool width")
    ap.add_argument("--frames-per-segment", type=int, default=32,
                    help="continuous recycling quantum (frames/steps)")
    ap.add_argument("--max-seconds", type=float, default=20.0,
                    help="continuous executor lane window length (longer requests are "
                         "transparently windowed + merged)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="shed load (HTTP 503) beyond this many queued requests; "
                         "0 = unbounded")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="split the continuous lane pool over the first N CUDA devices")
    ap.add_argument("--warmup", type=float, default=0.0, metavar="SECONDS",
                    help="run the serving shapes once before binding the port (micro: every "
                         "batch bucket at this request length; continuous: one request of "
                         "it) so first requests find everything built")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="build directory of the CUDA kernel and native libraries (default "
                         "$REAZONSPEECH_TPU_COMPILE_CACHE, else build/ beside the package): a "
                         "restart loads them from there instead of compiling them again")
    args = ap.parse_args(argv)

    if args.flavor == "avsr" and args.continuous:
        # AVSR serves through its own static micro-batcher: seq2seq generate
        # has no lane-recycling analogue
        ap.error("--continuous is not supported for --flavor avsr "
                 "(seq2seq generate has no lane-recycling analogue)")
    mesh = None
    if args.mesh_data:
        if not args.continuous:
            ap.error("--mesh-data splits the continuous executor's lane pool; add --continuous")
        from ..parallel.mesh import make_mesh

        try:  # before the load: a missing card fails fast
            mesh = make_mesh(n_data=args.mesh_data)  # the first N CUDA devices
        except ValueError as e:
            ap.error(f"--mesh-data {args.mesh_data}: {e}")
        print(f"mesh: {mesh}", flush=True)
    cache_dir = enable_compile_cache(args.compile_cache)
    if cache_dir:
        print(f"compile cache: {cache_dir}", flush=True)
    model = _load_flavor(args.flavor, args.checkpoint, args.decoding)
    if args.flavor == "avsr":
        print(f"serving avsr on {args.host}:{args.port} ({model.device})", flush=True)
        handler, batcher = make_avsr_app(model, max_batch=args.max_batch,
                                         max_wait_ms=args.max_wait_ms)
        if args.warmup:
            shapes = batcher.warmup(args.warmup)
            print(f"warmed {len(shapes)} serving shapes: {shapes}", flush=True)
        _serve_until_shutdown(handler, batcher, args.host, args.port)
        return
    spf = {"nemo": 0.08, "espnet": 0.04, "k2": 0.04}[args.flavor]
    print(f"serving {args.flavor} on {args.host}:{args.port} ({model.device})", flush=True)
    if args.continuous:
        serve(model, args.host, args.port, seconds_per_frame=spf, executor="continuous",
              warmup_seconds=args.warmup or None, n_lanes=args.lanes,
              frames_per_segment=args.frames_per_segment, max_seconds=args.max_seconds,
              max_pending=args.max_pending or None, mesh=mesh)
    else:
        serve(model, args.host, args.port, seconds_per_frame=spf,
              warmup_seconds=args.warmup or None, max_batch=args.max_batch,
              max_wait_ms=args.max_wait_ms)


if __name__ == "__main__":
    main()
