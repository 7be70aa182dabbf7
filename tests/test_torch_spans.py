"""The port's spans and counters (``utils.profiling``) on the CPU: the ALSD
loop's ``decode`` tree and its step and check counts, the nemo entry's
``entry`` tree, the ``rs.<name>`` ranges under ``torch.profiler`` on the
store's clock, no ``record_function`` without a profiler, the bounded ring,
per-thread parents, the kernel launch counters as a view of the store, the
counters on /healthz and /metrics, and the serving executor's
``serve.segment`` spans."""

import http.client
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from reazonspeech_tpu_torch import ops
from reazonspeech_tpu_torch.core.interface import AudioData
from reazonspeech_tpu_torch.decoding import rnnt_beam
from reazonspeech_tpu_torch.decoding.rnnt_beam import (
    CHECK_EVERY, BeamDecodeConfig, alsd_step_bound, rnnt_beam_decode,
)
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig, init_joint, init_predictor
from reazonspeech_tpu_torch.nemo.asr.model import load_model
from reazonspeech_tpu_torch.nemo.asr.transcribe import transcribe_batch
from reazonspeech_tpu_torch.serving import http as port_http
from reazonspeech_tpu_torch.utils import profiling
from reazonspeech_tpu_torch.utils.profiling import Store

SR = 16000
DECODE_CHILDREN = ("decode.setup", "decode.dispatch", "decode.check", "decode.select")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the serving case's executor thread starts
    an OpenMP team of its own beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_decoder():
    cfg = RNNTConfig.tiny(compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return init_predictor(gen, cfg), init_joint(gen, cfg), cfg


@pytest.fixture(scope="module")
def tiny_model():
    enc = FastConformerConfig.tiny(compute_dtype="float32")
    rnnt = RNNTConfig.tiny(enc_dim=enc.d_model, compute_dtype="float32")
    return load_model("cpu", checkpoint="random", enc_cfg=enc, rnnt_cfg=rnnt)


def _tree(root_id, spans):
    """{name: [spans]} of the spans under the root ``root_id``, in start order."""
    out = {}
    for sp in sorted(spans, key=lambda s: s.start_ns):
        if sp.root == root_id:
            out.setdefault(sp.name, []).append(sp)
    return out


def _expected_steps(lengths, t, cfg):
    """The loop's arithmetic: blocks of CHECK_EVERY bodies up to the bound,
    until every element has spent its budget T + int(alsd_max_target_len·T)."""
    budget = max(n + int(cfg.alsd_max_target_len * n) for n in lengths)
    bound, steps = alsd_step_bound(t, cfg), 0
    while steps < bound:
        steps += min(CHECK_EVERY, bound - steps)
        if steps >= budget:
            break
    return steps


def _decode(tiny_decoder, lengths, t=40, seed=1):
    pred, joint, cfg = tiny_decoder
    enc = torch.randn(len(lengths), t, cfg.enc_dim, generator=torch.Generator().manual_seed(seed))
    return rnnt_beam_decode(pred, joint, enc, torch.tensor(lengths), cfg, BeamDecodeConfig())


@pytest.mark.parametrize("lengths", [[40, 40], [30, 5], [10, 3], [17]])
def test_decode_root_and_counts(tiny_decoder, lengths, monkeypatch):
    """One ``decode`` root a call; its four kinds of children nest in it and
    share its root id; ``steps`` is the bodies dispatched, ``checks`` one a block
    of CHECK_EVERY, and the counters add the same."""
    bodies = []
    make_body = rnnt_beam._make_body

    def counting_body(*args, **kwargs):
        body = make_body(*args, **kwargs)

        def step(state):
            bodies.append(1)
            return body(state)

        return step

    monkeypatch.setattr(rnnt_beam, "_make_body", counting_body)
    profiling.reset()
    _decode(tiny_decoder, lengths)
    spans = profiling.spans()
    roots = [sp for sp in spans if sp.parent is None]
    assert [sp.name for sp in roots] == ["decode"]
    root = roots[0]
    want = _expected_steps(lengths, 40, BeamDecodeConfig())
    assert root.attrs == {"steps": want, "checks": -(-want // CHECK_EVERY),
                          "max_steps": alsd_step_bound(40, BeamDecodeConfig()),
                          "graph_steps": 0}  # on the CPU every body is eager
    assert len(bodies) == want
    if max(lengths) < 40:
        assert want < root.attrs["max_steps"]  # the loop stopped early
    tree = _tree(root.id, spans)
    assert set(tree) == {"decode", *DECODE_CHILDREN}
    assert len(tree["decode.dispatch"]) == len(tree["decode.check"]) == root.attrs["checks"]
    assert len(tree["decode.setup"]) == len(tree["decode.select"]) == 1
    for name in DECODE_CHILDREN:
        for sp in tree[name]:
            assert sp.parent == root.id
            assert root.start_ns <= sp.start_ns <= sp.end_ns <= root.end_ns
    order = [sp.name for sp in sorted(spans, key=lambda s: s.start_ns) if sp.parent == root.id]
    assert order == (["decode.setup"] + ["decode.dispatch", "decode.check"] * root.attrs["checks"]
                     + ["decode.select"])
    assert profiling.counters() == {"decode.steps": want, "decode.checks": root.attrs["checks"]}


def test_transcribe_batch_records_the_entry_tree(tiny_model):
    """``entry`` (utterances, audio seconds) over prepare, forward and
    results; the forward holds the copy in, the three layers and the copy out."""
    rng = np.random.default_rng(0)
    audios = [AudioData((rng.standard_normal(int(SR * s)) * 0.1).astype(np.float32), SR)
              for s in (1.0, 2.5)]
    profiling.reset()
    transcribe_batch(tiny_model, audios)
    spans = profiling.spans()
    roots = [sp for sp in spans if sp.parent is None]
    assert [sp.name for sp in roots] == ["entry"]
    root = roots[0]
    assert root.attrs == {"utterances": 2, "audio_s": pytest.approx(3.5)}
    tree = _tree(root.id, spans)
    assert all(len(v) == 1 for k, v in tree.items() if k != "decode.dispatch"
               and k != "decode.check")
    kids = lambda sp: [s.name for s in sorted(spans, key=lambda s: s.start_ns)  # noqa: E731
                       if s.parent == sp.id]
    assert kids(root) == ["entry.prepare", "entry.forward", "entry.results"]
    forward = tree["entry.forward"][0]
    assert kids(forward) == ["entry.copy_in", "frontend", "encoder", "decode", "entry.copy_out"]
    assert set(kids(tree["decode"][0])) == set(DECODE_CHILDREN)
    assert all(sp.root == root.id for v in tree.values() for sp in v)
    assert len(spans) == sum(len(v) for v in tree.values())


def test_ranges_under_the_profiler_share_the_store_clock(tiny_decoder):
    """Under a CPU ``torch.profiler`` every span is the range ``rs.<name>``,
    and its ``time_ns`` stamps bracket the range on the profiler's clock
    (the trace's start plus the event's offset)."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(tiny_decoder, [30, 5])
    spans = profiling.spans()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith("rs."):
            events.setdefault(e.name, []).append(e)
    assert set(events) == {"rs." + sp.name for sp in spans}
    for name, evs in events.items():
        mine = sorted((sp for sp in spans if "rs." + sp.name == name), key=lambda s: s.start_ns)
        evs.sort(key=lambda e: e.time_range.start)
        assert len(mine) == len(evs)
        for sp, e in zip(mine, evs):
            assert sp.start_ns <= t0 + e.time_range.start * 1e3
            assert t0 + e.time_range.end * 1e3 <= sp.end_ns


def test_no_record_function_without_a_profiler(tiny_decoder, monkeypatch):
    """With no profiler running a span enters no ``record_function``: the
    decode runs with it replaced by one that raises (and, under a profiler,
    that replacement is what a span would enter)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    profiling.reset()
    _decode(tiny_decoder, [10, 3])
    assert len(profiling.spans()) == 3 + 2 * 1  # decode, setup, select; one block
    from torch.profiler import ProfilerActivity, profile

    with pytest.raises(AssertionError, match="rs.decode"):
        with profile(activities=[ProfilerActivity.CPU]):
            _decode(tiny_decoder, [10, 3])


def test_ring_is_bounded_and_reset_takes_a_snapshot():
    store = Store(capacity=8)
    for i in range(20):
        with store.span("s", i=i):
            pass
    store.count("launch.a", 3)
    store.count("other")
    kept = store.spans()
    assert [sp.attrs["i"] for sp in kept] == list(range(12, 20))
    assert len({sp.id for sp in kept}) == 8 and all(sp.parent is None for sp in kept)
    assert store.reset("launch.") == ([], {"launch.a": 3})
    assert store.counters() == {"other": 1} and len(store.spans()) == 8
    got, counted = store.reset()
    assert len(got) == 8 and counted == {"other": 1}
    assert store.spans() == [] and store.counters() == {}


def test_threads_keep_separate_parents():
    """A span open on one thread is no parent of a span on another; spans
    opened by many threads at once keep their own trees and lose no count
    (a shortened switch interval forces interleaving)."""
    import sys

    store = Store()
    n_threads, n_calls = 8, 200
    gate = threading.Barrier(n_threads)

    def work(k):
        with store.span("outer", k=k):
            gate.wait(timeout=30)
            for _ in range(n_calls):
                with store.span("inner", k=k):
                    store.count("calls")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = store.spans()
    outer = {sp.attrs["k"]: sp for sp in spans if sp.name == "outer"}
    assert len(outer) == n_threads and all(sp.parent is None for sp in outer.values())
    inner = [sp for sp in spans if sp.name == "inner"]
    assert len(inner) == n_threads * n_calls
    for sp in inner:
        up = outer[sp.attrs["k"]]
        assert sp.parent == up.id and sp.root == up.id and sp.thread == up.thread
    assert store.counters() == {"calls": n_threads * n_calls}


def test_launch_counts_are_a_view_of_the_store(monkeypatch):
    from reazonspeech_tpu_torch.ops import _kernels

    class _Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_kernels, "load_library", lambda: _Lib())
    profiling.reset()
    profiling.count("decode.steps", 5)
    for _ in range(3):
        _kernels.launch("rs_topm_logsoftmax")
    _kernels.launch("rs_ln_dense")
    counts = ops.launch_counts()
    assert set(counts) == set(ops.KERNELS)
    assert counts["topm_logsoftmax"] == 3 and counts["ln_dense"] == 1
    assert sum(counts.values()) == 4
    assert profiling.counters() == {"decode.steps": 5, "launch.topm_logsoftmax": 3,
                                    "launch.ln_dense": 1}
    ops.reset_launch_counts()
    assert sum(ops.launch_counts().values()) == 0
    assert profiling.counters() == {"decode.steps": 5}


def test_counters_text():
    text = port_http._counters_text({"launch.ln_dense": 96, "decode.steps": 800})
    assert text == ('reazonspeech_count_total{name="decode.steps"} 800\n'
                    'reazonspeech_count_total{name="launch.ln_dense"} 96\n')
    assert port_http._counters_text({}) == ""


@pytest.mark.parametrize("executor", ["micro", "continuous"])
def test_healthz_and_metrics_report_the_counters(tiny_model, executor):
    """Both executors' /healthz carry the store's counters and /metrics
    renders them; the continuous executor records a ``serve.segment`` span
    for each segment it dispatches."""
    kw = dict(n_lanes=2, frames_per_segment=8, max_seconds=4.0) if executor == "continuous" \
        else dict(max_batch=2, max_wait_ms=5.0)
    handler, batcher = port_http.make_app(tiny_model, executor=executor, **kw)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def get(path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("POST" if body is not None else "GET", path, body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    try:
        profiling.reset()
        wav = (np.random.default_rng(1).standard_normal(SR) * 0.1).astype(np.float32)
        assert get("/transcribe", wav.tobytes())[0] == 200
        status, data = get("/healthz")
        import json

        health = json.loads(data)
        assert status == 200 and health["counters"]["decode.steps"] > 0
        status, data = get("/metrics")
        text = data.decode()
        assert status == 200
        steps = [ln for ln in text.splitlines()
                 if ln.startswith('reazonspeech_count_total{name="decode.steps"} ')]
        assert len(steps) == 1 and int(steps[0].split()[-1]) > 0
        assert "reazonspeech_counters" not in text
        if executor == "continuous":
            segments = [sp for sp in profiling.spans() if sp.name == "serve.segment"]
            assert len(segments) == batcher.segments > 0
            assert all(sp.end_ns >= sp.start_ns for sp in segments)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
