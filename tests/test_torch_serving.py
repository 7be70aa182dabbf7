"""The port's serving executors on the CPU, after the JAX package's
``tests/test_continuous_serving.py`` and ``tests/test_serving.py``: every
request through ``MicroBatcher`` or the lane-recycling ``ContinuousBatcher``
(Graves beam 4 on espnet, ALSD beam 4 and greedy on nemo, greedy on k2)
must decode to exactly what a dedicated ``decode_single`` of it gives under
the pool's emission cap (tiny fp32 models, random weights from a seed; the
espnet joint's blank raised as in ``tests/test_torch_espnet.py``). Also
long audio windowed over the pool, streaming, load shedding, ``stats``
against the JAX executor's own, the host lane clock against the encoder's
lengths, fault recovery, and the configurations it refuses."""

import queue
import threading
import types
from dataclasses import replace

import numpy as np
import pytest
import torch

from reazonspeech_tpu.serving import continuous as jax_continuous
from reazonspeech_tpu_torch.decoding.transducer_maes import MAESBeamConfig
from reazonspeech_tpu_torch.espnet.asr.model import encode_ctc
from reazonspeech_tpu_torch.espnet.asr.model import load_model_container as load_espnet
from reazonspeech_tpu_torch.k2.asr.model import load_model_container as load_k2
from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
from reazonspeech_tpu_torch.models.zipformer import ZipformerConfig
from reazonspeech_tpu_torch.nemo.asr.model import load_model as load_nemo
from reazonspeech_tpu_torch.serving import ContinuousBatcher, MicroBatcher, continuous

SR = 16000
JOINT_BLANK_BIAS = 2.5  # tests/test_torch_espnet.py's: frames end by ESPnet's test


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
def models():
    """{name: container}: espnet Graves beam 4, nemo ALSD beam 4 and greedy,
    k2 greedy; tiny, fp32, on the CPU."""
    espnet = load_espnet(checkpoint="random", device="cpu", decoding="beam", beam_size=4,
                         enc_cfg=espnet_encoder_config(num_layers=2, d_model=32, num_heads=4,
                                                       subsampling_channels=32,
                                                       compute_dtype="float32"))
    espnet.params["joint"]["out"]["b"][0] += JOINT_BLANK_BIAS
    enc = FastConformerConfig.tiny(compute_dtype="float32")
    rnnt = RNNTConfig.tiny(enc_dim=enc.d_model, compute_dtype="float32")
    nemo = load_nemo("cpu", checkpoint="random", enc_cfg=enc, rnnt_cfg=rnnt, beam_size=4)
    nemo_greedy = load_nemo("cpu", checkpoint="random", enc_cfg=enc, rnnt_cfg=rnnt,
                            decoding="greedy")
    k2 = load_k2(checkpoint="random", device="cpu",
                 enc_cfg=ZipformerConfig.tiny(compute_dtype="float32"))
    return {"espnet": espnet, "nemo": nemo, "nemo_greedy": nemo_greedy, "k2": k2}


def _mixed_wavs(n, seed=0, seconds=(0.4, 0.9, 1.3, 2.1)):
    """n noise waveforms of lengths drawn from ``seconds``."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(SR * rng.choice(seconds))) * 0.1).astype(np.float32)
            for _ in range(n)]


def _dedicated(model, batcher, wav):
    """decode_single under the executor's shared emission cap."""
    capped = replace(model, decode_cfg=replace(model.decode_cfg,
                                               max_tokens=batcher.cfg.max_tokens))
    return capped.decode_single(wav)


def _serve(batcher, wavs):
    try:
        return [f.result(timeout=300) for f in [batcher.submit(w) for w in wavs]]
    finally:
        batcher.close()


def test_bucket_samples_on_the_containers(models):
    """Each container carries its padding grid, as the JAX containers do:
    2 s for espnet, 4 s for nemo and k2; both batchers take it."""
    for name, want in (("espnet", 2), ("nemo", 4), ("k2", 4)):
        assert type(models[name]).bucket_samples == want * SR
        micro = MicroBatcher(models[name])
        micro.close()
        assert micro.bucket_samples == want * SR
    pool = ContinuousBatcher(models["espnet"], n_lanes=2, max_seconds=3.0)
    pool.close()
    assert pool.max_samples == 4 * SR  # 3 s rounds up on the 2 s grid


@pytest.mark.parametrize("name", ["espnet", "nemo", "k2"])
def test_microbatcher_matches_decode_single(models, name):
    """Concurrent requests coalesced into padded batches: each equals its
    decode_single; the batches of requests under 2 s pad to the container's
    grid (espnet's 2 s, as its decode_single pads them)."""
    model = models[name]
    wavs = _mixed_wavs(5, seed=3, seconds=(0.4, 0.9, 1.3))
    micro = MicroBatcher(model, max_batch=4, max_wait_ms=50.0)
    got = _serve(micro, wavs)
    for w, g in zip(wavs, got):
        assert g == model.decode_single(w)
    assert micro.requests == 5 and micro.largest_batch > 1
    grid = 2 * SR if name == "espnet" else 4 * SR
    assert {s for _, s in micro.batch_shapes} == {grid}


@pytest.mark.parametrize("name,lanes,quantum", [
    ("espnet", 3, 4), ("nemo", 3, 8), ("nemo_greedy", 2, 8), ("k2", 2, 8)])
def test_continuous_matches_dedicated_decode(models, name, lanes, quantum):
    """Mixed-length traffic over a small pool (8 requests, more than the
    lanes: saturation and lane reuse): tokens and frames equal."""
    model = models[name]
    pool = ContinuousBatcher(model, n_lanes=lanes, frames_per_segment=quantum, max_seconds=4.0,
                             max_encode_batch=2)
    # Graves pops every frame a few times over: shorter requests for espnet
    wavs = _mixed_wavs(8, seed=7, seconds=(0.4, 0.9, 1.3) if name == "espnet" else
                       (0.4, 0.9, 1.3, 2.1))
    got = _serve(pool, wavs)
    for i, (w, g) in enumerate(zip(wavs, got)):
        assert g == _dedicated(model, pool, w), i
    assert pool.segments > 0 and pool.encode_ticks >= 4
    assert pool.busy_lanes() == 0
    assert sum(len(t) for t, _ in got) > 0


def test_microbatcher_warmup_and_fixed_shape(models):
    """warmup runs every batch shape; fixed_shape pads every tick to it and
    refuses longer requests."""
    model = models["nemo"]
    micro = MicroBatcher(model, max_batch=4)
    try:
        assert micro.warmup() == [(1, 4 * SR), (2, 4 * SR), (4, 4 * SR)]
    finally:
        micro.close()
    fixed = MicroBatcher(model, fixed_shape=(2, 4 * SR))
    try:
        w = _mixed_wavs(1, seed=5)[0]
        assert fixed.transcribe(w) == model.decode_single(w)
        with pytest.raises(ValueError, match="fixed dispatch shape"):
            fixed.submit(np.zeros(5 * SR, np.float32)).result(timeout=60)
    finally:
        fixed.close()
    assert fixed.batch_shapes == {(2, 4 * SR)} and fixed.ticks == 1


def test_warmup_then_serves(models):
    pool = ContinuousBatcher(models["nemo"], n_lanes=2, frames_per_segment=8, max_seconds=4.0)
    try:
        assert pool.warmup((1.0, 9.0)) == [(1, SR), (1, 4 * SR)]
        w = _mixed_wavs(1, seed=21)[0]
        assert pool.transcribe(w) == _dedicated(models["nemo"], pool, w)
    finally:
        pool.close()


def test_submit_long_merges_windows_and_stream_equals_it(models):
    """A 10 s request over a 4 s window pool resolves to the centre-keep
    merge of its windows replayed through the same pool, frames on one
    global grid; stream() yields the same, incrementally; short audio is one
    plain submit."""
    pool = ContinuousBatcher(models["nemo"], n_lanes=3, frames_per_segment=8, max_seconds=4.0)
    try:
        rng = np.random.default_rng(23)
        w = (rng.standard_normal(SR * 10) * 0.1).astype(np.float32)
        got = pool.submit_long(w, overlap_seconds=1.0).result(timeout=300)
        starts, chunk, overlap = pool._window_plan(len(w), 1.0)
        assert len(starts) > 1
        want_t, want_f = [], []
        for i, s in enumerate(starts):
            toks, frs = pool._window_keep(*pool.transcribe(w[s:s + chunk]), i=i, start=s,
                                          starts=starts, chunk=chunk, overlap=overlap,
                                          w_len=len(w))
            want_t += toks
            want_f += frs
        assert got == (want_t, want_f)
        assert got[1] == sorted(got[1])
        parts = list(pool.stream(w, overlap_seconds=1.0))
        assert len(parts) == len(starts)
        assert (sum((p[0] for p in parts), []), sum((p[1] for p in parts), [])) == got
        short = _mixed_wavs(1, seed=37, seconds=(1.3,))[0]
        assert list(pool.stream(short)) == [pool.transcribe(short)]
        assert pool.submit_long(short).result(timeout=300) == pool.transcribe(short)
        with pytest.raises(ValueError, match="overlap_seconds"):
            pool.submit_long(np.zeros(SR * 9, np.float32), overlap_seconds=4.0)
    finally:
        pool.close()


def test_max_pending_sheds_load_and_stats(models):
    """Beyond max_pending queued requests submit raises queue.Full; every
    accepted request still equals its dedicated decode; stats() equals the
    JAX executor's stats() on the same counters."""
    model = models["espnet"]
    pool = ContinuousBatcher(model, n_lanes=1, frames_per_segment=8, max_seconds=2.0,
                             max_pending=2)
    try:
        accepted, shed = [], 0
        for w in _mixed_wavs(10, seed=41, seconds=(0.6,)):
            try:
                accepted.append((w, pool.submit(w)))
            except queue.Full:
                shed += 1
        results = [(w, f.result(timeout=300)) for w, f in accepted]
        stats = pool.stats()
        fields = ("segments", "encode_ticks", "_queue", "n_lanes", "busy_lane_segments",
                  "requests_done", "latencies", "_lat_lock")
        want = jax_continuous.ContinuousBatcher.stats(
            types.SimpleNamespace(**{f: getattr(pool, f) for f in fields}))
    finally:
        pool.close()
    assert shed > 0 and accepted
    for w, got in results:
        assert got == _dedicated(model, pool, w)
    assert stats == want
    assert stats["requests_done"] == len(accepted) and 0 < stats["lane_occupancy"] <= 1
    assert stats["latency_s"]["p99"] >= stats["latency_s"]["p50"] > 0


@pytest.mark.parametrize("name", ["espnet", "nemo", "k2"])
def test_host_frames_match_device_lengths(models, name):
    """The host lane clock equals the encoder lengths the device reports
    (decode_batch; espnet's encoder pass alone, its Graves decode being the
    slow part), for assorted sample counts: no readback, so correctness
    hinges on it."""
    model = models[name]
    pool = ContinuousBatcher(model, n_lanes=1, max_seconds=4.0)
    pool.close()
    ns = (1600, 6400, 16000, 16001, 31999, 48000)
    buf = np.zeros((len(ns), 64000), np.float32)
    lens = np.array(ns, np.int32)
    if name == "espnet":
        _, elens = encode_ctc(model.params, torch.from_numpy(buf), torch.from_numpy(lens),
                              model.fe_cfg, model.enc_cfg)
        elens = elens.numpy()
    else:
        *_, elens = model.decode_batch(buf, lens)
    assert [pool.host_frames(n) for n in ns] == elens.tolist()
    assert pool.t_buf == pool.host_frames(pool.max_samples)
    spf = pool.seconds_per_frame()
    assert spf == pytest.approx(32.0 / (pool.host_frames(48 * SR) - pool.host_frames(16 * SR)))


def test_fault_recovery_reinitializes_device_state(models):
    """A fault mid-traffic fails the in-flight requests, and the pool then
    serves correct results on a fresh device state."""
    model = models["espnet"]
    pool = ContinuousBatcher(model, n_lanes=2, frames_per_segment=4, max_seconds=4.0)
    try:
        real = pool._ad.segment_call
        calls = {"n": 0}

        def flaky(*args):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected device fault")
            return real(*args)

        pool._ad.segment_call = flaky
        failed = 0
        for f in [pool.submit(w) for w in _mixed_wavs(4, seed=7, seconds=(0.4, 0.9))]:
            try:
                f.result(timeout=300)
            except RuntimeError as e:
                assert "injected device fault" in str(e)
                failed += 1
        assert failed >= 1
        for w in _mixed_wavs(3, seed=11, seconds=(0.4, 0.9)):
            assert pool.submit(w).result(timeout=300) == _dedicated(model, pool, w)
        assert calls["n"] > 2
    finally:
        pool.close()


@pytest.mark.parametrize("where", ["encode", "segment_after_harvest"])
def test_fault_fails_requests_held_by_the_tick(models, monkeypatch, where):
    """A fault in the encode (its requests are off the queue, not yet in a
    lane) or in a segment on a tick that harvested a lane (freed, its result
    not yet read) fails every submitted request; none is left waiting. The
    fault waits until all are submitted, so each is in the tick, a lane or
    the queue when it strikes. The pool then serves again."""
    model = models["nemo_greedy"]
    submitted = threading.Event()
    pool = ContinuousBatcher(model, n_lanes=2, frames_per_segment=4, max_seconds=4.0)
    try:
        if where == "encode":
            real = continuous._proj_from_wav
            calls = {"n": 0}

            def flaky(*args):
                calls["n"] += 1
                if calls["n"] == 1:
                    submitted.wait(60)
                    raise RuntimeError("injected device fault")
                return real(*args)

            monkeypatch.setattr(continuous, "_proj_from_wav", flaky)
        else:
            real_fin, real_seg = pool._ad.finalize_call, pool._ad.segment_call
            harvested = {"n": 0}

            def fin(*args):
                harvested["n"] += 1
                return real_fin(*args)

            def seg(*args):
                if harvested["n"] == 1:
                    harvested["n"] += 1
                    submitted.wait(60)
                    raise RuntimeError("injected device fault")
                return real_seg(*args)

            pool._ad.finalize_call, pool._ad.segment_call = fin, seg
        futs = [pool.submit(w) for w in _mixed_wavs(4, seed=7, seconds=(0.4, 0.9))]
        submitted.set()
        for f in futs:
            with pytest.raises(RuntimeError, match="injected device fault"):
                f.result(timeout=120)
        w = _mixed_wavs(1, seed=11)[0]
        assert pool.submit(w).result(timeout=120) == _dedicated(model, pool, w)
        assert pool.busy_lanes() == 0
    finally:
        pool.close()


def test_refusals(models):
    """A mesh= the lanes do not divide over, other decode configs and
    overlong utterances are refused; a closed pool has drained. An mAES
    container is served (its adapter; its answers are held in
    tests/test_torch_maes.py; the mesh's in
    tests/test_torch_parallel_serving.py)."""
    espnet = models["espnet"]
    pool = ContinuousBatcher(replace(espnet, decode_cfg=MAESBeamConfig(beam_size=4)), n_lanes=1)
    assert type(pool._ad).__name__ == "_MAESAdapter"
    pool.close()
    from reazonspeech_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="must divide over the mesh data axis"):
        ContinuousBatcher(espnet, n_lanes=3, mesh=make_mesh(4, devices=["cpu"] * 4))
    with pytest.raises(TypeError, match="decode_cfg"):
        ContinuousBatcher(replace(espnet, decode_cfg=object()))
    pool = ContinuousBatcher(espnet, n_lanes=1, max_seconds=2.0)
    try:
        with pytest.raises(ValueError, match="max_seconds"):
            pool.submit(np.zeros(3 * SR, np.float32)).result(timeout=60)
    finally:
        pool.close()
    assert not pool._thread.is_alive() and pool.busy_lanes() == 0


def test_executor_runs_on_its_own_thread_in_inference_mode(models):
    """The executor's device work runs on its own thread, under inference
    mode (per thread in torch), whatever the caller's mode."""
    model = models["nemo_greedy"]
    seen = []
    pool = ContinuousBatcher(model, n_lanes=1, frames_per_segment=8, max_seconds=2.0)
    real = pool._ad.segment_call

    def spy(*args):
        seen.append(torch.is_inference_mode_enabled())
        return real(*args)

    pool._ad.segment_call = spy
    try:
        w = _mixed_wavs(1, seed=2)[0]
        assert pool.transcribe(w) == _dedicated(model, pool, w)
    finally:
        pool.close()
    assert seen and all(seen) and not torch.is_inference_mode_enabled()


def test_concurrent_submitters_and_stats(models):
    """More submitting threads than cores, stats() read all the while and a
    short switch interval: every request resolves to its dedicated decode,
    and the counters add up (a lost update would break them)."""
    import os
    import sys
    import threading

    model = models["nemo_greedy"]
    n = (os.cpu_count() or 4) + 2
    wavs = _mixed_wavs(n, seed=17, seconds=(0.4, 0.9))
    pool = ContinuousBatcher(model, n_lanes=3, frames_per_segment=8, max_seconds=2.0)
    got, polls, done = [None] * n, [0], threading.Event()

    def submit(i):
        got[i] = pool.submit(wavs[i]).result(timeout=300)

    def poll():
        while not done.is_set():
            pool.stats()
            polls[0] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        poller = threading.Thread(target=poll)
        poller.start()
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        done.set()
        poller.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        pool.close()
    assert not any(t.is_alive() for t in threads) and not poller.is_alive()
    assert polls[0] > 0
    for w, g in zip(wavs, got):
        assert g == _dedicated(model, pool, w)
    stats = pool.stats()
    assert stats["requests_done"] == n == len(pool.latencies)
    assert pool.busy_lane_segments <= pool.segments * pool.n_lanes
