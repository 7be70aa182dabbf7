"""Continuous batching for the transducer serving paths (PyTorch).

The port of ``reazonspeech_tpu/serving/continuous.py``. The static
:class:`~.batcher.MicroBatcher` turns request concurrency into the batch
dimension, but a beam batch runs until its SLOWEST lane finishes: with
mixed-length traffic most lanes sit masked-idle for the tail of every batch.
This executor removes that bound with lane recycling over a segmented
decode: the decoder state is a fixed pool of ``n_lanes`` lanes, each with
its own clock; every tick advances all lanes by one quantum, finished lanes
are finalized and refilled from the request queue at once. A segment's body
has no cross-lane op, so each lane's result equals a dedicated decode of its
request: continuous batching is a scheduling change. Three decodes plug in
through one adapter seam:

- **Graves beam** (espnet, ``decoding/transducer_graves.py``): lanes are
  frame-clocked; the quantum is ``frames_per_segment`` encoder frames and a
  lane is done at ``fidx >= lane_len``, which the host knows.
- **mAES beam** (espnet ``decoding="maes"``,
  ``decoding/transducer_maes.py``): frame-clocked as Graves, a segment
  exactly ``frames_per_segment`` frame bodies; its ``fidx >= lane_len``
  also comes back through the lagged done flags (it has no done flag of
  its own).
- **ALSD beam** (nemo, ``decoding/rnnt_beam.py``): lanes are
  alignment-step-clocked; completion is data-dependent (the beam can die
  before the ``lane_len + floor(ratio·lane_len)`` step bound), so the
  device's per-lane ``done`` flag is read one tick behind, with the bound as
  the fallback.
- **Greedy** (k2 and the nemo/espnet ``decoding="greedy"`` option,
  ``decoding/rnnt_greedy.py``): lanes are loop-iteration-clocked, with the
  same lagged ``done`` flag and ``lane_len + emission_cap`` as the bound.

Device interaction:

- the lane clocks are mirrored on the host by the device loop's own
  arithmetic, so scheduling reads nothing back from the card;
- the executor thread does its device work in inference mode; each lane
  group (the whole pool, or one per entry of a mesh's data axis) on a CUDA
  stream of its own (so the kernels' per-stream workspaces, and the
  allocator's blocks, are never shared with a decode on another thread);
- host arrays go to the card through pinned buffers that are made afresh
  for each copy and never written again;
- the finalized outputs and the lagged ``done`` flags come back through
  pinned memory, copied and fenced by an event BEFORE the next segment is
  dispatched, and read after it: the reads overlap the segment;
- new requests are encoded in one frontend → encoder → joint-projection
  pass per tick (at one fixed shape by default) and written into the
  per-lane ring of projections; the pad rows are filtered on the host, and
  every real write covers the lane's whole ``t_buf`` rows;
- the host's dispatch of each segment is the span ``serve.segment`` of
  ``utils.profiling``.
"""

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import replace

import numpy as np
import torch

from ..decoding.rnnt_beam import (
    BeamDecodeConfig, alsd_finalize, alsd_segment, alsd_state_init, alsd_step_bound,
)
from ..decoding.rnnt_greedy import (
    GreedyDecodeConfig, greedy_finalize, greedy_segment, greedy_state_init, greedy_step_bound,
)
from ..decoding.transducer_graves import (
    GravesBeamConfig, graves_beam_segment, graves_finalize, graves_state_init,
)
from ..decoding.transducer_maes import (
    MAESBeamConfig, maes_beam_segment, maes_finalize, maes_state_init,
)
from ..device import host_to_device, param_device
from ..frontend.features import log_mel_spectrogram, num_frames
from ..models.fastconformer import encoder_output_length, fastconformer_encode
from ..models.rnnt import joint_precompute_enc
from ..models.zipformer import ZipformerConfig, zipformer_encode, zipformer_output_length
from ..utils.profiling import span

__all__ = ["ContinuousBatcher"]


def _proj_from_wav(params, wav, lens, fe_cfg, enc_cfg, rnnt_cfg, t_buf, mvn):
    """frontend → encoder → joint encoder projection, padded or cropped to
    ``t_buf`` frames: [M, t_buf, J] fp32. The encoder follows the config's
    type (Zipformer2 for k2, FastConformer otherwise); ``mvn`` applies the
    espnet flavor's GlobalMVN between the frontend and the encoder."""
    feats, flens = log_mel_spectrogram(wav, lens, fe_cfg)
    if mvn:
        from ..espnet.asr.model import _apply_mvn

        feats = _apply_mvn(params, feats, flens)
    if isinstance(enc_cfg, ZipformerConfig):
        enc, _ = zipformer_encode(params["encoder"], feats, flens, enc_cfg)
    else:
        enc, _ = fastconformer_encode(params["encoder"], feats, flens, enc_cfg)
    proj = joint_precompute_enc(params["joint"], enc, rnnt_cfg)  # [M, t, J]
    t = proj.shape[1]
    if t < t_buf:
        return torch.nn.functional.pad(proj, (0, 0, 0, t_buf - t))
    return proj[:, :t_buf]


def _with_max_tokens(cfg, max_tokens):
    """``cfg`` with its emission buffer set, where the container left it to T."""
    return cfg if cfg.max_tokens > 0 else replace(cfg, max_tokens=max_tokens)


class _GravesAdapter:
    """Frame-clocked segmented Graves beam (espnet flavor)."""

    mvn = True

    def __init__(self, model, t_buf):
        self.model = model
        self.cfg = _with_max_tokens(model.decode_cfg, t_buf)

    def bound(self, lane_len: int) -> int:
        return int(lane_len)

    def state_init(self, params, n_lanes):
        return graves_state_init(n_lanes, self.model.rnnt_cfg, self.cfg,
                                 param_device(params["predictor"]))

    def segment_call(self, params, ring, lane_len, reset, state, n, frames_left):
        state = graves_beam_segment(params["predictor"], params["joint"], ring, lane_len, reset,
                                    state, self.model.rnnt_cfg, self.cfg, n,
                                    frames_left=frames_left)
        return state, None

    def finalize_call(self, state, lane_len):
        return graves_finalize(state, lane_len, self.model.rnnt_cfg, self.cfg)[:3]


class _MAESAdapter(_GravesAdapter):
    """Frame-clocked segmented mAES beam (espnet ``decoding="maes"``): the
    Graves adapter's lane contract; the harvest also reads ``fidx >=
    lane_len`` through the lagged done flags."""

    def state_init(self, params, n_lanes):
        return maes_state_init(params["predictor"], n_lanes, self.model.rnnt_cfg,
                               self.cfg)

    def segment_call(self, params, ring, lane_len, reset, state, n, frames_left):
        state = maes_beam_segment(params["predictor"], params["joint"], ring, lane_len, reset,
                                  state, self.model.rnnt_cfg, self.cfg, n,
                                  frames_left=frames_left)
        return state, state.fidx >= lane_len

    def finalize_call(self, state, lane_len):
        return maes_finalize(state, lane_len, self.model.rnnt_cfg, self.cfg)[:3]


class _ALSDAdapter:
    """Alignment-step-clocked segmented ALSD beam (nemo flavor)."""

    mvn = False

    def __init__(self, model, t_buf):
        self.model = model
        self.cfg = _with_max_tokens(model.decode_cfg, alsd_step_bound(t_buf, model.decode_cfg))

    def bound(self, lane_len: int) -> int:
        return alsd_step_bound(lane_len, self.cfg)

    def state_init(self, params, n_lanes):
        return alsd_state_init(params["predictor"], n_lanes, self.model.rnnt_cfg,
                               self.cfg)

    def segment_call(self, params, ring, lane_len, reset, state, n, frames_left):
        return alsd_segment(params["predictor"], params["joint"], ring, lane_len, reset, state,
                            self.model.rnnt_cfg, self.cfg, n)

    def finalize_call(self, state, lane_len):
        return alsd_finalize(state, lane_len, self.model.rnnt_cfg, self.cfg)[:3]


class _GreedyAdapter:
    """Loop-iteration-clocked segmented greedy decode: nemo and espnet
    ``decoding="greedy"`` and the k2 Zipformer (the reference's pinned
    greedy_search). MVN follows the param tree (only the espnet converter
    writes a ``normalize`` entry)."""

    def __init__(self, model, t_buf):
        self.model = model
        self.mvn = "normalize" in model.params
        self.cfg = _with_max_tokens(model.decode_cfg, t_buf)

    def bound(self, lane_len: int) -> int:
        return greedy_step_bound(lane_len, self.cfg)

    def state_init(self, params, n_lanes):
        return greedy_state_init(params["predictor"], n_lanes, self.model.rnnt_cfg,
                                 self.cfg)

    def segment_call(self, params, ring, lane_len, reset, state, n, frames_left):
        return greedy_segment(params["predictor"], params["joint"], ring, lane_len, reset, state,
                              self.model.rnnt_cfg, self.cfg, n)

    def finalize_call(self, state, lane_len):
        return greedy_finalize(state, lane_len)


def _adapter(model, t_buf):
    cfg = model.decode_cfg
    if isinstance(cfg, GravesBeamConfig):
        return _GravesAdapter(model, t_buf)
    if isinstance(cfg, MAESBeamConfig):
        return _MAESAdapter(model, t_buf)
    if isinstance(cfg, BeamDecodeConfig):
        return _ALSDAdapter(model, t_buf)
    if isinstance(cfg, GreedyDecodeConfig):
        return _GreedyAdapter(model, t_buf)
    raise TypeError(
        "ContinuousBatcher drives a segmented transducer decode; the container's decode_cfg "
        "must be a GravesBeamConfig or MAESBeamConfig (espnet), BeamDecodeConfig (nemo ALSD) "
        f"or GreedyDecodeConfig (nemo/k2/espnet greedy), got {type(cfg).__name__}.")


class _ToHost:
    """Device tensors copied into fresh pinned host memory and fenced by an
    event (on CPU tensors: plain copies); :meth:`get` waits for the copy and
    returns numpy arrays."""

    def __init__(self, tensors):
        if tensors[0].device.type != "cuda":
            self.host, self.event = [t.clone() for t in tensors], None
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class _LaneGroup:
    """One device's share of the lane pool: lanes ``[lo, hi)``, the params
    on its device, their decoder state and ring of projections, and a CUDA
    stream of its own. The pool is one group, or one per entry of the
    mesh's data axis."""

    def __init__(self, device, params, lo, hi):
        self.device = torch.device(device)
        self.params = params
        self.lo, self.hi = lo, hi
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.state = self.ring = None

    @contextlib.contextmanager
    def work(self):
        """The group's device current and its stream, where it has one."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def put(self, array):
        return host_to_device(array, self.device)

    def wait_for(self, other, tensor):
        """Order this group's stream after ``other``'s, which made
        ``tensor``, and keep ``tensor``'s memory until this stream is done."""
        if other is not self and self.stream is not None:
            self.stream.wait_stream(other.stream)
            tensor.record_stream(self.stream)


class ContinuousBatcher:
    """Lane-recycling executor for the transducer flavor containers.

    Args:
      model: a flavor container whose ``decode_cfg`` selects the decode:
        :class:`GravesBeamConfig` or :class:`MAESBeamConfig` (espnet),
        :class:`BeamDecodeConfig` (nemo ALSD, or k2/espnet beam), or
        :class:`GreedyDecodeConfig` (k2 and the nemo/espnet greedy options)
      n_lanes: the lane pool's width (every segment runs all lanes)
      frames_per_segment: the recycling quantum: encoder frames (Graves, mAES),
        alignment steps (ALSD) or loop iterations (greedy) each lane
        advances per tick
      max_seconds: longest utterance a lane takes (:meth:`submit_long`
        windows longer audio over the pool)
      drain_timeout: close() waits this long for in-flight lanes
      max_encode_batch: at most this many new requests are encoded per
        tick; the rest join on the next tick, one segment later. Every
        encode tick is padded to (max_encode_batch, max_samples): one batch
        shape for the encoder, the shape a same-shape MicroBatcher A/B and
        a captured graph of the tick need
      mesh: a :func:`parallel.mesh.make_mesh` mesh: the lane pool is split
        over its ``data`` axis into one group of lanes per entry, each with
        its own params copy, decoder state and ring on that entry's device
        (entries may repeat a device), so one executor (and one HTTP server)
        spans several devices. The encode tick splits its request batch
        over the groups, and segments and finalize run per group. Requires
        ``n_lanes`` and ``max_encode_batch`` divisible by the data-axis size.
        A lane's body has no cross-lane op, so each request's result is the
        single-device pool's
      max_pending: submit() raises queue.Full beyond this many queued
        requests (None: unbounded); the HTTP front answers 503

    Results resolve to ``(token_ids, frames)``, the MicroBatcher contract,
    and equal ``decode_single``'s under the same ``max_tokens`` emission cap
    (the pool shares one cap; a dedicated decode defaults its own to its
    padded T).
    """

    def __init__(self, model, n_lanes=16, frames_per_segment=32, max_seconds=20.0,
                 drain_timeout=300.0, max_encode_batch=16, mesh=None,
                 max_pending=None):
        self.model = model
        self.max_pending = max_pending
        self.n_lanes = int(n_lanes)
        self.n_frames = int(frames_per_segment)
        self.bucket_samples = getattr(model, "bucket_samples", 2 * 16000)
        self.max_samples = int(
            -(-max_seconds * 16000 // self.bucket_samples) * self.bucket_samples)
        self.t_buf = int(self.host_frames(self.max_samples))
        self._ad = _adapter(model, self.t_buf)
        self.cfg = self._ad.cfg
        self.drain_timeout = drain_timeout
        self.max_encode_batch = int(max_encode_batch)
        self.mesh = mesh
        self._groups = self._make_groups(mesh)
        with torch.inference_mode():
            for g in self._groups:
                with g.work():
                    self._init_device_state(g)
        # the lane clocks, mirrored on the host
        self._lane_len = np.zeros(self.n_lanes, np.int32)
        self._fidx = np.zeros(self.n_lanes, np.int32)
        self._bound = np.zeros(self.n_lanes, np.int32)
        self._lane_fut = [None] * self.n_lanes
        # lagged device done flags (ALSD, greedy): the flags read this tick
        # were computed by the PREVIOUS tick's segment; a lane refilled since
        # then carries a stale True, masked by _done_skip for exactly one read
        self._done_host = np.zeros(self.n_lanes, bool)
        self._done_pending = None
        self._done_skip = np.zeros(self.n_lanes, bool)

        self._queue = queue.Queue()
        self._closing = False
        # observability
        self.segments = 0
        self.encode_ticks = 0
        # stats() sorts the latencies from an HTTP thread while the executor
        # appends: the lock guards the deque against mutation mid-iteration
        self._lat_lock = threading.Lock()
        self.latencies = deque(maxlen=1024)
        self.busy_lane_segments = 0
        self.requests_done = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ContinuousBatcher")
        self._thread.start()

    def _make_groups(self, mesh):
        """The lane groups: the whole pool on the model's device, or one
        group per entry of the mesh's data axis."""
        if mesh is None:
            return [_LaneGroup(self.model.device, self.model.params, 0, self.n_lanes)]
        from ..parallel.mesh import DATA_AXIS, replicate

        n_data = int(mesh.shape[DATA_AXIS])
        if self.n_lanes % n_data:
            raise ValueError(
                f"n_lanes={self.n_lanes} must divide over the mesh data axis ({n_data})")
        if self.max_encode_batch % n_data:
            raise ValueError(f"max_encode_batch={self.max_encode_batch} must divide over "
                             f"the mesh data axis ({n_data})")
        per = self.n_lanes // n_data
        devices = [mesh.devices[d, 0] for d in range(n_data)]
        # params once per distinct device (the model's own where it is one)
        params = {dev: replicate(self.model.params, dev) for dev in dict.fromkeys(devices)}
        return [_LaneGroup(dev, params[dev], d * per, (d + 1) * per)
                for d, dev in enumerate(devices)]

    def _init_device_state(self, g):
        """A fresh decoder state and a zeroed ring of projections for ``g``."""
        g.state = self._ad.state_init(g.params, g.hi - g.lo)
        g.ring = torch.zeros((g.hi - g.lo, self.t_buf, self.model.rnnt_cfg.joint_hidden),
                             dtype=torch.float32, device=g.device)

    # -- public API ---------------------------------------------------------

    def submit(self, waveform) -> Future:
        """Enqueue one float32 waveform; resolves to (token_ids, frames).
        Raises queue.Full when ``max_pending`` requests already wait for a
        lane."""
        self._check_pending()
        fut = Future()
        w = np.asarray(waveform, np.float32)
        if len(w) > self.max_samples:
            fut.set_exception(ValueError(
                f"utterance of {len(w)} samples exceeds the executor's max_seconds window "
                f"({self.max_samples} samples); chunk long audio through the transcribe layer"))
            return fut
        fut._submit_t = time.perf_counter()
        self._queue.put((w, fut))
        return fut

    def _check_pending(self):
        """Front-door backpressure, checked once per request (a long
        request's windows are then enqueued unconditionally: shedding part
        of a window plan would break the merged result)."""
        if self.max_pending is not None and self._queue.qsize() >= self.max_pending:
            raise queue.Full(
                f"{self._queue.qsize()} requests already queued for the lane pool "
                f"(max_pending={self.max_pending}); retry later")

    def _submit_window(self, w) -> Future:
        """Enqueue one already-validated window, bypassing backpressure."""
        fut = Future()
        fut._submit_t = time.perf_counter()
        self._queue.put((w, fut))
        return fut

    def transcribe(self, waveform):
        return self.submit(waveform).result()

    def submit_long(self, waveform, overlap_seconds=None) -> Future:
        """Long audio through the lane pool: ``max_seconds`` windows sharing
        ``overlap_seconds`` of context, each submitted as ordinary lane work,
        merged by keeping each window's centre (the rule of the nemo
        flavor's chunked transcribe: tokens in an overlap half belong to the
        neighbour with more context). Audio that fits one window goes
        through :meth:`submit` unchanged. Resolves to ``(token_ids,
        frames)``, frames on the encoder-frame grid of the whole waveform."""
        w = np.asarray(waveform, np.float32)
        if len(w) <= self.max_samples:
            return self.submit(w)
        self._check_pending()
        starts, chunk, overlap = self._window_plan(len(w), overlap_seconds)
        futs = [self._submit_window(w[s:s + chunk]) for s in starts]

        out = Future()
        remaining = [len(starts)]
        lock = threading.Lock()

        def _gather(_fut):
            with lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            try:
                tokens, frames = [], []
                for i, (s, f) in enumerate(zip(starts, futs)):
                    toks, frs = self._window_keep(*f.result(), i=i, start=s, starts=starts,
                                                  chunk=chunk, overlap=overlap, w_len=len(w))
                    tokens += toks
                    frames += frs
                out.set_result((tokens, frames))
            except Exception as e:  # a failed window fails the request
                out.set_exception(e)

        for f in futs:
            f.add_done_callback(_gather)
        return out

    def stream(self, waveform, overlap_seconds=None):
        """Incremental long-form decode: a generator of one ``(token_ids,
        frames)`` increment per window, in order, each as soon as its lane
        work (and its predecessors') completes; the increments concatenate
        to :meth:`submit_long`'s result. Submission is eager: the windows
        are enqueued (and queue.Full raised) before the first yield."""
        w = np.asarray(waveform, np.float32)
        if len(w) <= self.max_samples:
            futs, starts, chunk, overlap = [self.submit(w)], [0], len(w), 0
        else:
            self._check_pending()
            starts, chunk, overlap = self._window_plan(len(w), overlap_seconds)
            futs = [self._submit_window(w[s:s + chunk]) for s in starts]

        def _deliver():
            for i, (s, f) in enumerate(zip(starts, futs)):
                toks, frs = f.result(timeout=self.drain_timeout)
                if len(futs) == 1:
                    yield toks, frs  # one window: no filtering, == submit
                else:
                    yield self._window_keep(toks, frs, i=i, start=s, starts=starts, chunk=chunk,
                                            overlap=overlap, w_len=len(w))

        return _deliver()

    def _window_plan(self, w_len, overlap_seconds):
        """Fixed overlapped max_seconds windows covering a w_len waveform."""
        sr = 16000
        chunk = self.max_samples
        if overlap_seconds is None:
            # TranscribeConfig.chunk_overlap_seconds' 4 s default, clamped
            # to half the window so small pools still chunk
            overlap_seconds = min(4.0, chunk / sr / 2)
        overlap = int(overlap_seconds * sr)
        hop = chunk - overlap
        if hop <= 0:
            raise ValueError(f"overlap_seconds={overlap_seconds} must be shorter than the "
                             f"executor's max_seconds window ({chunk / sr:.1f}s)")
        return list(range(0, max(w_len - overlap, 1), hop)), chunk, overlap

    def _window_keep(self, toks, frs, *, i, start, starts, chunk, overlap, w_len):
        """Centre-keep filter and global-grid rebase of window i's tokens."""
        sr = 16000
        spf = self.seconds_per_frame()
        half = overlap / 2 / sr
        chunk_sec = min(chunk, w_len - start) / sr
        keep_lo = 0.0 if i == 0 else half
        keep_hi = chunk_sec if i == len(starts) - 1 else chunk_sec - half
        tokens, frames = [], []
        for tok, fr in zip(toks, frs):
            t_local = fr * spf
            if keep_lo <= t_local < keep_hi:
                tokens.append(int(tok))
                frames.append(int(round((t_local + start / sr) / spf)))
        return tokens, frames

    def seconds_per_frame(self) -> float:
        """Encoder frame period in seconds on the host lane-clock grid
        (0.08 for the FastConformer flavors, 0.04 for Zipformer): the
        difference quotient cancels the frontend's edge constants."""
        return 16.0 / (self.host_frames(32 * 16000) - self.host_frames(16 * 16000))

    def host_frames(self, n_samples: int) -> int:
        """Encoder frames the device reports for an n_samples utterance (the
        host mirror the lane clocks run on)."""
        f = num_frames(self.model.fe_cfg, int(n_samples))
        if isinstance(self.model.enc_cfg, ZipformerConfig):
            return int(zipformer_output_length(f, self.model.enc_cfg))
        return int(encoder_output_length(f, self.model.enc_cfg))

    def warmup(self, seconds=(2.0, 5.0, 10.0, 15.0, 20.0)):
        """One dummy request per duration before taking traffic (builds the
        kernels, makes the library handles, grows the allocator's pools).
        Accepts one duration or several; returns the warmed (1, samples)
        shapes, as MicroBatcher.warmup does."""
        if isinstance(seconds, (int, float)):
            seconds = (seconds,)
        rng = np.random.default_rng(0)
        warmed = []
        for s in seconds:  # one at a time: stays under any max_pending bound
            n = int(min(s * 16000, self.max_samples))
            self.submit(rng.standard_normal(n).astype(np.float32) * 0.01).result(
                timeout=self.drain_timeout)
            warmed.append((1, n))
        return warmed

    def stats(self) -> dict:
        """Operational snapshot (the HTTP front's /healthz): segment and
        encode counters, queue depth, mean lane occupancy over all segment
        ticks, and rolling per-request latency percentiles."""
        with self._lat_lock:
            lat = sorted(self.latencies)
        pct = (lambda q: round(lat[min(len(lat) - 1, int(q * len(lat)))], 3)) if lat else (
            lambda q: None)
        return {
            "segments": self.segments,
            "encode_ticks": self.encode_ticks,
            "queue_depth": self._queue.qsize(),
            "lanes": self.n_lanes,
            "lane_occupancy": (
                round(self.busy_lane_segments / (self.segments * self.n_lanes), 3)
                if self.segments else 0.0),
            "requests_done": self.requests_done,
            "latency_s": {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)},
        }

    def busy_lanes(self) -> int:
        """Lanes holding a request now."""
        return sum(f is not None for f in self._lane_fut)

    def close(self):
        """Stop taking work: the lanes and the queue drain (up to
        ``drain_timeout``), then the executor thread exits."""
        self._closing = True
        self._queue.put(None)
        self._thread.join(timeout=self.drain_timeout)

    # -- internals ----------------------------------------------------------

    def _collect(self, n_free, block):
        """Pull up to n_free queued requests; optionally block for the first."""
        items = []
        while len(items) < n_free:
            try:
                item = self._queue.get(block=block and not items)
            except queue.Empty:
                break
            if item is None:  # shutdown marker: note it, keep draining
                self._closing = True
                if not block or items:
                    break
                return items  # idle + closing -> the caller exits
            items.append(item)
            block = False
        return items

    def _swap_in(self, items, lanes):
        """Encode the new utterances and write them into their lanes' rows
        of the ring."""
        m = len(items)
        buf = np.zeros((self.max_encode_batch, self.max_samples), np.float32)
        lens = np.zeros(self.max_encode_batch, np.int32)
        for i, (w, _) in enumerate(items):
            buf[i, :len(w)] = w
            lens[i] = len(w)
        mdl = self.model
        # the encode batch splits over the groups (rows all padding skipped),
        # then each real row goes to the group that owns its lane
        rows = self.max_encode_batch // len(self._groups)
        projs = []
        for d, g in enumerate(self._groups[:-(-m // rows)]):
            with g.work():
                projs.append(_proj_from_wav(
                    g.params, g.put(buf[d * rows:(d + 1) * rows]),
                    g.put(lens[d * rows:(d + 1) * rows]), mdl.fe_cfg, mdl.enc_cfg, mdl.rnnt_cfg,
                    self.t_buf, self._ad.mvn))
        for g in self._groups:
            mine = [i for i in range(m) if g.lo <= lanes[i] < g.hi]
            if not mine:
                continue
            with g.work():
                for d in {i // rows for i in mine}:
                    g.wait_for(self._groups[d], projs[d])
                # each real row covers all t_buf frames of its lane
                src = torch.cat([projs[i // rows][i % rows:i % rows + 1].to(g.device)
                                 for i in mine])
                g.ring.index_copy_(0, g.put(np.asarray([lanes[i] - g.lo for i in mine],
                                                       np.int64)), src)
        self.encode_ticks += 1
        for (w, fut), lane in zip(items, lanes):
            n = self.host_frames(len(w))
            self._lane_len[lane] = n
            self._lane_fut[lane] = fut
            self._fidx[lane] = 0
            self._bound[lane] = self._ad.bound(n)
            self._done_host[lane] = False
            # flags already in flight predate this swap: mask them once
            self._done_skip[lane] = self._done_pending is not None

    def _lane_done(self, lane: int) -> bool:
        return self._fidx[lane] >= self._bound[lane] or bool(self._done_host[lane])

    def _free(self, lane):
        self._lane_len[lane] = 0
        self._lane_fut[lane] = None
        self._fidx[lane] = 0
        self._bound[lane] = 0
        self._done_host[lane] = False

    def _loop(self):
        with torch.inference_mode():  # per thread; each group's device work on its stream
            while self._tick():
                pass

    def _group_of(self, lane):
        return lane // (self.n_lanes // len(self._groups))

    def _tick(self) -> bool:
        """One tick of the executor; False once it is closed and drained."""
        # futures this tick holds outside the lanes: the harvested lanes'
        # (freed before their results are read) and the new requests' (off
        # the queue before their lanes are assigned)
        held = []
        try:
            for g in self._groups:
                if g.state is None:  # a fault left no usable device state
                    with g.work():
                        self._init_device_state(g)
            # 1. harvest finished lanes: dispatch their groups' finalize and
            #    its copy to the host now, read the copy after the next
            #    segment is out
            finished = [lane for lane in range(self.n_lanes)
                        if self._lane_fut[lane] is not None and self._lane_done(lane)]
            fin = None
            if finished:
                hosts = {}
                for gi in sorted({self._group_of(lane) for lane in finished}):
                    g = self._groups[gi]
                    with g.work():
                        hosts[gi] = _ToHost(self._ad.finalize_call(
                            g.state, g.put(self._lane_len[g.lo:g.hi])))
                fin = (hosts, [(lane, self._lane_fut[lane]) for lane in finished])
                held += [fut for _, fut in fin[1]]
                for lane in finished:
                    self._free(lane)
            occupied = any(f is not None for f in self._lane_fut)

            # 2. refill free lanes from the queue
            free = [lane for lane in range(self.n_lanes) if self._lane_fut[lane] is None]
            block = not occupied and fin is None
            if block and self._closing and self._queue.empty():
                return False
            n_take = min(len(free), self.max_encode_batch)
            new = self._collect(n_take, block) if free else []
            held += [fut for _, fut in new]
            if block and not new and fin is None:
                return not self._closing  # woken with nothing to do
            reset = np.zeros(self.n_lanes, bool)
            if new:
                lanes = free[:len(new)]
                self._swap_in(new, lanes)
                reset[lanes] = True

            # 3. advance every lane by one segment
            done_dev = None
            if any(f is not None for f in self._lane_fut):
                busy = self._bound - self._fidx
                done_dev = []
                with span("serve.segment"):  # the host's dispatch of one segment
                    for g in self._groups:
                        lanes = slice(g.lo, g.hi)
                        with g.work():
                            g.state, done = self._ad.segment_call(
                                g.params, g.ring, g.put(self._lane_len[lanes]),
                                g.put(reset[lanes]), g.state, self.n_frames,
                                int(busy[lanes].max()))
                            done_dev.append(None if done is None else _ToHost([done]))
                if done_dev[0] is None:
                    done_dev = None
                self._fidx = np.minimum(self._fidx + self.n_frames, self._bound)
                self.segments += 1
                self.busy_lane_segments += sum(f is not None for f in self._lane_fut)

            # 4. resolve the finished futures (their copy overlaps the segment)
            if fin:
                hosts, recs = fin
                outs = {gi: h.get() for gi, h in hosts.items()}
                now = time.perf_counter()
                for lane, fut in recs:
                    g = self._group_of(lane)
                    tokens, frames, counts = outs[g]
                    lane -= self._groups[g].lo
                    c = int(counts[lane])
                    t0 = getattr(fut, "_submit_t", None)
                    if t0 is not None:
                        with self._lat_lock:
                            self.latencies.append(now - t0)
                    self.requests_done += 1
                    fut.set_result((tokens[lane, :c].tolist(), frames[lane, :c].tolist()))

            # 5. read the PREVIOUS tick's done flags (their segment ran before
            #    the one just dispatched), then queue this tick's
            if self._done_pending is not None:
                got = np.concatenate([h.get()[0] for h in self._done_pending])
                self._done_host = (self._done_host | got) & ~self._done_skip
                self._done_skip[:] = False
                self._done_pending = None
            if done_dev is not None:
                self._done_pending = done_dev
            return True
        except Exception as e:  # a failed tick fails every request it holds
            self._fail_all(e, held)
            return not self._closing

    def _fail_all(self, e, held):
        """Fail the tick's held requests, the lanes' and the queue's with
        ``e`` and drop the device state: the fault may have left it
        poisoned, and resuming on it would decode garbage into the next
        occupants' lanes. The next tick makes a fresh one (and fails its
        requests if it cannot). Only the requests queued before the fault
        are failed: one submitted once its predecessors have failed is
        served."""
        queued = self._queue.qsize()  # any behind these came after the fault
        for fut in held:
            if not fut.done():
                fut.set_exception(e)
        for lane in range(self.n_lanes):
            fut = self._lane_fut[lane]
            if fut is not None and not fut.done():
                fut.set_exception(e)
            self._free(lane)
        self._done_skip[:] = False
        self._done_pending = None
        for g in self._groups:
            g.state = g.ring = None
        for _ in range(queued):
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                self._closing = True
            elif not item[1].done():
                item[1].set_exception(e)
        time.sleep(0.01)
