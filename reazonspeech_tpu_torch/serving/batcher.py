"""Micro-batching executor for ASR serving.

A copy of ``reazonspeech_tpu/serving/batcher.py`` with the same behaviour:
the port imports nothing of the JAX package.

Concurrent requests are coalesced into ONE ``decode_batch`` call per tick:
requests accumulate until ``max_batch`` are waiting or ``max_wait_ms``
elapses, waveforms are padded to the model's bucket grid (the same padding
as the offline ``decode_single``, so a bounded set of batch shapes reaches
the card), and results are fanned back out per request. The batch dimension
is where the card's throughput comes from: one utterance alone leaves most
of it idle.
"""

import queue
import threading
from concurrent.futures import Future

import numpy as np

__all__ = ["MicroBatcher"]


class MicroBatcher:
    """Coalesce transcription requests into batched decode calls.

    Args:
      model: any flavor container exposing ``decode_batch(waveforms, lengths)
        -> (tokens, frames, counts, ...)`` (nemo/espnet/k2 all qualify)
      max_batch: hard batch-size cap per tick
      max_wait_ms: how long the first request in a tick waits for company
      bucket_samples: waveforms pad to multiples of this (a bounded set of
        batch shapes)
      fixed_shape: optional (batch, samples) — pad EVERY tick to exactly
        this dispatch shape instead of bucketing. One batch shape total, and
        the encode shape matches a ContinuousBatcher's over the same caps
        (``max_encode_batch``, ``max_samples``) — the same-shape static
        side of the continuous-vs-static A/B (another batch shape can take
        other GEMM kernels, whose bf16 encode low bits differ; near-tie
        beams amplify that into token flips).
        Requests longer than ``samples`` are rejected at submit().
    """

    def __init__(self, model, max_batch=32, max_wait_ms=20.0,
                 bucket_samples=None, fixed_shape=None):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.fixed_shape = fixed_shape
        if fixed_shape is not None:
            # a tick can never exceed (or undershoot the padding of) the
            # fixed dispatch batch
            self.max_batch = fixed_shape[0]
        # default to the model's own padding grid so batched results match
        # decode_single exactly even when worst-case emission caps bind
        self.bucket_samples = bucket_samples or getattr(
            model, "bucket_samples", 4 * 16000
        )
        # models sharded over several devices need batch sizes divisible
        # over their data axis
        self.batch_multiple = int(getattr(model, "batch_multiple", 1))
        if self.batch_multiple > 1 and max_batch % self.batch_multiple:
            raise ValueError(
                f"max_batch={max_batch} must be a multiple of the model's "
                f"batch_multiple={self.batch_multiple} (mesh data axis)")
        self._queue = queue.Queue()
        self._running = True
        # observability, bounded for the server's life: counters and the set
        # of dispatched (b_pad, samples) shapes (a bucket grid's, not a tick's)
        self.ticks = 0  # batches dispatched
        self.requests = 0  # requests answered by them
        self.largest_batch = 0  # the most requests one batch held
        self.batch_shapes = set()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="MicroBatcher")
        self._thread.start()

    def submit(self, waveform) -> Future:
        """Enqueue one float32 waveform; resolves to (token_ids, frames)."""
        fut = Future()
        w = np.asarray(waveform, np.float32)
        if self.fixed_shape is not None and len(w) > self.fixed_shape[1]:
            fut.set_exception(ValueError(
                f"request of {len(w)} samples exceeds the fixed dispatch "
                f"shape ({self.fixed_shape[1]} samples)"))
            return fut
        self._queue.put((w, fut))
        return fut

    def transcribe(self, waveform):
        """Blocking convenience wrapper around submit()."""
        return self.submit(waveform).result()

    def warmup(self, seconds=None):
        """Run every batch shape once before serving traffic.

        Dispatches one all-zero batch per bucket signature (zero-length
        rows already emit count 0 — the padding-invariance the batcher
        relies on) so the first real request at each signature finds the
        kernels built, the library handles made and the allocator's pools
        grown. ``seconds`` picks the time bucket to warm (default: one
        ``bucket_samples`` grid step). Returns the list of (batch, samples)
        shapes warmed.
        """
        if seconds is None:
            samples = self.bucket_samples
        else:
            n = int(seconds * 16000)
            samples = max(self.bucket_samples,
                          -(-n // self.bucket_samples) * self.bucket_samples)
        if self.fixed_shape is not None:
            shapes = [tuple(self.fixed_shape)]
        else:
            # the exact b_pad set _loop can dispatch: powers of two rounded
            # to the mesh batch multiple, clamped to (and including)
            # max_batch
            sizes = []
            b = 1
            while b < self.max_batch:
                b_pad = b
                if self.batch_multiple > 1:
                    b_pad = min(-(-b // self.batch_multiple)
                                * self.batch_multiple, self.max_batch)
                if b_pad not in sizes:
                    sizes.append(b_pad)
                b <<= 1
            if self.max_batch not in sizes:
                sizes.append(self.max_batch)
            shapes = [(b_pad, samples) for b_pad in sizes]
        warmed = []
        for b_pad, smp in shapes:
            buf = np.zeros((b_pad, smp), np.float32)
            lens = np.zeros((b_pad,), np.int32)
            self.model.decode_batch(buf, lens)
            warmed.append((b_pad, smp))
        self.warmed = warmed
        return warmed

    def close(self):
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=5)

    # -- internals ---------------------------------------------------------

    def _collect(self):
        """Block for the first request, then soak up to max_batch for up to
        max_wait_ms."""
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        deadline = self.max_wait_ms / 1e3
        import time

        t0 = time.monotonic()
        while len(items) < self.max_batch:
            remaining = deadline - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the shutdown marker
                break
            items.append(nxt)
        return items

    def _loop(self):
        while self._running:
            items = self._collect()
            if items is None:
                return
            try:
                b = len(items)
                if self.fixed_shape is not None:
                    b_pad, padded = self.fixed_shape
                else:
                    n_max = max(len(w) for w, _ in items)
                    padded = max(
                        self.bucket_samples,
                        -(-n_max // self.bucket_samples) * self.bucket_samples,
                    )
                    # bucket the BATCH dimension too (next power of two): a
                    # variable b would give one batch shape per distinct size
                    # under organic load; zero-length pad rows emit count 0
                    # (padding-invariant caps, tests/test_serving.py).
                    # Clamped to max_batch so a non-power-of-two cap (say 24)
                    # never dispatches a batch shape (32) the cap was meant
                    # to preclude.
                    b_pad = min(1 << (b - 1).bit_length(), self.max_batch)
                    m = self.batch_multiple
                    if m > 1:
                        b_pad = min(-(-b_pad // m) * m, self.max_batch)
                buf = np.zeros((b_pad, padded), np.float32)
                lens = np.zeros((b_pad,), np.int32)
                for i, (w, _) in enumerate(items):
                    buf[i, : len(w)] = w
                    lens[i] = len(w)
                self.ticks += 1
                self.batch_shapes.add((b_pad, padded))
                out = self.model.decode_batch(buf, lens)
                tokens, frames, counts = out[0], out[1], out[2]
                self.requests += b
                self.largest_batch = max(self.largest_batch, b)
                for i, (_, fut) in enumerate(items):
                    c = int(counts[i])
                    fut.set_result((tokens[i, :c].tolist(), frames[i, :c].tolist()))
            except Exception as e:  # pragma: no cover - fan the error out
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
