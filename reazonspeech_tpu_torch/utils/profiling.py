"""Observability: RTFx counters, the program's spans and counters, and
device tracing.

Port of ``reazonspeech_tpu/utils/profiling.py``. :class:`RTFxMeter` is a
copy (plain Python); :func:`trace` records with ``torch.profiler`` in place
of ``jax.profiler`` and writes a Chrome trace (open it in Perfetto or
``chrome://tracing``).

The program records into one store (:data:`STORE`), always:

- :func:`span` times a region at a layer boundary (coarse: a call, a layer,
  a block of decode steps; never a step, a kernel or an utterance). Each
  span keeps its name, its id, its parent's (the innermost span open on
  the same thread), the root id that every span of one call shares, its
  start and end in ``time.time_ns()``, the thread and its attrs. While a
  ``torch.profiler`` runs, a span also opens the range ``rs.<name>``, and
  the profiler's clock is ``time_ns`` (an event's offset plus the trace's
  start), so a span's stamps place it on the device trace. Without a
  profiler it opens none (``record_function`` alone costs more than the
  span).
- :func:`count` adds to a named counter (``launch.<kernel>`` for every
  kernel launch, ``decode.steps``, ``decode.checks``).
- :func:`spans`, :func:`counters` and :func:`reset` read and clear. The
  spans are a ring of the last :data:`CAPACITY`, so a long-running server
  holds a bounded store.
"""

import contextlib
import itertools
import os
import threading
import time
from collections import deque

import torch

__all__ = ["CAPACITY", "STORE", "RTFxMeter", "Span", "Store", "count", "counters", "reset",
           "span", "spans", "trace"]

CAPACITY = 16384  # spans the store keeps: the newest


class Span:
    """One timed region of the program (use it as a context manager; a
    store's :meth:`Store.span` makes it). ``parent`` is None at a root;
    ``end_ns`` is None until it closes; :meth:`set` adds attrs up to then."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "thread", "start_ns", "end_ns",
                 "_store", "_range")

    def __init__(self, store, name, attrs):
        self._store, self.name, self.attrs = store, name, attrs
        self.end_ns = self._range = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        store = self._store
        stack = store._stack()
        up = stack[-1] if stack else None
        self.id = next(store._ids)
        self.parent, self.root = (up.id, up.root) if up else (None, self.id)
        self.thread = threading.get_ident()
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function("rs." + self.name)
        self.start_ns = time.time_ns()
        if self._range is not None:
            self._range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        self._store._close(self)
        return False


class Store:
    """Spans (a ring of the newest ``capacity``) and counters, shared by
    every thread: parents are found per thread, the ring and the counters
    behind one lock."""

    def __init__(self, capacity=CAPACITY):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity)
        self._counters = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _close(self, sp):
        self._stack().remove(sp)  # the top: spans close in the order they open
        with self._lock:
            self._ring.append(sp)

    def span(self, name, **attrs):
        return Span(self, name, attrs)

    def count(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self):
        """The closed spans the ring holds, oldest first."""
        with self._lock:
            return list(self._ring)

    def counters(self):
        with self._lock:
            return dict(self._counters)

    def reset(self, prefix=None):
        """Clear the store and return what it held, ``(spans, counters)``;
        with ``prefix``, only the counters whose name starts with it."""
        with self._lock:
            if prefix is not None:
                gone = {k: v for k, v in self._counters.items() if k.startswith(prefix)}
                for k in gone:
                    del self._counters[k]
                return [], gone
            out = list(self._ring), self._counters
            self._ring.clear()
            self._counters = {}
            return out


STORE = Store()  # the program's store
span, count, spans, counters, reset = (STORE.span, STORE.count, STORE.spans, STORE.counters,
                                       STORE.reset)


class RTFxMeter:
    """Accumulate (audio_seconds, wall_seconds) and report throughput.

    Usage:
        meter = RTFxMeter()
        with meter.measure(audio_seconds=30.0 * batch):
            run_pipeline(...)
        print(meter.rtfx)
    """

    def __init__(self):
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0
        self.batches = 0

    @contextlib.contextmanager
    def measure(self, audio_seconds: float):
        t0 = time.perf_counter()
        yield
        self.wall_seconds += time.perf_counter() - t0
        self.audio_seconds += audio_seconds
        self.batches += 1

    @property
    def rtfx(self) -> float:
        if self.wall_seconds == 0:
            return 0.0
        return self.audio_seconds / self.wall_seconds

    @property
    def rtf(self) -> float:
        """Real-time factor (wall per audio second; < 1 is faster than RT)."""
        return 1.0 / self.rtfx if self.rtfx else float("inf")

    def summary(self) -> dict:
        return {
            "rtfx": round(self.rtfx, 1),
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "batches": self.batches,
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA's where a GPU is present) and write it as a Chrome trace into
    ``log_dir``, also when the block raises. Yields the trace file's path.
    The program's spans show in it as ``rs.<name>`` ranges.

    The caller synchronises the device inside the block where the trace
    should hold the kernels its work enqueued."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
