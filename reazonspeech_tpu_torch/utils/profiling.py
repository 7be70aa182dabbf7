"""Observability: RTFx counters and device tracing.

Port of ``reazonspeech_tpu/utils/profiling.py``. :class:`RTFxMeter` is a
copy (plain Python); :func:`trace` records with ``torch.profiler`` in place
of ``jax.profiler`` and writes a Chrome trace (open it in Perfetto or
``chrome://tracing``).
"""

import contextlib
import os
import time

__all__ = ["RTFxMeter", "trace"]


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

    The caller synchronises the device inside the block where the trace
    should hold the kernels its work enqueued."""
    import torch
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
