"""What a traced run reads from ``torch.profiler``: the device's busy time
(the union of every device activity's interval), the largest device
operations, the longest idle gaps by what the host was doing, and the
device time of the kernels launched inside the benchmark's own ranges
(``portbench.<name>``, opened around a program call by :class:`Ranges`).

Nothing is written to disk: the trace stays in memory.
"""

import importlib
from collections import defaultdict

import torch

__all__ = ["Profile", "Ranges", "merge", "union"]


def union(intervals):
    """(length of the union, gaps) of sorted (start, end, name) intervals;
    a gap is (end of the union so far, next start, the next one's name)."""
    busy, gaps, end = 0.0, [], None
    for s, t, name in intervals:
        if end is not None and s > end:
            gaps.append((end, s, name))
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy, gaps


def _meta(x):
    """A tensor's shape and type without its storage (small ones kept as
    they are: a length vector is read after the profile)."""
    if isinstance(x, torch.Tensor) and x.numel() > 4096:
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, (tuple, list)):
        return type(x)(_meta(v) for v in x)
    return x


class Ranges:
    """Wraps program functions (``module``, ``name``) so that each call runs
    inside ``record_function("portbench.<label>")`` and leaves its
    arguments' shapes for the bound; restores them on exit."""

    def __init__(self, targets):
        self.targets = targets  # label -> [(module, name)]
        self.calls = defaultdict(list)
        self._saved = []

    def __enter__(self):
        for label, places in self.targets.items():
            for module, name in places:
                mod = importlib.import_module(module)
                orig = getattr(mod, name)
                self._saved.append((mod, name, orig))
                setattr(mod, name, self._wrap(label, orig))
        return self

    def _wrap(self, label, orig):
        calls = self.calls[label]

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(f"portbench.{label}"):
                out = orig(*args, **kwargs)
            calls.append((_meta(args), _meta(out)))
            return out

        return wrapped

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()


class Profile:
    """One profiled stretch: ``with Profile(cpu=...) as p: ...`` (the work
    ends in a synchronise inside the block)."""

    def __init__(self, cpu):
        from torch.profiler import ProfilerActivity

        self.cuda = torch.cuda.is_available()
        acts = ([ProfilerActivity.CUDA] if self.cuda else []) + (
            [ProfilerActivity.CPU] if cpu or not self.cuda else [])
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        import time

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        self._read()

    def _read(self):
        from torch.autograd import DeviceType

        events = list(self.prof.events())
        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                     and not e.name.startswith("portbench."))
        self.ops = defaultdict(float)
        for s, t, name in dev:
            self.ops[name] += (t - s) / 1e6
        busy_us, self.gaps = union(dev)
        self.busy_s = busy_us / 1e6
        self.host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                           if e.device_type == DeviceType.CPU and not e.is_async)
        self.range_ms = self._ranges(events, DeviceType)

    @staticmethod
    def _ranges(events, DeviceType):
        """{label: device ms} of every device activity whose launch (the
        runtime call of the same correlation id) lies inside a
        ``portbench.<label>`` range on the launching thread."""
        import bisect

        spans = defaultdict(list)  # thread -> [(start, end, label)]
        launch = {}  # correlation id -> (thread, time)
        for e in events:
            if e.device_type != DeviceType.CPU:
                continue
            if e.name.startswith("portbench."):
                spans[e.thread].append((e.time_range.start, e.time_range.end,
                                        e.name[len("portbench."):]))
            elif e.name.startswith(("cuda", "cu")) and e.id:
                launch[e.id] = (e.thread, e.time_range.start)
        for v in spans.values():
            v.sort()
        starts = {k: [x[0] for x in v] for k, v in spans.items()}
        out = defaultdict(float)
        for e in events:
            if e.device_type != DeviceType.CUDA or e.id not in launch:
                continue
            thread, t = launch[e.id]
            i = bisect.bisect_right(starts.get(thread, []), t) - 1
            if i >= 0 and spans[thread][i][1] >= t:
                out[spans[thread][i][2]] += (e.time_range.end - e.time_range.start) / 1e3
        return out

    def gap_seconds(self, where):
        """{label: idle seconds}: each gap between device activities named
        after the innermost host operation (not a CUDA runtime call) that
        spans its middle, else after ``where`` and the operation that ends
        it."""
        import bisect

        ops = [h for h in self.host if not h[2].startswith(("cuda", "cu"))]
        starts = [h[0] for h in ops]
        long_ops = [h for h in ops if h[1] - h[0] > 1000.0]
        out = defaultdict(float)
        for s, t, nxt in self.gaps:
            mid, label = (s + t) / 2, None
            i = bisect.bisect_right(starts, mid)
            for hs, ht, name in reversed(ops[max(0, i - 2000):i]):
                if ht >= mid:
                    label = name
                    break
            if label is None:
                spans = [h for h in long_ops if h[0] <= mid <= h[1]]
                label = max(spans)[2] if spans else None
            out[f"{where}: {label}" if label else f"{where}: before {nxt[:80]}"] += (t - s) / 1e6
        return out


def merge(profiles, where):
    """(busy_s, window_s, breakdown) over profiles and their ``where`` labels."""
    busy = sum(p.busy_s for p in profiles)
    window = sum(p.wall_s for p in profiles)
    ops, gaps = defaultdict(float), defaultdict(float)
    for p, w in zip(profiles, where):
        for k, v in p.ops.items():
            ops[k] += v
        for k, v in p.gap_seconds(w).items():
            gaps[k] += v
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return busy, window, {"device_ops": top(ops), "idle_gaps": top(gaps)}
