"""The decode readers (``decode_dispatch_us.offline``,
``decode_sync_wait_ms.offline``, ``decode_steps.offline``) on a hand-made
store of the program's spans: the warm-up's root and the profiled batch's
are dropped; nothing is read from a program without spans. Then a tiny
traced run on the CPU reports all three."""

import importlib.util

import pytest
from _tiny import ROOT, run_cell

from reazonspeech_tpu_torch.utils import profiling
from reazonspeech_tpu_torch.utils.profiling import Store

READERS = ("decode_dispatch_us.offline", "decode_sync_wait_ms.offline", "decode_steps.offline")


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(store, steps, dispatch_ms, check_ms, other_root=False):
    """One decode root: a dispatch and a check span per block, with the
    given durations (ms), and ``steps`` bodies."""
    if other_root:
        with store.span("frontend"):
            pass
    with store.span("decode") as root:
        for d, c in zip(dispatch_ms, check_ms):
            for name, ms in (("decode.dispatch", d), ("decode.check", c)):
                with store.span(name) as sp:
                    pass
                sp.end_ns = sp.start_ns + int(ms * 1e6)
        root.set(steps=steps, checks=len(dispatch_ms), max_steps=steps)


@pytest.fixture
def store(monkeypatch):
    s = Store()
    monkeypatch.setattr(profiling, "spans", s.spans)
    _batch(s, 64, [1000.0, 1000.0], [500.0, 500.0])  # the warm-up
    _batch(s, 800, [100.0] * 25, [1.0] * 25, other_root=True)  # window batch 1
    _batch(s, 800, [120.0] * 25, [3.0] * 25, other_root=True)  # window batch 2
    _batch(s, 832, [140.0] * 26, [2.0] * 26, other_root=True)  # window batch 3
    _batch(s, 96, [9999.0] * 3, [9999.0] * 3)  # the profiled batch
    return s


def test_window_roots_only(store):
    rec = {"spans": {"decode_ms": [1.0, 2.0, 3.0]}}
    dispatch, wait, steps = (_reader(n).read(rec) for n in READERS)
    assert dispatch == pytest.approx(1e3 * 120.0 * 25 / 800)  # the median of 3,125, 3,750, 4,375
    assert wait == pytest.approx(52.0)  # 25, 75, 52 ms
    assert steps == 800


def test_fewer_roots_than_the_window_reads_nothing(store):
    assert all(_reader(n).read({"spans": {"decode_ms": [1.0] * 5}}) is None for n in READERS)
    assert all(_reader(n).read({"spans": {}}) is None for n in READERS)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    rec = {"spans": {"decode_ms": [1.0]}}
    assert all(_reader(n).read(rec) is None for n in READERS)


def test_traced_run_reports_the_decode_spans():
    res = run_cell("nemo-offline-b192", trace=1)
    assert res["correct"], res["checks"]
    got = {n: res["metrics"][n]["value"] for n in READERS}
    # 2 s chunks, 0.5 s of silence each side, in the 4 s bucket: T = 51
    # frames, ALSD's bound 102 steps; every utterance's budget (3 s valid:
    # 38 frames, 76 steps) ends in the third block of 32
    assert got["decode_steps.offline"] == 96
    assert got["decode_dispatch_us.offline"] > 0 and got["decode_sync_wait_ms.offline"] > 0
    assert [res["metrics"][n]["unit"] for n in READERS] == ["us/step", "ms", "steps"]
