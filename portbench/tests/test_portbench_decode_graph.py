"""The reader of ``decode_graph_share.offline`` on a hand-made store of the
program's spans: the window's roots only, the median batch; nothing read
where the program records no ``graph_steps`` (as before the graph) or no
spans. Then a tiny traced run on the CPU, where every body is eager."""

import importlib.util

import pytest
from _tiny import ROOT, run_cell

from reazonspeech_tpu_torch.utils import profiling
from reazonspeech_tpu_torch.utils.profiling import Store

NAME = "decode_graph_share.offline"


def _reader():
    path = ROOT / "portbench" / "metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location("reader_decode_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _store(monkeypatch, roots):
    """A store of ``decode`` roots with these attrs, each over one dispatch."""
    s = Store()
    monkeypatch.setattr(profiling, "spans", s.spans)
    for attrs in roots:
        with s.span("decode") as root:
            with s.span("decode.dispatch"):
                pass
            root.set(**attrs)
    return s


def _attrs(steps, graph_steps=None):
    out = {"steps": steps, "checks": -(-steps // 32), "max_steps": 802}
    if graph_steps is not None:
        out["graph_steps"] = graph_steps
    return out


@pytest.mark.parametrize("window,want", [
    ([(800, 800), (800, 800), (800, 800)], 100.0),
    ([(800, 800), (802, 800), (96, 64)], 800 / 802 * 100),  # the median of 100, 99.75, 66.7
    ([(20, 0), (20, 0), (20, 0)], 0.0),  # batches under one block
])
def test_the_window_median(monkeypatch, window, want):
    """The warm-up's root (first) and the profiled batch's (last) are left out."""
    roots = [_attrs(64, 0)] + [_attrs(*w) for w in window] + [_attrs(96, 0)]
    _store(monkeypatch, roots)
    assert _reader()({"spans": {"decode_ms": [1.0] * len(window)}}) == pytest.approx(want)


def test_nothing_without_graph_steps(monkeypatch):
    """A program whose roots carry no ``graph_steps``, or that records no
    spans at all, reads nothing."""
    _store(monkeypatch, [_attrs(800)] * 5)
    assert _reader()({"spans": {"decode_ms": [1.0] * 3}}) is None
    monkeypatch.delattr(profiling, "spans")
    assert _reader()({"spans": {"decode_ms": [1.0] * 3}}) is None


def test_traced_run_reports_the_share():
    """On the CPU every body is eager: the share reads 0 %."""
    res = run_cell("nemo-offline-b192", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"][NAME] == {"value": 0.0, "unit": "%"}
