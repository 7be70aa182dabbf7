"""The ALSD loop's block of ``CHECK_EVERY`` bodies replayed as a CUDA graph
(``decoding/rnnt_beam.py``).

On the CPU: a CPU decode runs no graph; the cache's key and its LRU bound;
the graphed loop's plumbing (inputs copied into the static buffers, the
state written back, partial last blocks eager, spans, counters) with the
capture replaced by the same bodies run eagerly; the deferred launch
tally; the workspaces a capture takes.

Marked ``cuda`` (they skip without a GPU): the graphed decode against the
eager loop at nemo-v2's predictor and joint widths and on the tiny
stateless (k2) predictor, bit for bit; the cache hit on new inputs; short
and partial batches; two threads on streams of their own; the launch
counts. On a machine with a GPU (and without JAX) run them with

    python -m pytest tests/test_torch_alsd_graph.py -m cuda --noconftest -q
"""

import sys
import threading
import types
from collections import OrderedDict

import pytest
import torch

from reazonspeech_tpu_torch.decoding import rnnt_beam
from reazonspeech_tpu_torch.decoding.rnnt_beam import (
    CHECK_EVERY, GRAPHS_KEPT, BeamDecodeConfig, alsd_step_bound, rnnt_beam_decode,
)
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig, init_joint, init_predictor
from reazonspeech_tpu_torch.ops import _kernels, beam_topk, launch_counts, reset_launch_counts
from reazonspeech_tpu_torch.utils import profiling

GRAPH_COUNTERS = ("decode.graph_captures", "decode.graph_replays")


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    """Each test starts with an empty cache of captures."""
    monkeypatch.setattr(rnnt_beam, "_graphs", OrderedDict())
    return rnnt_beam._graphs


def _decoder(cfg, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    pred, joint = init_predictor(gen, cfg), init_joint(gen, cfg)
    move = lambda tree: (  # noqa: E731
        {k: move(v) for k, v in tree.items()} if isinstance(tree, dict)
        else [move(v) for v in tree] if isinstance(tree, list) else tree.to(device))
    return move(pred), move(joint)


def _enc(cfg, b, t, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, cfg.enc_dim, generator=gen).to(device)


def _roots():
    return [sp for sp in profiling.spans() if sp.name == "decode" and sp.parent is None]


def _kids(root):
    return [sp.name for sp in sorted(profiling.spans(), key=lambda s: s.start_ns)
            if sp.parent == root.id]


def _equal(a, b):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# --- CPU ---------------------------------------------------------------------

TINY = RNNTConfig.tiny(compute_dtype="float32")
TINY_K2 = RNNTConfig.tiny(compute_dtype="float32", predictor_kind="stateless")


def test_cpu_decode_runs_no_graph():
    """On the CPU every step is eager: ``graph_steps`` 0, no capture span,
    and the graph counters stay 0."""
    pred, joint = _decoder(TINY)
    profiling.reset()
    rnnt_beam_decode(pred, joint, _enc(TINY, 2, 40, 1), torch.tensor([40, 33]), TINY)
    (root,) = _roots()
    assert root.attrs["graph_steps"] == 0 and root.attrs["steps"] > CHECK_EVERY
    assert "decode.capture" not in _kids(root)
    assert all(profiling.counters().get(name, 0) == 0 for name in GRAPH_COUNTERS)


_KEPT = {}  # (config, seed) -> weights, alive for the module: keys hold their addresses


def _key_args(cfg=TINY, b=2, t=40, beam=BeamDecodeConfig(), stream=7, weights_seed=0):
    pred, joint = _KEPT.setdefault((cfg, weights_seed), _decoder(cfg, seed=weights_seed))
    enc_proj = torch.zeros(b, t, cfg.joint_hidden)
    state = rnnt_beam._init_state(pred, b, cfg, beam, alsd_step_bound(t, beam), "cpu")
    return stream, pred, joint, enc_proj, state, cfg, beam


BASE = _key_args()

CHANGES = {
    "batch": dict(b=3),
    "frames": dict(t=48),
    "stream": dict(stream=8),
    "weights": dict(weights_seed=1),
    "beam config": dict(beam=BeamDecodeConfig(score_norm=False)),
    "beam size": dict(beam=BeamDecodeConfig(beam_size=2)),
    "emission buffer": dict(beam=BeamDecodeConfig(max_tokens=30)),
    "predictor kind": dict(cfg=TINY_K2),
    "predictor dtype": dict(cfg=RNNTConfig.tiny(compute_dtype="bfloat16")),
}


def test_the_same_decode_finds_its_entry(fresh_cache):
    """Same shapes, weights (the same tensors), configuration and stream:
    one entry, returned again, holding the weights."""
    first = rnnt_beam._block_graph(*BASE)
    again = rnnt_beam._block_graph(*BASE[:1], *BASE[1:])
    assert first is again and len(fresh_cache) == 1
    assert first.graph is None  # made, not captured: the capture is the caller's
    held = {w.data_ptr() for w in first.weights}
    assert held == {w.data_ptr() for w in rnnt_beam._weights((BASE[1], BASE[2]))}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_change_makes_a_new_entry(fresh_cache, change):
    """A change of shape, stream, weights or configuration is a new entry;
    the old one stays cached."""
    first = rnnt_beam._block_graph(*BASE)
    other = rnnt_beam._block_graph(*_key_args(**CHANGES[change]))
    assert other is not first and len(fresh_cache) == 2
    assert rnnt_beam._block_graph(*BASE) is first


def test_the_cache_drops_the_least_recently_used(fresh_cache):
    """At most GRAPHS_KEPT entries; a hit makes an entry the most recent."""
    entries = [rnnt_beam._block_graph(*_key_args(stream=s)) for s in range(GRAPHS_KEPT)]
    assert rnnt_beam._block_graph(*_key_args(stream=0)) is entries[0]  # now the newest
    rnnt_beam._block_graph(*_key_args(stream=GRAPHS_KEPT))
    assert len(fresh_cache) == GRAPHS_KEPT
    assert rnnt_beam._block_graph(*_key_args(stream=0)) is entries[0]
    assert rnnt_beam._block_graph(*_key_args(stream=1)) is not entries[1]  # it was dropped


def test_the_cache_under_threads(fresh_cache):
    """More threads than cores, each looking up its own key over and over
    with a short switch interval: every lookup of a key returns the one
    entry made for it (a lost update would make a second), and the cache
    keeps its bound."""
    n = GRAPHS_KEPT
    args = [_key_args(stream=s) for s in range(n)]
    seen, errors = [set() for _ in range(n)], []

    def work(i):
        try:
            for _ in range(300):
                seen[i].add(id(rnnt_beam._block_graph(*args[i])))
                assert len(fresh_cache) <= GRAPHS_KEPT
        except AssertionError as exc:
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i % n,)) for i in range(2 * n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert all(len(ids) == 1 for ids in seen)
    assert len(fresh_cache) == n


def _eager_capture(self, pred, joint, rnnt_cfg, cfg):
    """The capture's stand-in on the CPU: a replay runs what the graph
    records, eagerly (the body built over the static buffers, CHECK_EVERY
    bodies, the write-back), and counts one made-up launch."""
    def replay():
        body = rnnt_beam._make_body(pred, joint, self.enc_proj, self.enc_lengths,
                                    self.u_max_el, rnnt_cfg, cfg)
        s = self.state
        for _ in range(CHECK_EVERY):
            s = body(s)
        for dst, src in zip(rnnt_beam._leaves(self.state), rnnt_beam._leaves(s)):
            dst.copy_(src)

    self.graph, self.launches = types.SimpleNamespace(replay=replay), {"launch.stand_in": 1}


@pytest.fixture
def graphed_on_cpu(monkeypatch):
    """The graphed loop on CPU tensors: engaged wherever a full block fits,
    the capture replaced by :func:`_eager_capture`."""
    monkeypatch.setattr(rnnt_beam, "_graphable", lambda enc_proj, n: n >= CHECK_EVERY)
    monkeypatch.setattr(rnnt_beam._BlockGraph, "capture", _eager_capture)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


# (config, T, lengths of the first call, of the second): full blocks and a
# partial last one (bound 80 = 2 x 32 + 16, 96 = 3 x 32), a batch under one
# block (bound 20), an early stop (budget 2 x 17 = 34: two blocks of 96)
CPU_CASES = {
    "partial last block": (TINY, 40, [40, 31], [28, 40]),
    "full blocks only": (TINY, 48, [48, 20], [48, 48]),
    "under one block": (TINY, 10, [10, 7], [6, 10]),
    "early stop": (TINY, 48, [17, 9], [12, 17]),
    "stateless": (TINY_K2, 40, [40, 23], [33, 40]),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_graphed_loop_equals_eager(graphed_on_cpu, monkeypatch, case):
    """Two calls at one shape, the first under ``inference_mode`` and the
    second under ``no_grad``, with other encoder values and lengths: both
    equal the eager loop, the second reuses the first's capture, and steps,
    checks, ``graph_steps``, spans and counters follow the blocks."""
    cfg, t, lens1, lens2 = CPU_CASES[case]
    pred, joint = _decoder(cfg)
    calls = [(_enc(cfg, 2, t, 1), torch.tensor(lens1), torch.inference_mode),
             (_enc(cfg, 2, t, 2), torch.tensor(lens2), torch.no_grad)]
    with monkeypatch.context() as m:
        m.setattr(rnnt_beam, "_graphable", lambda enc_proj, n: False)
        profiling.reset()
        want = []
        for enc, lens, mode in calls:
            with mode():
                want.append(rnnt_beam_decode(pred, joint, enc, lens, cfg))
        eager = [r.attrs for r in _roots()]
    profiling.reset()
    for (enc, lens, mode), expect in zip(calls, want):
        with mode():
            _equal(rnnt_beam_decode(pred, joint, enc, lens, cfg), expect)
    roots = _roots()
    full = alsd_step_bound(t, BeamDecodeConfig()) >= CHECK_EVERY
    for root, attrs in zip(roots, eager):
        assert all(root.attrs[k] == attrs[k] for k in ("steps", "checks", "max_steps"))
        steps = root.attrs["steps"]
        assert root.attrs["graph_steps"] == (steps // CHECK_EVERY * CHECK_EVERY if full else 0)
    assert [("decode.capture" in _kids(r)) for r in roots] == [full, False]
    replays = sum(r.attrs["graph_steps"] for r in roots) // CHECK_EVERY
    counted = profiling.counters()
    assert counted.get("decode.graph_captures", 0) == int(full)
    assert counted.get("decode.graph_replays", 0) == replays
    assert counted.get("launch.stand_in", 0) == replays
    assert counted["decode.steps"] == sum(r.attrs["steps"] for r in roots)


def test_deferred_launches_are_tallied_per_thread(monkeypatch):
    """Inside ``deferred_launches`` the calling thread's launches go to the
    tally, not the store; another thread's still count; outside, they count."""
    fake = types.SimpleNamespace(rs_stand_in=lambda *args: 0)
    monkeypatch.setattr(_kernels, "load_library", lambda: fake)
    profiling.reset()
    with _kernels.deferred_launches() as tally:
        _kernels.launch("rs_stand_in")
        _kernels.launch("rs_stand_in")
        other = threading.Thread(target=_kernels.launch, args=("rs_stand_in",))
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert tally == {"launch.stand_in": 2}
    assert profiling.counters() == {"launch.stand_in": 1}
    _kernels.launch("rs_stand_in")
    assert profiling.counters() == {"launch.stand_in": 2}


def test_take_workspaces_takes_one_stream(monkeypatch):
    """A capture takes its stream's workspaces out of the table (the next
    call on that stream gets new ones) and leaves the others."""
    bufs = {key: [torch.zeros(2), torch.zeros(3)]
            for key in (("topm", 0, 11), ("joint", 0, 11), ("topm", 0, 12), ("topm", 1, 11))}
    monkeypatch.setattr(beam_topk, "_workspaces", dict(bufs))
    taken = beam_topk.take_workspaces(torch.device("cuda", 0), 11)
    assert {id(t) for t in taken} == {id(t) for k in (("topm", 0, 11), ("joint", 0, 11))
                                      for t in bufs[k]}
    assert set(beam_topk._workspaces) == {("topm", 0, 12), ("topm", 1, 11)}


# --- on the card ---------------------------------------------------------------

NEMO = RNNTConfig(vocab_size=3000, enc_dim=1024, pred_hidden=640, joint_hidden=640)
K2 = RNNTConfig.tiny(predictor_kind="stateless")
CARD_CASES = {
    # nemo-v2's predictor and joint, as load_model runs them on CUDA
    "nemo": (NEMO, BeamDecodeConfig(topk_impl="pallas")),
    # the same with the joint + top-m and LSTM-cell kernels
    "nemo step kernels": (NEMO, BeamDecodeConfig(joint_impl="pallas", lstm_impl="pallas")),
    "k2 stateless": (K2, BeamDecodeConfig(topk_impl="pallas")),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eager(monkeypatch, *args):
    with monkeypatch.context() as m:
        m.setattr(rnnt_beam, "_graphable", lambda enc_proj, n: False)
        out = rnnt_beam_decode(*args)
    torch.cuda.synchronize()
    return out


def _lengths(t, b, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(t // 2, t + 1, (b,), generator=gen).clamp(max=t).index_fill(
        0, torch.tensor([0]), t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_graph_equals_eager(dev, monkeypatch, case):
    """B = 8, T = 401: the graphed decode equals the eager loop bit for bit;
    a second call at the shape with other encoder values and lengths hits
    the cache (captures 1, replays rising) and again equals eager; from the
    second call on, the launch counts equal the eager decode's."""
    cfg, beam = CARD_CASES[case]
    pred, joint = _decoder(cfg, dev)
    b, t = 8, 401
    calls = [(_enc(cfg, b, t, s, dev), _lengths(t, b, s).to(dev)) for s in (1, 2)]
    with torch.inference_mode():
        for k, (enc, lens) in enumerate(calls):
            reset_launch_counts()
            want = _eager(monkeypatch, pred, joint, enc, lens, cfg, beam)
            eager_counts = launch_counts()
            profiling.reset("decode.")
            got = rnnt_beam_decode(pred, joint, enc, lens, cfg, beam)
            torch.cuda.synchronize()
            _equal(got, want)
            counted = profiling.counters()
            assert counted.get("decode.graph_captures", 0) == int(k == 0)
            assert counted["decode.graph_replays"] == counted["decode.steps"] // CHECK_EVERY > 0
            if k:  # the capture's warm-up body launched once more
                reset_launch_counts()
                _equal(rnnt_beam_decode(pred, joint, enc, lens, cfg, beam), want)
                assert launch_counts() == eager_counts
    assert len(rnnt_beam._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("t", [10, 40, 48])
def test_card_short_and_partial_batches(dev, monkeypatch, t):
    """Under one block (T = 10: bound 20), a partial last block (T = 40:
    bound 80) and full blocks only (T = 48): the steps and checks of the
    eager loop, its outputs, and graph_steps the full blocks run."""
    cfg, beam = CARD_CASES["nemo"]
    pred, joint = _decoder(cfg, dev)
    enc, lens = _enc(cfg, 4, t, 3, dev), torch.tensor([t, t - 1, t // 2, 3], device=dev)
    with torch.inference_mode():
        profiling.reset()
        want = _eager(monkeypatch, pred, joint, enc, lens, cfg, beam)
        got = rnnt_beam_decode(pred, joint, enc, lens, cfg, beam)
        torch.cuda.synchronize()
    _equal(got, want)
    eager, graphed = _roots()
    for k in ("steps", "checks", "max_steps"):
        assert graphed.attrs[k] == eager.attrs[k]
    full = alsd_step_bound(t, beam) >= CHECK_EVERY
    steps = graphed.attrs["steps"]
    assert graphed.attrs["graph_steps"] == (steps // CHECK_EVERY * CHECK_EVERY if full else 0)
    assert eager.attrs["graph_steps"] == 0


@pytest.mark.cuda
def test_card_two_threads_on_their_own_streams(dev, monkeypatch):
    """Two threads, each on a stream of its own, decode at once (capturing,
    then replaying) and match the serial results."""
    cfg, beam = CARD_CASES["nemo"]
    pred, joint = _decoder(cfg, dev)
    b, t = 8, 160
    inputs = [(_enc(cfg, b, t, s, dev), _lengths(t, b, s).to(dev)) for s in (5, 6)]
    with torch.inference_mode():
        want = [_eager(monkeypatch, pred, joint, enc, lens, cfg, beam) for enc, lens in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    got, errors = [None, None], []

    def work(i):
        try:
            with torch.inference_mode(), torch.cuda.stream(streams[i]):
                for _ in range(2):
                    got[i] = rnnt_beam_decode(pred, joint, *inputs[i], cfg, beam)
            streams[i].synchronize()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    torch.cuda.synchronize()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    for g, w in zip(got, want):
        _equal(g, w)
    assert len(rnnt_beam._graphs) == 2
