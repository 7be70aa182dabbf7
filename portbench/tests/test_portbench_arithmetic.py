"""The metrics' arithmetic on hand-made numbers."""

import importlib.util

import pytest
import torch
from _tiny import ROOT

from portbench import check, frozen, trace


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mfu():
    rec = {"spans": {"flops": [989e12, 989e12], "batch_s": [2.0, 2.0]}}
    assert _reader("mfu").read(rec) == pytest.approx(50.0)
    assert _reader("mfu").read({"spans": {}}) is None


def test_idle_share():
    r = _reader("device_idle_share.offline")
    rec = {"busy_s": 0.25, "window_s": 3.0, "spans": {"batch_s": [1.0, 0.9, 1.2]}}
    assert r.read(rec) == pytest.approx(75.0)
    assert r.read({"busy_s": 0.0, "spans": {"batch_s": [1.0]}}) is None


def test_spans_are_medians():
    rec = {"spans": {"frontend_ms": [3.0, 1.0, 2.0], "encoder_ms": [5.0, 4.0],
                     "decode_ms": [9.0]}}
    assert _reader("frontend_ms.offline").read(rec) == 2.0
    assert _reader("encoder_ms.offline").read(rec) == 4.5
    assert _reader("decode_ms.offline").read(rec) == 9.0
    assert _reader("encoder_ms.offline").read({"spans": {"encoder_ms": [None]}}) is None


def test_bound_and_ln_dense_roofline():
    x = torch.empty(2, 100, 64, dtype=torch.float32, device="meta")
    w = torch.empty(64, 256, dtype=torch.bfloat16, device="meta")
    g, b, c = torch.ones(64), torch.zeros(64), torch.zeros(256)
    out = torch.empty(2, 100, 256, dtype=torch.bfloat16, device="meta")
    args = (x, g, b, w, c)
    flops = frozen.flops_ln_dense(args, out)
    assert flops == {"bf16": 2.0 * 200 * 64 * 256}
    moved = 200 * 64 * 4 + 64 * 4 * 2 + 64 * 256 * 2 + 256 * 4 + 200 * 256 * 2
    ms, kind = frozen.bound_ms(flops, args, out)
    assert kind == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    r = _reader("ln_dense_roofline")
    rec = {"ranges": ({"ln_dense": 4 * ms}, {"ln_dense": [(args, out)] * 2})}
    assert r.read(rec) == pytest.approx(50.0)
    assert r.read({"ranges": ({}, {})}) is None


def test_enc_rel_l2_and_token_gap():
    params = {"predictor": {"embed": {"table": torch.zeros(3, 2)},
                            "lstm": [{"w_ih": torch.zeros(2, 8), "w_hh": torch.zeros(2, 8),
                                      "b_ih": torch.zeros(8), "b_hh": torch.zeros(8)}]},
              "joint": {"enc": {"w": torch.eye(2), "b": torch.zeros(2)},
                        "pred": {"w": torch.zeros(2, 2), "b": torch.zeros(2)},
                        "out": {"w": torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]]),
                                "b": torch.zeros(4)}}}
    cfg = {"rnnt": {"vocab_size": 3, "pred_hidden": 2, "pred_rnn_layers": 1, "joint_hidden": 2,
                    "joint_activation": "relu", "predictor_kind": "lstm"},
           "decoding": {"alsd_max_target_len": 1.0}}
    ref = torch.tensor([[3.0, 4.0], [0.0, 0.0], [9.0, 9.0]])
    got = ref + torch.tensor([[0.3, 0.4], [0.0, 0.0], [5.0, 5.0]])  # frame 2 is padding
    assert check.enc_rel_l2(cfg, params, [(ref, 2)], [(got, 2)]) == pytest.approx(0.1)
    assert check.enc_rel_l2(cfg, params, [(ref, 2)], [(got, 1)]) == float("inf")
    # frame 0: blank (id 3) leads every label by 3 nats; frame 1: all four tie
    assert check.token_gap(cfg, params, [(ref, 2)], [([], [])]) == pytest.approx(0.0, abs=1e-6)
    assert check.token_gap(cfg, params, [(ref, 2)], [([1], [1])]) == pytest.approx(0.0, abs=1e-6)
    assert check.token_gap(cfg, params, [(ref, 2)], [([1], [0])]) == pytest.approx(3.0)
    assert check.alignment_blanks(cfg, 10, 4) == 10 and check.alignment_blanks(cfg, 10, 14) == 6


def test_busy_union_and_gaps():
    p = trace.Profile.__new__(trace.Profile)
    p.ops, p.gaps, p.host, p.busy_s = {}, [(30.0, 50.0, "k3")], [(0.0, 100.0, "aten::mm")], 0.0
    gaps = p.gap_seconds("decode")
    assert gaps == {"decode: aten::mm": pytest.approx(20e-6)}
    p.host = []
    assert p.gap_seconds("decode") == {"decode: before k3": pytest.approx(20e-6)}


def test_rtfx_of_offline_window():
    from portbench.runners.offline import rtfx

    # 3 batches of 4 x 30 s in 6 s: 60 audio-s/s
    assert rtfx(3, {"batch": 4, "chunk_seconds": 30.0}, 6.0) == pytest.approx(60.0)


def test_union_of_device_intervals():
    busy, gaps = trace.union([(0, 10, "a"), (5, 12, "b"), (20, 25, "c"), (21, 22, "d")])
    assert busy == 17 and gaps == [(12, 20, "c")]


def test_judge():
    ok, rows = check.judge({"a": 0.1, "b": 0.5}, {"a": 0.2, "b": 0.5})
    assert ok and rows == [("a", 0.1, 0.2), ("b", 0.5, 0.5)]
    assert not check.judge({"a": 0.3}, {"a": 0.2})[0]
    assert not check.judge({"a": 0.1}, {})[0]
    assert not check.judge({"a": float("nan")}, {"a": 1.0})[0]
