"""``BENCHMARK.json`` keeps to the benchmark's contract, and every piece it
names is found by name under ``portbench/``."""

import json
import re

import pytest
from _tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert MANIFEST["paths"] == ["portbench"]
    assert len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    for c in MANIFEST["configs"]:
        assert set(c) == KEYS["config"]
    for w in MANIFEST["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    names += [w[k] for w in MANIFEST["workloads"] for k in ("config", "traffic")]
    names += [r for c in MANIFEST["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in MANIFEST[k]]
        assert len(seen) == len(set(seen))
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    texts = [x["why"] for k in ("configs", "workloads") for x in MANIFEST[k]]
    texts += [m["layer"] for m in MANIFEST["per_layer"]] + [c["source"] for c in MANIFEST["configs"]]
    assert all(_line(t) for t in texts)


def test_every_piece_is_found_by_name():
    bench = ROOT / "portbench"
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench / "checks" / f"{w['name']}.json").is_file()
    for c in configs.values():
        spec = json.loads((ROOT / c["file"]).read_text())
        assert (bench / "families" / f"{spec['family']}.py").is_file()
        assert spec["reduced"] == c["reduced"] and spec["source"] == c["source"]
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for w in cells:
        reports = [m["name"] for m in MANIFEST["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(w in m.get("workloads", cells) for m in MANIFEST["per_layer"])


def test_limits_are_set_for_every_cell():
    for w in MANIFEST["workloads"]:
        limits = json.loads((ROOT / "portbench/checks" / f"{w['name']}.json").read_text())
        assert limits["limits"] and all(v > 0 for v in limits["limits"].values())


@pytest.mark.parametrize("name,refused", [("jax", True), ("jaxlib.xla", True), ("flax", True),
                                          ("reazonspeech_tpu.ops", True), ("reazonspeech", True),
                                          ("reazonspeech_tpu_torch.ops", False),
                                          ("jaxtyping", False)])
def test_forbidden_modules_compare_whole_names(name, refused, monkeypatch):
    import sys
    import types

    from portbench import run

    for mod in run.FORBIDDEN:
        monkeypatch.delitem(sys.modules, mod, raising=False)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(run.forbidden_modules()) == refused
