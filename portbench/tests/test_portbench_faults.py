"""A run with the timed path broken underneath comes out not correct (tiny
cells on the CPU; the control against each cell's limits at its own size
is ``test_portbench_card.py``, on the card)."""

import numpy as np
import pytest
from _tiny import CELLS, overrides, run_cell

from portbench.control import FAULTS, plant

CELL_NAMES = sorted(CELLS)


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_sound_run_is_correct(cell):
    res = run_cell(cell)
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"rtfx", "setup_s"}
    assert set(res["checks"]) == set(CELLS[cell]["limits"])


@pytest.mark.parametrize("side", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELL_NAMES)
def test_broken_answers_are_not_correct(cell, side):
    res = run_cell(cell, fault=plant(FAULTS[side]))
    assert not res["correct"], res["checks"]
    assert res["checks"]["token_gap"]["value"] > res["checks"]["token_gap"]["limit"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_broken_encoder_is_not_correct(cell, monkeypatch):
    """The encoder's output moved by 1 % where the entry calls it: the
    captured rows read it, whatever the served tokens do."""
    import torch

    from portbench import run as R

    fam = R.importlib.import_module("portbench.families.nemo")
    module, name = fam.ENCODER
    mod = R.importlib.import_module(module)
    orig = getattr(mod, name)

    def encode(*args, **kwargs):
        enc, lens = orig(*args, **kwargs)
        gen = torch.Generator().manual_seed(0)
        noise = torch.randn(enc.shape, generator=gen, dtype=enc.dtype)
        return enc + 0.01 * enc.norm() / noise.norm() * noise, lens

    monkeypatch.setattr(mod, name, encode)
    res = run_cell(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["enc_rel_l2"]["value"] > res["checks"]["enc_rel_l2"]["limit"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_traced_run_reports_its_layers(cell):
    res = run_cell(cell, trace=1)
    assert res["correct"], res["checks"]
    assert {"decode_ms.offline", "mfu"} <= set(res["metrics"])
    assert "breakdown" in res and "busy_s" in res["device"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_control_and_program_readings(cell):
    """Each side's readings run end to end: the sound fp32 program passes
    the tiny cell's limits, each fault fails ``token_gap``'s, and the fp8
    control reads ``enc_rel_l2`` far above the program. (The card test
    holds the control to the cell's limits at its own size.)"""
    import torch

    from portbench.control import readings

    seed = CELLS[cell]["seed"]
    kw = dict(device=torch.device("cpu"), overrides=overrides(cell))
    program = readings(cell, "program", seed, **kw)
    control = readings(cell, "control", seed, **kw)
    limits = CELLS[cell]["limits"]
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert control["labels"] > 0 and np.isfinite([control[k] for k in limits]).all(), control
    assert control["enc_rel_l2"] > 10 * program["enc_rel_l2"], (control, program)
    for side in FAULTS:
        assert readings(cell, side, seed, **kw)["token_gap"] > limits["token_gap"]
