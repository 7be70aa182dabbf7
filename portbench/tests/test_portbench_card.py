"""On the card: a sound run of the program passes the cell's limits, and
the control (the reference in fp8 in the program's place) fails them at
the cell's own size on each of three seeds. Skips without a CUDA device;
decided inside the test.

    python -m pytest portbench/tests/test_portbench_card.py -m cuda -q
"""

import json

import pytest
from _tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.check import judge
    from portbench.control import readings

    limits = json.loads((ROOT / "portbench/checks" / f"{cell}.json").read_text())["limits"]
    seeds = [2**31 + 12345, 2**31 + 23456, 2**31 + 34567]
    program = readings(cell, "program", seeds[0])
    assert judge({k: program[k] for k in limits}, limits)[0], program
    controls = [readings(cell, "control", s) for s in seeds]
    assert not any(judge({k: c[k] for k in limits}, limits)[0] for c in controls), controls
