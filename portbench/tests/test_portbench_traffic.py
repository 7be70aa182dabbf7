"""Each traffic mix's inputs are fixed by the seed."""

import json

import numpy as np
import pytest
from _tiny import ROOT, TRAFFIC

from portbench.runners import offline

MIXES = sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_mix_names_a_runner(mix):
    spec = json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json").read_text())
    assert (ROOT / "portbench" / "runners" / f"{spec['kind']}.py").is_file()


def test_offline_inputs_fixed_by_seed():
    a, b = offline.stage(TRAFFIC, 2**31 + 5), offline.stage(TRAFFIC, 2**31 + 5)
    c = offline.stage(TRAFFIC, 2**31 + 6)
    assert len(a) == TRAFFIC["distinct_batches"] and len(a[0]) == TRAFFIC["batch"]
    assert all(np.array_equal(x, y) for bx, by in zip(a, b) for x, y in zip(bx, by))
    assert not np.array_equal(a[0][0], c[0][0])
    assert not np.array_equal(a[0][0], a[0][1]) and not np.array_equal(a[0][0], a[1][0])
    assert all(len(w) == int(TRAFFIC["chunk_seconds"] * 16000) for w in a[0])


def test_weights_fixed_by_seed():
    import torch

    from portbench.families import nemo
    from portbench.weights import make_tree, tree_shapes
    from _tiny import CELLS

    cfg = {**json.loads((ROOT / "portbench/configs/nemo-v2.json").read_text()),
           **CELLS["nemo-offline-b192"]["config"]}
    a, b = (make_tree(nemo.spec(cfg), 7, "cpu") for _ in range(2))
    c = make_tree(nemo.spec(cfg), 8, "cpu")
    assert tree_shapes(a) == tree_shapes(b)
    wa, wb, wc = (t["encoder"]["blocks"]["ffn1_in"]["w"] for t in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    ptrs = [t.data_ptr() % 16 for t in (wa, a["joint"]["out"]["b"])]
    assert ptrs == [0, 0]


def test_sample_fixed_by_seed():
    from portbench.run import pick

    batches = offline.stage({**TRAFFIC, "batch": 40}, 2**31 + 5)
    a, b, c = pick(2**31 + 5, batches, 12), pick(2**31 + 5, batches, 12), pick(9, batches, 12)
    assert a == b and a != c and len(a) == 12 and len(set(a)) == 12
    assert {d for d, _ in a} == {0, 1}
