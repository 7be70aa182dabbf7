"""The plain reference against the port at tiny fp32 configurations: the
same weight tree (the port's layout), the same features and encodings."""

import json

import numpy as np
import pytest
import torch
from _tiny import CELLS, ROOT

from portbench.check import pad_like_program
from portbench.families import nemo
from portbench.frozen import speech_like
from portbench.reference.frontend import log_mel
from portbench.reference.numerics import Numerics
from portbench.weights import make_tree, tree_shapes

FAMILIES = {"nemo-offline-b192": (nemo, "nemo-v2")}


def _setup(cell):
    fam, name = FAMILIES[cell]
    cfg = {**json.loads((ROOT / f"portbench/configs/{name}.json").read_text()),
           **CELLS[cell]["config"]}
    params = make_tree(fam.spec(cfg), 11, "cpu")
    model = fam.build(cfg, params, torch.device("cpu"), 11)
    return fam, cfg, params, model


@pytest.mark.parametrize("cell", sorted(FAMILIES))
def test_tree_is_the_ports_layout(cell):
    fam, cfg, params, model = _setup(cell)
    from reazonspeech_tpu_torch.nemo.asr.model import init_params

    theirs = init_params(0, model.enc_cfg, model.rnnt_cfg)
    assert tree_shapes(params) == tree_shapes(theirs)


@pytest.mark.parametrize("cell", sorted(FAMILIES))
def test_features_and_encoder_agree_with_the_port(cell):
    torch.set_num_threads(2)
    fam, cfg, params, model = _setup(cell)
    waves = [speech_like(2.0, [3, i]) for i in range(2)] + [speech_like(1.3, [3, 9])]
    buf, lengths = pad_like_program(waves, cfg)
    wav, lens = torch.from_numpy(buf), torch.from_numpy(lengths)
    fe, enc, _ = fam.layers(model)
    with torch.no_grad():
        feats_p, flens_p = fe(wav, lens.to(torch.int32))
        feats_r, flens_r = log_mel(wav, lens, cfg["frontend"])
        assert torch.equal(flens_p.long(), flens_r)
        scale = feats_r.abs().max()
        assert (feats_p - feats_r).abs().max() <= 1e-4 * scale
        x_p, xl_p = enc(feats_r, flens_r.to(torch.int32))
        x_r, xl_r = fam.reference_encode(cfg, params, feats_r, flens_r, Numerics("fp32"))
        assert torch.equal(xl_p.long(), xl_r.long())
        err = (x_p - x_r).norm() / x_r.norm()
        assert err <= 1e-5, float(err)


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    q = Numerics("fp8").q(x)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-2)).max()
    assert 1e-2 < rel < 0.2
    assert torch.equal(Numerics("fp32").q(x), x)
    assert np.isfinite(q.numpy()).all()
