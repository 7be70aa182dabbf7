"""Readings that set a cell's limits: the program's sound runs, the
control's, and the program with a fault planted where it produces its
answers, on seeds given on the command line, in one process.

    python3 portbench/control.py --workload <cell> --side program|control|token|half --seeds 1 2

``program``: the cell's weights and traffic from each seed, one call of
the program's entry on each distinct batch at the cell's batch size,
judged as ``run.py`` judges a window (the same sample, the same numbers).
``control``: the plain reference computed in fp8 (``Numerics("fp8")``:
every product's operands rounded to e4m3) put in the program's place for
the same sample: its encoder output, and the hypotheses its own ALSD
serves from it, judged by the same numbers against the fp32 reference.
``token`` and ``half``: the program with the fault of the same name
(:data:`FAULTS`). Each seed prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _alter_token(tokens, frames, counts, model):
    """Every utterance's first label replaced by another label."""
    v, blank = model.rnnt_cfg.vocab_size, model.rnnt_cfg.blank_id
    for i in range(len(counts)):
        if counts[i]:
            nxt = (int(tokens[i, 0]) + 17) % (v + 1)
            tokens[i, 0] = nxt if nxt != blank else (nxt + 1) % v
    return tokens, frames, counts


def _drop_half(tokens, frames, counts, model):
    """Half of the batch left out: every other utterance answered empty."""
    counts[1::2] = 0
    return tokens, frames, counts


FAULTS = {"token": _alter_token, "half": _drop_half}


def plant(alter):
    """A fault planted where the program produces its answers: the batch
    decode's (tokens, frames, counts) pass through ``alter``."""

    def fault(model):
        orig = model.decode_batch

        def decode_batch(waveforms, lengths):
            tokens, frames, counts, enc_lengths = orig(waveforms, lengths)
            return (*alter(tokens.copy(), frames, counts.copy(), model), enc_lengths)

        model.decode_batch = decode_batch

    return fault


def readings(workload, side, seed, device=None, overrides=None):
    """One seed's numbers for ``side``. ``device`` and ``overrides`` (of the
    configuration, traffic and limits) are for the tests' tiny CPU runs."""
    import torch

    from portbench import run as R
    from portbench.check import enc_rel_l2, reference_encode, token_gap
    from portbench.reference.numerics import Numerics
    from portbench.reference.transducer import Transducer
    from portbench.weights import make_tree

    R._environment()
    R._program()
    manifest = R._json(ROOT / "BENCHMARK.json")
    args = R._parse(["--workload", workload, "--seed", str(seed), "--seconds", "0"])
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    device = device or R._device(cell["chips"])
    run = R.Run(args, manifest, device, overrides)
    t0 = time.perf_counter()
    params = make_tree(run.family.spec(run.cfg), seed, device)
    batches = run.runner.stage(run.mix, seed, device)
    run.sample = R.pick(seed, batches, run.mix["sample"])
    if side != "control":
        model = run.family.build(run.cfg, params, device, seed)
        if side in FAULTS:
            plant(FAULTS[side])(model)
        audios = run.runner._as_audio(batches)
        with run.runner.Capture(run.family, model, run.runner._rows(run, len(batches))) as cap:
            for audio in audios:
                run.family.transcribe_batch(model, audio)
        del model
        numbers = R.verify(run, params, batches,
                           run.runner.results(cap.outs, cap.encs, len(batches)))
        labels = None
    else:
        waves = [batches[b][i] for b, i in run.sample]
        encoded = reference_encode(run.family, run.cfg, params, waves, device, Numerics("fp32"))
        nm, dec = Numerics("fp8"), run.cfg["decoding"]
        low = reference_encode(run.family, run.cfg, params, waves, device, nm, raw=True)
        td = Transducer(params, run.cfg["rnnt"], nm)
        with torch.no_grad():
            hyps = [td.alsd(td.enc_proj(x), n, dec["beam_size"], dec["alsd_max_target_len"])
                    for x, n in low]
        numbers = {"enc_rel_l2": enc_rel_l2(run.cfg, params, encoded, low),
                   "token_gap": token_gap(run.cfg, params, encoded, hyps)}
        labels = sum(len(h[0]) for h in hyps)
    return {"workload": workload, "side": side, "seed": seed, **numbers, "labels": labels,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control", *FAULTS), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, args.side, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
