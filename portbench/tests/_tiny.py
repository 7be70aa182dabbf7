"""Tiny configurations of the benchmark's cells, for CPU tests: the
published shapes' structure at toy widths, fp32, few short chunks."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRAFFIC = {"batch": 3, "chunk_seconds": 2.0, "distinct_batches": 2, "sample": 100}
FP32 = {"compute_dtype": "float32", "residual_dtype": "float32"}

CELLS = {
    "nemo-offline-b192": {
        "seed": 3000000001,
        "config": {
            "encoder": {"feat_in": 80, "num_layers": 2, "d_model": 64, "num_heads": 4,
                        "ff_expansion": 4, "conv_kernel": 9, "subsampling_factor": 8,
                        "subsampling_channels": 32, "subsampling_style": "dw_striding",
                        "conv_norm": "batch_norm", "xscaling": True, "final_norm": False},
            "rnnt": {"vocab_size": 64, "pred_hidden": 32, "pred_rnn_layers": 1,
                     "joint_hidden": 32, "joint_activation": "relu", "predictor_kind": "lstm",
                     "context_size": 2},
            "numerics": FP32},
        "traffic": TRAFFIC,
        "limits": {"enc_rel_l2": 1e-4, "token_gap": 0.1}}
}


def overrides(cell):
    return {k: CELLS[cell][k] for k in ("config", "traffic", "limits")}


def run_cell(cell, trace=0, fault=None, seconds=0.5):
    """One run of ``cell`` at its tiny size on the CPU; the result object."""
    import torch

    from portbench import run as R

    torch.set_num_threads(2)
    argv = ["--workload", cell, "--seed", str(CELLS[cell]["seed"]), "--seconds", str(seconds),
            "--trace", str(trace)]
    return R.execute(argv, device=torch.device("cpu"), overrides=overrides(cell), fault=fault)
