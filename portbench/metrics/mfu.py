"""The whole step's share of the chip's peak: the model FLOPs of every
batch of the traced window (``families/<family>.flops``: the encoder over
the valid frames, the predictor and joint over each utterance's alignment
steps and beam rows) over the batches' wall time x 989 TFLOP/s (one H100,
bf16 dense), in %."""

from portbench.frozen import PEAK_FLOPS


def read(rec):
    spans = rec.get("spans", {})
    flops, wall = sum(spans.get("flops", [])), sum(spans.get("batch_s", []))
    if not flops or not wall:
        return None
    return 100.0 * flops / wall / PEAK_FLOPS["bf16"]
