"""Alignment steps the ALSD loop (``decoding/rnnt_beam.py``) runs a batch:
the ``steps`` attr of the program's ``decode`` root (bodies dispatched, in
blocks of ``CHECK_EVERY``; the counter ``decode.steps`` adds the same),
the median batch of the traced window (``utils.profiling``, read through
``portbench/spans.py``)."""

import statistics

from portbench.spans import window_decodes


def read(rec):
    batches = window_decodes(rec)
    if not batches:
        return None
    return statistics.median(root.attrs["steps"] for root, _ in batches)
